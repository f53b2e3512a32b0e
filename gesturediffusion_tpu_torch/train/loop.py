"""Training step and loop.

PyTorch counterpart of gesturediffusion_tpu/train/loop.py.  The JAX step
is one jitted function (:109-291); here ``train_step`` is a plain Python
function on tensors that does the same work in the same order: sample
timesteps (or take injected ones), q_sample with the given or drawn noise,
run the model in train mode, the importance-weighted masked-MSE loss,
backward (averaged over ``microbatch_size`` microbatches), then, unless
the loss or the gradient norm is not finite, the AdamW update with the
reference's lagged linear LR anneal, the EMA and the sampler update.  A
non-finite step changes nothing but the skip count, the BatchNorm running
statistics that its forward moved included (JAX keeps the old
``model_state``, loop.py:262).  The running statistics move once per
microbatch, in microbatch order (loop.py:218-230); the EMA covers the
parameters only, as JAX's ``ema_params``, so a checkpoint carries the live
statistics.  The step's convolutions (the wav encoder's) run in float32,
cuDNN's TF32 off, forward and backward (utils/device.py:full_f32).  Every
random draw comes from one torch.Generator on the model's device.  ``use_bf16`` rounds
the model's input x_t to bfloat16 and back, as JAX's step does (loop.py:154
casts it, and the model's first act casts it back to float32): every
product stays float32.  ``fk_fn`` (xyz joints of a sample) goes to the
geometric loss terms (loop.py:114,172-174).

Over several ranks (parallel/, ``TrainState.mesh``) each data rank holds
its rows of the global batch and the step equals the single-process step
on that batch: every draw is of the global batch from the generator all
ranks seed alike (parallel/distributed.py:global_rows), the microbatches
are the global batch's contiguous ones (loop.py:182-199; with several
microbatches the ranks gather the batch and each keeps its rows of every
microbatch), the gradients are averaged over the data group once a step
in one flat bucket, and the logged loss, the finiteness check, the
metrics and the sampler's (t, loss) are the global batch's, so every rank
keeps or skips the same step and holds the same EMA and sampler state.
Under tensor parallelism (``mesh.model`` > 1, loop.py:386-407) each weight
of parallel/mesh.py:shard_params_tp is its block in the model
(``TrainState.tp``), and so are its gradient, its AdamW moments and its
EMA: the plain layers run their products on the blocks
(parallel/tensor.py), the fused training layer gathers its layer's
weights for each call, the gradient norm sums each block's squares over
the model group once, and the whole weights are built only for a
checkpoint (the single-process layout) and rank 0's evaluation at a save
(``TrainState.whole``).

``TrainLoop`` is the host shell: data, text embedding, logging,
checkpoints and resume.  With a ``text_encoder`` each batch's captions are
embedded on the host into ``text_emb`` (loop.py:517-529); the batch's
``mask`` (its items' lengths) reaches the loss; string fields (captions,
``action_text``) stay on the host.  ``eval_fn(state, step)`` runs after
every save inside the loop (loop.py:599-610; not after the last one), its
metrics logged as ``eval/<name>`` beside ``eval/wall_s`` and reported to
the platform's ``Eval`` group.  A checkpoint is ``model{step:09d}.pt`` (the model's state dict in the
reference torch layout, which the generate CLI and the JAX package's
load_torch_checkpoint read) beside ``opt{step:09d}.pt`` (optimizer, LR
schedule, sampler, EMA, skip count and generator state).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from gesturediffusion_tpu_torch.data.collate import device_cond
from gesturediffusion_tpu_torch.data.loader import DataLoader, infinite_batches
from gesturediffusion_tpu_torch.diffusion.gaussian import GaussianDiffusion
from gesturediffusion_tpu_torch.diffusion.resample import create_named_schedule_sampler
from gesturediffusion_tpu_torch.parallel.distributed import (
    all_gather_cat,
    all_reduce_mean,
    barrier,
    global_rows,
    make_global_batch,
    process_index,
)
from gesturediffusion_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedParams,
    make_data_mesh_for_batch,
)
from gesturediffusion_tpu_torch.train.platforms import TrainPlatform
from gesturediffusion_tpu_torch.utils import logger as log_lib
from gesturediffusion_tpu_torch.utils.convert import load_weights
from gesturediffusion_tpu_torch.utils.device import full_f32

# the buffers a training forward moves (BatchNorm's running statistics)
RUNNING_STATS = ("running_mean", "running_var", "num_batches_tracked")


@dataclasses.dataclass
class TrainConfig:
    save_dir: str = "save/run"
    lr: float = 1e-4
    weight_decay: float = 0.0
    lr_anneal_steps: int = 0
    num_steps: int = 600_000
    batch_size: int = 256
    log_interval: int = 1_000
    save_interval: int = 50_000
    schedule_sampler: str = "uniform"
    ema_rate: float = 0.0  # 0 disables EMA
    use_bf16: bool = False  # round the model input to bfloat16
    # gradient accumulation: split each batch into microbatches of this
    # size (0 = off)
    microbatch_size: int = 0
    seed: int = 10


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    sampler: object
    ema: dict  # parameter name -> EMA tensor; empty when EMA is off
    step: int = 0
    nonfinite_skips: int = 0
    mesh: Optional[Mesh] = None          # the ranks' grid; None: one process
    tp: Optional[ShardedParams] = None   # the sharded weights' blocks (mesh.model > 1)

    def whole(self):
        """Run a block with the model's sharded weights and the EMA whole
        (ShardedParams.whole; collective over the model group), as a
        checkpoint and the evaluation read them; nothing without tensor
        parallelism."""
        return contextlib.nullcontext() if self.tp is None else self.tp.whole(self.ema)


def quartile_means(t: torch.Tensor, values: torch.Tensor, num_timesteps: int) -> dict:
    """Mean of ``values`` per timestep quartile (the reference's logging)."""
    quart = (t * 4) // num_timesteps
    out = {}
    for q in range(4):
        sel = (quart == q).to(values.dtype)
        out[f"q{q}"] = (values * sel).sum() / sel.sum().clamp(min=1.0)
    return out


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((x.float() ** 2).sum() for x in tensors))


def lr_factor(count: int, anneal_steps: int) -> float:
    """The reference anneals after each update, so update k (1-based,
    count = k - 1) applies lr * (1 - clip((count - 1) / N, 0, 1)): one step
    behind a plain linear schedule (loop.py:make_optimizer)."""
    if not anneal_steps:
        return 1.0
    return 1.0 - min(max((count - 1) / anneal_steps, 0.0), 1.0)


def make_optimizer(params, config: TrainConfig):
    """AdamW with optax's adamw defaults (betas 0.9 / 0.999, eps 1e-8,
    decoupled weight decay on every parameter) and the lagged anneal."""
    opt = torch.optim.AdamW(params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=config.weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: lr_factor(count, config.lr_anneal_steps))
    return opt, sched


def make_train_state(model: nn.Module, config: TrainConfig, sampler,
                     mesh: Optional[Mesh] = None) -> TrainState:
    """A fresh state: each weight tensor parallelism shards cut to its
    block in the model, AdamW over the model's parameters, the EMA from
    the weights."""
    tp = ShardedParams(model, mesh) if mesh is not None and mesh.model > 1 else None
    opt, sched = make_optimizer(model.parameters(), config)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if config.ema_rate > 0 else {})
    return TrainState(model, opt, sched, sampler, ema, mesh=mesh, tp=tp)


def average_grads(params, group) -> None:
    """Each gradient averaged over the group, in one flat bucket."""
    if group is None:
        return
    flat = all_reduce_mean(torch.cat([p.grad.reshape(-1) for p in params]), group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()


def train_step(
    state: TrainState,
    diffusion: GaussianDiffusion,
    config: TrainConfig,
    motion: torch.Tensor,
    cond: dict,
    generator: torch.Generator,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    fk_fn: Optional[Callable] = None,
) -> dict:
    """One update.  ``t`` and ``noise`` default to the sampler's and the
    generator's draws; passing them replays a step exactly.  Over several
    data ranks ``motion``, ``cond``, ``t`` and ``noise`` are this rank's
    rows of the global batch (its loader slice).  Returns the metrics as
    tensors, the global batch's (one host sync decides whether the step is
    kept)."""
    model = state.model
    model.train()
    mesh = state.mesh
    dp, r, group = (1, 0, None) if mesh is None else (mesh.data, mesh.data_index,
                                                      mesh.data_group)
    b = motion.shape[0] * dp  # the global batch
    mb = config.microbatch_size
    if mb and mb < b:
        if b % mb:
            raise ValueError(f"batch {b} not divisible by microbatch_size {mb}")
        k = b // mb
    else:
        k, mb = 1, b
    if mb % dp:
        raise ValueError(f"microbatch {mb} not divisible by the {dp} data ranks")
    mbl = mb // dp  # this rank's rows of a microbatch

    def mine(x):
        """This rank's rows of each global microbatch from the global batch."""
        return x.reshape(k, dp, mbl, *x.shape[1:])[:, r].reshape(k * mbl, *x.shape[1:])

    def in_order(x):
        """The global batch from every rank's rows (mine's inverse)."""
        x = all_gather_cat(x, group)
        return x.reshape(dp, k, mbl, *x.shape[1:]).transpose(0, 1).reshape(b, *x.shape[1:])

    if k > 1 and dp > 1:
        # a rank's slice of the batch spans whole microbatches: regroup
        def regroup(x):
            return None if x is None else mine(make_global_batch(mesh, x))

        motion, t, noise = regroup(motion), regroup(t), regroup(noise)
        cond = {key: regroup(v) for key, v in cond.items()}
    if t is None:
        t, weights = (mine(x) for x in state.sampler.sample(b, generator))
    else:
        # injected timesteps: uniform importance weights
        weights = torch.ones(t.shape, dtype=torch.float32, device=motion.device)
    if noise is None:
        noise = mine(torch.randn((b,) + motion.shape[1:], generator=generator,
                                 device=motion.device, dtype=motion.dtype))

    def model_fn(x, tt, cc):
        if config.use_bf16:
            x = x.to(torch.bfloat16).to(x.dtype)
        return model(x, tt, cc, train=True, generator=generator).to(motion.dtype)

    model.zero_grad(set_to_none=True)
    state.optimizer.zero_grad(set_to_none=True)
    stats = [buf for n, buf in model.named_buffers() if n.rsplit(".", 1)[-1] in RUNNING_STATS]
    stats_before = [buf.clone() for buf in stats]
    loss = torch.zeros((), device=motion.device)
    terms: dict = {}
    for i in range(k):
        sl = slice(i * mbl, (i + 1) * mbl)
        cc = {key: v[sl] for key, v in cond.items()}
        rows = (global_rows(r * mbl, mbl, mb, group) if dp > 1 else contextlib.nullcontext())
        with torch.enable_grad(), full_f32(), rows:  # whatever the caller's grad mode
            terms_i = diffusion.training_losses(
                model_fn, motion[sl], t[sl], cc, mask=cc["mask"], noise=noise[sl], fk_fn=fk_fn)
            loss_i = (terms_i["loss"] * weights[sl]).mean()
            (loss_i / k).backward()
        loss = loss + loss_i.detach() / k
        for name, val in terms_i.items():
            terms.setdefault(name, []).append(val.detach())
    terms = {name: torch.cat(vals) for name, vals in terms.items()}

    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    for p in params:
        if p.grad is None:  # a parameter the loss does not reach
            p.grad = torch.zeros_like(p)
    if dp > 1:  # the global batch's gradients, loss, timesteps and terms
        average_grads(params, group)
        loss = all_reduce_mean(loss, group)
        names = list(terms)
        cols = in_order(torch.stack([t.float(), weights, *(terms[n] for n in names)], dim=1))
        t, weights = cols[:, 0].long(), cols[:, 1]
        terms = {n: cols[:, 2 + j] for j, n in enumerate(names)}
    if state.tp is None:
        grad_norm = global_norm(p.grad for p in params)
    else:  # the whole model's norm from the blocks
        grad_norm = state.tp.global_norm((n, p.grad) for n, p in named)
    ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
    if ok:
        state.optimizer.step()
        state.scheduler.step()
        if config.ema_rate > 0:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    state.ema[name].mul_(config.ema_rate).add_(p, alpha=1 - config.ema_rate)
        state.sampler.update_with_losses(t, terms["loss"])
    else:
        with torch.no_grad():
            for buf, before in zip(stats, stats_before):
                buf.copy_(before)
        state.nonfinite_skips += 1
    state.step += 1

    with torch.no_grad():
        param_norm = (global_norm(params) if state.tp is None
                      else state.tp.global_norm(named))
        metrics = {"loss": loss, "grad_norm": grad_norm, "param_norm": param_norm,
                   "nonfinite_skips": state.nonfinite_skips}
        for name, val in terms.items():
            # importance-weighted, so the logged loss is the optimised one
            wval = val * weights
            metrics[name] = wval.mean()
            for qname, qval in quartile_means(t, wval, diffusion.num_timesteps).items():
                metrics[f"{name}_{qname}"] = qval
    return metrics


def batch_to_device(motion: np.ndarray, cond: dict, device: torch.device,
                    text_encoder: Optional[Callable] = None, audio: bool = False):
    """A collated (motion, cond) as tensors on ``device``, the captions
    embedded by ``text_encoder`` into ``text_emb``; host-only fields stay
    behind, and the raw audio too unless ``audio`` (a model that reads it:
    the wav encoder's; the others read the MFCCs)."""
    dcond = {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in device_cond(cond).items() if audio or k != "audio"}
    if text_encoder is not None and "text" in cond:
        dcond["text_emb"] = torch.as_tensor(text_encoder(cond["text"]), device=device)
    return torch.from_numpy(motion).to(device), dcond


class TrainLoop:
    """Host-side training shell: data, logging, checkpoints, resume."""

    def __init__(
        self,
        config: TrainConfig,
        diffusion: GaussianDiffusion,
        model: nn.Module,
        data: DataLoader,
        device: torch.device,
        platform: Optional[TrainPlatform] = None,
        args_to_save: Optional[dict] = None,
        text_encoder: Optional[Callable] = None,
        fk_fn: Optional[Callable] = None,
        eval_fn: Optional[Callable] = None,
        mesh: Optional[Mesh] = None,
    ):
        """``data`` yields this rank's rows of each global batch of
        ``config.batch_size``; ``mesh`` defaults to every rank on the data
        axis.  Rank 0 alone writes files, logs progress and runs
        ``eval_fn``."""
        self.config = config
        self.text_encoder = text_encoder
        self.eval_fn = eval_fn
        self.fk_fn = fk_fn
        self.diffusion = diffusion
        self.data = data
        self.device = device
        self.mesh = mesh if mesh is not None else make_data_mesh_for_batch(config.batch_size)
        self.writes = process_index() == 0
        self.platform = platform or TrainPlatform(config.save_dir)
        # the logger is one process's (utils/logger.py): the other ranks print
        # their table and write no file, whatever OPENAI_LOGDIR and
        # OPENAI_LOG_FORMAT say
        self.logger = (log_lib.configure(config.save_dir) if self.writes
                       else log_lib.configure(format_strs=["stdout"]))
        model = model.to(device)
        sampler = create_named_schedule_sampler(
            config.schedule_sampler, diffusion.num_timesteps, device)
        self.state = make_train_state(model, config, sampler, self.mesh)
        self.generator = torch.Generator(device=device).manual_seed(config.seed)
        os.makedirs(config.save_dir, exist_ok=True)
        if args_to_save is not None and self.writes:
            with open(os.path.join(config.save_dir, "args.json"), "w") as f:
                json.dump(args_to_save, f, indent=4, sort_keys=True)
        self.resume_step = 0
        self._prev_skips = 0

    def _fresh_ema(self, model: nn.Module) -> dict:
        if self.config.ema_rate <= 0:
            return {}
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    # ---- checkpoints (model{step:09d}.pt + opt{step:09d}.pt) ------------ #
    def _path(self, kind: str, step: int) -> str:
        return os.path.abspath(os.path.join(self.config.save_dir, f"{kind}{step:09d}.pt"))

    def save(self) -> str:
        """Rank 0 writes the checkpoint in the single-process layout (the
        sharded weights, moments and EMA gathered whole first), the others
        wait for it."""
        s = self.state
        path = self._path("model", s.step)
        opt_state = s.optimizer.state_dict()
        if s.tp is not None:
            opt_state = s.tp.full_optimizer_state(opt_state)
        with s.whole():
            if self.writes:
                torch.save(s.model.state_dict(), path)
                torch.save({
                    "optimizer": opt_state,
                    "scheduler": s.scheduler.state_dict(),
                    "sampler": s.sampler.state_dict(),
                    "ema": s.ema,
                    "nonfinite_skips": s.nonfinite_skips,
                    "generator": self.generator.get_state(),
                    # parameters as they train where the model file holds them
                    # folded (models/mdm_t2m.py:EmbedAction)
                    "unfolded": {n: m.unfolded_state() for n, m in s.model.named_modules()
                                 if hasattr(m, "unfolded_state")},
                }, self._path("opt", s.step))
                log_lib.log(f"saved checkpoint {path}")
        barrier()
        return path

    def load(self, path: str) -> None:
        """Resume from ``model*.pt``.  With its ``opt*.pt`` beside it the
        optimizer, schedule, sampler, EMA and generator continue; without
        it (a reference or JAX-exported file) the optimizer starts fresh
        and only the LR schedule resumes at the file's step.  Every rank
        reads the files; a sharded weight, its moments and its EMA keep
        their blocks of the whole ones."""
        s = self.state
        step = parse_resume_step_from_filename(path)
        opt_path = os.path.join(os.path.dirname(path),
                                os.path.basename(path).replace("model", "opt", 1))
        ck = (torch.load(opt_path, map_location=self.device, weights_only=True)
              if os.path.exists(opt_path) else None)
        with s.whole():
            load_weights(s.model, path)
            if ck is not None:
                modules = dict(s.model.named_modules())
                for n, state in ck.get("unfolded", {}).items():
                    modules[n].load_unfolded_state(state)
        if ck is not None:
            s.optimizer.load_state_dict(ck["optimizer"] if s.tp is None
                                        else s.tp.local_optimizer_state(ck["optimizer"]))
            s.scheduler.load_state_dict(ck["scheduler"])
            s.sampler.load_state_dict(ck["sampler"])
            ema = {n: e.to(self.device) for n, e in ck["ema"].items()}
            s.ema = ema if s.tp is None else s.tp.block_tensors(ema)
            s.nonfinite_skips = int(ck["nonfinite_skips"])
            self.generator.set_state(ck["generator"].cpu())
            log_lib.log(f"resumed from {path} at step {step}")
        else:
            s.optimizer, s.scheduler = make_optimizer(s.model.parameters(), self.config)
            s.scheduler.last_epoch = step
            for group, base in zip(s.optimizer.param_groups, s.scheduler.base_lrs):
                group["lr"] = base * lr_factor(step, self.config.lr_anneal_steps)
            s.ema = self._fresh_ema(s.model)
            log_lib.log(f"fine-tuning from {path} at step {step} (fresh optimizer state)")
        s.step = step
        self.resume_step = step
        self._prev_skips = s.nonfinite_skips

    # ---- the loop ------------------------------------------------------- #
    def _host_batches(self):
        """Collated batches as tensors on the device (batch_to_device)."""
        audio = getattr(self.state.model, "reads_audio", False)
        for motion, cond in infinite_batches(self.data):
            yield batch_to_device(motion, cond, self.device, self.text_encoder, audio)

    def run_loop(self, batch_source=None) -> None:
        """Train to ``num_steps``; ``batch_source`` yields ready
        (motion, cond) tensor pairs instead of the data loader's."""
        if batch_source is not None:
            return self._run(batch_source)
        batches = self._host_batches()
        try:
            self._run(batches)
        finally:
            batches.close()  # stops the loader's producer thread

    def _run(self, batch_source) -> None:
        cfg = self.config
        t_start = time.time()
        for step in range(self.state.step, cfg.num_steps):
            motion, dcond = next(batch_source)
            metrics = train_step(self.state, self.diffusion, cfg, motion, dcond, self.generator,
                                 fk_fn=self.fk_fn)

            if step % cfg.log_interval == 0:
                skips = self.state.nonfinite_skips
                if skips > self._prev_skips:
                    log_lib.log(f"WARNING: {skips - self._prev_skips} non-finite step(s) "
                                f"skipped since last log (total {skips})")
                if skips - self._prev_skips >= max(cfg.log_interval, 1):
                    self.save()
                    raise FloatingPointError(
                        f"all {cfg.log_interval} steps since last log were non-finite "
                        f"at step {step}; checkpoint saved")
                self._prev_skips = skips
                for k, v in metrics.items():
                    v = float(v)
                    if not np.isfinite(v):
                        continue  # a skipped step's NaN; the skip count records it
                    log_lib.logkv_mean(k, v)
                    if k == "loss":
                        self.platform.report_scalar(k, v, iteration=step, group_name="Loss")
                log_lib.logkv("step", step)
                log_lib.logkv("steps/sec", (step - self.resume_step + 1)
                              / max(time.time() - t_start, 1e-9))
                log_lib.dumpkvs()

            if step > 0 and step % cfg.save_interval == 0:
                with self.state.whole():  # one gather for the save and the evaluation
                    self.save()
                    if self.eval_fn is not None and self.writes:
                        self._evaluate(step)
                barrier()  # the other ranks wait for rank 0's evaluation
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    return
        self.save()

    def _evaluate(self, step: int) -> None:
        t_eval = time.time()
        for k, v in (self.eval_fn(self.state, step) or {}).items():
            log_lib.logkv(f"eval/{k}", float(v))
            self.platform.report_scalar(k, float(v), iteration=step, group_name="Eval")
        log_lib.logkv("eval/wall_s", time.time() - t_eval)
        log_lib.dumpkvs()


def parse_resume_step_from_filename(path: str) -> int:
    """N from a ``model{N:09d}.pt`` path."""
    m = re.search(r"model(\d+)", os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else 0


def find_latest_checkpoint(save_dir: str) -> Optional[str]:
    """The ``model{N}.pt`` with the largest step N in ``save_dir``."""
    if not os.path.isdir(save_dir):
        return None
    ckpts = [f for f in os.listdir(save_dir) if re.fullmatch(r"model\d+\.pt", f)]
    if not ckpts:
        return None
    return os.path.join(save_dir, max(ckpts, key=parse_resume_step_from_filename))
