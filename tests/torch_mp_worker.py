"""One rank of the port's multi-rank runs on the CPU, and the runs' shared
code.

``python tests/torch_mp_worker.py SPEC_DIR NAME [NAME ...]`` with
GDT_COORDINATOR_ADDRESS, GDT_NUM_PROCESSES and GDT_PROCESS_ID set joins the
gloo group (parallel/distributed.py:maybe_initialize on the CPU), then for
each NAME loads ``SPEC_DIR/NAME.pt`` (written by
tests/test_torch_multiprocess.py), runs it on the (data, model) grid the
spec names and writes ``SPEC_DIR/NAME.rank{r}.pt``.  The same functions with
``mesh=None`` are the single-process runs the ranks are held against.  It
imports torch and the port only (no JAX), and runs torch on one thread.
"""

from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion  # noqa: E402
from gesturediffusion_tpu_torch.diffusion.resample import (  # noqa: E402
    create_named_schedule_sampler,
)
from gesturediffusion_tpu_torch.models.mdm import MDM  # noqa: E402
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM  # noqa: E402
from gesturediffusion_tpu_torch.models.rotation2xyz import rotation2xyz  # noqa: E402
from gesturediffusion_tpu_torch.models.smpl import make_synthetic_smpl  # noqa: E402
from gesturediffusion_tpu_torch.parallel import distributed as dist_lib  # noqa: E402
from gesturediffusion_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from gesturediffusion_tpu_torch.train.loop import (  # noqa: E402
    TrainConfig,
    TrainLoop,
    make_train_state,
    train_step,
)

# the model's row of a batch for data rank r of dp: rows [r * b, (r + 1) * b)


def local_rows(x, mesh):
    """This data rank's contiguous slice of a global batch (its loader's)."""
    if mesh is None or mesh.data == 1:
        return x
    per = x.shape[0] // mesh.data
    return x[mesh.data_index * per:(mesh.data_index + 1) * per]


def local_batch(batch: dict, mesh) -> dict:
    return {k: ({n: local_rows(v, mesh) for n, v in batch[k].items()} if k == "cond"
                else local_rows(batch[k], mesh)) for k in batch}


def build_model(spec: dict):
    """The spec's gesture MDM, or with ``spec["motion_mdm"]`` the MotionMDM."""
    model = (MotionMDM if spec.get("motion_mdm") else MDM)(**spec["model"])
    model.load_state_dict(spec["state"])
    return model


def make_fk_fn(spec: dict):
    """xyz joints through a synthetic SMPL of ``spec["smpl_vertices"]``
    vertices (the a2m geometric losses), or None."""
    if not spec.get("smpl_vertices"):
        return None
    smpl = make_synthetic_smpl(spec["smpl_vertices"])
    return lambda sample: rotation2xyz(smpl, sample, pose_rep="rot6d", translation=True,
                                       glob=True, jointstype="smpl", vertstrans=False)


def train_steps(spec: dict, mesh=None) -> dict:
    """``spec["batches"]`` (global batches; ``t`` and ``noise`` injected
    where a batch has them) through train_step on this rank's rows: the
    losses, each step's gradients (averaged over the ranks), the weights
    and buffers after, the optimizer state in the
    single-process layout, the EMA, the sampler state and the shapes of the
    optimizer's tensors a sharded weight holds."""
    model = build_model(spec)
    cfg = TrainConfig(**spec["config"])
    diffusion = create_diffusion(steps=spec["diffusion_steps"], noise_schedule="cosine",
                                 **spec.get("lambdas", {}))
    sampler = create_named_schedule_sampler(cfg.schedule_sampler, diffusion.num_timesteps)
    state = make_train_state(model, cfg, sampler, mesh)
    tp = state.tp
    gen = torch.Generator().manual_seed(spec["seed"])
    fk_fn = make_fk_fn(spec)
    losses, grad_norms, grads = [], [], []
    for batch in spec["batches"]:
        b = local_batch(batch, mesh)
        m = train_step(state, diffusion, cfg, b["motion"], b["cond"], gen, b.get("t"),
                       b.get("noise"), fk_fn=fk_fn)
        losses.append(m["loss"].item())
        grad_norms.append(m["grad_norm"].item())
        g = {n: p.grad.clone() for n, p in model.named_parameters()}
        grads.append(g if tp is None else tp.whole_tensors(g))
    opt = state.optimizer.state_dict()
    shards = {}
    if tp is not None:
        # what a rank holds of each sharded weight: the weight, its gradient,
        # its two moments and its EMA
        params = dict(model.named_parameters())
        for n in tp.blocks:
            p = params[n]
            st = state.optimizer.state[p]
            shards[n] = tuple(tuple(x.shape) for x in (p, p.grad, st["exp_avg"],
                                                       st["exp_avg_sq"], state.ema[n]))
        opt = tp.full_optimizer_state(opt)
    with state.whole():
        params = {k: v.clone() for k, v in model.state_dict().items()}
        ema = dict(state.ema)
    return {"losses": losses, "grad_norms": grad_norms, "grads": grads, "params": params,
            "opt": opt["state"], "ema": ema, "sampler": state.sampler.state_dict(),
            "shards": shards, "generator": gen.get_state()}


def train_resumed(spec: dict, save_dir: str, mesh=None) -> dict:
    """TrainLoop over ``spec["batches"]`` (draws from the loop's
    generator): with ``spec["resume_at"]`` k, k steps, a checkpoint, then a
    fresh loop resumed from it for the rest; else uninterrupted.  The
    weights and buffers at the end."""
    batches = [local_batch(b, mesh) for b in spec["batches"]]
    n = len(batches)
    diffusion = create_diffusion(steps=spec["diffusion_steps"], noise_schedule="cosine")

    def loop_to(steps: int) -> TrainLoop:
        cfg = TrainConfig(**spec["config"], save_dir=save_dir, num_steps=steps)
        return TrainLoop(cfg, diffusion, build_model(spec), None, torch.device("cpu"), mesh=mesh)

    k = spec.get("resume_at")
    if k:
        first = loop_to(k)
        first.run_loop(batch_source=((b["motion"], b["cond"]) for b in batches[:k]))
        loop = loop_to(n)
        loop.load(os.path.join(save_dir, f"model{k:09d}.pt"))
        rest = batches[k:]
    else:
        loop, rest = loop_to(n), batches
    loop.run_loop(batch_source=((b["motion"], b["cond"]) for b in rest))
    with loop.state.whole():
        params = {k: v.clone() for k, v in loop.state.model.state_dict().items()}
    return {"params": params, "step": loop.state.step}


def stream_chunks(spec: dict, mesh=None) -> list:
    """A streaming session's chunks (every rank returns the whole chunk)."""
    from gesturediffusion_tpu_torch.serve.streaming import StreamingGestureSession

    session = StreamingGestureSession(build_model(spec), mesh=mesh, device="cpu",
                                      **spec["session"])
    session.start(spec["seed0"], rng=spec["seed"])
    return [torch.from_numpy(session.feed({"mfcc": m})) for m in spec["mfcc"]]


def generate_take(spec: dict) -> dict:
    """The generate CLI in this process (``spec["argv"]`` for this rank)."""
    from gesturediffusion_tpu_torch.sample import generate

    argv = spec["argv"][dist_lib.process_index()]
    return {"out": generate.main(argv)}


def train_cli(argv: list) -> dict:
    """The train CLI in this process."""
    from gesturediffusion_tpu_torch.train import train_mdm

    return {"step": train_mdm.main(argv).state.step}


def run(spec: dict, mesh) -> dict:
    kind = spec["kind"]
    if kind == "train_cli":
        return train_cli(spec["argv"])
    if kind == "steps":
        return train_steps(spec, mesh)
    if kind == "resume":
        return train_resumed(spec, spec["save_dir"], mesh)
    if kind == "stream":
        return {"chunks": stream_chunks(spec, mesh)}
    if kind == "generate":
        return generate_take(spec)
    raise ValueError(f"unknown run kind {kind}")


def main(spec_dir: str, names: list) -> None:
    torch.set_num_threads(1)
    assert dist_lib.maybe_initialize("cpu"), "GDT_COORDINATOR_ADDRESS is not set"
    rank = dist_lib.process_index()
    for name in names:
        spec = torch.load(os.path.join(spec_dir, f"{name}.pt"), weights_only=False)
        mesh = make_mesh(*spec["mesh"]) if "mesh" in spec else None
        out = run(spec, mesh)
        torch.save(out, os.path.join(spec_dir, f"{name}.rank{rank}.pt"))
        print(f"WORKER {name} rank {rank} done", flush=True)
    torch.distributed.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
