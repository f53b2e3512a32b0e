"""The port's multi-rank runs on the CPU: gloo ranks spawned as processes
(tests/torch_mp_worker.py, GDT_COORDINATOR_ADDRESS on a free localhost
port, torch on one thread a rank) held against the port's single-process
runs on the global batch, and a 2-rank step against JAX's step.

Three spawns serve every test of the file: a world of 2 ranks, which runs
the data-parallel grid (2 x 1) and the tensor-parallel one (1 x 2), a
world of 4 (2 x 2), and a world of 2 launched with torchrun's variables
(WORLD_SIZE, RANK, LOCAL_RANK) in place of the GDT_* pair, held bit for
bit against the GDT_* launch.  The spawned runs:

  * data-parallel steps with dropout 0.1 and cond_mask_prob 0.1 through
    the fused training layer's plain twin (rank 1 at a nonzero row offset);
    with microbatches (the plain layers under remat); with the
    loss-second-moment sampler past its warm-up; the wav-encoder MDM, whose
    BatchNorms reduce over the ranks;
  * tensor-parallel steps at 1 x 2 and 2 x 2 (a D 256 model, so that the
    shape rule shards weights) through the fused training layer and on the
    plain path (the column-parallel products; at 2 x 2 also with
    microbatches under remat and the wav-encoder MDM; at 1 x 2 the a2m
    MotionMDM with its geometric losses), each sharded weight, its
    gradient, its AdamW moments and its EMA at 1/tp of their size on
    every rank; the plain 2 x 2 runs are held against the same rows'
    2 x 1 runs, which the world of 2 runs too
    (test_plain_path_runs_its_products_on_the_blocks says why);
  * TrainLoop runs saved by rank 0 at step 2 and resumed on 2 ranks (data-
    parallel, and tensor-parallel through the fused layer and plain);
  * the train CLI over 2 ranks (2 x 1, and 1 x 2 under --mesh_model_axis
    2), and the generate CLI's take over 2 ranks; a 4-stream session on
    mesh=;
  * one 2-rank step from JAX weights at injected timesteps and noise,
    dropout and cond_mask_prob 0, against JAX's make_train_step.

Tolerances: the losses and gradient norms of every step rtol 1e-5, and
every parameter's gradient at every step within 1e-5 of its max |value|
(sums in another order: the gradient's halves summed over ranks); the
weights and the EMA after the steps rtol 1e-5 with atol 1e-5, a hundredth
of an Adam step of lr 1e-3 (Adam divides each gradient by its own size, so
a gradient near zero carries its summation-order noise into the step),
except where a gradient is zero in exact arithmetic (the key projection's
bias: softmax gives it none), whose rounding noise Adam turns into steps
of +-lr that differ between any two summation orders; BatchNorm
statistics and the optimizer state rtol 1e-5 / atol 1e-7; generate and
streaming rtol 1e-4, atol 1e-4 (JAX's sharded-sampling tolerance,
tests/test_distributed.py:153); against JAX the loss and gradient norm
rtol 1e-5 and the weights as tests/test_torch_train.py holds three steps
(atol 1e-4, mean below 1e-7).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion import gaussian as jg
from gesturediffusion_tpu.train import loop as jloop
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.sample import generate
from gesturediffusion_tpu_torch.utils.convert import state_dict_from_params
from tests import torch_mp_worker as worker
from tests.torch_port_common import (
    SMALL,
    build_pair,
    threefry_prng,  # noqa: F401 (autouse fixture)
    to_jax,
    torch_threads,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
T = 16
WIDE = dict(SMALL, latent_dim=256, num_layers=1, ff_size=256)  # the shape rule shards it
LR = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(spec_dir: str, names: list, world: int, timeout: float = 400,
          torchrun: bool = False) -> list:
    """Run the named specs on ``world`` gloo ranks; each rank's stdout.
    The ranks learn the world from GDT_NUM_PROCESSES and GDT_PROCESS_ID,
    or with ``torchrun`` from the variables torchrun sets (WORLD_SIZE,
    RANK, LOCAL_RANK) alone."""
    env = dict(os.environ, GDT_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for var in ("GDT_DIST_BACKEND", "GDT_NUM_PROCESSES", "GDT_PROCESS_ID", "WORLD_SIZE",
                "RANK", "LOCAL_RANK"):
        env.pop(var, None)

    def rank_env(r):
        if torchrun:
            return dict(env, WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r))
        return dict(env, GDT_NUM_PROCESSES=str(world), GDT_PROCESS_ID=str(r))

    procs = [subprocess.Popen([sys.executable, WORKER, spec_dir, *names],
                              env=rank_env(r), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in out, out[-4000:]
    return outs


def _model_state(kw: dict, seed: int = 0) -> dict:
    torch.manual_seed(seed)
    return MDM(**kw).state_dict()


def _batches(n: int, b: int, kw: dict, seed: int = 3, inject: bool = False,
             audio: bool = False) -> list:
    rs = np.random.RandomState(seed)
    j, s, a = kw["njoints"], kw["seed_poses"], kw["mfcc_dim"]
    out = []
    for _ in range(n):
        mask = np.ones((b, 1, 1, T), bool)
        mask[-1, ..., T // 2:] = False
        cond = {"seed": rs.randn(b, j, 1, s) * 0.5, "mask": mask}
        if audio:
            cond["audio"] = rs.randn(b, T * 735) * 0.1
        else:
            cond["mfcc"] = rs.randn(b, a, 1, T)
        batch = {"motion": torch.from_numpy((rs.randn(b, j, 1, T) * 0.5).astype(np.float32)),
                 "cond": {k: torch.from_numpy(v if v.dtype == bool else v.astype(np.float32))
                          for k, v in cond.items()}}
        if inject:
            batch["t"] = torch.from_numpy(rs.randint(0, 8, size=b)).long()
            batch["noise"] = torch.from_numpy(rs.randn(b, j, 1, T).astype(np.float32))
        out.append(batch)
    return out


def _steps_spec(mesh, kw, n=2, b=4, config=None, diffusion_steps=8, **batch_kw) -> dict:
    return {"kind": "steps", "mesh": mesh, "model": kw, "state": _model_state(kw),
            "config": {"lr": LR, "weight_decay": 0.1, **(config or {})},
            "diffusion_steps": diffusion_steps, "seed": 5,
            "batches": _batches(n, b, kw, **batch_kw)}


FUSED = dict(SMALL, dropout=0.1, use_fused_train_encoder=True)
WAV = dict(SMALL, dropout=0.1, use_fused_train_encoder=True, use_wav_enc=True,
           mfcc_input=False)
TP = dict(WIDE, dropout=0.1, use_fused_train_encoder=True)
TP_PLAIN = dict(WIDE, dropout=0.1)  # the default path: plain layers, products on the blocks
TP_CONFIG = {"ema_rate": 0.9}
# the action-mode MotionMDM at D 256 with HumanAct12's 12 actions (its action table
# stays whole), the recipe's geometric losses through a synthetic SMPL
A2M = dict(njoints=25, nfeats=6, latent_dim=256, num_layers=1, ff_size=256, num_heads=4,
           cond_mode="action", num_actions=12, cond_mask_prob=0.1, dropout=0.1)
A2M_LAMBDAS = dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0)


def _a2m_spec(mesh) -> dict:
    """Steps of the a2m MotionMDM with its geometric losses (fk_fn)."""
    rs = np.random.RandomState(3)
    torch.manual_seed(0)
    state = MotionMDM(**A2M).state_dict()
    batches = []
    for _ in range(2):
        mask = np.ones((4, 1, 1, T), bool)
        mask[-1, ..., T // 2:] = False
        motion = rs.randn(4, 25, 6, T).astype(np.float32) * 0.3
        motion[:, 24, 3:] = 0.0  # the translation row holds xyz
        batches.append({"motion": torch.from_numpy(motion),
                        "cond": {"action": torch.from_numpy(rs.randint(0, 12, size=4)),
                                 "mask": torch.from_numpy(mask)}})
    return {"kind": "steps", "mesh": mesh, "model": A2M, "motion_mdm": True, "state": state,
            "config": {"lr": LR, "weight_decay": 0.1, **TP_CONFIG}, "diffusion_steps": 8,
            "seed": 5, "lambdas": A2M_LAMBDAS, "smpl_vertices": 128, "batches": batches}


# the plain path's tensor-parallel runs: name -> (world, spec maker)
PLAIN_TP = {
    "dp1xtp2": (2, lambda: _steps_spec((1, 2), TP_PLAIN, config=TP_CONFIG)),
    "dp1xtp2_a2m": (2, lambda: _a2m_spec((1, 2))),
    "dp2xtp2": (4, lambda: _steps_spec((2, 2), TP_PLAIN, config=TP_CONFIG)),
    # the wav encoder's BatchNorms reduce over the data group, not the model group;
    # microbatches of the global batch, each through the plain layers under remat
    "dp2xtp2_wav_microbatch": (4, lambda: _steps_spec(
        (2, 2), dict(TP_PLAIN, use_wav_enc=True, mfcc_input=False, remat=True), b=8,
        config={**TP_CONFIG, "microbatch_size": 4}, audio=True)),
}
# the 4-rank runs: the fused layer's 2 x 2 (tp_dp) and the plain path's
WORLD4 = {"tp_dp": lambda: _steps_spec((2, 2), TP, config=TP_CONFIG),
          **{name: make for name, (world, make) in PLAIN_TP.items() if world == 4}}


def _specs(tmp: str) -> dict:
    """name -> spec of the 2-rank world's runs."""
    specs = {
        "dp_fused": _steps_spec((2, 1), FUSED),
        "dp_microbatch": _steps_spec((2, 1), dict(SMALL, dropout=0.1, remat=True), b=8,
                                     config={"microbatch_size": 4}),
        "dp_lsm": _steps_spec((2, 1), FUSED, n=7, b=8, diffusion_steps=4,
                              config={"schedule_sampler": "loss-second-moment"}),
        "dp_wav": _steps_spec((2, 1), WAV, audio=True),
        "tp2": _steps_spec((1, 2), TP, config=TP_CONFIG),
    }
    for name, mesh, kw in (("resume_dp", (2, 1), FUSED), ("resume_tp", (1, 2), TP),
                           ("resume_tp_plain", (1, 2), TP_PLAIN)):
        specs[name] = {**_steps_spec(mesh, kw, n=3, config=TP_CONFIG), "kind": "resume",
                       "resume_at": 2, "save_dir": os.path.join(tmp, name)}
    for name, (world, make) in PLAIN_TP.items():
        if world == 2:
            specs[name] = make()
        else:  # the 2 x 2 run's rows over 2 data ranks, without tensor parallelism
            specs[f"{name}_dp"] = {**make(), "mesh": (2, 1)}
    return specs


def _jax_spec():
    """A 2-rank step from JAX weights (dropout and cond_mask_prob 0,
    injected timesteps and noise), and JAX's step on the global batch:
    (spec, JAX's metrics, JAX's weights in the port's layout)."""
    jax_model, params, port = build_pair(dropout=0.0, cond_mask_prob=0.0)
    kw = dict(SMALL, dropout=0.0, cond_mask_prob=0.0)
    spec = {"kind": "steps", "mesh": (2, 1), "model": kw, "state": port.state_dict(),
            "config": {"lr": LR, "weight_decay": 0.1}, "diffusion_steps": 8, "seed": 0,
            "batches": _batches(1, 4, kw, inject=True)}
    jcfg = jloop.TrainConfig(lr=LR, weight_decay=0.1)
    tx = jloop.make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jloop.TrainState(step=jnp.asarray(0, jnp.int32), params=jparams,
                              opt_state=tx.init(jparams), ema_params={},
                              sampler=jloop.create_named_schedule_sampler("uniform", 8))

    def apply_fn(p, x, t, c, rngs=None):
        return jax_model.apply(p, x, t, c, train=True, rngs=rngs)

    step = jloop.make_train_step(jg.create_diffusion(steps=8, noise_schedule="cosine"),
                                 apply_fn, tx, jcfg)
    batch = spec["batches"][0]
    cond = {k: v.numpy() for k, v in batch["cond"].items()}
    jstate, jm = step(jstate, jnp.asarray(batch["motion"].numpy()), to_jax(cond),
                      jax.random.PRNGKey(0), jnp.asarray(batch["t"].numpy().astype(np.int32)),
                      jnp.asarray(batch["noise"].numpy()))
    want = state_dict_from_params(jax.tree_util.tree_map(np.asarray, jstate.params),
                                  cl_head=SMALL["cl_head"])
    return spec, {k: float(v) for k, v in jm.items()}, want


def _generate_spec(tmp: str) -> dict:
    torch.manual_seed(0)
    model = MDM(njoints=498, latent_dim=64, num_layers=1, cond_mask_prob=0.1)
    path = os.path.join(tmp, "gen_run", "model000000000.pt")
    os.makedirs(os.path.dirname(path))
    torch.save(model.state_dict(), path)
    with open(os.path.join(os.path.dirname(path), "args.json"), "w") as f:
        json.dump({"dataset": "synthetic", "num_frames": 20, "layers": 1, "latent_dim": 64,
                   "cond_mask_prob": 0.1, "seed_poses": 10, "noise_schedule": "cosine",
                   "diffusion_steps": 6, "sigma_small": True}, f)
    argv = ["--model_path", path, "--num_samples", "4", "--device", "cpu", "--seed", "3"]
    return {"kind": "generate", "argv": [argv + ["--output_dir", os.path.join(tmp, f"gen{r}")]
                                         for r in range(2)],
            "single": argv + ["--output_dir", os.path.join(tmp, "gen_single")]}


CLI_ARGS = ["--dataset", "synthetic", "--device", "cpu", "--num_frames", "20", "--batch_size",
            "4", "--num_steps", "3", "--use_fused_train_encoder", "--overwrite"]
CLI_MODELS = {"cli_dp": ["--layers", "1", "--latent_dim", "64"],
              "cli_tp": ["--layers", "1", "--latent_dim", "256", "--mesh_model_axis", "2"]}


def _cli_spec(tmp: str, name: str) -> dict:
    return {"kind": "train_cli",
            "argv": CLI_ARGS + CLI_MODELS[name] + ["--save_dir", os.path.join(tmp, name)]}


def _stream_spec() -> dict:
    kw = dict(SMALL)
    rs = np.random.RandomState(4)
    streams = 4
    return {"kind": "stream", "mesh": (2, 1), "model": kw, "state": _model_state(kw, 1),
            "session": dict(guidance_param=2.5, streams=streams, chunk_frames=T,
                            seed_poses=kw["seed_poses"], diffusion_steps=20, sample_steps=4,
                            sampler="ddim"),
            "seed0": rs.randn(streams, kw["njoints"], 1, kw["seed_poses"]).astype(np.float32),
            "mfcc": [rs.randn(streams, kw["mfcc_dim"], 1, T).astype(np.float32)
                     for _ in range(2)],
            "seed": 7}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every 2-rank run: {name: (spec, [rank outputs])}."""
    tmp = str(tmp_path_factory.mktemp("mp2"))
    specs = _specs(tmp)
    specs["jax"], jax_metrics, jax_weights = _jax_spec()
    specs["generate"] = _generate_spec(tmp)
    for name in CLI_MODELS:
        specs[name] = _cli_spec(tmp, name)
    specs["stream"] = _stream_spec()
    for name, spec in specs.items():
        torch.save(spec, os.path.join(tmp, f"{name}.pt"))
    spawn(tmp, list(specs), 2)
    outs = {name: (spec, [torch.load(os.path.join(tmp, f"{name}.rank{r}.pt"),
                                     weights_only=False) for r in range(2)])
            for name, spec in specs.items()}
    outs["jax_reference"] = (jax_metrics, jax_weights)
    outs["tmp"] = tmp
    return outs


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Every 4-rank run: {name: (spec, [rank outputs])}; ``tp_dp`` through
    the fused training layer, the others the plain path's (PLAIN_TP)."""
    tmp = str(tmp_path_factory.mktemp("mp4"))
    specs = {name: make() for name, make in WORLD4.items()}
    for name, spec in specs.items():
        torch.save(spec, os.path.join(tmp, f"{name}.pt"))
    spawn(tmp, list(specs), 4)
    return {name: (spec, [torch.load(os.path.join(tmp, f"{name}.rank{r}.pt"),
                                     weights_only=False) for r in range(4)])
            for name, spec in specs.items()}


@pytest.fixture(scope="module")
def torchrun2(tmp_path_factory):
    """The 1 x 2 plain-path run on 2 ranks launched with torchrun's
    variables (WORLD_SIZE, RANK, LOCAL_RANK) and no GDT_* world pair."""
    tmp = str(tmp_path_factory.mktemp("mp2_torchrun"))
    spec = PLAIN_TP["dp1xtp2"][1]()
    torch.save(spec, os.path.join(tmp, "dp1xtp2.pt"))
    spawn(tmp, ["dp1xtp2"], 2, torchrun=True)
    return spec, [torch.load(os.path.join(tmp, f"dp1xtp2.rank{r}.pt"), weights_only=False)
                  for r in range(2)]


def _zero_grad_rows(name: str, d: int):
    """The rows of a weight whose gradient is zero in exact arithmetic."""
    return slice(d, 2 * d) if name.endswith("in_proj_bias") else None


def assert_weights_close(got: dict, want: dict, d: int, rtol=1e-5, atol=1e-5):
    for k, w in want.items():
        g = got[k]
        if not torch.is_floating_point(w):
            assert torch.equal(g, w), k
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=1e-7, err_msg=k)
            continue
        rows = _zero_grad_rows(k, d)
        if rows is not None:
            keep = torch.ones(w.shape[0], dtype=torch.bool)
            keep[rows] = False
            g, w = g[keep], w[keep]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=k)


def assert_steps_equal(spec: dict, outs: list, want: dict):
    d = spec["model"]["latent_dim"]
    for out in outs:
        np.testing.assert_allclose(out["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norms"], want["grad_norms"], rtol=1e-5)
        for step, (got_g, want_g) in enumerate(zip(out["grads"], want["grads"])):
            for k, w in want_g.items():
                gap = (got_g[k] - w).abs().max().item()
                assert gap <= 1e-5 * w.abs().max().item(), (step, k, gap)
        assert_weights_close(out["params"], want["params"], d)
        assert_weights_close(out["ema"], want["ema"], d)
        for i, st in want["opt"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(out["opt"][i][key].numpy(), st[key].numpy(),
                                           rtol=1e-5, atol=1e-7)
        for key, v in want["sampler"].items():
            np.testing.assert_allclose(out["sampler"][key].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-7)
        assert torch.equal(out["generator"], want["generator"])


def _single(spec: dict) -> dict:
    with torch_threads(1):
        return worker.train_steps(spec)


@pytest.mark.parametrize("name", ["dp_fused", "dp_microbatch", "dp_lsm"])
def test_data_parallel_steps_equal_the_single_process_steps(world2, name):
    """Dropout and conditioning masks drawn for the global batch (the fused
    layer's hash dropout of rank 1 from its row offset), microbatches of
    the global batch under remat, and the loss-second-moment sampler fed
    the global (t, loss) past its warm-up: the 2-rank steps equal the
    single-process steps on the global batch."""
    spec, outs = world2[name]
    want = _single(spec)
    assert_steps_equal(spec, outs, want)
    if name == "dp_lsm":
        hist = want["sampler"]["counts"]
        assert bool((hist == 10).all())  # warmed up: the last steps sampled by importance


def test_wav_encoder_batchnorm_reduces_over_the_ranks(world2):
    """The wav encoder's BatchNorms normalise with, and move their running
    statistics towards, the global batch's statistics."""
    spec, outs = world2["dp_wav"]
    want = _single(spec)
    assert_steps_equal(spec, outs, want)
    stats = [k for k in want["params"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 6
    for k in stats:
        assert not torch.equal(want["params"][k], spec["state"][k]), k  # they moved


def assert_blocks_held(spec: dict, outs: list, at_least: int = 5):
    """Each weight the shape rule picks is held by every rank as its 1/tp
    row block: the weight in the model, its gradient, its two AdamW
    moments and its EMA; every other parameter whole."""
    tp = spec["mesh"][1]
    params = dict(worker.build_model(spec).named_parameters())
    sharded = {n for n, p in params.items()
               if p.ndim == 2 and p.numel() >= 1 << 16 and p.shape[0] % tp == 0}
    assert len(sharded) >= at_least
    for out in outs:
        assert set(out["shards"]) == sharded
        for n, shapes in out["shards"].items():
            block = (params[n].shape[0] // tp, params[n].shape[1])
            assert shapes == (block,) * 5, n


def _tp_run(world2, world4, name: str):
    """A tensor-parallel run: world2's ``name`` (1 x 2), else world4's (2 x 2)."""
    return world2[name] if name in world2 else world4[name]


@pytest.mark.parametrize("grid", ["dp1xtp2", "dp2xtp2"])
def test_tensor_parallel_steps_equal_the_single_process_steps(world2, world4, grid):
    """Through the fused training layer (which gathers its layer's weights
    for each call; the model's other picked weights run the column-parallel
    product): each weight the shape rule picks trains as its 1/tp row
    block, with its gradient, 1/tp moments and its EMA, on every rank; the
    steps, the EMA and the whole moments equal the single-process steps."""
    spec, outs = _tp_run(world2, world4, "tp2" if grid == "dp1xtp2" else "tp_dp")
    assert_steps_equal(spec, outs, _single(spec))
    assert_blocks_held(spec, outs)


@pytest.mark.parametrize("name", list(PLAIN_TP))
def test_plain_path_runs_its_products_on_the_blocks(world2, world4, name):
    """The default training path (plain layers, no fused layer) under
    tensor parallelism: every product on a picked weight is the column-
    parallel product on its block, so a rank's model, gradients, moments
    and EMA hold blocks.  At 1 x 2 (and the a2m model's geometric losses
    through SMPL) the steps equal the single-process steps.  At 2 x 2 (the
    data group's all-reduce of block gradients; with microbatches under
    remat and the wav encoder's BatchNorms, whose statistics are over the
    data group) they equal the same rows' steps over 2 data ranks without
    tensor parallelism (2 x 1): on this path the 2 x 1 steps themselves
    stand one weight element 1.96e-05 from one process's, against
    assert_weights_close's atol 1e-5, because that element's first
    gradient (1.5e-08) lies within Adam's eps of 1e-8, where the halves'
    summation order moves the step."""
    spec, outs = _tp_run(world2, world4, name)
    want = _single(spec) if spec["mesh"][0] == 1 else world2[f"{name}_dp"][1][0]
    assert_steps_equal(spec, outs, want)
    assert_blocks_held(spec, outs, at_least=6)


def test_torchrun_launch_equals_the_gdt_launch(world2, torchrun2):
    """Two ranks that learn the world from WORLD_SIZE, RANK and LOCAL_RANK
    alone run the 1 x 2 plain-path steps exactly as the GDT_* launch."""
    _, got = torchrun2
    _, want = world2["dp1xtp2"]
    for g, w in zip(got, want):
        assert g["losses"] == w["losses"] and g["grad_norms"] == w["grad_norms"]
        for k, v in w["params"].items():
            assert torch.equal(g["params"][k], v), k
        assert g["shards"] == w["shards"]


@pytest.mark.parametrize("name", ["resume_dp", "resume_tp", "resume_tp_plain"])
def test_resume_on_two_ranks_equals_the_uninterrupted_run(world2, name, tmp_path):
    """Rank 0 writes the step-2 checkpoint (the sharded weights, moments
    and EMA gathered whole), a fresh loop on 2 ranks reads it (each rank
    cutting its blocks), and its step equals step 3 of an uninterrupted
    single-process loop."""
    spec, outs = world2[name]
    save_dir = spec["save_dir"]
    assert sorted(f for f in os.listdir(save_dir) if f.endswith(".pt")) == [
        "model000000002.pt", "model000000003.pt", "opt000000002.pt", "opt000000003.pt"]
    with torch_threads(1):
        want = worker.train_resumed({**spec, "resume_at": None}, str(tmp_path))
    for out in outs:
        assert out["step"] == want["step"] == 3
        assert_weights_close(out["params"], want["params"], spec["model"]["latent_dim"])


def test_two_rank_step_matches_jax_make_train_step(world2):
    """One step of 2 ranks from JAX weights at injected timesteps and noise
    against JAX's jitted step on the global batch."""
    _, outs = world2["jax"]
    jm, want = world2["jax_reference"]
    d = SMALL["latent_dim"]
    for out in outs:
        np.testing.assert_allclose(out["losses"][0], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norms"][0], jm["grad_norm"], rtol=1e-5)
        diffs = []
        for k, v in want.items():
            a, b = out["params"][k].numpy(), v.numpy()
            if k.endswith("in_proj_bias"):
                a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=k)
            diffs.append(np.abs(a - b).ravel())
        assert np.concatenate(diffs).mean() < 1e-7


@pytest.mark.parametrize("name", list(CLI_MODELS))
def test_train_cli_over_two_ranks_equals_the_single_process_cli(world2, name, tmp_path):
    """The train CLI on 2 ranks (each loading its slice of every global
    batch; under --mesh_model_axis 2 each large weight as its half) writes,
    on rank 0, the checkpoint of the single-process CLI's run (one process
    has no model axis)."""
    spec, outs = world2[name]
    assert [out["step"] for out in outs] == [3, 3]
    save_dir = spec["argv"][-1]
    want_dir = str(tmp_path / "single")
    with torch_threads(1):
        worker.train_cli(CLI_ARGS + CLI_MODELS[name][:4] + ["--save_dir", want_dir])
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(save_dir)) == names
    assert {"model000000003.pt", "opt000000003.pt", "args.json"} <= set(names)
    for ckpt in ("model000000003.pt", "opt000000003.pt"):
        got, want = (torch.load(os.path.join(d, ckpt), weights_only=False)
                     for d in (save_dir, want_dir))
        if ckpt.startswith("model"):
            assert_weights_close(got, want, int(CLI_MODELS[name][3]))
        else:
            for i, st in want["optimizer"]["state"].items():
                np.testing.assert_allclose(got["optimizer"]["state"][i]["exp_avg"].numpy(),
                                           st["exp_avg"].numpy(), rtol=1e-5, atol=1e-7)
            assert torch.equal(got["generator"], want["generator"])


def test_generate_over_two_ranks_equals_the_single_process_take(world2):
    """The generate CLI's takes split over 2 ranks (the global noise drawn
    on each) equal the single-process CLI's; rank 0 writes the files and
    rank 1 none."""
    spec, outs = world2["generate"]
    tmp = world2["tmp"]
    assert not os.path.exists(os.path.join(tmp, "gen1"))
    with torch_threads(1):
        single = generate.main(spec["single"])
    got = np.load(os.path.join(outs[0]["out"], "results.npy"), allow_pickle=True).item()
    want = np.load(os.path.join(single, "results.npy"), allow_pickle=True).item()
    assert got["motion"].shape == want["motion"].shape == (4, 83, 3, 20)
    np.testing.assert_allclose(got["motion"], want["motion"], rtol=1e-4, atol=1e-4)
    assert sorted(os.listdir(outs[0]["out"])) == sorted(os.listdir(single))


def test_mesh_streaming_session_equals_the_single_process_session(world2):
    """4 streams split over 2 data ranks: every rank returns the whole
    chunk, equal to the single-process session's."""
    spec, outs = world2["stream"]
    with torch_threads(1):
        want = worker.stream_chunks(spec)
    for out in outs:
        assert len(out["chunks"]) == len(want) == 2
        for got, w in zip(out["chunks"], want):
            assert got.shape == (4, SMALL["njoints"], 1, T)
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-4, atol=1e-4)

