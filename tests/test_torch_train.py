"""Port parity of gesture training against the JAX package on the CPU:
diffusion/gaussian.py:training_losses, diffusion/resample.py, the AdamW +
lagged-anneal optimizer of train/loop.py:make_optimizer, and three
training steps of a small MDM against train/loop.py:make_train_step under
injected timesteps and noise.  Then the train CLI: checkpoint, resume, the
generate CLI and the JAX package's loader on the file it writes.

Tolerances (float32): losses rtol 1e-5 / atol 1e-6 and the optimizer
rtol 1e-5 / atol 1e-7 (elementwise, the same operations); the trajectory
rtol 1e-4 on the loss, and on the parameters after three Adam steps of
lr 1e-3 atol 1e-4 (a tenth of a step: Adam turns the rounding noise of a
near-zero gradient into a sizeable step) with a mean deviation below 1e-7;
the JAX forward of the port's checkpoint atol 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gesturediffusion_tpu.diffusion import gaussian as jg
from gesturediffusion_tpu.diffusion.resample import LossSecondMomentState as JaxSecondMoment
from gesturediffusion_tpu.models.mdm import MDM as JaxMDM
from gesturediffusion_tpu.train import loop as jloop
from gesturediffusion_tpu.utils.convert_torch import load_torch_checkpoint
from gesturediffusion_tpu_torch.diffusion import gaussian as pg
from gesturediffusion_tpu_torch.diffusion.resample import (
    LossSecondMomentState,
    UniformSampler,
    create_named_schedule_sampler,
)
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.sample import generate
from gesturediffusion_tpu_torch.train import loop as ploop
from gesturediffusion_tpu_torch.train import train_mdm
from gesturediffusion_tpu_torch.utils.convert import load_checkpoint, state_dict_from_params
from gesturediffusion_tpu_torch.utils.parser import train_args
from tests.torch_port_common import (
    SMALL,
    build_pair,
    threefry_prng,  # noqa: F401 (autouse fixture)
    to_jax,
    to_torch,
)

MEAN_TYPES = ("START_X", "EPSILON", "PREVIOUS_X")


def _loss_inputs(b=3, j=6, t=8, seed=0):
    rs = np.random.RandomState(seed)
    x0 = rs.randn(b, j, 1, t).astype(np.float32)
    noise = rs.randn(b, j, 1, t).astype(np.float32)
    mask = np.zeros((b, 1, 1, t), bool)
    mask[0] = True          # full
    mask[1, ..., :5] = True  # partial
    # row 2 stays all zero: its loss must be 0, not 0/0
    return x0, noise, mask, np.array([0, 4, 9])


def _model_fns(learned: bool):
    def out(x, tt, xp):
        y = x * 0.7 + 0.01 * tt[:, None, None, None]
        return xp.concatenate([y, xp.tanh(x)], axis=1) if learned else y

    def jfn(x, tt, c):
        return out(x, tt.astype(jnp.float32), jnp)

    class TorchNp:
        concatenate = staticmethod(lambda a, axis: torch.cat(a, dim=axis))
        tanh = staticmethod(torch.tanh)

    def pfn(x, tt, c):
        return out(x, tt.float(), TorchNp)

    return jfn, pfn


@pytest.mark.parametrize("mean_type", MEAN_TYPES)
@pytest.mark.parametrize("lambda_vel,learned", [(0.0, False), (0.5, False), (0.0, True)])
def test_training_losses_match_jax(mean_type, lambda_vel, learned):
    var = "LEARNED_RANGE" if learned else "FIXED_SMALL"
    kw = dict(steps=10, noise_schedule="cosine", lambda_vel=lambda_vel)
    dj = jg.create_diffusion(model_mean_type=jg.ModelMeanType[mean_type],
                             model_var_type=jg.ModelVarType[var], **kw)
    dp = pg.create_diffusion(model_mean_type=pg.ModelMeanType[mean_type],
                             model_var_type=pg.ModelVarType[var], **kw)
    x0, noise, mask, t = _loss_inputs()
    jfn, pfn = _model_fns(learned)
    want = dj.training_losses(jfn, jnp.asarray(x0), jnp.asarray(t), {},
                              mask=jnp.asarray(mask), noise=jnp.asarray(noise))
    got = dp.training_losses(pfn, torch.from_numpy(x0), torch.from_numpy(t), {},
                             mask=torch.from_numpy(mask), noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert got["rot_mse"][2].item() == 0.0


def test_geometric_losses_raise_until_the_body_model_is_ported():
    """A geometric lambda needs the body model's forward kinematics: without
    an fk_fn both packages raise the same ValueError; with one the terms
    appear (tests/test_torch_a2m_train.py holds them against JAX)."""
    x0, noise, mask, t = _loss_inputs()
    for lam in ("lambda_rcxyz", "lambda_fc", "lambda_vel_rcxyz"):
        dj = jg.create_diffusion(steps=10, **{lam: 1.0})
        dp = pg.create_diffusion(steps=10, **{lam: 1.0})
        with pytest.raises(ValueError, match="require fk_fn") as want:
            dj.training_losses(lambda x, tt, c: x, jnp.asarray(x0), jnp.asarray(t), {},
                               mask=jnp.asarray(mask), noise=jnp.asarray(noise))
        with pytest.raises(ValueError, match="require fk_fn") as got:
            dp.training_losses(lambda x, tt, c: x, torch.from_numpy(x0), torch.from_numpy(t), {},
                               mask=torch.from_numpy(mask), noise=torch.from_numpy(noise))
        assert str(got.value) == str(want.value)
        terms = dp.training_losses(
            lambda x, tt, c: x * 0.5, torch.from_numpy(x0), torch.from_numpy(t), {},
            mask=torch.from_numpy(mask), noise=torch.from_numpy(noise),
            fk_fn=lambda s: s.repeat(1, 2, 3, 1))  # 12 "joints" of 3
        assert {"lambda_rcxyz": "rcxyz_mse", "lambda_fc": "fc",
                "lambda_vel_rcxyz": "vel_xyz_mse"}[lam] in terms


def test_samplers_match_jax():
    g = torch.Generator().manual_seed(0)
    t, w = UniformSampler(9).sample(5, g)
    assert t.shape == (5,) and int(t.max()) < 9 and torch.equal(w, torch.ones(5))
    assert isinstance(create_named_schedule_sampler("uniform", 9), UniformSampler)

    rs = np.random.RandomState(1)
    j, p = JaxSecondMoment.create(7, history_per_term=4), LossSecondMomentState(7, 4)
    for _ in range(8):  # duplicates in a batch, rings that fill and roll
        ts, ls = rs.randint(0, 7, size=9), rs.rand(9).astype(np.float32)
        j = j.update_with_losses(jnp.asarray(ts), jnp.asarray(ls))
        p.update_with_losses(torch.from_numpy(ts), torch.from_numpy(ls))
        np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
        np.testing.assert_array_equal(p.history.numpy(), np.asarray(j.history))
    assert bool(p.warmed_up())
    np.testing.assert_allclose(p.weights().numpy(), np.asarray(j.weights()), rtol=1e-6)
    t, w = p.sample(64, g)
    np.testing.assert_allclose(w.numpy(), 1.0 / (7 * p.weights()[t].numpy()), rtol=1e-6)


def test_adamw_with_anneal_and_weight_decay_tracks_optax():
    lr, wd, n = 1e-2, 0.5, 20
    tx = jloop.make_optimizer(jloop.TrainConfig(lr=lr, weight_decay=wd, lr_anneal_steps=n))
    rs = np.random.RandomState(2)
    p0 = rs.randn(5, 3).astype(np.float32)
    jp = {"w": jnp.asarray(p0)}
    js = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = ploop.make_optimizer([param], ploop.TrainConfig(
        lr=lr, weight_decay=wd, lr_anneal_steps=n))
    for _ in range(25):
        g = rs.randn(5, 3).astype(np.float32)
        updates, js = tx.update({"w": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, updates)
        param.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp["w"]),
                                   rtol=1e-5, atol=1e-7)


def _trajectory_batches(n, b, t, seed=3):
    rs = np.random.RandomState(seed)
    j, s, a = SMALL["njoints"], SMALL["seed_poses"], SMALL["mfcc_dim"]
    out = []
    for _ in range(n):
        mask = np.ones((b, 1, 1, t), bool)
        mask[-1, ..., t // 2:] = False
        out.append(dict(
            motion=rs.randn(b, j, 1, t).astype(np.float32) * 0.5,
            cond=dict(mfcc=rs.randn(b, a, 1, t).astype(np.float32),
                      seed=rs.randn(b, j, 1, s).astype(np.float32) * 0.5, mask=mask),
            t=rs.randint(0, 8, size=b).astype(np.int32),
            noise=rs.randn(b, j, 1, t).astype(np.float32),
        ))
    return out


@pytest.mark.parametrize("microbatch,fused", [(0, False), (2, False), (0, True)],
                         ids=["whole-batch", "microbatch-2", "fused-train-layer"])
def test_three_steps_match_jax_make_train_step(microbatch, fused):
    """Dropout 0 and cond_mask_prob 0 make the step deterministic; with
    use_fused_train_encoder the JAX side runs the Pallas training kernels
    in interpret mode and the port its plain hash-dropout layer."""
    jax_model, params, port = build_pair(dropout=0.0, cond_mask_prob=0.0,
                                         use_fused_train_encoder=fused)
    lr, wd = 1e-3, 0.1
    dj = jg.create_diffusion(steps=8, noise_schedule="cosine")
    dp = pg.create_diffusion(steps=8, noise_schedule="cosine")

    jcfg = jloop.TrainConfig(lr=lr, weight_decay=wd, microbatch_size=microbatch)
    tx = jloop.make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jloop.TrainState(step=jnp.asarray(0, jnp.int32), params=jparams,
                              opt_state=tx.init(jparams), ema_params={},
                              sampler=jloop.create_named_schedule_sampler("uniform", 8))

    def apply_fn(p, x, t, c, rngs=None):
        return jax_model.apply(p, x, t, c, train=True, rngs=rngs)

    jstep = jloop.make_train_step(dj, apply_fn, tx, jcfg)

    pcfg = ploop.TrainConfig(lr=lr, weight_decay=wd, microbatch_size=microbatch)
    opt, sched = ploop.make_optimizer(port.parameters(), pcfg)
    pstate = ploop.TrainState(port, opt, sched, UniformSampler(8), {})
    gen = torch.Generator().manual_seed(0)

    for batch in _trajectory_batches(3, 4, 16):
        jstate, jm = jstep(jstate, jnp.asarray(batch["motion"]), to_jax(batch["cond"]),
                           jax.random.PRNGKey(0), jnp.asarray(batch["t"]),
                           jnp.asarray(batch["noise"]))
        pm = ploop.train_step(pstate, dp, pcfg, torch.from_numpy(batch["motion"]),
                              to_torch(batch["cond"]), gen, torch.from_numpy(batch["t"]).long(),
                              torch.from_numpy(batch["noise"]))
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-3)
    assert pstate.step == 3 and pstate.nonfinite_skips == 0
    want = state_dict_from_params(jax.tree_util.tree_map(np.asarray, jstate.params),
                                  cl_head=SMALL["cl_head"])
    got = port.state_dict()
    d = SMALL["latent_dim"]
    diffs = []
    for k, v in want.items():
        a, b = got[k].numpy(), v.numpy()
        if k.endswith("in_proj_bias"):
            # the key bias shifts every score of a row equally, so softmax
            # gives it an exactly zero gradient; Adam turns the rounding
            # noise there into +-lr steps that differ between frameworks
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=k)
        diffs.append(np.abs(a - b).ravel())
    assert np.concatenate(diffs).mean() < 1e-7


def test_non_finite_loss_skips_the_update():
    _, _, port = build_pair(dropout=0.0, cond_mask_prob=0.0)
    cfg = ploop.TrainConfig(lr=1e-3)
    opt, sched = ploop.make_optimizer(port.parameters(), cfg)
    state = ploop.TrainState(port, opt, sched, UniformSampler(8), {})
    before = {k: v.clone() for k, v in port.state_dict().items()}
    batch = _trajectory_batches(1, 2, 16)[0]
    motion = torch.from_numpy(batch["motion"])
    motion[0, 0, 0, 0] = float("nan")
    m = ploop.train_step(state, pg.create_diffusion(steps=8), cfg, motion,
                         to_torch(batch["cond"]), torch.Generator().manual_seed(0))
    assert (state.step, state.nonfinite_skips, m["nonfinite_skips"]) == (1, 1, 1)
    assert sched.last_epoch == 0 and not opt.state
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_train_mode_draws_dropout_and_cond_masks_from_the_generator():
    _, _, port = build_pair(dropout=0.3, cond_mask_prob=0.5, use_fused_train_encoder=True)
    b = _trajectory_batches(1, 4, 16)[0]
    x, cond = torch.from_numpy(b["motion"]), to_torch(b["cond"])
    t = torch.from_numpy(b["t"]).long()

    def run(seed):
        return port(x, t, cond, train=True, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert (run(1) - run(2)).abs().max() > 1e-3
    with torch.no_grad():
        assert (run(1) - port(x, t, cond)).abs().max() > 1e-3


# ---- the CLIs ----------------------------------------------------------- #
CLI = ["--device", "cpu", "--dataset", "synthetic", "--layers", "1", "--latent_dim", "64",
       "--num_frames", "20", "--batch_size", "4", "--diffusion_steps", "6",
       "--log_interval", "1", "--use_fused_train_encoder"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    save = tmp_path_factory.mktemp("train") / "run"
    loop = train_mdm.main(CLI + ["--save_dir", str(save), "--num_steps", "3"])
    return save, loop


def test_train_cli_writes_the_checkpoint_and_args(trained):
    save, loop = trained
    assert loop.state.step == 3
    assert {"model000000003.pt", "opt000000003.pt", "args.json"} <= set(os.listdir(save))
    with open(save / "args.json") as f:
        args = json.load(f)
    assert args["use_fused_train_encoder"] and args["latent_dim"] == 64
    sd = load_checkpoint(str(save / "model000000003.pt"))
    assert "seqTransEncoder.layers.0.self_attn.in_proj_weight" in sd


def test_train_cli_resumes_at_the_latest_step(trained):
    save, _ = trained
    loop = train_mdm.main(CLI + ["--save_dir", str(save), "--num_steps", "5",
                                 "--resume_checkpoint", "latest", "--overwrite"])
    assert (loop.resume_step, loop.state.step) == (3, 5)
    assert os.path.exists(save / "model000000005.pt")
    assert ploop.find_latest_checkpoint(str(save)).endswith("model000000005.pt")


def test_generate_cli_samples_from_the_trained_checkpoint(trained, tmp_path):
    save, _ = trained
    out = generate.main(["--model_path", str(save / "model000000003.pt"), "--dataset",
                         "synthetic", "--num_samples", "2", "--device", "cpu",
                         "--output_dir", str(tmp_path / "out")])
    res = np.load(os.path.join(out, "results.npy"), allow_pickle=True).item()
    assert res["motion"].shape == (2, 83, 3, 20) and np.isfinite(res["motion"]).all()


def test_jax_package_loads_the_port_checkpoint(trained):
    save, _ = trained
    path = str(save / "model000000003.pt")
    jm = JaxMDM(njoints=498, latent_dim=64, num_layers=1, ff_size=1024, num_heads=4,
                seed_poses=10, cond_mask_prob=0.1)
    variables = load_torch_checkpoint(path, jm)
    port = MDM(njoints=498, latent_dim=64, num_layers=1, seed_poses=10, cond_mask_prob=0.1)
    port.load_state_dict(load_checkpoint(path))
    rs = np.random.RandomState(4)
    x = rs.randn(2, 498, 1, 20).astype(np.float32)
    t = np.array([1, 4], np.int32)
    cond = {"mfcc": rs.randn(2, 26, 1, 20).astype(np.float32),
            "seed": rs.randn(2, 498, 1, 10).astype(np.float32)}
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flag", [["--mesh_model_axis", "0"],
                                  ["--mfcc_input", "--use_wav_enc", "--dataset", "genea2023"]])
def test_flags_the_port_cannot_honour_raise(flag, tmp_path):
    """A model axis under 1 is refused (tensor parallelism takes 2 and up,
    tests/test_torch_multiprocess.py), and a gesture model's two audio
    inputs at once are refused with JAX's ValueError
    (model_factory.py:72-79), each before anything is written;
    --eval_during_training runs on every dataset
    (tests/test_torch_eval_train_hook.py), and a text dataset takes
    --use_wav_enc as JAX does, unread."""
    if "--mesh_model_axis" in flag:
        error, match = SystemExit, None
        assert train_args(["--save_dir", str(tmp_path / "x"), "--mesh_model_axis",
                           "2"]).mesh_model_axis == 2
    else:
        error, match = ValueError, "mutually exclusive"
    with pytest.raises(error, match=match):
        train_args(["--save_dir", str(tmp_path / "x"), *flag])
    assert not os.path.exists(tmp_path / "x")
    for dataset in ("genea2023", "humanml"):
        assert train_args(["--save_dir", str(tmp_path / "x"), "--eval_during_training",
                           "--dataset", dataset]).eval_during_training
    assert train_args(["--save_dir", str(tmp_path / "x"), "--use_wav_enc", "--dataset",
                       "humanml"]).use_wav_enc


@pytest.mark.parametrize("flag", [["--use_bf16"], ["--remat"], ["--device_batch_pool", "2"]])
def test_a4_flags_parse_and_train(flag, tmp_path, monkeypatch):
    """The train CLI's last single-card flags run: --use_bf16 rounds the
    model input to bfloat16 (every product f32), --remat recomputes the
    plain layers in the backward pass, --device_batch_pool stages 2
    batches and cycles them for 3 steps."""
    seen = []
    step = ploop.train_step

    def recording(state, diffusion, config, motion, cond, *args, **kwargs):
        seen.append((config.use_bf16, motion.clone()))
        return step(state, diffusion, config, motion, cond, *args, **kwargs)

    monkeypatch.setattr(ploop, "train_step", recording)
    loop = train_mdm.main(["--device", "cpu", "--dataset", "synthetic", "--layers", "1",
                           "--latent_dim", "32", "--num_frames", "20", "--batch_size", "4",
                           "--num_steps", "3", "--save_dir", str(tmp_path / "run"), *flag])
    assert loop.state.step == 3 and len(seen) == 3
    assert {bf16 for bf16, _ in seen} == {flag[0] == "--use_bf16"}
    assert loop.state.model.seqTransEncoder.remat == (flag[0] == "--remat")
    same = torch.equal(seen[2][1], seen[0][1])
    assert same == (flag[0] == "--device_batch_pool")  # the pool of 2 came round again
    with open(tmp_path / "run" / "args.json") as f:
        assert json.load(f)[flag[0][2:]] == ({"--device_batch_pool": 2}.get(flag[0], True))


@pytest.mark.parametrize("flag", [["--use_fused_encoder"], ["--eval_mode", "debug"],
                                  ["--no_fast_sampler"], ["--prng", "rbg"],
                                  ["--use_audio"], ["--emb_trans_dec", "true"],
                                  ["--guidance_param", "2.5"]])
def test_flags_no_code_reads_are_refused(flag, tmp_path):
    """JAX train flags the port does not read, and the sampling and eval
    CLIs' flags (the train CLI's --eval_* settings, --eval_split among
    them, are read by the eval hooks, tests/test_torch_eval_train_hook.py)."""
    with pytest.raises(SystemExit):
        train_args(["--save_dir", str(tmp_path / "x"), *flag])


def test_train_cli_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mdm.main(["--save_dir", str(tmp_path / "x"), "--dataset", "synthetic"])
