"""Port parity of action-to-motion training against the JAX package on the
CPU: the geometric terms of training_losses (rcxyz_mse, vel_xyz_mse, the
foot contact fc, with vel_mse) through each package's rotation2xyz on one
synthetic SMPL model; three steps of a small action-mode MotionMDM (latent
64, 2 layers of heads of 16, ff 128; 25 rows of rot6d) against
train/loop.py:make_train_step with fk_fn, plain, through the fused
training layer and under use_bf16; the action embedding's kernel + bias
layout and its export fold; --remat's gradients and generator; and the
train CLI on synthetic HumanAct12 and UESTC trees with the recipe's
lambdas, its checkpoint read by JAX's load_torch_checkpoint.

Tolerances: training_losses rtol 1e-5 / atol 1e-6 (the losses and the
gradient of their sum; float32, the same operations but the rest joints
regressed in another order); the steps those of
test_torch_t2m_train.py::test_three_steps_match_jax_make_train_step (loss
rtol 1e-4, gradient norm rtol 1e-3, parameters atol 1e-4 with a mean
deviation below 1e-7); the JAX forward of the port's checkpoint atol 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion import gaussian as jg
from gesturediffusion_tpu.models import rotation2xyz as jr2x
from gesturediffusion_tpu.models import smpl as js
from gesturediffusion_tpu.models.mdm_t2m import MotionMDM as JaxMotionMDM
from gesturediffusion_tpu.ops import rotations as jrot
from gesturediffusion_tpu.train import loop as jloop
from gesturediffusion_tpu.utils.convert_torch import (
    export_motion_mdm_state_dict,
    load_torch_checkpoint,
)
from gesturediffusion_tpu_torch.data.a2m import make_synthetic_humanact12
from gesturediffusion_tpu_torch.data.uestc import make_synthetic_uestc
from gesturediffusion_tpu_torch.diffusion import gaussian as pg
from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
from gesturediffusion_tpu_torch.models import rotation2xyz as pr2x
from gesturediffusion_tpu_torch.models import smpl as ps
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.train import loop as ploop
from gesturediffusion_tpu_torch.train import train_mdm
from gesturediffusion_tpu_torch.utils.convert import (
    load_checkpoint,
    motion_mdm_state_dict_from_params,
)
from tests.torch_port_common import (
    SMALL_T2M,
    load_motion_mdm_params,
    threefry,
    threefry_prng,  # noqa: F401 (autouse fixture)
    to_jax,
    to_torch,
)

RTOL, ATOL = 1e-5, 1e-6
NJ, NF, T = 25, 6, 20
NV = 128
LAMBDAS = dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0, lambda_vel_rcxyz=1.0)


@pytest.fixture(scope="module")
def smpl_pair():
    return js.make_synthetic_smpl(NV), ps.make_synthetic_smpl(NV)


def _fks(smpl_pair):
    jm, pm = smpl_pair
    kw = dict(pose_rep="rot6d", translation=True, glob=True, jointstype="smpl",
              vertstrans=False)
    return (lambda s: jr2x.rotation2xyz(jm, s, **kw)), (lambda s: pr2x.rotation2xyz(pm, s, **kw))


def _motion(b, t=T, seed=0):
    """Rot6d rows of valid rotations plus the translation row [B, 25, 6, T];
    the first frames repeat, so that the ground-truth feet stand still
    there (the contact mask holds) and move after."""
    rs = np.random.RandomState(seed)
    d6 = rs.randn(b, 24, t, 6).astype(np.float32) * 0.3
    d6[:, :, :4] = d6[:, :, :1]
    m = np.asarray(jrot.rotation_6d_to_matrix(jnp.asarray(d6)))
    rot = np.asarray(jrot.matrix_to_rotation_6d(jnp.asarray(m)))
    trans = np.zeros((b, 1, t, 6), np.float32)
    trans[..., :3] = np.cumsum(rs.randn(b, 1, t, 3) * 0.01, axis=2)
    return np.ascontiguousarray(np.concatenate([rot, trans], 1).transpose(0, 1, 3, 2))


def _mask(b, t=T):
    mask = np.ones((b, 1, 1, t), bool)
    mask[-1, ..., t // 2:] = False  # a shorter clip
    return mask


def test_geometric_losses_match_jax(smpl_pair):
    """Each term and d(sum of terms)/d(the model's two parameters) for a
    model_fn x * a + c, with every lambda at 1 and at a mix."""
    jfk, pfk = _fks(smpl_pair)
    b = 3
    x0, mask = _motion(b), _mask(b)
    rs = np.random.RandomState(1)
    noise = rs.randn(*x0.shape).astype(np.float32)
    t = np.array([0, 4, 9], np.int32)
    a = (1.0 + 0.1 * rs.randn(NJ, NF, 1)).astype(np.float32)
    c = (0.01 * rs.randn(NJ, NF, 1)).astype(np.float32)
    for lambdas in (LAMBDAS, dict(lambda_rcxyz=0.5, lambda_fc=2.0),
                    dict(lambda_vel_rcxyz=1.0)):
        dj = jg.create_diffusion(steps=10, **lambdas)
        dp = pg.create_diffusion(steps=10, **lambdas)

        def jterms(a_, c_):
            return dj.training_losses(lambda x, tt, cc: x * a_ + c_, jnp.asarray(x0),
                                      jnp.asarray(t), {}, mask=jnp.asarray(mask),
                                      noise=jnp.asarray(noise), fk_fn=jfk)

        want = jterms(jnp.asarray(a), jnp.asarray(c))
        wgrad = jax.grad(lambda a_, c_: sum(jnp.sum(v) for v in jterms(a_, c_).values()),
                         argnums=(0, 1))(jnp.asarray(a), jnp.asarray(c))
        pa = torch.from_numpy(a).requires_grad_()
        pc = torch.from_numpy(c).requires_grad_()
        got = dp.training_losses(lambda x, tt, cc: x * pa + pc, torch.from_numpy(x0),
                                 torch.from_numpy(t).long(), {}, mask=torch.from_numpy(mask),
                                 noise=torch.from_numpy(noise), fk_fn=pfk)
        sum(v.sum() for v in got.values()).backward()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{lambdas} {k}")
        for g, w in zip((pa.grad, pc.grad), wgrad):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
        if "lambda_fc" in lambdas:
            assert float(want["fc"].max()) > 0  # the contact mask held somewhere
        if "vel_xyz_mse" in want:  # reported, never summed into the loss
            rest = want["rot_mse"] + sum(lambdas.get(f"lambda_{n}", 0) * want.get(k, 0)
                                         for n, k in (("vel", "vel_mse"),
                                                      ("rcxyz", "rcxyz_mse"), ("fc", "fc")))
            np.testing.assert_allclose(got["loss"].detach().numpy(), np.asarray(rest),
                                       rtol=RTOL, atol=ATOL)


# ---- the action-mode MotionMDM --------------------------------------------- #
def _build(cond_mode="action", **overrides):
    """(JAX MotionMDM, its params with a nonzero action bias, the port
    model in its trainable layout with the same weights)."""
    kw = dict(SMALL_T2M, njoints=NJ, nfeats=NF, cond_mode=cond_mode, num_actions=12,
              **overrides)
    jax_model = JaxMotionMDM(**kw)
    x = jnp.zeros((2, NJ, NF, T))
    with threefry():
        params = jax_model.init(jax.random.PRNGKey(0), x, jnp.zeros((2,), jnp.int32),
                                {"action": jnp.zeros((2,), jnp.int32)})
    params = jax.tree_util.tree_map(np.array, params)
    if cond_mode == "action":
        bias = params["params"]["embed_action"]["bias"]
        bias[:] = np.random.RandomState(9).randn(*bias.shape) * 0.5
    port = load_motion_mdm_params(MotionMDM(**kw), params)
    return jax_model, params, port


def _batches(n, b, seed=3):
    rs = np.random.RandomState(seed)
    return [dict(motion=_motion(b, seed=seed + i),
                 cond=dict(action=rs.randint(0, 12, size=b).astype(np.int32), mask=_mask(b)),
                 t=rs.randint(0, 8, size=b).astype(np.int32),
                 noise=rs.randn(b, NJ, NF, T).astype(np.float32))
            for i in range(n)]


@pytest.mark.parametrize("fused,bf16", [(False, False), (True, False), (False, True)],
                         ids=["plain", "fused-train-layer", "use_bf16"])
def test_three_steps_match_jax_make_train_step(smpl_pair, fused, bf16):
    """Dropout 0 and cond_mask_prob 0 make the step deterministic; the
    recipe's lambdas through each package's fk_fn; under use_bf16 both
    round x_t to bfloat16 before the model."""
    jfk, pfk = _fks(smpl_pair)
    jax_model, params, port = _build(dropout=0.0, cond_mask_prob=0.0,
                                     use_fused_train_encoder=fused)
    lr, wd = 1e-3, 0.1
    lambdas = dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0)
    dj = jg.create_diffusion(steps=8, **lambdas)
    dp = pg.create_diffusion(steps=8, **lambdas)
    jcfg = jloop.TrainConfig(lr=lr, weight_decay=wd, use_bf16=bf16)
    tx = jloop.make_optimizer(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jloop.TrainState(step=jnp.asarray(0, jnp.int32), params=jparams,
                              opt_state=tx.init(jparams), ema_params={},
                              sampler=jloop.create_named_schedule_sampler("uniform", 8))

    def apply_fn(p, x, t, c, rngs=None):
        return jax_model.apply(p, x, t, c, train=True, rngs=rngs)

    jstep = jloop.make_train_step(dj, apply_fn, tx, jcfg, fk_fn=jfk)
    pcfg = ploop.TrainConfig(lr=lr, weight_decay=wd, use_bf16=bf16)
    opt, sched = ploop.make_optimizer(port.parameters(), pcfg)
    pstate = ploop.TrainState(port, opt, sched, UniformSampler(8), {})
    gen = torch.Generator().manual_seed(0)
    for batch in _batches(3, 4):
        jstate, jm = jstep(jstate, jnp.asarray(batch["motion"]), to_jax(batch["cond"]),
                           jax.random.PRNGKey(0), jnp.asarray(batch["t"]),
                           jnp.asarray(batch["noise"]))
        pm = ploop.train_step(pstate, dp, pcfg, torch.from_numpy(batch["motion"]),
                              to_torch(batch["cond"]), gen, torch.from_numpy(batch["t"]).long(),
                              torch.from_numpy(batch["noise"]), fk_fn=pfk)
        for k in ("loss", "rot_mse", "rcxyz_mse", "vel_mse", "fc"):
            np.testing.assert_allclose(pm[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-3)
    assert pstate.step == 3 and pstate.nonfinite_skips == 0
    jp = jax.tree_util.tree_map(np.asarray, jstate.params)
    want = motion_mdm_state_dict_from_params(jp)
    got = port.state_dict()
    d = SMALL_T2M["latent_dim"]
    diffs = []
    for k, v in want.items():
        a, b = got[k].numpy(), v.numpy()
        if k.endswith("in_proj_bias"):
            # the key bias gets an exactly zero gradient (softmax is
            # shift-invariant); Adam turns its rounding noise into +-lr
            # steps that differ between frameworks
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=k)
        diffs.append(np.abs(a - b).ravel())
    assert np.concatenate(diffs).mean() < 1e-7
    # the kernel and the bias apart, as each trained
    for got_p, want_p in ((port.embed_action.action_embedding, jp["params"]["embed_action"]["kernel"]),
                          (port.embed_action.bias, jp["params"]["embed_action"]["bias"])):
        np.testing.assert_allclose(got_p.detach().numpy(), want_p, rtol=0, atol=1e-4)


def test_action_embedding_holds_kernel_and_bias_and_exports_folded():
    """The trainable layout: a kernel and a bias, the bias's gradient the
    sum of the rows'; the state dict folds them as JAX's exporter does;
    loading one sets kernel = rows, bias = 0 (as JAX's importer); the
    forward is the same either way."""
    jax_model, params, port = _build(dropout=0.0, cond_mask_prob=0.0)
    names = {n for n, _ in port.named_parameters() if n.startswith("embed_action")}
    assert names == {"embed_action.action_embedding", "embed_action.bias"}
    sd = port.state_dict()
    assert "embed_action.bias" not in sd
    want = export_motion_mdm_state_dict(params, jax_model)
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    action = torch.tensor([0, 3, 3, 7])
    out = port.embed_action(action)
    out.backward(torch.randn(out.shape, generator=torch.Generator().manual_seed(1)))
    torch.testing.assert_close(port.embed_action.bias.grad,
                               port.embed_action.action_embedding.grad.sum(0), rtol=0, atol=1e-6)
    folded = MotionMDM(**dict(SMALL_T2M, njoints=NJ, nfeats=NF, cond_mode="action",
                              dropout=0.0))
    folded.load_state_dict(sd)
    assert not folded.embed_action.bias.any()
    torch.testing.assert_close(folded.embed_action.action_embedding,
                               sd["embed_action.action_embedding"], rtol=0, atol=0)
    x, t = torch.from_numpy(_motion(4)), torch.tensor([1, 2, 3, 4])
    with torch.no_grad():
        torch.testing.assert_close(folded(x, t, {"action": action}),
                                   port(x, t, {"action": action}), rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError, match="Unexpected"):
        folded.load_state_dict({**sd, "embed_action.bias": torch.zeros(64)})


def test_remat_gradients_equal_the_stored_path_and_advance_the_generator_once():
    """Plain training layers at dropout 0.1 under --remat: the recompute
    replays the forward's masks from the generator's saved state, so the
    gradients equal the stored-activation path's bit for bit, and the
    caller's generator ends where the stored path leaves it."""
    kw = dict(SMALL_T2M, njoints=NJ, nfeats=NF, cond_mode="action", dropout=0.1,
              cond_mask_prob=0.0)
    torch.manual_seed(0)
    stored = MotionMDM(**kw)
    remat = MotionMDM(**kw, remat=True)
    remat.load_state_dict(stored.state_dict())
    assert remat.seqTransEncoder.remat and not stored.seqTransEncoder.remat
    x, t = torch.from_numpy(_motion(3)), torch.tensor([1, 5, 9])
    cond = {"action": torch.tensor([0, 4, 11])}
    grads, states = [], []
    for model in (stored, remat):
        gen = torch.Generator().manual_seed(5)
        out = model(x, t, cond, train=True, generator=gen)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0, atol=0, msg=n)
    with torch.no_grad():  # the masks acted
        assert (out - remat(x, t, cond)).abs().max() > 1e-3
    fused = MotionMDM(**kw, remat=True, use_fused_train_encoder=True)
    assert not fused.seqTransEncoder.remat  # the fused layer keeps only its input


# ---- the train CLI on synthetic trees ----------------------------------- #
@pytest.fixture(scope="module")
def a2m_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("a2m_train")
    ps.save_synthetic_smpl_pickle(str(root / "smpl.pkl"), n_vertices=NV)
    make_synthetic_humanact12(str(root / "humanact12"), n_clips=16)
    make_synthetic_uestc(str(root / "uestc"), n_videos=24, n_actions=40, min_frames=96,
                         max_frames=130)
    return root


RECIPE = ["--device", "cpu", "--layers", "2", "--latent_dim", "64", "--batch_size", "4",
          "--diffusion_steps", "8", "--cond_mask_prob", "0", "--lambda_rcxyz", "1",
          "--lambda_vel", "1", "--lambda_fc", "1", "--log_interval", "1"]


def _train(root, dataset, save, *extra):
    return train_mdm.main(RECIPE + ["--dataset", dataset, "--data_dir", str(root / dataset),
                                    "--save_dir", str(save), *extra])


@pytest.mark.parametrize("dataset,num_frames", [("humanact12", "60"), ("humanact12", None),
                                                ("uestc", "60")])
def test_train_cli_trains_the_action_datasets(a2m_root, dataset, num_frames, tmp_path,
                                              monkeypatch):
    """The recipe's flags at --num_frames 60 (upstream's) and at the
    parser's default 120; the checkpoint read by JAX's
    load_torch_checkpoint gives the port's forward."""
    monkeypatch.setenv("SMPL_MODEL_PATH", str(a2m_root / "smpl.pkl"))
    extra = ["--num_frames", num_frames] if num_frames else []
    loop = _train(a2m_root, dataset, tmp_path / "run", "--num_steps", "2",
                  "--use_fused_train_encoder", *extra)
    frames = int(num_frames or 120)
    model = loop.state.model
    assert model.cond_mode == "action" and loop.fk_fn is not None
    assert model.embed_action.action_embedding.shape[0] == {"humanact12": 12, "uestc": 40}[dataset]
    assert loop.state.step == 2 and loop.state.nonfinite_skips == 0
    with open(tmp_path / "run" / "args.json") as f:
        assert json.load(f)["num_frames"] == frames
    path = str(tmp_path / "run" / "model000000002.pt")
    jm = JaxMotionMDM(njoints=NJ, nfeats=NF, latent_dim=64, num_layers=2, ff_size=1024,
                      num_heads=4, cond_mode="action",
                      num_actions=model.embed_action.action_embedding.shape[0])
    variables = load_torch_checkpoint(path, jm)
    port = MotionMDM(njoints=NJ, nfeats=NF, latent_dim=64, num_layers=2, ff_size=1024,
                     num_heads=4, cond_mode="action",
                     num_actions=model.embed_action.action_embedding.shape[0])
    port.load_state_dict(load_checkpoint(path))
    x, t = _motion(2, t=frames, seed=7), np.array([1, 6], np.int32)
    cond = {"action": np.array([3, 11], np.int32)}
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
        trained = model.eval()(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(trained, got, rtol=0, atol=1e-5)


def test_train_cli_resumes_the_unfolded_embedding_and_trains_no_cond(a2m_root, tmp_path,
                                                                      monkeypatch):
    monkeypatch.setenv("SMPL_MODEL_PATH", str(a2m_root / "smpl.pkl"))
    save = tmp_path / "run"
    loop = _train(a2m_root, "humanact12", save, "--num_steps", "2", "--num_frames", "40")
    bias = loop.state.model.embed_action.bias.detach().clone()
    assert bias.abs().max() > 0
    resumed = _train(a2m_root, "humanact12", save, "--num_steps", "2", "--num_frames", "40",
                     "--resume_checkpoint", "latest", "--overwrite")
    assert resumed.resume_step == 2
    assert torch.equal(resumed.state.model.embed_action.bias, bias)
    assert torch.equal(resumed.state.model.embed_action.action_embedding,
                       loop.state.model.embed_action.action_embedding)
    free = _train(a2m_root, "uestc", tmp_path / "free", "--num_steps", "1", "--num_frames", "40",
                  "--unconstrained")
    assert free.state.model.cond_mode == "no_cond"
    assert not hasattr(free.state.model, "embed_action")


def test_geometric_lambdas_need_the_body_model(a2m_root, tmp_path, monkeypatch):
    """Without the SMPL pickle the geometric losses cannot run: the CLI
    fails to read it; with the lambdas at 0 no fk_fn is built."""
    monkeypatch.setenv("SMPL_MODEL_PATH", str(tmp_path / "missing.pkl"))
    with pytest.raises(FileNotFoundError):
        _train(a2m_root, "humanact12", tmp_path / "run", "--num_steps", "1", "--num_frames", "40")
    loop = train_mdm.main(["--device", "cpu", "--layers", "1", "--latent_dim", "32",
                           "--batch_size", "4", "--diffusion_steps", "8", "--dataset",
                           "humanact12", "--data_dir", str(a2m_root / "humanact12"),
                           "--save_dir", str(tmp_path / "plain"), "--num_steps", "1",
                           "--num_frames", "40"])
    assert loop.fk_fn is None
