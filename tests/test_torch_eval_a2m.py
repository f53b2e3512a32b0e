"""Port parity of the action-to-motion evaluation against the JAX package
on the CPU: ``A2MEvaluation`` (GRU), ``STGCNA2MEvaluation`` (recognition
ST-GCN), the multi-seed loops ``evaluate_humanact12`` and
``evaluate_uestc`` and the unconstrained branch (MoDi ST-GCN, the
FK-derived GT and the npy GT) on synthetic HumanAct12 and UESTC trees and
a synthetic SMPL, all from injected samples: the same ``sample_fn`` stub
in both packages returns numpy-seeded draws in call order (JAX draws its
chains from jax.random, which the port cannot reproduce).  The
classifiers carry JAX weights drawn under threefry2x32, and the global
``np.random`` and the datasets' shuffles draw in JAX's order.  Then the
eval CLI in debug mode next to JAX's CLI run in-process on one checkpoint
the port wrote, both reading one humanact12_gru.tar: the same YAML keys
and the same ``*_gt`` metrics.

Tolerances: the metrics rtol 1e-5 (float32 features through SMPL and the
classifiers, the same products in another order; FID's PSD branch
amplifies them most), with atol 1e-8 for FID and its interval where a set
is scored against itself (zero up to rounding); a 95% interval over seeds
(``*_conf``, the spread of per-seed values, each within rtol) within rtol
of its metric's magnitude; KID (a difference of kernel means of order 1)
within rtol of 1; the CLIs' ``*_gt`` metrics rtol 1e-4, likewise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.data import a2m as ja2m
from gesturediffusion_tpu.data import uestc as juestc
from gesturediffusion_tpu.eval import eval_a2m as jev
from gesturediffusion_tpu.eval import eval_unconstrained as junc
from gesturediffusion_tpu.eval import networks as jn
from gesturediffusion_tpu.eval import stgcn as jst
from gesturediffusion_tpu.models import rotation2xyz as jr2x
from gesturediffusion_tpu.models import smpl as js
from gesturediffusion_tpu_torch.data import a2m as pa2m
from gesturediffusion_tpu_torch.data import uestc as puestc
from gesturediffusion_tpu_torch.eval import eval_a2m as pev
from gesturediffusion_tpu_torch.eval import eval_unconstrained as punc
from gesturediffusion_tpu_torch.models import smpl as ps
from gesturediffusion_tpu_torch.train import train_mdm
from gesturediffusion_tpu_torch.utils.convert import (
    motion_discriminator_state_dict_from_params,
    stgcn_state_dict_from_variables,
)
from tests.torch_port_common import threefry, threefry_prng  # noqa: F401 (autouse fixture)

RTOL, ATOL = 1e-5, 1e-8
CLI_RTOL = 1e-4


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("a2m_eval")
    smpl = ps.save_synthetic_smpl_pickle(str(root / "smpl.pkl"), 128)
    return dict(
        smpl=smpl,
        ha12=pa2m.make_synthetic_humanact12(str(root / "ha12"), n_clips=24),
        uestc=puestc.make_synthetic_uestc(str(root / "uestc"), n_videos=24),
        root=root,
    )


@pytest.fixture(scope="module")
def fks(trees):
    kw = dict(pose_rep="rot6d", translation=True, glob=True, jointstype="smpl",
              vertstrans=True)
    jm = js.load_smpl_pickle(trees["smpl"])
    return (jax.jit(lambda s: jr2x.rotation2xyz(jm, s, **kw)),
            pev.make_fk_fn(ps.load_smpl_pickle(trees["smpl"])))


def _stubs():
    """(JAX sample_fn, port sample_fn) returning the same draws in call
    order, rot6d rows and a translation row alike."""
    def maker(wrap):
        calls = []

        def sample_fn(_rng, shape, _cond):
            rs = np.random.RandomState(1000 + len(calls))
            calls.append(shape)
            return wrap((rs.randn(*shape) * 0.3).astype(np.float32))

        return sample_fn

    return maker(jnp.asarray), maker(torch.from_numpy)


def _datasets(kind, trees):
    if kind == "humanact12":
        return (ja2m.HumanAct12Poses(trees["ha12"], num_frames=60, split="test"),
                pa2m.HumanAct12Poses(trees["ha12"], num_frames=60, split="test"))
    return (juestc.UESTC(trees["uestc"], num_frames=60, split="test"),
            puestc.UESTC(trees["uestc"], num_frames=60, split="test"))


def _assert_metrics(got, want, rtol=RTOL):
    """Every metric within rtol; an interval ``<k>_conf``, a difference of
    per-seed values, within rtol of its metric's magnitude; KID, a
    difference of polynomial-kernel means of order 1 (coef0 = 1), within
    rtol of 1."""
    assert sorted(got) == sorted(want)
    for k in want:
        scale = abs(want[k.removesuffix("_conf")]) if k.endswith("_conf") else 0.0
        if k.startswith("kid_"):
            scale = 1.0
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=ATOL + rtol * scale,
                                   err_msg=k)


@pytest.fixture(scope="module")
def gru_params():
    with threefry():
        params = jn.MotionDiscriminator(input_size=72).init(
            jax.random.PRNGKey(7), jnp.zeros((2, 24, 3, 8)), jnp.asarray([8, 8]))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _stgcn_variables(kw, shape):
    with threefry():
        v = jst.STGCN(**kw).init(jax.random.PRNGKey(8), jnp.zeros(shape))
    v = jax.tree_util.tree_map(np.array, v)
    rs = np.random.RandomState(8)

    def move(stats):  # non-zero running statistics
        if "var" not in stats:
            return [move(s) for s in stats.values()]
        stats["mean"] += rs.randn(*stats["mean"].shape).astype(np.float32) * 0.1
        stats["var"] *= rs.uniform(0.5, 1.5, stats["var"].shape).astype(np.float32)

    move(v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def evaluations(gru_params):
    rec = _stgcn_variables(dict(in_channels=6, num_class=40, layout="smpl",
                                variant="recognition"), (2, 6, 16, 24))
    modi = _stgcn_variables(dict(in_channels=3, num_class=12, layout="openpose15",
                                 variant="modi"), (2, 3, 16, 15))
    return {
        "humanact12": (jev.A2MEvaluation(classifier_params=gru_params),
                       pev.A2MEvaluation(state_dict=motion_discriminator_state_dict_from_params(
                           gru_params), device="cpu")),
        "uestc": (jev.STGCNA2MEvaluation(variables=rec),
                  pev.STGCNA2MEvaluation(state_dict=stgcn_state_dict_from_variables(rec),
                                         device="cpu")),
        "modi": (junc.UnconstrainedEvaluator(variables=modi),
                 punc.UnconstrainedEvaluator(state_dict=stgcn_state_dict_from_variables(modi),
                                           device="cpu")),
    }


@pytest.mark.parametrize("cond_mode", ["action", "no_cond"])
@pytest.mark.parametrize("kind", ["humanact12", "uestc"])
def test_evaluation_object_matches_jax(trees, fks, evaluations, kind, cond_mode):
    """One gt and one generated loader through each package's evaluation
    object: accuracy, FID, diversity, multimodality (NaN under no_cond)."""
    jds, pds = _datasets(kind, trees)
    jsample, psample = _stubs()
    out = []
    for pkg, ds, fk, sample, ev in ((jev, jds, fks[0], jsample, evaluations[kind][0]),
                                    (pev, pds, fks[1], psample, evaluations[kind][1])):
        cpu = {"device": "cpu"} if pkg is pev else {}
        gt = pkg.make_gt_batches(fk, ds, 10, 4, 60, **cpu)
        gen = pkg.make_generated_batches(sample, fk, ds, 10, 4, 60, seed=0, **cpu)
        assert [len(b["y"]) for b in gen] == [4, 4, 2]  # the padded last block cut on the host
        np.random.seed(0)
        out.append(ev.evaluate({"gt": gt, "gen": gen}, cond_mode=cond_mode))
    _assert_metrics(out[1], out[0])
    assert np.isnan(out[1]["multimodality_gen"]) == (cond_mode == "no_cond")


@pytest.mark.parametrize("kind", ["humanact12", "uestc"])
def test_multi_seed_loops_match_jax(trees, fks, evaluations, kind):
    """evaluate_humanact12 / evaluate_uestc (both splits, keys suffixed)
    over 2 seeds: every metric and its 95% interval."""
    jds, pds = _datasets(kind, trees)
    jsample, psample = _stubs()
    out = []
    for pkg, ds, fk, sample, ev in ((jev, jds, fks[0], jsample, evaluations[kind][0]),
                                    (pev, pds, fks[1], psample, evaluations[kind][1])):
        loop = pkg.evaluate_uestc if kind == "uestc" else pkg.evaluate_humanact12
        np.random.seed(10)
        cpu = {"device": "cpu"} if pkg is pev else {}
        out.append(loop(sample, fk, ds, ev, num_seeds=2, num_samples=6, batch_size=4,
                        num_frames=60, log=_quiet, **cpu))
    _assert_metrics(out[1], out[0])
    if kind == "uestc":
        assert {"fid_gen_train", "fid_gen_test", "accuracy_gt_test_conf"} <= set(out[1])


@pytest.mark.parametrize("gt_source", ["fk", "npy"])
def test_unconstrained_branch_matches_jax(trees, fks, evaluations, gt_source):
    """The MoDi branch: the 15-joint subset of SMPL's joints, FID, KID
    and diversity against the FK-derived GT or a 16-joint npy."""
    npy = None
    if gt_source == "npy":
        npy = str(trees["root"] / "humanact12_unconstrained_modi_struct.npy")
        np.save(npy, np.random.RandomState(3).randn(10, 16, 3, 60).astype(np.float32))
    jds, pds = _datasets("humanact12", trees)
    jsample, psample = _stubs()
    out = []
    for pkg, ds, fk, sample, ev in ((jev, jds, fks[0], jsample, evaluations["modi"][0]),
                                    (pev, pds, fks[1], psample, evaluations["modi"][1])):
        np.random.seed(11)
        out.append(pkg.evaluate_unconstrained_branch(
            sample, fk, ds, num_samples=8, batch_size=4, num_frames=60, dataset_npy_path=npy,
            evaluator=ev, log=_quiet, **({"device": "cpu"} if pkg is pev else {})))
    _assert_metrics(out[1], out[0])
    assert set(out[1]) == {f"{k}_unconstrained" for k in (
        "fid", "kid_mean", "kid_std", "diversity_gen", "diversity_gt")}
    assert pev.UNCONSTRAINED_15_JOINTS == jev.UNCONSTRAINED_15_JOINTS


def test_eval_modes_and_the_full_protocol_refusal(tmp_path, monkeypatch):
    """debug is 2 seeds x 64 samples and full 20 x 1000, as in JAX; a text
    mode raises ValueError; full refuses random classifier weights."""
    assert pev.EVAL_MODES_A2M == jev.EVAL_MODES_A2M
    monkeypatch.setenv("A2M_CLASSIFIER_PATH", str(tmp_path / "absent.tar"))
    with pytest.raises(FileNotFoundError, match="A2M_CLASSIFIER_PATH"):
        pev.make_a2m_evaluation("humanact12", eval_mode="full", device="cpu")
    assert isinstance(pev.make_a2m_evaluation("humanact12", eval_mode="debug", device="cpu"),
                      pev.A2MEvaluation)
    monkeypatch.setenv("UESTC_STGCN_PATH", str(tmp_path / "absent.tar"))
    assert isinstance(pev.make_a2m_evaluation("uestc", device="cpu"), pev.STGCNA2MEvaluation)


@pytest.fixture(scope="module")
def port_checkpoint(trees, tmp_path_factory):
    """A tiny humanact12 MotionMDM the port's train CLI wrote (4 diffusion
    steps), with its args.json."""
    save_dir = str(tmp_path_factory.mktemp("a2m_ckpt") / "run")
    with pytest.MonkeyPatch.context() as mp:  # the synthetic SMPL for this call only
        mp.setenv("SMPL_MODEL_PATH", trees["smpl"])
        train_mdm.main(["--device", "cpu", "--dataset", "humanact12", "--data_dir",
                        trees["ha12"], "--save_dir", save_dir, "--layers", "1",
                        "--latent_dim", "32", "--batch_size", "4", "--num_frames", "60",
                        "--num_steps", "2", "--diffusion_steps", "4", "--cond_mask_prob", "0"])
    return os.path.join(save_dir, "model000000002.pt")


def _yaml(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def test_eval_cli_debug_matches_jax_cli(trees, gru_params, port_checkpoint, monkeypatch,
                                        tmp_path):
    """Both packages' eval CLIs in debug mode on one port checkpoint and one
    reference-layout humanact12_gru.tar: the YAML keys, and the *_gt
    metrics (the generated ones come from each package's own noise)."""
    tar = str(tmp_path / "humanact12_gru.tar")
    torch.save({"model": motion_discriminator_state_dict_from_params(gru_params)}, tar)
    monkeypatch.setenv("A2M_CLASSIFIER_PATH", tar)
    monkeypatch.setenv("SMPL_MODEL_PATH", trees["smpl"])
    argv = ["--model_path", port_checkpoint, "--eval_mode", "debug", "--batch_size", "32"]
    out = os.path.join(os.path.dirname(port_checkpoint), "eval_humanact12_debug.yaml")
    jev.main(argv)
    want = _yaml(out)
    os.remove(out)
    summary = pev.main(["--device", "cpu", *argv])
    got = _yaml(out)
    assert sorted(got) == sorted(want) and got == pytest.approx(summary, nan_ok=True)
    _assert_metrics({k: v for k, v in got.items() if "_gt" in k},
                    {k: v for k, v in want.items() if "_gt" in k}, rtol=CLI_RTOL)
    assert all(np.isfinite(v) for v in got.values()), got
