"""Port parity of the text-to-motion benchmark against the JAX package on
the CPU: the whole ``evaluation`` (matching score, R-precision, FID,
diversity, multimodality over two replications) from one injected sample
stub in both packages (numpy-seeded draws in call order, moved by each
batch's caption embedding: JAX draws its chains from jax.random, which the
port cannot reproduce) on a synthetic HumanML3D tree with varied captions,
the evaluators carrying JAX weights drawn under threefry2x32; every metric
and its 95% interval (read from both logs); then the eval CLI in debug mode
next to JAX's, run in-process on one checkpoint the port's train CLI wrote,
both reading one reference-layout finest.tar (the same metric keys, the
ground truth's metrics alike, the generated ones finite); the train CLI's
hook (``make_training_eval_fn``) against JAX's on the same checkpoint;
``EVAL_MODES``, ``full`` refused, ``load_eval_renorm``'s search order,
``collate_humanml_eval`` and ``get_opt``.

Tolerances: metrics rtol 1e-5 (float32 embeddings ~1e-6 apart through
the distance matrices, the covariances and FID's matrix square root of
rank-deficient covariances, 32 samples of 512 features); an interval, a spread of per-replication values each within
that, within rtol of its metric's magnitude; R-precision exactly equal
(the ranks of distances that differ at 1e-6 do not flip here); the CLIs'
and hooks' ground-truth metrics the same.
"""

import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.eval import eval_humanml as jeh
from gesturediffusion_tpu.eval import evaluator_wrapper as jew
from gesturediffusion_tpu.data import humanml as jh
from gesturediffusion_tpu.utils import get_opt as jgo
from gesturediffusion_tpu.utils.text_embedder import HashTextEmbedder as JaxHash
from gesturediffusion_tpu_torch.data import humanml as ph
from gesturediffusion_tpu_torch.eval import eval_humanml as peh
from gesturediffusion_tpu_torch.eval import evaluator_wrapper as pew
from gesturediffusion_tpu_torch.train import train_mdm
from gesturediffusion_tpu_torch.utils import get_opt as pgo
from gesturediffusion_tpu_torch.utils.convert import t2m_evaluator_state_dicts_from_params
from gesturediffusion_tpu_torch.utils.text_embedder import HashTextEmbedder
from tests.test_torch_eval_humanml_networks import vary_captions
from tests.torch_port_common import (  # noqa: F401 (fixtures)
    one_torch_thread,
    threefry,
    threefry_prng,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 1e-5, 1e-8


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """32 clips a split (train and test) and a few sub-range clips: one
    protocol batch of 32 a replication; varied captions."""
    root = str(tmp_path_factory.mktemp("t2m_eval") / "humanml")
    return vary_captions(ph.make_synthetic_humanml(root, n_clips=64, seed=5,
                                                   splits=("train", "test")), seed=5)


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    """(JAX wrapper, port wrapper) with the same threefry-drawn weights,
    and those weights as a reference-layout finest.tar."""
    with threefry():
        jw = jew.EvaluatorWrapper("humanml", dim_pose=263, seed=4)
    sds = t2m_evaluator_state_dicts_from_params(jax.tree_util.tree_map(np.asarray, jw.params))
    tar = str(tmp_path_factory.mktemp("t2m_tar") / "finest.tar")
    torch.save(sds, tar)
    return jw, pew.EvaluatorWrapper("humanml", state_dicts=sds, device="cpu"), tar


def _stubs(dim):
    """(JAX sample_fn, port sample_fn): the same draws in call order, each
    batch moved by its captions' embedding, so that a sample depends on
    its caption."""
    def maker(to_np, wrap):
        calls = []

        def sample_fn(_rng, cond):
            rs = np.random.RandomState(100 + len(calls))
            calls.append(1)
            text = to_np(cond["text_emb"])[:, :dim]
            x = rs.randn(len(text), dim, 1, 196).astype(np.float32) * 0.5
            return wrap(x + text[:, :, None, None] * 3.0)

        return sample_fn

    return (maker(np.asarray, jnp.asarray),
            maker(lambda t: t.cpu().numpy(), torch.from_numpy))


def _summaries(log_file):
    """{(metric, loader): (mean, interval)} from an evaluation log."""
    out, metric = {}, None
    with open(log_file) as f:
        for line in f:
            m = re.match(r"=+ (.+) Summary =+", line)
            if m:
                metric = m.group(1)
                continue
            m = re.match(r"---> \[(.+)\] Mean: (.+) CInterval: (.+)", line)
            if m and metric:
                out[(metric, m.group(1))] = tuple(
                    np.array(np.fromstring(v.strip("[] \n"), sep=" ")) for v in m.groups()[1:])
    return out


def _assert_summaries(got, want, rtol=RTOL, keys=None):
    assert sorted(got) == sorted(want)
    for k in keys or want:
        (gm, gc), (wm, wc) = got[k], want[k]
        if k[0] == "R_precision":
            np.testing.assert_array_equal(gm, wm, err_msg=str(k))
        else:
            np.testing.assert_allclose(gm, wm, rtol=rtol, atol=ATOL, err_msg=str(k))
        np.testing.assert_allclose(gc, wc, rtol=rtol, atol=ATOL + rtol * np.abs(wm).max(),
                                   err_msg=str(k))


@pytest.mark.parametrize("run_mm", [False, True])
def test_evaluation_matches_jax(tree, evaluators, tmp_path, run_mm):
    """Two replications of a generated batch of 32 (with run_mm, sampled 3
    times: multimodality over 2 pairs) and the ground truth,
    renormalised to the evaluators' statistics; the global np.random and
    the dataset's crops drawing in the same order."""
    jw, pw, _ = evaluators
    mode = dict(mm_num_samples=32, mm_num_repeats=3) if run_mm else {}
    out = []
    for pkg, hpkg, wrapper, sample, embed, name in (
            (jeh, jh, jw, _stubs(263)[0], JaxHash(), "jax"),
            (peh, ph, pw, _stubs(263)[1], HashTextEmbedder(), "port")):
        ds = hpkg.Text2MotionDatasetV2(tree, "test", w_vectorizer=hpkg.HashVectorizer())
        renorm = pkg.load_eval_renorm(ds, _quiet)
        assert renorm is not None and len(ds) // 32 == 1
        gt = pkg.GroundTruthMotionSet(ds, renorm=renorm)

        def make_loader(replication, pkg=pkg, ds=ds, sample=sample, embed=embed,
                        renorm=renorm):
            gen = pkg.GeneratedMotionSet(sample, ds, text_encoder=embed, renorm=renorm,
                                         seed=replication, **mode,
                                         **({"device": "cpu"} if pkg is peh else {}))
            return gen, gen.mm_batches

        log_file = str(tmp_path / f"{name}.log")
        np.random.seed(3)
        means = pkg.evaluation(wrapper, gt, {"vald": make_loader}, log_file,
                               replication_times=2, mm_num_times=2, run_mm=run_mm)
        out.append((means, _summaries(log_file)))
    (jm, js), (pm, ps) = out
    assert sorted(pm) == sorted(jm)
    _assert_summaries(ps, js)
    for k, v in jm.items():
        if k.startswith("R_precision"):
            np.testing.assert_array_equal(pm[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(pm[k], v, rtol=RTOL, atol=ATOL, err_msg=k)
    assert ("MultiModality", "vald") in ps if run_mm else not any(
        k[0] == "MultiModality" for k in ps)
    # the varied captions give an R-precision of the ground truth below 1
    assert 0 < pm["R_precision_ground truth"][0] < 1


def test_eval_modes_and_full_is_refused(tmp_path):
    """debug, wo_mm and mm_short as in JAX; full, the action benchmark's,
    raises before anything loads."""
    assert peh.EVAL_MODES == jeh.EVAL_MODES
    (tmp_path / "args.json").write_text('{"dataset": "humanml"}')
    with pytest.raises(ValueError, match="unsupported for t2m"):
        peh.main(["--model_path", str(tmp_path / "model000000001.pt"), "--eval_mode", "full",
                  "--device", "cpu"])


def test_collate_matches_jax(tree):
    items = [ph.Text2MotionDatasetV2(tree, "test", w_vectorizer=ph.HashVectorizer())[i]
             for i in range(5)]
    want, got = jeh.collate_humanml_eval(items), peh.collate_humanml_eval(items)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)


def test_renorm_search_order(tree, tmp_path, monkeypatch):
    """The working directory's dataset/ first; stats of another width there
    are skipped for the repository's; none found -> None."""
    ds = ph.Text2MotionDatasetV2(tree, "test")
    os.makedirs(tmp_path / "dataset")
    monkeypatch.chdir(tmp_path)
    for prefix, width in (("t2m", 100), ("kit", 251)):
        np.save(tmp_path / "dataset" / f"{prefix}_mean.npy", np.ones(width))
        np.save(tmp_path / "dataset" / f"{prefix}_std.npy", np.full(width, 2.0))
    for name in ("humanml", "kit"):
        got = peh.load_eval_renorm(ds, _quiet, dataset_name=name)
        want = jeh.load_eval_renorm(ds, _quiet, dataset_name=name)
        assert (got is None) == (want is None) == (name == "kit")
        if got is not None:  # the repository's 263-wide t2m stats
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    np.save(tmp_path / "dataset" / "t2m_mean.npy", np.ones(263))
    np.save(tmp_path / "dataset" / "t2m_std.npy", np.full(263, 2.0))
    got = peh.load_eval_renorm(ds, _quiet)
    assert (got[2] == 1).all() and (got[3] == 2).all()


def test_get_opt_matches_jax(tmp_path):
    path = tmp_path / "opt.txt"
    path.write_text("------------ Options -------------\ndataset_name: kit\nunit_length: 4\n"
                    "lr: 0.0002\nis_train: True\nname: text_mot_match\nmax_text_len: 20\n"
                    "neg: -3\n-------------- End ----------------\n")
    assert vars(pgo.get_opt(str(path))) == vars(jgo.get_opt(str(path)))
    path.write_text("dataset_name: other\n")
    with pytest.raises(KeyError):
        pgo.get_opt(str(path))


@pytest.fixture(scope="module")
def port_checkpoint(tree, tmp_path_factory):
    """A tiny humanml MotionMDM the port's train CLI wrote (4 diffusion
    steps), with its args.json."""
    save_dir = str(tmp_path_factory.mktemp("t2m_ckpt") / "run")
    train_mdm.main(["--device", "cpu", "--dataset", "humanml", "--data_dir", tree,
                    "--save_dir", save_dir, "--layers", "1", "--latent_dim", "32",
                    "--batch_size", "4", "--num_steps", "2", "--diffusion_steps", "4"])
    return os.path.join(save_dir, "model000000002.pt")


GT_KEYS = [(m, "ground truth") for m in ("Matching Score", "R_precision", "FID", "Diversity")]


def test_eval_cli_debug_matches_jax_cli(evaluators, port_checkpoint, monkeypatch):
    """Both packages' eval CLIs in debug mode (5 replications of a batch
    at guidance 2.5) on one port checkpoint and one finest.tar: the same
    metric keys, the ground truth's metrics and intervals alike, the
    generated ones finite (each package samples from its own noise)."""
    monkeypatch.setenv("T2M_EVALUATOR_PATH", evaluators[2])
    argv = ["--model_path", port_checkpoint, "--eval_mode", "debug"]
    log_file = os.path.join(os.path.dirname(port_checkpoint),
                            "eval_humanml_run_000000002_debug.log")
    want = jeh.main(argv)
    want_log = _summaries(log_file)
    os.remove(log_file)
    got = peh.main(["--device", "cpu", *argv])
    got_log = _summaries(log_file)
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(np.asarray(v)).all() for v in got.values()), got
    _assert_summaries(got_log, want_log, keys=GT_KEYS)
    assert len([k for k in got_log if k[1] == "vald"]) == 4


def _hook_args(tree, save_dir, ckpt_args):
    return types.SimpleNamespace(**{**ckpt_args, "dataset": "humanml", "data_dir": tree,
                                    "eval_split": "test", "eval_num_samples": 32,
                                    "eval_rep_times": 2, "save_dir": save_dir})


def test_training_eval_fn_matches_jax(tree, evaluators, port_checkpoint, tmp_path,
                                      monkeypatch):
    """The train CLI's hook of both packages on the same weights (scale 1, 2
    replications of 32 samples): the same keys (R-precision as _top1..3),
    the ground truth's metrics alike; the port's model handed back in train
    mode."""
    from gesturediffusion_tpu.utils.checkpoint import load_checkpoint as jax_load
    from gesturediffusion_tpu.utils.model_factory import create_model_and_diffusion as jcreate
    from gesturediffusion_tpu.utils.parser import evaluation_parser
    from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
    from gesturediffusion_tpu_torch.utils.model_factory import create_model_and_diffusion
    from gesturediffusion_tpu_torch.utils.parser import evaluation_args

    monkeypatch.setenv("T2M_EVALUATOR_PATH", evaluators[2])
    jargs = evaluation_parser(["--model_path", port_checkpoint])
    pargs = evaluation_args(["--model_path", port_checkpoint, "--device", "cpu"])
    ds = ph.Text2MotionDatasetV2(tree, "train")
    jmodel, jdiff = jcreate(jargs, ds)
    jstate = types.SimpleNamespace(params=jax_load(port_checkpoint, model=jmodel)["params"],
                                   ema_params=None)
    model, diffusion = create_model_and_diffusion(pargs, ds, torch.device("cpu"))
    model.load_state_dict(load_checkpoint(port_checkpoint))
    model.train()
    pstate = types.SimpleNamespace(model=model, ema={})
    out = {}
    for name, make, state, kwargs in (
            ("jax", jeh.make_training_eval_fn, jstate,
             dict(model=jmodel, diffusion=jdiff, text_encoder=JaxHash(), log=_quiet)),
            ("port", peh.make_training_eval_fn, pstate,
             dict(diffusion=diffusion, device="cpu", text_encoder=HashTextEmbedder(),
                  log=_quiet))):
        save_dir = str(tmp_path / name)
        os.makedirs(save_dir)
        eval_fn = make(_hook_args(tree, save_dir, vars(pargs)), **kwargs)
        np.random.seed(7)
        out[name] = (eval_fn(state, 2), _summaries(os.path.join(save_dir,
                                                                "eval_humanml_000000002.log")))
    (jm, js), (pm, ps) = out["jax"], out["port"]
    assert sorted(pm) == sorted(jm) and "R_precision_vald_top3" in pm
    assert all(np.isfinite(v) for v in pm.values())
    _assert_summaries(ps, js, keys=GT_KEYS)
    assert model.training
