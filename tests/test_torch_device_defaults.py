"""The public entry points of the port's evaluation (eval/) and mesh export
(viz/) run on the CUDA card unless the caller passes ``device="cpu"``:
without a card each raises ``resolve_device``'s error when no device is
given (``torch.cuda.is_available`` is patched to False, so the test reads
the same on a machine with a card), and each runs with ``device="cpu"``.
``evaluate_unconstrained_metrics`` builds its default evaluator on the
device it is given.  The multi-seed loops' CPU runs are in
test_torch_eval_a2m.py.
"""

import numpy as np
import pytest
import torch

from gesturediffusion_tpu_torch.data import a2m as pa2m
from gesturediffusion_tpu_torch.eval import eval_a2m as pev
from gesturediffusion_tpu_torch.eval import eval_humanml as peh
from gesturediffusion_tpu_torch.eval import eval_unconstrained as punc
from gesturediffusion_tpu_torch.eval.evaluator_wrapper import EvaluatorWrapper
from gesturediffusion_tpu_torch.models.smpl import make_synthetic_smpl
from gesturediffusion_tpu_torch.viz import joints2smpl as pj
from gesturediffusion_tpu_torch.viz import motions2hik as phik
from gesturediffusion_tpu_torch.viz import vis_utils as pvis

NO_CARD = "no CUDA device is available"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def ha12(tmp_path_factory):
    root = pa2m.make_synthetic_humanact12(str(tmp_path_factory.mktemp("ha12")), n_clips=8)
    return pa2m.HumanAct12Poses(root, num_frames=20, split="test")


def _sample_fn(generator, shape, _cond):
    return torch.randn(shape, generator=generator, device=generator.device)


def _fk_fn(sample):
    return sample[:, :24, :3]


@pytest.fixture(scope="module")
def results_npy(tmp_path_factory):
    smpl = make_synthetic_smpl(32)
    pose = torch.as_tensor(np.random.RandomState(0).randn(3, 24, 3) * 0.1, dtype=torch.float32)
    joints = pj.fk_joints(smpl, pose, torch.zeros(3, 3)).numpy()  # [T, 24, 3]
    path = str(tmp_path_factory.mktemp("npy") / "results.npy")
    np.save(path, {"motion": joints.transpose(1, 2, 0)[None], "num_samples": 1})
    return path, joints


def _entry_points(ha12, results_npy):
    """name -> call(device) of every public entry point with a device."""
    path, joints = results_npy
    smpl = make_synthetic_smpl(32)
    motions = np.random.RandomState(1).randn(4, 15, 3, 20).astype(np.float32)
    fit = dict(num_smplify_iters=1)
    return {
        "EvaluatorWrapper": lambda d: EvaluatorWrapper("humanml", device=d),
        "A2MEvaluation": lambda d: pev.A2MEvaluation(device=d),
        "STGCNA2MEvaluation": lambda d: pev.STGCNA2MEvaluation(device=d),
        "UnconstrainedEvaluator": lambda d: punc.UnconstrainedEvaluator(device=d),
        "make_a2m_evaluation": lambda d: pev.make_a2m_evaluation("humanact12", device=d),
        "make_generated_batches": lambda d: pev.make_generated_batches(
            _sample_fn, _fk_fn, ha12, 4, 4, 20, device=d),
        "make_gt_batches": lambda d: pev.make_gt_batches(_fk_fn, ha12, 4, 4, 20, device=d),
        "evaluate_unconstrained_metrics": lambda d: punc.evaluate_unconstrained_metrics(
            motions, motions, log=lambda *a: None, device=d),
        "GeneratedMotionSet": lambda d: peh.GeneratedMotionSet(
            lambda *a: None, [], device=d),
        "joints2smpl": lambda d: pj.joints2smpl(smpl, joints, device=d, **fit),
        "npy2smpl": lambda d: pj.npy2smpl(path, smpl, out_path=path[:-4] + f"_{d}_rot.npy",
                                          device=d, **fit),
        "Npy2Obj": lambda d: pvis.Npy2Obj(path, 0, 0, smpl, device=d, **fit),
        "motions2hik": lambda d: phik.motions2hik(joints.transpose(1, 2, 0)[None], smpl,
                                                  device=d, **fit),
        "joints2smpl CLI": lambda d: pj.main(
            ["--input_path", path, "--num_smplify_iters", "1"] + (["--device", d] if d else [])),
        "render-mesh CLI": lambda d: pvis.main(
            ["--input_path", path, "--num_smplify_iters", "1"] + (["--device", d] if d else [])),
    }


ENTRY_POINTS = ["EvaluatorWrapper", "A2MEvaluation", "STGCNA2MEvaluation",
                "UnconstrainedEvaluator", "make_a2m_evaluation", "make_generated_batches",
                "make_gt_batches", "evaluate_unconstrained_metrics", "GeneratedMotionSet",
                "joints2smpl", "npy2smpl", "Npy2Obj", "motions2hik", "joints2smpl CLI",
                "render-mesh CLI"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_needs_a_card_unless_asked_for_the_cpu(name, ha12, results_npy, no_card):
    call = _entry_points(ha12, results_npy)[name]
    with pytest.raises(RuntimeError, match=NO_CARD):
        call(None)
    call("cpu")


@pytest.mark.parametrize("name", ["evaluate_humanact12", "evaluate_uestc",
                                  "evaluate_unconstrained_branch"])
def test_evaluation_loops_need_a_card_unless_asked(name, no_card):
    """The loops resolve their device before they touch their arguments."""
    with pytest.raises(RuntimeError, match=NO_CARD):
        getattr(pev, name)(None, None, None, *(() if name.endswith("branch") else (None,)))


def test_unconstrained_metrics_build_their_evaluator_on_the_given_device(monkeypatch):
    built = []
    real = punc.UnconstrainedEvaluator

    def spy(*args, **kwargs):
        ev = real(*args, **kwargs)
        built.append(ev.device)
        return ev

    monkeypatch.setattr(punc, "UnconstrainedEvaluator", spy)
    motions = np.random.RandomState(2).randn(6, 15, 3, 20).astype(np.float32)
    out = punc.evaluate_unconstrained_metrics(motions, motions, log=lambda *a: None,
                                              device="cpu")
    assert built == [torch.device("cpu")] and np.isfinite(out["fid"])
