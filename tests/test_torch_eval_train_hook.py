"""The train CLI's ``--eval_during_training`` on the CPU: the a2m benchmark
on humanact12 (the port's classifiers, random weights) and, without SMPL,
the validation-loss fallback; the validation loss on a GENEA-2023 tree;
the text benchmark on humanml and kit (the T2M evaluators, random
weights) over ``--eval_split``; each logged as ``eval/<metric>`` beside
``eval/wall_s`` after every save inside the loop (JAX
train/loop.py:599-610: not after the last save), and the validation loss
the same at every call on the same weights.
"""

import json
import os

import numpy as np
import pytest
import torch

from gesturediffusion_tpu_torch.data.a2m import make_synthetic_humanact12
from gesturediffusion_tpu_torch.data.humanml import make_synthetic_humanml
from gesturediffusion_tpu_torch.data.synthetic import make_synthetic_genea2023
from gesturediffusion_tpu_torch.models.smpl import save_synthetic_smpl_pickle
from gesturediffusion_tpu_torch.train import train_mdm
from gesturediffusion_tpu_torch.utils.parser import train_args
from tests.torch_port_common import one_torch_thread  # noqa: F401 (fixture)

TINY = ["--device", "cpu", "--layers", "1", "--latent_dim", "32", "--batch_size", "4",
        "--num_steps", "5", "--save_interval", "2", "--log_interval", "10",
        "--eval_num_samples", "8", "--eval_batch_size", "4", "--eval_rep_times", "1"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("hook")
    return dict(
        smpl=save_synthetic_smpl_pickle(str(root / "smpl.pkl"), 128),
        humanact12=make_synthetic_humanact12(str(root / "ha12"), n_clips=12),
        genea2023=make_synthetic_genea2023(str(root / "g2023"), n_takes=3, frames_per_take=240,
                                           pose_dim=24, seed=1),
        # 32 clips a split: one protocol batch
        humanml=make_synthetic_humanml(str(root / "humanml"), n_clips=96, seed=1),
        kit=make_synthetic_humanml(str(root / "kit"), n_clips=96, dim=251, seed=2),
    )


def _evals(save_dir):
    """The eval rows of the run's progress.json."""
    with open(os.path.join(save_dir, "progress.json")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "eval/wall_s" in r]


def _train(monkeypatch, dataset, root, save_dir, *extra):
    """The train CLI with the hook, its calls recorded as (step, metrics)."""
    calls = []
    make = train_mdm.make_eval_fn

    def recording(*args, **kwargs):
        fn = make(*args, **kwargs)

        def eval_fn(state, step):
            out = fn(state, step)
            calls.append((step, state.model.training, out))  # the mode it hands back
            return out

        return eval_fn

    monkeypatch.setattr(train_mdm, "make_eval_fn", recording)
    loop = train_mdm.main([*TINY, "--dataset", dataset, "--data_dir", root, "--save_dir",
                           save_dir, "--eval_during_training", *extra])
    return loop, calls


def test_a2m_benchmark_runs_at_every_save(roots, tmp_path, monkeypatch):
    """humanact12: the GRU benchmark after the saves at steps 2 and 4 (5
    steps, save_interval 2), 8 samples in batches of 4, one seed."""
    monkeypatch.setenv("SMPL_MODEL_PATH", roots["smpl"])
    save_dir = str(tmp_path / "run")
    loop, calls = _train(monkeypatch, "humanact12", roots["humanact12"], save_dir,
                         "--num_frames", "60", "--diffusion_steps", "4", "--cond_mask_prob", "0")
    assert [step for step, _, _ in calls] == [2, 4] and loop.state.step == 5
    assert all(training for _, training, _ in calls)  # handed back in train mode
    for _, _, metrics in calls:
        assert {"accuracy_gen", "fid_gen", "diversity_gt", "multimodality_gen"} <= set(metrics)
    rows = _evals(save_dir)
    assert len(rows) == 2 and all(r["eval/wall_s"] > 0 for r in rows)
    assert rows[1]["eval/fid_gen"] == calls[1][2]["fid_gen"]


def test_a2m_without_smpl_falls_back_to_the_val_loss(roots, tmp_path, monkeypatch):
    monkeypatch.setenv("SMPL_MODEL_PATH", str(tmp_path / "absent.pkl"))
    loop, calls = _train(monkeypatch, "humanact12", roots["humanact12"], str(tmp_path / "run"),
                         "--num_frames", "60", "--diffusion_steps", "4", "--cond_mask_prob", "0")
    assert [(step, set(m)) for step, _, m in calls] == [(2, {"val_loss"}), (4, {"val_loss"})]


def test_gesture_val_loss_is_logged_and_repeatable(roots, tmp_path, monkeypatch):
    """genea2023: the validation loss over ceil(8 / 4) = 2 batches of the
    val split, after each in-loop save; the hook called again on the final
    weights gives the same value twice (timesteps and noise drawn from a
    generator seeded alike at every call)."""
    save_dir = str(tmp_path / "run")
    loop, calls = _train(monkeypatch, "genea2023", roots["genea2023"], save_dir,
                         "--num_frames", "40")
    assert [step for step, _, _ in calls] == [2, 4]
    rows = _evals(save_dir)
    assert [r["eval/val_loss"] for r in rows] == [m["val_loss"] for _, _, m in calls]
    again = [loop.eval_fn(loop.state, 5)["val_loss"] for _ in range(2)]
    assert again[0] == again[1] and again[0] > 0
    assert loop.state.model.training


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("dataset", ["humanml", "kit"])
def test_text_datasets_raise_naming_a8b(roots, dataset, tmp_path, monkeypatch):
    """Since ROADMAP A8b the flag no longer raises on the text datasets: the
    text benchmark (eval_humanml.make_training_eval_fn, scale 1) runs after
    the saves at steps 2 and 4 over --eval_split's 32 clips, one
    replication, its log beside the checkpoints; R-precision as _top1..3."""
    save_dir = str(tmp_path / "run")
    loop, calls = _train(monkeypatch, dataset, roots[dataset], save_dir,
                         "--diffusion_steps", "4", "--eval_num_samples", "32",
                         "--eval_split", "val")
    assert [step for step, _, _ in calls] == [2, 4] and loop.state.step == 5
    assert all(training for _, training, _ in calls)
    for _, _, metrics in calls:
        assert {"FID_vald", "Diversity_ground truth", "Matching Score_vald",
                "R_precision_vald_top3"} <= set(metrics)
        assert all(np.isfinite(v) for v in metrics.values())
    rows = _evals(save_dir)
    assert [r["eval/FID_vald"] for r in rows] == [m["FID_vald"] for _, _, m in calls]
    assert os.path.exists(os.path.join(save_dir, "eval_humanml_000000004.log"))
    assert train_args(["--save_dir", save_dir, "--dataset", dataset]).eval_split == "test"


def test_eval_flags_parse_with_jax_defaults(tmp_path):
    args = train_args(["--save_dir", str(tmp_path / "x")])
    assert (args.eval_batch_size, args.eval_rep_times,
            args.eval_num_samples) == (32, 3, 1000)
    assert not args.eval_during_training


def test_full_f32_switches_tf32_off_and_restores_the_settings():
    """The evaluation's guard around its device work: both TF32 switches
    off inside, whatever they were, and as they were after."""
    from gesturediffusion_tpu_torch.utils.device import full_f32

    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for setting in ((False, True), (True, True), (True, False)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = setting
            with full_f32():
                assert not (torch.backends.cuda.matmul.allow_tf32
                            or torch.backends.cudnn.allow_tf32)
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == setting
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
