"""The port's train, generate and demo CLIs on the CPU (``--device cpu``) on
synthetic GENEA trees, against the JAX package's CLIs on the same tree and
the same checkpoint (the two read one ``model*.pt`` layout).  Generated
motion comes from each package's own generator, so the comparison is of
what does not depend on it: the files written (but the JAX CLI's video,
which the port does not write yet), ``results.npy``'s keys, lengths and
text, and the ground-truth BVH and audio, which must be the same bytes."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from gesturediffusion_tpu.sample import generate as jax_generate
from gesturediffusion_tpu.serve import demo as jax_demo
from gesturediffusion_tpu_torch.data.genea import Genea2023
from gesturediffusion_tpu_torch.data.synthetic import (
    make_synthetic_genea2022,
    make_synthetic_genea2023,
)
from gesturediffusion_tpu_torch.sample import generate
from gesturediffusion_tpu_torch.serve import demo
from gesturediffusion_tpu_torch.train import train_mdm

POSE, FRAMES = 24, 40
TINY = ["--layers", "1", "--latent_dim", "32", "--num_frames", str(FRAMES)]
VIDEO = (".mp4", ".gif")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A checkpoint trained by the port's train CLI on the genea2023 tree's
    train split, and the trees."""
    root = tmp_path_factory.mktemp("cli")
    trees = {
        "genea2023": make_synthetic_genea2023(str(root / "g2023"), n_takes=3,
                                              frames_per_take=240, pose_dim=POSE, seed=1),
        "genea2022": make_synthetic_genea2022(str(root / "g2022"), n_takes=3,
                                              frames_per_take=240, pose_dim=POSE, seed=1),
    }
    save = str(root / "run")
    train_mdm.main(["--device", "cpu", "--dataset", "genea2023", "--data_dir",
                    trees["genea2023"], "--save_dir", save, "--batch_size", "4",
                    "--num_steps", "2", "--use_fused_train_encoder", *TINY])
    return root, trees, os.path.join(save, "model000000002.pt")


@pytest.fixture
def no_video(monkeypatch):
    """Neither generate CLI draws its stick-figure videos (test_torch_viz.py
    holds them): the JAX CLI's is skipped through its own fallback for a
    headless machine, the port's renderer draws nothing."""
    def skip(*args, **kwargs):
        raise RuntimeError("video not compared")

    monkeypatch.setattr("gesturediffusion_tpu.viz.plot.plot_3d_motion", skip)
    monkeypatch.setattr("gesturediffusion_tpu_torch.viz.plot.plot_3d_motion",
                        lambda *args, **kwargs: None)


def _files(path):
    return sorted(f for f in os.listdir(path) if not f.endswith(VIDEO))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _results(path):
    return np.load(os.path.join(path, "results.npy"), allow_pickle=True).item()


def test_train_cli_reads_the_train_split(run, tmp_path):
    _, trees, _ = run
    argv = ["--device", "cpu", "--data_dir", trees["genea2023"], "--save_dir",
            str(tmp_path / "run"), "--batch_size", "4", "--num_steps", "1", *TINY]
    loop = train_mdm.main(argv)  # --dataset genea2023, the default
    assert loop.state.step == 1
    assert os.path.exists(tmp_path / "run" / "model000000001.pt")
    with open(tmp_path / "run" / "args.json") as f:
        args = json.load(f)
    assert (args["dataset"], args["data_dir"]) == ("genea2023", trees["genea2023"])


def test_train_cli_refuses_a_dataset_without_seed_poses(run, tmp_path):
    """Genea2022 loads (its loader is held against JAX's in
    test_torch_genea_data.py) but has no seed poses, on which the model
    conditions; the JAX CLI fails on it inside the model."""
    _, trees, _ = run
    with pytest.raises(ValueError, match="no seed poses"):
        train_mdm.main(["--device", "cpu", "--dataset", "genea2022", "--data_dir",
                        trees["genea2022"], "--save_dir", str(tmp_path / "run"),
                        "--batch_size", "4", "--num_steps", "1", *TINY])


def test_generate_cli_writes_what_jax_writes(run, tmp_path, no_video):
    _, trees, ckpt = run
    argv = ["--model_path", ckpt, "--num_samples", "3", "--timestep_respacing", "2"]
    port = generate.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    jax = jax_generate.main(argv + ["--output_dir", str(tmp_path / "jax")])
    assert _files(port) == _files(jax)
    takes = [f[: -len("_gt.bvh")] for f in _files(jax) if f.endswith("_gt.bvh")]
    assert len(takes) == 3
    for take in takes:
        for suffix in ("_gt.bvh", ".wav"):
            assert _bytes(os.path.join(port, take + suffix)) == \
                _bytes(os.path.join(jax, take + suffix)), take + suffix
    got, want = _results(port), _results(jax)
    assert sorted(got) == sorted(want)
    assert got["text"] == want["text"]
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    chunks = (240 - FRAMES) // FRAMES  # the val split's step is the window
    assert (got["num_samples"], got["num_chunks"]) == (want["num_samples"],
                                                        want["num_chunks"]) == (3, chunks)
    assert got["motion"].shape == want["motion"].shape == (3, POSE // 6, 3, chunks * FRAMES)
    assert np.isfinite(got["motion"]).all()
    for name in ("results.txt", "results_len.txt"):
        assert _bytes(os.path.join(port, name)) == _bytes(os.path.join(jax, name))


def _val_wav(trees, path):
    """A 22050 Hz int16 wav of the first val take's audio."""
    ds = Genea2023(trees["genea2023"], split="val")
    audio = np.load(os.path.join(ds.audiopath, ds.takes[0] + ".npy"))
    wavfile.write(path, 22050, (audio * 32767).astype(np.int16))
    return path


@pytest.mark.parametrize("feeder", ["dataset", "wav"])
def test_demo_cli_writes_what_jax_writes(run, tmp_path, feeder):
    _, trees, ckpt = run
    argv = ["--model_path", ckpt, "--streams", "2", "--num_chunks", "3", "--sampler", "ddim",
            "--sample_steps", "2"]
    if feeder == "wav":
        argv += ["--wav", _val_wav(trees, str(tmp_path / "take.wav"))]
    port = demo.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    jax = jax_demo.main(argv + ["--output_dir", str(tmp_path / "jax")])
    assert _files(port) == _files(jax) == ["results.npy", "serving_report.json",
                                           "stream_0.bvh", "stream_1.bvh"]
    got, want = _results(port), _results(jax)
    assert sorted(got) == sorted(want)
    assert got["text"] == want["text"]
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert got["motion"].shape == want["motion"].shape == (2, POSE // 6, 3, 3 * FRAMES)
    assert np.isfinite(got["motion"]).all()
    assert sorted(got["serving_report"]) == sorted(want["serving_report"])
    for key in ("streams", "chunks_served", "sampler", "sample_steps"):
        assert got["serving_report"][key] == want["serving_report"][key]
    with open(os.path.join(port, "serving_report.json")) as f:
        assert json.load(f) == got["serving_report"]


def test_generate_refuses_overlapping_windows_as_jax_does(run, tmp_path):
    """Genea2022's windows step 30 frames: chunks of 40 would overlap."""
    _, trees, ckpt = run
    ckpt_dir = tmp_path / "g2022"
    ckpt_dir.mkdir()
    shutil.copy(ckpt, ckpt_dir / "model000000002.pt")
    with open(os.path.join(os.path.dirname(ckpt), "args.json")) as f:
        args = json.load(f)
    args.update(dataset="genea2022", data_dir=trees["genea2022"])
    with open(ckpt_dir / "args.json", "w") as f:
        json.dump(args, f)
    argv = ["--model_path", str(ckpt_dir / "model000000002.pt"), "--num_samples", "2",
            "--output_dir", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as want:
        jax_generate.main(argv)
    with pytest.raises(SystemExit) as got:
        generate.main(argv + ["--device", "cpu"])
    assert "non-overlapping windows" in str(got.value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cli", [generate, demo])
def test_clis_need_the_card_unless_asked_for_the_cpu(run, tmp_path, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model_path", run[2], "--output_dir", str(tmp_path / "out")])
