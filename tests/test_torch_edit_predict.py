"""Port parity of motion editing and text-to-motion sampling against the
JAX package: the DDPM and DDIM loops with ``inpaint`` under the JAX chain's
own noise (replayed through ``noise_fn``: normal(fold_in(rng, num_steps))
for x_T, normal(fold_in(rng, i)) at timestep i; rtol 1e-4 / atol 2e-5,
float32 reassociation through 8 steps of a 2-layer MotionMDM), the kept
entries of an edit equal to the ground truth (at t = 0 the posterior mean
is x_start there), and the predict and edit CLIs of both packages run
in-process on one ``.pt``: the same files (but JAX's videos), results keys,
shapes, texts and lengths, and the same kept frames (xyz of the kept
prefix and of the lower body within rtol 2e-4 / atol 2e-5, the port's
standard: the same features through recover_from_ric, whose root
trajectory is a float32 cumulative sum over up to 196 frames, summed in
another order by XLA; raw gesture features within 1e-6).  The
refusals of the generate, serve and train CLIs for the text datasets."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.data.humanml_utils import HML_LOWER_BODY_JOINTS
from gesturediffusion_tpu.diffusion.gaussian import create_diffusion as jax_create_diffusion
from gesturediffusion_tpu.diffusion.sampling import (
    ddim_sample_loop as jax_ddim_loop,
    p_sample_loop as jax_p_loop,
)
from gesturediffusion_tpu.models.cfg import classifier_free_guidance as jax_cfg
from gesturediffusion_tpu.sample import edit as jax_edit
from gesturediffusion_tpu.sample import predict as jax_predict
from gesturediffusion_tpu.utils.convert_torch import save_torch_checkpoint
from gesturediffusion_tpu_torch.data.humanml import make_synthetic_humanml
from gesturediffusion_tpu_torch.data.synthetic import make_synthetic_genea2023
from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
from gesturediffusion_tpu_torch.diffusion.sampling import ddim_sample_loop, p_sample_loop
from gesturediffusion_tpu_torch.models.cfg import classifier_free_guidance
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.sample import edit, generate, predict
from gesturediffusion_tpu_torch.serve import demo
from tests.torch_port_common import (
    build_t2m_pair,
    threefry_prng,  # noqa: F401 (autouse fixture)
    to_jax,
    to_torch,
)

T, STEPS = 20, 8
VIDEO = (".mp4", ".gif")


@pytest.fixture
def no_clip_no_video(monkeypatch, tmp_path):
    """Both packages take the hash text embedder, and neither draws its
    stick-figure videos (test_torch_viz.py holds them): the JAX CLI's is
    skipped through its own fallback, the port's renderer draws nothing."""
    monkeypatch.delenv("CLIP_CHECKPOINT", raising=False)
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    monkeypatch.chdir(tmp_path)

    def skip(*args, **kwargs):
        raise RuntimeError("video not compared")

    monkeypatch.setattr("gesturediffusion_tpu.viz.plot.plot_3d_motion", skip)
    monkeypatch.setattr("gesturediffusion_tpu_torch.viz.plot.plot_3d_motion",
                        lambda *args, **kwargs: None)


def _inpaint_case(seed=0):
    rs = np.random.RandomState(seed)
    gt = rs.randn(3, 263, 1, T).astype(np.float32)
    mask = np.zeros((3, 263, 1, T), bool)
    mask[:, :, :, :5] = True   # a kept prefix
    mask[:, :40] = True        # and kept features
    text = rs.randn(3, 512).astype(np.float32)
    return gt, mask, text


@pytest.mark.parametrize("loop", ["ddpm", "ddim"])
def test_inpainting_loops_match_jax(loop):
    """Both loops with CFG at guidance 2.5 and inpainting, under JAX's noise."""
    jax_model, params, port = build_t2m_pair("text")
    gt, mask, text = _inpaint_case()
    cond = {"text_emb": text, "scale": np.full((3,), 2.5, np.float32)}
    shape = gt.shape
    jd = jax_create_diffusion(steps=40, timestep_respacing=str(STEPS))
    jfn = jax_cfg(lambda x, t, c: jax_model.apply(params, x, t, c), 0.1)
    jloop = jax_p_loop if loop == "ddpm" else jax_ddim_loop
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda r, c: jloop(
        jd, jfn, shape, r, c, inpaint=(jnp.asarray(mask), jnp.asarray(gt))))(rng, to_jax(cond)))

    def noise_fn(chunk, step, shp):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(rng, step), shp)))

    pd = create_diffusion(steps=40, timestep_respacing=str(STEPS), device="cpu")
    ploop = p_sample_loop if loop == "ddpm" else ddim_sample_loop
    got = ploop(pd, classifier_free_guidance(port, 0.1), shape, to_torch(cond),
                generator=torch.Generator(), noise_fn=noise_fn,
                inpaint=(torch.from_numpy(mask), torch.from_numpy(gt))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    # the kept entries are the ground truth: at t = 0 the posterior mean is
    # x_start, and x_start is imputed there
    np.testing.assert_allclose(got[mask], gt[mask], rtol=1e-6, atol=1e-6)
    assert np.abs(got[~mask] - gt[~mask]).max() > 1e-2  # the rest was generated


def test_inpainting_keeps_the_generator_draws():
    """Inpainting changes no draw: the chains' unkept entries start from the
    same x_T, and with an empty mask the chain is the plain one."""
    _, _, port = build_t2m_pair("no_cond")
    gt, _, _ = _inpaint_case(1)
    pd = create_diffusion(steps=40, timestep_respacing=str(STEPS), device="cpu")
    empty = torch.zeros(gt.shape, dtype=torch.bool)
    a = p_sample_loop(pd, port, gt.shape, {}, generator=torch.Generator().manual_seed(5),
                      inpaint=(empty, torch.from_numpy(gt)))
    b = p_sample_loop(pd, port, gt.shape, {}, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A text checkpoint written by JAX save_torch_checkpoint beside a
    humanml args.json, a gesture checkpoint beside a genea2023 one, and
    their trees."""
    root = tmp_path_factory.mktemp("edit")
    hml = make_synthetic_humanml(str(root / "hml"), n_clips=9, dim=263, seed=2)
    jax_model, params, _ = build_t2m_pair("text", ff_size=1024)
    t2m = os.path.join(root, "t2m", "model000000001.pt")
    os.makedirs(os.path.dirname(t2m))
    save_torch_checkpoint(t2m, params, jax_model)
    with open(os.path.join(root, "t2m", "args.json"), "w") as f:
        json.dump({"dataset": "humanml", "data_dir": hml, "layers": 2, "latent_dim": 64,
                   "cond_mask_prob": 0.1, "diffusion_steps": STEPS, "noise_schedule": "cosine",
                   "sigma_small": True}, f)
    genea = make_synthetic_genea2023(str(root / "genea"), n_takes=3, frames_per_take=240,
                                     pose_dim=24, seed=1)
    torch.manual_seed(0)
    gesture = os.path.join(root, "gesture", "model000000001.pt")
    os.makedirs(os.path.dirname(gesture))
    torch.save(MDM(njoints=24, latent_dim=32, num_layers=1, cond_mask_prob=0.1).state_dict(),
               gesture)
    with open(os.path.join(root, "gesture", "args.json"), "w") as f:
        json.dump({"dataset": "genea2023", "data_dir": genea, "layers": 1, "latent_dim": 32,
                   "num_frames": 40, "seed_poses": 10, "cond_mask_prob": 0.1,
                   "diffusion_steps": STEPS, "noise_schedule": "cosine", "sigma_small": True}, f)
    return {"t2m": t2m, "hml": hml, "gesture": gesture}


def _results(path):
    return np.load(os.path.join(path, "results.npy"), allow_pickle=True).item()


def _same_files(port, jax):
    files = sorted(f for f in os.listdir(jax) if not f.endswith(VIDEO))
    assert sorted(os.listdir(port)) == files
    for name in files:
        if name.endswith(".txt"):
            with open(os.path.join(port, name)) as a, open(os.path.join(jax, name)) as b:
                assert a.read() == b.read(), name


def test_predict_cli_writes_what_jax_writes(runs, tmp_path, no_clip_no_video, capsys):
    argv = ["--model_path", runs["t2m"], "--text", "a person jumps", "--num_repetitions", "2",
            "--motion_length", "2.5", "--latent_dim", "64", "--layers", "2", "--ff_size",
            "1024", "--diffusion_steps", str(STEPS), "--dataset_root", runs["hml"]]
    port = predict.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    port_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax = jax_predict.main(argv + ["--output_dir", str(tmp_path / "jax")])
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: v for k, v in port_line.items() if k != "output_dir"} == \
        {k: v for k, v in jax_line.items() if k != "output_dir"} == \
        {"frames": 50, "repetitions": 2}
    _same_files(port, jax)
    got, want = _results(port), _results(jax)
    assert sorted(got) == sorted(want)
    assert got["text"] == want["text"] == ["a person jumps"] * 2
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert got["num_samples"] == want["num_samples"] == 2
    assert got["motion"].shape == want["motion"].shape == (2, 22, 3, 50)
    assert np.isfinite(got["motion"]).all()


def test_predictor_matches_jax_under_its_noise(runs, no_clip_no_video):
    """The whole predict take (CFG, the hash text embedding, de-normalising
    and recover_from_ric) under JAX's noise: features within the port's
    rtol 2e-4 / atol 2e-5; xyz within rtol 2e-4 / atol 1e-4, because the
    root trajectory integrates the features' float32 error over the frames
    (a cumulative sum, summed in another order by XLA) and rotates it by
    the integrated yaw: ~5e-5 at 0.4% of the joints on this take."""
    jd = jax_create_diffusion(steps=STEPS, noise_schedule="cosine")
    from gesturediffusion_tpu.models.mdm_t2m import MotionMDM as JaxMotionMDM
    from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM

    kw = dict(njoints=263, latent_dim=64, ff_size=1024, num_layers=2, num_heads=4,
              cond_mode="text", cond_mask_prob=0.1)
    jp = jax_predict.Predictor(runs["t2m"], dataset_root=runs["hml"], num_frames=40,
                               model=JaxMotionMDM(**kw), diffusion=jd)
    want = jp.predict("a person jumps", num_repetitions=2, seed=4, motion_length=1.5)
    rng = jax.random.PRNGKey(4)

    def noise_fn(chunk, step, shp):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(rng, step), shp)))

    pp = predict.Predictor(runs["t2m"], dataset_root=runs["hml"], num_frames=40,
                           model=MotionMDM(**kw),
                           diffusion=create_diffusion(steps=STEPS, device="cpu"), device="cpu")
    got = pp.predict("a person jumps", num_repetitions=2, seed=4, motion_length=1.5,
                     noise_fn=noise_fn)
    assert got["length"] == want["length"] == 30 and got["prompt"] == want["prompt"]
    for k, atol in (("features", 2e-5), ("motion_xyz", 1e-4)):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=atol, err_msg=k)


@pytest.mark.parametrize("mode,text", [("in_between", ""), ("in_between", "a person jumps"),
                                       ("upper_body", "")])
def test_text_edit_cli_writes_what_jax_writes(runs, tmp_path, no_clip_no_video, mode, text):
    argv = ["--model_path", runs["t2m"], "--num_samples", "2", "--num_repetitions", "2",
            "--edit_mode", mode, "--text_condition", text, "--seed", "3"]
    res = edit.run(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    jax = jax_edit.main(argv + ["--output_dir", str(tmp_path / "jax")])
    port = res["out_path"]
    _same_files(port, jax)
    got, want = _results(port), _results(jax)
    assert sorted(got) == sorted(want)
    assert got["text"] == want["text"] and len(got["text"]) == 4
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert (got["num_samples"], got["num_repetitions"]) == (want["num_samples"],
                                                            want["num_repetitions"]) == (2, 2)
    assert got["motion"].shape == want["motion"].shape == (4, 22, 3, 196)
    # the kept entries are the ground truth in model space
    mask = np.tile(res["mask"], (2, 1, 1, 1))
    np.testing.assert_allclose(res["samples"][mask], np.tile(res["gt"], (2, 1, 1, 1))[mask],
                               rtol=1e-6, atol=1e-6)
    # and the joints they alone decide agree with JAX's: the kept prefix of
    # in_between (each frame reads the velocities before it), the lower
    # body of upper_body
    for i, length in enumerate(want["lengths"]):
        if mode == "in_between":
            a, b = got["motion"][i, ..., :int(length * 0.25)], want["motion"][i, ..., :int(length * 0.25)]
        else:
            a, b = got["motion"][i, HML_LOWER_BODY_JOINTS], want["motion"][i, HML_LOWER_BODY_JOINTS]
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


def test_gesture_edit_cli_writes_what_jax_writes(runs, tmp_path, no_clip_no_video):
    """in_between on a gesture checkpoint (the fast CFG path): raw features,
    the kept frames the ground truth in both packages."""
    argv = ["--model_path", runs["gesture"], "--num_samples", "3", "--num_repetitions", "1"]
    res = edit.run(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    jax = jax_edit.main(argv + ["--output_dir", str(tmp_path / "jax")])
    _same_files(res["out_path"], jax)
    got, want = _results(res["out_path"]), _results(jax)
    assert sorted(got) == sorted(want)
    assert got["text"] == want["text"]
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    assert got["motion"].shape == want["motion"].shape == (3, 24, 1, 40)
    mask = res["mask"]
    np.testing.assert_allclose(got["motion"][mask], res["gt"][mask], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want["motion"][mask], res["gt"][mask], rtol=1e-6, atol=1e-6)


def test_text_datasets_are_refused_where_they_do_not_belong(runs, tmp_path):
    """generate (the gesture generator, JAX generate.py:109-120) and the
    serve demo name sample.predict for a text checkpoint, and refuse an
    action-to-motion checkpoint too (no audio takes), as JAX's generate
    does; the train CLI trains both kinds since A11 and A12."""
    for cli in (generate, demo):
        with pytest.raises(SystemExit, match="sample.predict"):
            cli.main(["--model_path", runs["t2m"], "--device", "cpu"])
    a2m = tmp_path / "a2m"
    a2m.mkdir()
    with open(a2m / "args.json", "w") as f:
        json.dump({"dataset": "humanact12", "layers": 2, "latent_dim": 64}, f)
    for cli in (generate, demo):
        with pytest.raises(SystemExit, match="--dataset humanact12 has no audio takes"):
            cli.main(["--model_path", str(a2m / "model000000001.pt"), "--device", "cpu"])
