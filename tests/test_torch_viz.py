"""Port parity of the mesh export and the stick-figure videos against the
JAX package on the CPU: the pose priors (viz/prior.py), the SMPLify fit
(viz/joints2smpl.py: the stage objectives and their gradients at one
state, a whole two-stage fit, the rot6d ``_rot.npy`` CLI), ``Npy2Obj``'s
OBJ vertices on both routes and the render-mesh CLI (viz/vis_utils.py),
the HumanIK JSON (viz/motions2hik.py), the stick-figure GIF (viz/plot.py)
and the videos of the generate and edit CLIs.

A synthetic SMPL at 128 vertices and the synthetic GMM (8 components of
69) are written as pickles both packages read; the motions are SMPL joints
of numpy-drawn poses, 3 repetitions of 6 frames; each fit runs ITERS Adam
steps a stage.  The JAX fits share one compiled runner (same shapes, the
same cached prior) through module-scoped fixtures.

Tolerances: the objectives rtol 1e-6 and their gradients 1e-6 of the
gradient's max (measured ~1e-7: one float32 chain in another order); a fit
of ITERS steps a stage, the poses and translations atol 1e-4 (measured
1.6e-5 on such a fit: Adam divides each gradient by its own size, so a
rounding difference moves a step by up to lr where a gradient is tiny;
at 150 steps a stage the poses part by up to 2.7e-2 while the keypoint
error agrees to 6e-4 of itself); vertices and joints derived from the fits
atol 1e-4, the rot6d route's vertices 1e-5; HumanIK's Euler degrees 1e-2.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.models import smpl as js
from gesturediffusion_tpu.viz import joints2smpl as jj
from gesturediffusion_tpu.viz import motions2hik as jhik
from gesturediffusion_tpu.viz import plot as jplot
from gesturediffusion_tpu.viz import prior as jpr
from gesturediffusion_tpu.viz import vis_utils as jvis
from gesturediffusion_tpu_torch.models import smpl as ps
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.sample import edit, generate
from gesturediffusion_tpu_torch.utils import paramutil
from gesturediffusion_tpu_torch.viz import joints2smpl as pj
from gesturediffusion_tpu_torch.viz import motions2hik as phik
from gesturediffusion_tpu_torch.viz import plot as pplot
from gesturediffusion_tpu_torch.viz import prior as ppr
from gesturediffusion_tpu_torch.viz import vis_utils as pvis

NV, T, REPS, ITERS = 128, 6, 3, 8
RTOL_OBJ = 1e-6
TOL_GRAD = 1e-6
ATOL_FIT = 1e-4
ATOL_ROT = 1e-5
ATOL_DEG = 1e-2


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The SMPL and GMM pickles, both packages' models and priors, and one
    results.npy of xyz joints [REPS, 22, 3, T] in a directory of each
    package's (their CLIs write beside it)."""
    root = tmp_path_factory.mktemp("viz")
    smpl_path = ps.save_synthetic_smpl_pickle(str(root / "smpl.pkl"), NV)
    gmm_path = str(root / "gmm.pkl")
    with open(gmm_path, "wb") as f:
        pickle.dump(ppr.make_synthetic_gmm(), f)
    pm = ps.load_smpl_pickle(smpl_path)
    rs = np.random.RandomState(0)
    pose = torch.as_tensor(rs.randn(REPS * T, 24, 3) * 0.3, dtype=torch.float32)
    transl = torch.as_tensor(rs.randn(REPS * T, 3) * 0.2, dtype=torch.float32)
    joints = pj.fk_joints(pm, pose, transl).numpy()[:, :22].reshape(REPS, T, 22, 3)
    joints = joints + (rs.randn(*joints.shape) * 0.01).astype(np.float32)
    npys = {}
    for pkg in ("jax", "port"):
        os.makedirs(root / pkg)
        npys[pkg] = str(root / pkg / "results.npy")
        np.save(npys[pkg], {"motion": joints.transpose(0, 2, 3, 1), "text": ["walk"] * REPS,
                            "lengths": np.full(REPS, T), "num_samples": 1,
                            "num_repetitions": REPS})
    return dict(root=root, smpl_path=smpl_path, gmm_path=gmm_path, npys=npys,
                joints=joints, jm=js.load_smpl_pickle(smpl_path), pm=pm,
                jprior=jpr.load_gmm_prior(gmm_path), pprior=ppr.load_gmm_prior(gmm_path))


@pytest.fixture(scope="module")
def fit_env(env):
    """GMM_PRIOR_PATH at the synthetic GMM; no mean-pose file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GMM_PRIOR_PATH", env["gmm_path"])
        mp.setenv("SMPL_MEAN_PATH", str(env["root"] / "absent.h5"))
        yield env


@pytest.fixture(scope="module")
def jax_outputs(fit_env):
    """Every JAX fit the tests compare with: one joints2smpl, npy2smpl's
    _rot.npy, motions2hik's JSON, Npy2Obj on both routes."""
    env = fit_env
    motions = env["joints"].transpose(0, 2, 3, 1)
    rot_path = jj.npy2smpl(env["npys"]["jax"], env["jm"], num_smplify_iters=ITERS)
    return dict(
        fit=jj.joints2smpl(env["jm"], env["joints"][0], num_smplify_iters=ITERS),
        rot=np.load(rot_path, allow_pickle=True).item(),
        hik=jhik.motions2hik(motions, env["jm"], num_smplify_iters=ITERS),
        obj_xyz=jvis.Npy2Obj(env["npys"]["jax"], 0, 1, env["jm"], num_smplify_iters=ITERS),
        obj_rot=jvis.Npy2Obj(rot_path, 0, 2, env["jm"]),
        rot_path=rot_path,
    )


def _close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def test_priors_and_gmof_match_jax(env, tmp_path):
    """MaxMixturePrior (its float64-built tables and the NLL), the angle
    prior and gmof; the GMM loader's cache and its absent-file None."""
    want, got = jpr.make_synthetic_gmm(seed=3), ppr.make_synthetic_gmm(seed=3)
    for k in ("means", "covars", "weights"):
        np.testing.assert_array_equal(got[k], want[k])
    jp, pp = env["jprior"], env["pprior"]
    for name in ("means", "precisions", "nll_weights"):
        np.testing.assert_array_equal(getattr(pp, name).numpy(), getattr(jp, name))
    assert ppr.load_gmm_prior(env["gmm_path"]) is pp
    assert ppr.load_gmm_prior(str(tmp_path / "absent.pkl")) is None
    assert pp.to("cpu") is pp
    body = (np.random.RandomState(4).randn(5, 69) * 0.4).astype(np.float32)
    _close(pp(torch.from_numpy(body)), jp(jnp.asarray(body)), 0, RTOL_OBJ)
    _close(ppr.angle_prior(torch.from_numpy(body)), jpr.angle_prior(jnp.asarray(body)), 0,
           RTOL_OBJ)
    x = np.linspace(-300, 300, 41).astype(np.float32)
    _close(pj.gmof(torch.from_numpy(x), pj.GMOF_SIGMA), jj.gmof(jnp.asarray(x), jj.GMOF_SIGMA),
           0, RTOL_OBJ)


def _jax_objective(env, target, subset, conf, prior, fit_pose):
    """JAX's stage objective, as gesturediffusion_tpu/viz/joints2smpl.py:
    run_stage.objective (:120-141) composes it from the package's parts."""
    def objective(params):
        pose, transl = params
        err = jj._fk_joints(env["jm"], pose, transl)[:, subset] - target[:, subset]
        if not fit_pose:
            return jnp.mean(jnp.sum(err ** 2, -1))
        joint_loss = (jj.JOINT_LOSS_WEIGHT ** 2) * jnp.sum(
            (conf ** 2)[None, :] * jnp.sum(jj.gmof(err, jj.GMOF_SIGMA), -1), -1)
        body = pose[:, 1:].reshape(pose.shape[0], -1)
        ang = (jj.ANGLE_PRIOR_WEIGHT ** 2) * jnp.sum(jpr.angle_prior(body), -1)
        pp = (jj.POSE_PRIOR_WEIGHT ** 2) * (prior(body) if prior is not None
                                             else jnp.sum(body ** 2, -1))
        return jnp.sum(joint_loss + ang + pp)
    return objective


@pytest.mark.parametrize("stage", ["body, GMM prior", "body, L2 prior", "global"])
def test_stage_objectives_and_gradients_match_jax(env, stage):
    """Each stage's objective and its gradient at one shared state, with the
    fix_foot confidences."""
    fit_pose, gmm = stage.startswith("body"), stage.endswith("GMM prior")
    rs = np.random.RandomState(7)
    pose = (rs.randn(T, 24, 3) * 0.2).astype(np.float32)
    transl = (rs.randn(T, 3) * 0.1).astype(np.float32)
    target, subset, conf = pj.fit_inputs(env["joints"][1], "cpu", fix_foot=True)
    assert sorted(conf.numpy().tolist()).count(1.5) == 4
    want, (gp, gt) = jax.value_and_grad(_jax_objective(
        env, jnp.asarray(target.numpy()), np.asarray(subset), jnp.asarray(conf.numpy()),
        env["jprior"] if gmm else None, fit_pose))((jnp.asarray(pose), jnp.asarray(transl)))
    tp = torch.from_numpy(pose).requires_grad_(True)
    tt = torch.from_numpy(transl).requires_grad_(True)
    got = pj.stage_objective(env["pm"], tp, tt, target, subset, conf,
                             env["pprior"] if gmm else None, fit_pose)
    got.backward()
    _close(got.detach(), want, 0, RTOL_OBJ)
    gmax = max(np.abs(gp).max(), np.abs(gt).max())
    _close(tp.grad, gp, TOL_GRAD * gmax)
    _close(tt.grad, gt, TOL_GRAD * gmax)


def test_two_stage_fit_matches_jax(fit_env, jax_outputs):
    """joints2smpl from the zero pose under the GMM prior: poses,
    translations and each stage's keypoint error; stage 1 leaves the body
    rows of the pose at zero; a fit that starts from a given pose."""
    env, want = fit_env, jax_outputs["fit"]
    got = pj.joints2smpl(env["pm"], env["joints"][0], num_smplify_iters=ITERS, device="cpu")
    _close(got["thetas"], want["thetas"], ATOL_FIT)
    _close(got["root_translation"], want["root_translation"], ATOL_FIT)
    _close(got["loss"], want["loss"], 0, 1e-4)
    assert got["loss"][1] < got["loss"][0]
    target, subset, conf = pj.fit_inputs(env["joints"][0], "cpu")
    pose0, transl0 = pj.initial_params(env["pm"], target)
    pose1, _, _ = pj.fit_stage(env["pm"], target, subset, conf, pose0, transl0,
                               fit_pose=False, num_iters=3)
    assert torch.equal(pose1[:, 1:], pose0[:, 1:]) and not torch.equal(pose1[:, 0], pose0[:, 0])
    init = (np.random.RandomState(8).randn(T, 24, 3) * 0.05).astype(np.float32)
    _close(pj.joints2smpl(env["pm"], env["joints"][0], num_smplify_iters=2, init_pose=init,
                          device="cpu")["thetas"],
           jj.joints2smpl(env["jm"], env["joints"][0], num_smplify_iters=2,
                          init_pose=init)["thetas"], ATOL_FIT)


def test_rot_npy_cli_and_hik_json_match_jax(fit_env, jax_outputs):
    """The joints2smpl CLI's _rot.npy ([N, 25, 6, T]: rot6d rows, the root's
    xyz in row 24, the other keys passed through) and motions2hik's JSON."""
    env, want = fit_env, jax_outputs
    (out,) = pj.main(["--input_path", env["npys"]["port"], "--num_smplify_iters", str(ITERS),
                      "--smpl_model", env["smpl_path"], "--device", "cpu"])
    assert out == env["npys"]["port"][:-4] + "_rot.npy"
    got = np.load(out, allow_pickle=True).item()
    assert sorted(got) == sorted(want["rot"])
    assert got["motion"].shape == want["rot"]["motion"].shape == (REPS, 25, 6, T)
    _close(got["motion"], want["rot"]["motion"], ATOL_FIT)
    np.testing.assert_array_equal(got["motion"][:, 24, :3],
                                  env["joints"][:, :, 0].transpose(0, 2, 1))
    assert not got["motion"][:, 24, 3:].any()
    assert got["text"] == want["rot"]["text"] and got["num_repetitions"] == REPS
    with pytest.raises(ValueError, match="xyz motions"):
        pj.npy2smpl(out, env["pm"], device="cpu")

    hik = phik.motions2hik(env["joints"].transpose(0, 2, 3, 1), env["pm"],
                           num_smplify_iters=ITERS, device="cpu")
    json.dumps(hik)
    assert {k: hik[k] for k in ("joint_map", "num_repetitions", "num_frames")} == \
        {k: want["hik"][k] for k in ("joint_map", "num_repetitions", "num_frames")}
    assert len(hik["frames"]) == REPS and len(hik["frames"][0]) == T
    for rep_got, rep_want in zip(hik["frames"], want["hik"]["frames"]):
        for f_got, f_want in zip(rep_got, rep_want):
            assert sorted(f_got) == sorted(f_want)
            for name in f_want:
                _close(f_got[name], f_want[name],
                       ATOL_FIT if name == "HipsTranslation" else ATOL_DEG)


def _obj_vertices(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return (np.asarray([[float(x) for x in l.split()[1:]] for l in lines if l.startswith("v ")]),
            [l for l in lines if l.startswith("f ")])


def test_npy2obj_both_routes_match_jax(fit_env, jax_outputs, tmp_path):
    """The xyz route (a fit of repetition 1) and the rot6d route (sample 2
    of JAX's _rot.npy): the parsed OBJ vertices, the thetas and
    smpl_params.npy; write_obj's bytes are JAX's for the same arrays."""
    env, want = fit_env, jax_outputs
    for route, args, atol in (("xyz", (env["npys"]["port"], 0, 1), ATOL_FIT),
                              ("rot6d", (want["rot_path"], 0, 2), ATOL_ROT)):
        conv = pvis.Npy2Obj(*args, env["pm"], num_smplify_iters=ITERS, device="cpu")
        ref = want["obj_" + ("xyz" if route == "xyz" else "rot")]
        assert conv.vertices.shape == (T, NV, 3)
        for i in (0, T - 1):
            got_v, _ = _obj_vertices(conv.save_obj(str(tmp_path / f"port{i}.obj"), i))
            want_v, _ = _obj_vertices(ref.save_obj(str(tmp_path / f"jax{i}.obj"), i))
            _close(got_v, want_v, atol + 1e-6)  # 6 decimals in the file
        _close(conv.thetas, ref.thetas, atol)
        conv.save_npy(str(tmp_path / "params.npy"))
        params = np.load(str(tmp_path / "params.npy"), allow_pickle=True).item()
        assert params["motion"].shape == (1, 24, 3, T) and params["num_frames"] == T
    faces = np.random.RandomState(11).randint(0, NV, (30, 3)).astype(np.uint32)
    for pkg in (pvis, jvis):
        pkg.write_obj(str(tmp_path / f"{pkg.__name__}.obj"), want["obj_rot"].vertices[1], faces)
    with open(tmp_path / f"{pvis.__name__}.obj", "rb") as a, \
            open(tmp_path / f"{jvis.__name__}.obj", "rb") as b:
        assert a.read() == b.read()


def test_render_mesh_cli_writes_objs_with_the_pickles_faces(fit_env, tmp_path):
    """One OBJ a frame with the SMPL pickle's triangles, and smpl_params.npy."""
    env = fit_env
    with open(env["smpl_path"], "rb") as f:
        data = pickle.load(f)
    faces = np.random.RandomState(9).randint(0, NV, (40, 3))
    with open(tmp_path / "smpl_f.pkl", "wb") as f:
        pickle.dump({**data, "f": faces.astype(np.uint32)}, f)
    np.save(tmp_path / "results.npy", np.load(env["npys"]["port"], allow_pickle=True).item())
    conv = pvis.main(["--input_path", str(tmp_path / "results.npy"), "--rep_idx", "2",
                      "--num_smplify_iters", "2", "--smpl_model", str(tmp_path / "smpl_f.pkl"),
                      "--device", "cpu"])
    out = tmp_path / "results_obj"
    assert sorted(os.listdir(out)) == [f"frame{i:03d}.obj" for i in range(T)] + ["smpl_params.npy"]
    verts, face_lines = _obj_vertices(out / "frame005.obj")
    _close(verts, conv.vertices[5], 1e-6)
    assert face_lines[0] == "f {} {} {}".format(*(faces[0] + 1)) and len(face_lines) == 40
    assert pvis.smpl_faces(env["smpl_path"]) is None


def test_plot_writes_the_jax_gif(tmp_path):
    """plot_3d_motion's GIF, frame for frame the JAX package's, with the
    ground truth's frames tinted; an .mp4 name becomes a GIF without ffmpeg."""
    pytest.importorskip("matplotlib")
    from PIL import Image, ImageSequence

    joints = np.random.RandomState(10).randn(4, 22, 3) * 0.3
    kw = dict(dataset="humanml", title="a person", fps=20, vis_mode="in_between",
              gt_frames=[0, 3])
    paths = [pkg.plot_3d_motion(str(tmp_path / f"{name}.gif"), paramutil.t2m_kinematic_chain,
                                joints, **kw)
             for name, pkg in (("port", pplot), ("jax", jplot))]
    frames = [[np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(p))]
              for p in paths]
    assert len(frames[0]) == len(frames[1]) == 4
    for a, b in zip(*frames):
        np.testing.assert_array_equal(a, b)
    assert pplot._writer_for("x.mp4")[1] in ("ffmpeg", "pillow")


def test_render_or_log_swallows_only_a_missing_matplotlib(monkeypatch, tmp_path):
    logged = []
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    assert pplot.render_or_log(logged.append, str(tmp_path / "a.mp4"), [[0, 1]],
                               np.zeros((2, 2, 3))) is None
    assert logged == ["  (video skipped: import of matplotlib halted; None in sys.modules)"]
    for err in (ModuleNotFoundError("No module named 'PIL'", name="PIL"), ValueError("bad")):
        def fail(*args, err=err, **kwargs):
            raise err
        monkeypatch.setattr(pplot, "plot_3d_motion", fail)
        with pytest.raises(type(err)):
            pplot.render_or_log(logged.append, str(tmp_path / "a.mp4"), [[0, 1]], None)


def test_generate_cli_writes_each_takes_video(tmp_path):
    """The gesture generate CLI draws a take's GIF (no ffmpeg here) with the
    83-joint GENEA chains."""
    pytest.importorskip("matplotlib")
    from PIL import Image

    torch.manual_seed(0)
    run = tmp_path / "run"
    run.mkdir()
    torch.save(MDM(njoints=498, latent_dim=32, num_layers=1, cond_mask_prob=0.1).state_dict(),
               run / "model000000000.pt")
    with open(run / "args.json", "w") as f:
        json.dump({"dataset": "synthetic", "num_frames": 20, "layers": 1, "latent_dim": 32,
                   "cond_mask_prob": 0.1, "seed_poses": 10, "diffusion_steps": 2,
                   "noise_schedule": "cosine", "sigma_small": True}, f)
    out = generate.main(["--model_path", str(run / "model000000000.pt"), "--num_samples", "1",
                         "--device", "cpu", "--output_dir", str(tmp_path / "out")])
    videos = [f for f in os.listdir(out) if f.endswith((".gif", ".mp4"))]
    assert videos == ["take_0.gif"] or "take_0.mp4" in videos
    if videos == ["take_0.gif"]:
        assert Image.open(os.path.join(out, "take_0.gif")).n_frames == 20


def test_edit_cli_draws_each_text_sample_with_the_ground_truth_tinted(tmp_path, monkeypatch):
    """The humanml edit CLI draws a video a sample and repetition: the t2m
    chains, the clip's length, the in_between frames kept from the ground
    truth as gt_frames, the caption as title, 20 fps."""
    from gesturediffusion_tpu_torch.data.humanml import make_synthetic_humanml

    monkeypatch.delenv("CLIP_CHECKPOINT", raising=False)
    monkeypatch.delenv("CLIP_BPE_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(pplot, "plot_3d_motion",
                        lambda path, chains, joints, **kw: calls.append((path, chains, joints, kw)))
    hml = make_synthetic_humanml(str(tmp_path / "hml"), n_clips=6, seed=2)
    torch.manual_seed(0)
    run = tmp_path / "t2m"
    run.mkdir()
    torch.save(MotionMDM(latent_dim=32, num_layers=1).state_dict(), run / "model000000001.pt")
    with open(run / "args.json", "w") as f:
        json.dump({"dataset": "humanml", "data_dir": hml, "layers": 1, "latent_dim": 32,
                   "cond_mask_prob": 0.1, "diffusion_steps": 2,
                   "noise_schedule": "cosine", "sigma_small": True}, f)
    res = edit.run(["--model_path", str(run / "model000000001.pt"), "--num_samples", "2",
                    "--num_repetitions", "2", "--device", "cpu",
                    "--output_dir", str(tmp_path / "out")])
    results = np.load(os.path.join(res["out_path"], "results.npy"), allow_pickle=True).item()
    assert [os.path.basename(c[0]) for c in calls] == [
        "sample00_rep00.mp4", "sample01_rep00.mp4", "sample00_rep01.mp4", "sample01_rep01.mp4"]
    for k, (path, chains, joints, kw) in enumerate(calls):
        length = int(results["lengths"][k % 2])
        assert chains == paramutil.t2m_kinematic_chain and joints.shape == (length, 22, 3)
        np.testing.assert_array_equal(joints, results["motion"][k, :, :, :length].transpose(2, 0, 1))
        assert kw["gt_frames"] == list(range(int(length * 0.25))) + list(
            range(int(length * 0.75), length))
        assert (kw["fps"], kw["vis_mode"], kw["dataset"], kw["title"]) == (
            20, "in_between", "humanml", results["text"][k])
