"""Port parity of utils/export_torch.py against the JAX package's CLI on
the CPU.

One set of JAX variables and an EMA tree (the variables perturbed by a
seeded numpy draw) are saved as a JAX run (an Orbax checkpoint with
``params`` and ``ema_params`` beside an ``args.json``) and, carried across
through the JAX package's own exporter (utils/convert_torch.py), as a port
run (``model*.pt``, and ``opt*.pt`` whose ``ema`` is keyed by
``named_parameters()``).  Both CLIs export each run with and without
``--ema``; the files are equal tensor by tensor, exactly, for the gesture
MDM on MFCCs, the wav-encoder MDM (its BatchNorm statistics from the model
file, not the EMA), the text MotionMDM and the action MotionMDM (whose
state dict folds the action Dense's bias into its rows).  Then the
refusals, and the EMA of the port's own train loop through the export to
the generate CLI.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.utils import export_torch as jax_export
from gesturediffusion_tpu.utils.convert_torch import (
    export_mdm_state_dict,
    export_motion_mdm_state_dict,
)
from gesturediffusion_tpu.utils.model_factory import create_model as jax_create_model
from gesturediffusion_tpu_torch.utils import export_torch
from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
from gesturediffusion_tpu_torch.utils.model_factory import create_model
from tests.torch_port_common import threefry

T, S, STEP = 20, 3, 7
BASE = dict(arch="trans_enc", layers=1, latent_dim=32, cond_mask_prob=0.1, seed_poses=S,
            unconstrained=False, use_text=False, use_audio=False, mfcc_input=False,
            use_wav_enc=False)
CASES = {
    "gesture_mfcc": dict(dataset="synthetic", mfcc_input=True),
    "gesture_wav": dict(dataset="synthetic", use_wav_enc=True),
    "text": dict(dataset="humanml"),
    "action": dict(dataset="humanact12"),
}


def _init(case: str, model):
    """JAX variables of ``model`` from seeded inputs, as float32 numpy,
    with non-trivial BatchNorm statistics and action bias."""
    rs = np.random.RandomState(0)
    if case.startswith("gesture"):
        x = rs.randn(1, model.njoints, 1, T)
        cond = {"seed": rs.randn(1, model.njoints, 1, S)}
        cond.update({"audio": rs.randn(1, 16000)} if case == "gesture_wav"
                    else {"mfcc": rs.randn(1, 26, 1, T)})
    else:
        x = rs.randn(1, model.njoints, model.nfeats, T)
        cond = ({"text_emb": rs.randn(1, 512)} if case == "text"
                else {"action": np.array([3], np.int32)})
    cond = {k: jnp.asarray(v, jnp.int32 if k == "action" else jnp.float32)
            for k, v in cond.items()}
    with threefry():
        variables = model.init(jax.random.PRNGKey(1), jnp.asarray(x, jnp.float32),
                               jnp.zeros((1,), jnp.int32), cond)
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables)
    for leaf in jax.tree_util.tree_leaves(variables.get("batch_stats", {})):
        leaf += rs.rand(*leaf.shape).astype(np.float32)
    if case == "action":
        bias = variables["params"]["embed_action"]["bias"]
        bias[:] = rs.randn(*bias.shape) * 0.5
    return variables


def _port_model(args, jax_model, variables):
    """The port model holding ``variables``, its action kernel and bias
    apart as they train."""
    export = (export_mdm_state_dict if args.dataset == "synthetic"
              else export_motion_mdm_state_dict)
    model = create_model(args)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in export(variables, jax_model).items()})
    if args.dataset == "humanact12":
        model.embed_action.load_unfolded_state(
            {k: torch.from_numpy(v) for k, v in variables["params"]["embed_action"].items()})
    return model


def _runs(case: str, root):
    """A JAX run and a port run of one set of weights and one EMA; returns
    their checkpoint paths."""
    train_args = dict(BASE, **CASES[case])
    args = argparse.Namespace(**train_args)
    jax_model = jax_create_model(args)
    variables = _init(case, jax_model)
    rs = np.random.RandomState(1)
    ema = {"params": jax.tree_util.tree_map(
        lambda p: p + 0.01 * rs.randn(*p.shape).astype(np.float32), variables["params"])}

    jax_dir, port_dir = root / "jax", root / "port"
    for d in (jax_dir, port_dir):
        d.mkdir()
        (d / "args.json").write_text(json.dumps(train_args))
    import orbax.checkpoint as ocp

    jax_ckpt = jax_dir / f"model{STEP:09d}"
    ocp.PyTreeCheckpointer().save(str(jax_ckpt), {"params": variables, "ema_params": ema})

    port_ckpt = port_dir / f"model{STEP:09d}.pt"
    torch.save(_port_model(args, jax_model, variables).state_dict(), port_ckpt)
    ema_vars = dict(ema, **{k: v for k, v in variables.items() if k != "params"})
    ema_model = _port_model(args, jax_model, ema_vars)
    torch.save({"ema": {n: p.detach().clone() for n, p in ema_model.named_parameters()}},
               port_dir / f"opt{STEP:09d}.pt")
    return str(jax_ckpt), str(port_ckpt)


def _assert_same_file(got_path, want_path):
    got = torch.load(got_path, map_location="cpu", weights_only=True)
    want = torch.load(want_path, map_location="cpu", weights_only=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_export_matches_jax(case, tmp_path):
    jax_ckpt, port_ckpt = _runs(case, tmp_path)
    for ema in (False, True):
        flag = ["--ema"] if ema else []
        want = jax_export.main(["--model_path", jax_ckpt,
                                "--out", str(tmp_path / f"jax{ema}.pt")] + flag)
        got = export_torch.main(["--model_path", port_ckpt,
                                 "--out", str(tmp_path / f"port{ema}.pt")] + flag)
        _assert_same_file(got, want)
        if not ema:  # the model file itself, unchanged
            _assert_same_file(got, port_ckpt)
    if case == "gesture_wav":  # the statistics come from the model file, not the EMA
        sd = load_checkpoint(got)
        assert not torch.equal(sd["wav_encoder.feat_extractor.1.running_var"],
                               torch.ones_like(sd["wav_encoder.feat_extractor.1.running_var"]))
    if case == "action":  # the folded rows of the EMA's kernel and bias
        ema = torch.load(os.path.join(os.path.dirname(port_ckpt), f"opt{STEP:09d}.pt"),
                         weights_only=True)["ema"]
        assert torch.equal(load_checkpoint(got)["embed_action.action_embedding"],
                           ema["embed_action.action_embedding"] + ema["embed_action.bias"])


@pytest.mark.parametrize("case", ["no_args_json", "no_opt_file", "empty_ema"])
def test_export_refusals(case, tmp_path):
    model = create_model(argparse.Namespace(**dict(BASE, **CASES["gesture_mfcc"])))
    ckpt = tmp_path / f"model{STEP:09d}.pt"
    torch.save(model.state_dict(), ckpt)
    argv = ["--model_path", str(ckpt), "--out", str(tmp_path / "out.pt"), "--ema"]
    if case != "no_args_json":
        (tmp_path / "args.json").write_text(json.dumps(dict(BASE, **CASES["gesture_mfcc"])))
    if case == "empty_ema":
        torch.save({"ema": {}}, tmp_path / f"opt{STEP:09d}.pt")
    if case == "no_args_json":
        with pytest.raises(FileNotFoundError, match="training args are needed"):
            export_torch.main(argv)
    elif case == "no_opt_file":
        with pytest.raises(ValueError, match=f"opt{STEP:09d}.pt does not exist"):
            export_torch.main(argv)
    else:
        with pytest.raises(ValueError, match=r"no EMA weights \(trained with ema_rate=0\)"):
            export_torch.main(argv)
    assert not (tmp_path / "out.pt").exists()


def test_train_loop_ema_exports_and_samples(tmp_path, monkeypatch):
    """The port's own run at --ema_rate 0.5: the export's parameters are the
    loop's EMA, its buffers the model file's, and the generate CLI samples
    it (its videos, held elsewhere, not drawn)."""
    from gesturediffusion_tpu_torch.sample import generate
    from gesturediffusion_tpu_torch.train import train_mdm

    save = tmp_path / "run"
    loop = train_mdm.main(["--device", "cpu", "--dataset", "synthetic", "--layers", "1",
                           "--latent_dim", "32", "--num_frames", "20", "--batch_size", "2",
                           "--diffusion_steps", "8", "--num_steps", "2", "--ema_rate", "0.5",
                           "--use_wav_enc", "--save_dir", str(save)])
    out = export_torch.main(["--model_path", str(save / "model000000002.pt"),
                             "--out", str(save / "ema000000002.pt"), "--ema"])
    sd, model_sd = load_checkpoint(out), load_checkpoint(str(save / "model000000002.pt"))
    params = dict(loop.state.model.named_parameters())
    assert loop.state.ema and set(loop.state.ema) == set(params)
    for k, v in sd.items():
        want = loop.state.ema[k] if k in params else model_sd[k]
        assert torch.equal(v, want), k
    assert any(not torch.equal(loop.state.ema[k], model_sd[k]) for k in params)
    assert int(sd["wav_encoder.feat_extractor.1.num_batches_tracked"]) == 2
    monkeypatch.setattr(generate, "render_or_log", lambda *a, **k: None)
    res = generate.main(["--model_path", out, "--num_samples", "2", "--device", "cpu",
                         "--timestep_respacing", "4", "--output_dir", str(tmp_path / "gen")])
    res = np.load(os.path.join(res, "results.npy"), allow_pickle=True).item()
    assert res["motion"].shape[0] == 2 and np.isfinite(res["motion"]).all()
