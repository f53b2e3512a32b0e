"""Port parity of the text-to-motion denoiser (models/mdm_t2m.py:MotionMDM)
against the JAX package's MotionMDM: the forward for cond_mode text, action
and no_cond, the JAX side with and without ``use_fused_encoder`` (its
Pallas encoder layer in interpret mode); the weights carried by
utils/convert.py and read back from a ``.pt`` that JAX
``save_torch_checkpoint`` writes; the CFG model function against JAX
``classifier_free_guidance`` at guidance 2.5 and 0 through the sampling
selector; the model factory's dispatch.  Small widths (latent 64, 2
layers of 4 heads, ff 128, 20 frames) at the full feature widths 263 and
251.  Tolerance rtol 2e-4, atol 2e-5 (float32 reassociation, as
tests/test_torch_mdm.py)."""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.models.cfg import classifier_free_guidance as jax_cfg
from gesturediffusion_tpu.models.mdm_fastpath import (
    select_sampling_model_fn as jax_select,
)
from gesturediffusion_tpu.utils.convert_torch import (
    export_motion_mdm_state_dict,
    save_torch_checkpoint,
)
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
from gesturediffusion_tpu_torch.utils.model_factory import create_model_and_diffusion
from tests.torch_port_common import (
    SMALL_T2M,
    build_t2m_pair,
    make_t2m_inputs,
    threefry_prng,  # noqa: F401 (autouse fixture)
    to_jax,
    to_torch,
)

RTOL, ATOL = 2e-4, 2e-5
T = 20


@pytest.mark.parametrize("use_fused_encoder", [False, True])
@pytest.mark.parametrize("cond_mode,njoints", [("text", 263), ("action", 263),
                                               ("no_cond", 251)])
def test_forward_matches_jax(cond_mode, njoints, use_fused_encoder):
    jax_model, params, port = build_t2m_pair(cond_mode, njoints, use_fused_encoder)
    x, t, cond = make_t2m_inputs(3, njoints, cond_mode, seed=1)
    cond["uncond"] = np.array([0.0, 1.0, 0.0], np.float32)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    assert got.shape == (3, njoints, 1, T)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cond_mode", ["text", "action", "no_cond"])
def test_reference_state_dict_and_pt_carry_the_weights(cond_mode, tmp_path):
    """The converter gives JAX export_motion_mdm_state_dict's keys and
    values, and the .pt that JAX save_torch_checkpoint writes loads into the
    port with the same forward."""
    jax_model, params, port = build_t2m_pair(cond_mode)
    want_sd = export_motion_mdm_state_dict(params, jax_model)
    got_sd = port.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got_sd[k].numpy(), np.asarray(v), err_msg=k)
    path = save_torch_checkpoint(str(tmp_path / "model000000001.pt"), params, jax_model)
    loaded = MotionMDM(**SMALL_T2M, cond_mode=cond_mode)
    loaded.load_state_dict(load_checkpoint(path))
    x, t, cond = make_t2m_inputs(2, 263, cond_mode, seed=2)
    with torch.no_grad():
        a = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond))
        b = loaded.eval()(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_upstream_clip_keys_are_left_out(tmp_path):
    """An upstream text-to-motion checkpoint carries its frozen CLIP tower
    (clip_model.*); the denoiser loads without it."""
    _, _, port = build_t2m_pair("text")
    sd = dict(port.state_dict())
    sd["clip_model.positional_embedding"] = torch.zeros(77, 512)
    torch.save(sd, tmp_path / "model.pt")
    MotionMDM(**SMALL_T2M).load_state_dict(load_checkpoint(str(tmp_path / "model.pt")))


@pytest.mark.parametrize("guidance", [2.5, 0.0])
@pytest.mark.parametrize("cond_mode", ["text", "action"])
def test_cfg_model_fn_matches_jax(cond_mode, guidance):
    """select_sampling_model_fn gives a MotionMDM the module's own forward
    under CFG (no precompute), as JAX does; at guidance 0 the scale returns
    the unconditional pass, which leaves no trace of the conditioning."""
    jax_model, params, port = build_t2m_pair(cond_mode)
    x, t, cond = make_t2m_inputs(3, 263, cond_mode, seed=4)
    cond["scale"] = np.full((3,), guidance, np.float32)
    pre_j, fn_j = jax_select(jax_model, params, guidance, 0.0 if guidance == 0 else 0.1)
    assert pre_j is None
    want = np.asarray(fn_j(jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    pre, fn = select_sampling_model_fn(port, guidance, 0.0 if guidance == 0 else 0.1)
    assert pre is None
    with torch.no_grad():
        got = fn(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    also = np.asarray(jax_cfg(lambda a, b, c: jax_model.apply(params, a, b, c), 0.1)(
        jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    np.testing.assert_allclose(got, also, rtol=RTOL, atol=ATOL)
    if guidance == 0:
        with torch.no_grad():
            uncond = port(torch.from_numpy(x), torch.from_numpy(t),
                          dict(to_torch(cond), uncond=torch.ones(3))).numpy()
        np.testing.assert_allclose(got, uncond, rtol=RTOL, atol=ATOL)


def test_guidance_one_is_the_plain_forward():
    _, _, port = build_t2m_pair("text")
    pre, fn = select_sampling_model_fn(port, 1.0, 0.1)
    assert pre is None and fn is port
    with pytest.raises(ValueError, match="conditioning dropout"):
        select_sampling_model_fn(port, 2.5, 0.0)


def _flags(**kw):
    base = dict(arch="trans_enc", dataset="humanml", latent_dim=64, layers=2,
                cond_mask_prob=0.1, unconstrained=False, noise_schedule="cosine",
                diffusion_steps=10, sigma_small=True, use_wav_enc=False, use_text=False,
                seed_poses=10)
    return argparse.Namespace(**dict(base, **kw))


@pytest.mark.parametrize("dataset,unconstrained,njoints,cond_mode", [
    ("humanml", False, 263, "text"), ("kit", False, 251, "text"),
    ("humanml", True, 263, "no_cond"),
])
def test_factory_builds_motion_mdm_as_jax(dataset, unconstrained, njoints, cond_mode):
    from gesturediffusion_tpu.utils.model_factory import create_model as jax_create

    args = _flags(dataset=dataset, unconstrained=unconstrained)
    model, diffusion = create_model_and_diffusion(args, None, torch.device("cpu"))
    want = jax_create(args)
    assert isinstance(model, MotionMDM)
    assert (model.njoints, model.cond_mode, model.latent_dim, model.num_layers) == (
        want.njoints, want.cond_mode, want.latent_dim, want.num_layers) == (
        njoints, cond_mode, 64, 2)
    assert diffusion.num_timesteps == 10


def test_factory_keeps_gesture_datasets_and_refuses_action_ones():
    """The gesture datasets keep MDM V2; the action datasets, refused
    before their slice, now get the action-mode MotionMDM as JAX builds it
    (25 rows of 6, 12 and 40 actions; no_cond under --unconstrained) and
    the recipe's geometric lambdas; an unknown dataset is refused."""
    from gesturediffusion_tpu.utils.model_factory import create_model as jax_create

    class Data:
        pose_dim = 24

    model, _ = create_model_and_diffusion(_flags(dataset="synthetic"), Data(),
                                          torch.device("cpu"))
    assert isinstance(model, MDM)
    for name, actions in (("humanact12", 12), ("uestc", 40)):
        for unconstrained in (False, True):
            args = _flags(dataset=name, unconstrained=unconstrained, lambda_rcxyz=1.0,
                          lambda_vel=1.0, lambda_fc=1.0)
            model, diffusion = create_model_and_diffusion(args, None, torch.device("cpu"))
            want = jax_create(args)
            assert isinstance(model, MotionMDM)
            assert (model.njoints, model.nfeats, model.cond_mode) == (
                want.njoints, want.nfeats, want.cond_mode) == (
                25, 6, "no_cond" if unconstrained else "action")
            if not unconstrained:
                assert model.embed_action.action_embedding.shape == (
                    want.num_actions, 64) == (actions, 64)
            assert (diffusion.lambda_rcxyz, diffusion.lambda_vel, diffusion.lambda_fc) == (
                1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="Unsupported"):
        create_model_and_diffusion(_flags(dataset="h36m"), None, torch.device("cpu"))