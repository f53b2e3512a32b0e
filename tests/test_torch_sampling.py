"""Port parity of the diffusion schedule and the chunked-AR DDPM take
against the JAX package (diffusion/gaussian.py:create_diffusion,
diffusion/sampling.py:autoregressive_sample_loop with the fast CFG path).
The port's loop replays the JAX noise through ``noise_fn``:
normal(fold_in(fold_in(rng, k), num_steps)) for chunk k's x_T and
normal(fold_in(fold_in(rng, k), i)) for its step at timestep i."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion.gaussian import (
    ModelMeanType as JaxMean,
    ModelVarType as JaxVar,
    create_diffusion as jax_create_diffusion,
)
from gesturediffusion_tpu.diffusion.sampling import (
    autoregressive_sample_loop as jax_ar_loop,
)
from gesturediffusion_tpu.models.mdm_fastpath import make_fast_cfg_fn as jax_fast_cfg
from gesturediffusion_tpu_torch.diffusion.gaussian import (
    ModelMeanType,
    ModelVarType,
    create_diffusion,
)
from gesturediffusion_tpu_torch.diffusion.sampling import (
    autoregressive_sample_loop,
    p_sample_loop,
)
from gesturediffusion_tpu_torch.models.mdm_fastpath import make_fast_cfg_fn
from tests.torch_port_common import SMALL, build_pair

ARRAYS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2", "fixed_large_variance", "fixed_large_log_variance",
    "timestep_map",
)


@pytest.mark.parametrize("schedule,steps,respacing", [
    ("cosine", 1000, None),
    ("cosine", 1000, "50"),
    ("linear", 100, "ddim10"),
])
def test_diffusion_arrays_equal_jax(schedule, steps, respacing):
    """Both build in float64 numpy and cast to float32: exactly equal."""
    want = jax_create_diffusion(noise_schedule=schedule, steps=steps,
                                timestep_respacing=respacing)
    got = create_diffusion(noise_schedule=schedule, steps=steps,
                           timestep_respacing=respacing, device="cpu")
    assert got.num_timesteps == want.num_timesteps
    assert got.original_num_steps == want.original_num_steps
    for name in ARRAYS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )


@pytest.mark.parametrize("mean_type,var_type,inpaint", [
    ("START_X", "FIXED_SMALL", False),
    ("START_X", "FIXED_LARGE", True),
    ("EPSILON", "FIXED_SMALL", False),
    ("PREVIOUS_X", "FIXED_LARGE", False),
])
def test_p_mean_variance_matches_jax(mean_type, var_type, inpaint):
    rs = np.random.RandomState(0)
    x, out = rs.randn(2, 3, 1, 5).astype(np.float32), rs.randn(2, 3, 1, 5).astype(np.float32)
    mask = rs.rand(2, 3, 1, 5) > 0.5
    gt = rs.randn(2, 3, 1, 5).astype(np.float32)
    t = np.array([0, 7])
    kw = dict(steps=20, timestep_respacing="10")
    jd = jax_create_diffusion(model_mean_type=JaxMean[mean_type],
                              model_var_type=JaxVar[var_type], **kw)
    pd = create_diffusion(model_mean_type=ModelMeanType[mean_type],
                          model_var_type=ModelVarType[var_type], device="cpu", **kw)
    want = jd.p_mean_variance(
        lambda *_: jnp.asarray(out), jnp.asarray(x), jnp.asarray(t), {},
        inpaint=(jnp.asarray(mask), jnp.asarray(gt)) if inpaint else None,
    )
    got = pd.p_mean_variance(
        lambda *_: torch.from_numpy(out), torch.from_numpy(x), torch.from_numpy(t), {},
        inpaint=(torch.from_numpy(mask), torch.from_numpy(gt)) if inpaint else None,
    )
    got["eps"] = pd.predict_eps_from_xstart(torch.from_numpy(x), torch.from_numpy(t), got["pred_xstart"])
    want["eps"] = jd.predict_eps_from_xstart(jnp.asarray(x), jnp.asarray(t), want["pred_xstart"])
    for k in ("mean", "variance", "log_variance", "pred_xstart", "eps"):
        np.testing.assert_allclose(
            np.broadcast_to(got[k].numpy(), x.shape),
            np.broadcast_to(np.asarray(want[k]), x.shape), rtol=1e-5, atol=1e-5, err_msg=k,
        )


def test_ar_take_matches_jax():
    """Two chunks of a 4-step respaced cosine DDPM with the fast CFG path,
    the seed hand-off between them, under the JAX chain's own noise.
    Tolerance rtol 1e-4, atol 2e-5: float32 reassociation through 8
    denoise steps."""
    b, t, c = 2, 16, 2
    j, s, a = SMALL["njoints"], SMALL["seed_poses"], SMALL["mfcc_dim"]
    jax_model, params, port = build_pair(t=t)
    rs = np.random.RandomState(5)
    mfcc = rs.randn(c, b, a, 1, t).astype(np.float32)
    scale = np.full((c, b), 2.5, np.float32)
    seed0 = rs.randn(b, j, 1, s).astype(np.float32)
    shape = (b, j, 1, t)

    jd = jax_create_diffusion(steps=20, timestep_respacing="4")
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda r, cc, s0: jax_ar_loop(
        jd, fn_j, shape, r, cc, s0, s, cond_precompute=pre_j,
    ))(rng, {"mfcc": jnp.asarray(mfcc), "scale": jnp.asarray(scale)}, jnp.asarray(seed0)))

    def noise_fn(chunk, step, shp):
        key = jax.random.fold_in(jax.random.fold_in(rng, chunk), step)
        return torch.from_numpy(np.array(jax.random.normal(key, shp)))

    pd = create_diffusion(steps=20, timestep_respacing="4", device="cpu")
    pre, fn = make_fast_cfg_fn(port, 0.1)
    got = autoregressive_sample_loop(
        pd, fn, shape, {"mfcc": torch.from_numpy(mfcc), "scale": torch.from_numpy(scale)},
        torch.from_numpy(seed0), s, generator=torch.Generator(), noise_fn=noise_fn,
        cond_precompute=pre,
    )
    assert got.shape == (c, b, j, 1, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def test_generator_makes_the_chain_reproducible():
    pd = create_diffusion(steps=10, device="cpu")

    def model_fn(x, t, cond):
        return 0.5 * x

    def run(seed):
        return p_sample_loop(pd, model_fn, (2, 3, 1, 4), {},
                             generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
