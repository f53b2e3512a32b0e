"""Port parity of the fast path's time-major "btj" layout against the JAX
package: models/mdm_fastpath.py:make_fast_model_fn and make_fast_cfg_fn
with layout="btj" (state [B, T, J*F] in and out), the seed's flattening
from the time-major carry [B, S, J*F], and
diffusion/sampling.py:autoregressive_sample_loop with time_axis=1 under
the JAX chain's own noise; and the errors both raise, message for message.
Weights cross with gesturediffusion_tpu_torch/utils/convert.py.

Tolerances: the fast functions rtol 2e-4, atol 2e-5 and the seed
flattening rtol 1e-6, as JAX's tests/test_fastpath.py:156-230; the
2-chunk loop rtol 1e-4, atol 2e-5, as tests/test_torch_sampling.py's
bjft take; the btj take against the port's bjft take under the same
(transposed) noise within 1e-5 of the take's max (float32 reassociation of
the products on the relaid state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion.gaussian import create_diffusion as jax_create_diffusion
from gesturediffusion_tpu.diffusion.sampling import autoregressive_sample_loop as jax_ar_loop
from gesturediffusion_tpu.models.mdm import MDM as JaxMDM
from gesturediffusion_tpu.models.mdm_fastpath import make_fast_cfg_fn as jax_fast_cfg
from gesturediffusion_tpu.models.mdm_fastpath import make_fast_model_fn as jax_fast_fn
from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
from gesturediffusion_tpu_torch.diffusion.sampling import (
    ar_chunk_step,
    autoregressive_sample_loop,
)
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_fastpath import make_fast_cfg_fn, make_fast_model_fn
from tests.torch_port_common import (
    SMALL,
    build_pair,
    make_inputs,
    threefry_prng,  # noqa: F401 (autouse fixture)
    to_jax,
    to_torch,
)

RTOL, ATOL = 2e-4, 2e-5
B, T = 3, 16
J, S, A = SMALL["njoints"], SMALL["seed_poses"], SMALL["mfcc_dim"]


def time_major(x: np.ndarray) -> np.ndarray:
    """[B, J, F, T] -> [B, T, J*F]."""
    b, j, f, t = x.shape
    return np.ascontiguousarray(x.reshape(b, j * f, t).transpose(0, 2, 1))


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def test_btj_fast_fn_matches_jax(pair):
    """fast_fn on the time-major state, against JAX's btj fast_fn and the
    module's canonical output relaid."""
    jax_model, params, port = pair
    x, t, cond = make_inputs(B, T, seed=1)
    cond["uncond"] = np.array([0.0, 1.0, 0.0], np.float32)
    pre_j, fn_j = jax_fast_fn(jax_model, params, layout="btj")
    want = np.asarray(fn_j(jnp.asarray(time_major(x)), jnp.asarray(t), pre_j(to_jax(cond))))
    pre, fn = make_fast_model_fn(port, layout="btj")
    with torch.no_grad():
        got = fn(torch.from_numpy(time_major(x)), torch.from_numpy(t), pre(to_torch(cond)))
        module = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    assert got.shape == (B, T, J)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), time_major(module), rtol=RTOL, atol=ATOL)


def test_btj_cfg_matches_jax(pair):
    """The CFG function under btj, a time-major seed carry in the
    conditioning, against JAX's."""
    jax_model, params, port = pair
    x, t, cond = make_inputs(B, T, seed=2)
    cond["scale"] = np.array([2.5, 1.0, 0.0], np.float32)
    cond["seed"] = time_major(cond["seed"])
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1, layout="btj")
    want = np.asarray(fn_j(jnp.asarray(time_major(x)), jnp.asarray(t), pre_j(to_jax(cond))))
    pre, fn = make_fast_cfg_fn(port, 0.1, layout="btj")
    with torch.no_grad():
        got = fn(torch.from_numpy(time_major(x)), torch.from_numpy(t), pre(to_torch(cond)))
    assert got.shape == (B, T, J)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_btj_seed_flattening_matches_the_canonical_seed(pair):
    """A [B, S, J*F] carry flattens in the (j, f, s) order of the canonical
    [B, J, F, S] seed; the precomputed features agree with JAX's."""
    jax_model, params, port = pair
    _, _, cond = make_inputs(B, T, seed=3)
    pre, _ = make_fast_model_fn(port, layout="btj")
    canon = pre(to_torch(cond))["_fast"]
    tm = pre(to_torch({**cond, "seed": time_major(cond["seed"])}))["_fast"]
    for key in ("stxt", "stxt_proj", "base"):
        np.testing.assert_allclose(tm[key].numpy(), canon[key].numpy(), rtol=1e-6, err_msg=key)
    pre_j, _ = jax_fast_fn(jax_model, params, layout="btj")
    want = pre_j(to_jax({**cond, "seed": time_major(cond["seed"])}))["_fast"]
    np.testing.assert_allclose(tm["stxt"].numpy(), np.asarray(want["stxt"]), rtol=RTOL,
                               atol=ATOL)


def _loop_inputs(c: int = 2):
    rs = np.random.RandomState(5)
    mfcc = rs.randn(c, 2, A, 1, T).astype(np.float32)
    scale = np.full((c, 2), 2.5, np.float32)
    seed0 = rs.randn(2, J, 1, S).astype(np.float32)
    return mfcc, scale, seed0


def test_btj_ar_loop_matches_jax(pair):
    """Two chunks of a 4-step respaced DDPM with the btj CFG function at
    time_axis=1 (the seed handed off as out[:, -S:], [B, S, J*F]) under the
    JAX chain's noise: normal(fold_in(fold_in(rng, k), i)) in the time-
    major shape."""
    jax_model, params, port = pair
    mfcc, scale, seed0 = _loop_inputs()
    shape = (2, T, J)
    jd = jax_create_diffusion(steps=20, timestep_respacing="4")
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1, layout="btj")
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda r, cc, s0: jax_ar_loop(
        jd, fn_j, shape, r, cc, s0, S, cond_precompute=pre_j, time_axis=1,
    ))(rng, {"mfcc": jnp.asarray(mfcc), "scale": jnp.asarray(scale)},
       jnp.asarray(time_major(seed0))))

    def noise_fn(chunk, step, shp):
        key = jax.random.fold_in(jax.random.fold_in(rng, chunk), step)
        return torch.from_numpy(np.array(jax.random.normal(key, shp)))

    pd = create_diffusion(steps=20, timestep_respacing="4", device="cpu")
    pre, fn = make_fast_cfg_fn(port, 0.1, layout="btj")
    got = autoregressive_sample_loop(
        pd, fn, shape, {"mfcc": torch.from_numpy(mfcc), "scale": torch.from_numpy(scale)},
        torch.from_numpy(time_major(seed0)), S, generator=torch.Generator(),
        noise_fn=noise_fn, cond_precompute=pre, time_axis=1,
    )
    assert got.shape == (2, 2, T, J)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def test_btj_take_equals_the_bjft_take(pair):
    """The port's btj take from the canonical seed equals its bjft take
    under the same noise (the bjft draws relaid time-major)."""
    _, _, port = pair
    mfcc, scale, seed0 = _loop_inputs()
    pd = create_diffusion(steps=20, timestep_respacing="4", device="cpu")
    conds = {"mfcc": torch.from_numpy(mfcc), "scale": torch.from_numpy(scale)}
    draws = {}

    def canonical_noise(chunk, step, shp):
        key = (chunk, step)
        if key not in draws:
            g = torch.Generator().manual_seed(100 * chunk + step)
            draws[key] = torch.randn(shp, generator=g)
        return draws[key]

    def tm_noise(chunk, step, shp):
        return torch.from_numpy(time_major(canonical_noise(chunk, step, (2, J, 1, T)).numpy()))

    runs = {}
    for layout, shape, axis, noise in (("bjft", (2, J, 1, T), -1, canonical_noise),
                                       ("btj", (2, T, J), 1, tm_noise)):
        pre, fn = make_fast_cfg_fn(port, 0.1, layout=layout)
        runs[layout] = autoregressive_sample_loop(
            pd, fn, shape, conds, torch.from_numpy(seed0), S, generator=torch.Generator(),
            noise_fn=noise, cond_precompute=pre, time_axis=axis)
    want = np.stack([time_major(c) for c in runs["bjft"].numpy()])
    gap = np.abs(runs["btj"].numpy() - want).max()
    assert gap <= 1e-5 * np.abs(want).max(), gap


def _jax_error(fn):
    with pytest.raises(Exception) as err:
        fn()
    return err.type, str(err.value)


def test_time_axis_errors_match_jax(pair):
    """time_axis=1 on a canonical 4-D shape, and an axis that is neither
    the last nor 1: JAX's ValueErrors, word for word, from the loop and
    from one chunk."""
    jax_model, params, port = pair
    jd = jax_create_diffusion(steps=2)
    pd = create_diffusion(steps=2, device="cpu")
    for shape, axis in (((2, J, 1, T), 1), ((2, T, J), 0)):
        want = _jax_error(lambda: jax_ar_loop(
            jd, lambda x, t, c: x, shape, jax.random.PRNGKey(0),
            {"scale": jnp.ones((1, 2))}, jnp.zeros((2, S, J)), S, time_axis=axis))
        assert want[0] is ValueError
        with pytest.raises(ValueError) as got:
            autoregressive_sample_loop(pd, lambda x, t, c: x, shape, {"scale": torch.ones(1, 2)},
                                       torch.zeros(2, S, J), S, generator=torch.Generator(),
                                       time_axis=axis)
        assert str(got.value) == want[1]
        with pytest.raises(ValueError) as got:
            ar_chunk_step(pd, lambda x, t, c: x, shape, 0, {}, torch.zeros(2, S, J), S,
                          generator=torch.Generator(), time_axis=axis)
        assert str(got.value) == want[1]


def test_unknown_layout_and_the_wav_encoder_are_refused_as_jax_refuses(pair):
    """An unknown layout: JAX's ValueError; a model without the MFCC input
    (the wav encoder's): JAX's NotImplementedError."""
    jax_model, params, port = pair
    want = _jax_error(lambda: jax_fast_fn(jax_model, params, layout="tbj"))
    with pytest.raises(want[0]) as got:
        make_fast_model_fn(port, layout="tbj")
    assert str(got.value) == want[1]
    with pytest.raises(want[0]) as got:
        make_fast_cfg_fn(port, 0.1, layout="tbj")
    assert str(got.value) == want[1]
    kw = dict(SMALL, use_wav_enc=True, mfcc_input=False)
    # JAX refuses before it reads the parameters
    want = _jax_error(lambda: jax_fast_fn(JaxMDM(**kw), None, layout="btj"))
    assert want[0] is NotImplementedError
    wav = MDM(**kw)
    for layout in ("btj", "bjft"):
        with pytest.raises(NotImplementedError) as got:
            make_fast_model_fn(wav, layout=layout)
        assert str(got.value) == want[1]
