"""Port parity of the sampling loops against the JAX package on the CPU
(diffusion/sampling.py: plms_sample_loop, dpmpp_sample_loop,
ddim_reverse_sample, the loops' keyword surface, make_sample_fn; and
diffusion/gaussian.py: clip_denoised, denoised_fn, condition_mean,
condition_score), on the small gesture MDM of torch_port_common through
the fast CFG path.  x_T is passed to both packages as ``noise=``; where a
loop draws more (DDPM, DDIM) the port replays JAX's draws,
normal(fold_in(rng, i)) for the step at timestep i, through ``noise_fn``.

Tolerance: rtol 1e-4 / atol 2e-5, as the chain tests
(test_torch_long_chunk.py, test_torch_streaming.py) have: float32 rounding
that the CFG chain amplifies.  Then the JAX package's own sampler
properties (tests/test_diffusion.py), ported: perfect-model recoveries,
DPM++ of order 1 equal to DDIM at eta 0, the second-order solver and the
log-SNR spacing closer to the ODE at few steps, the invalid orders, const
noise, and imputation under every sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion import sampling as js
from gesturediffusion_tpu.diffusion.gaussian import (
    ModelMeanType as JaxMean,
    create_diffusion as jax_create_diffusion,
)
from gesturediffusion_tpu.models.mdm_fastpath import make_fast_cfg_fn as jax_fast_cfg
from gesturediffusion_tpu_torch.diffusion import sampling as ps
from gesturediffusion_tpu_torch.diffusion.gaussian import ModelMeanType, create_diffusion
from gesturediffusion_tpu_torch.diffusion.schedules import respacing_string
from gesturediffusion_tpu_torch.models.mdm_fastpath import make_fast_cfg_fn
from tests.torch_port_common import (
    SMALL,
    build_pair,
    threefry_prng,  # noqa: F401 (autouse fixture)
)

RTOL, ATOL = 1e-4, 2e-5
# the whole 20-step chain: respaced to a few steps, PLMS of order 2-4 on
# random weights under CFG turns a 3e-7 change of x_T into 1e-2 (JAX
# against itself), which would hide the port behind rounding
B, T, STEPS, GUIDANCE = 2, 16, 20, 2.5
J, S, A = SMALL["njoints"], SMALL["seed_poses"], SMALL["mfcc_dim"]
SHAPE = (B, J, 1, T)
SAMPLERS = ("ddpm", "ddim", "plms", "dpmpp")
JAX_LOOPS = {"ddpm": js.p_sample_loop, "ddim": js.ddim_sample_loop,
             "plms": js.plms_sample_loop, "dpmpp": js.dpmpp_sample_loop}


@pytest.fixture(scope="module")
def pair():
    return build_pair()


@pytest.fixture(scope="module")
def cfg(pair):
    """(JAX model fn, JAX cond, port model fn, port cond): the fast CFG
    path of the pair with its conditioning precomputed."""
    jax_model, params, port = pair
    rs = np.random.RandomState(3)
    cond = {"mfcc": rs.randn(B, A, 1, T).astype(np.float32),
            "seed": rs.randn(B, J, 1, S).astype(np.float32),
            "scale": np.full((B,), GUIDANCE, np.float32)}
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1)
    pre, fn = make_fast_cfg_fn(port, 0.1)
    return (fn_j, pre_j({k: jnp.asarray(v) for k, v in cond.items()}),
            fn, pre({k: torch.from_numpy(v) for k, v in cond.items()}))


def _diffusions(sampler="ddpm", steps=STEPS, respacing=None):
    r = respacing_string(respacing, sampler) if respacing else None
    return (jax_create_diffusion(steps=steps, timestep_respacing=r),
            create_diffusion(steps=steps, timestep_respacing=r, device="cpu"))


def _x_t(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(sampler, cfg, jax_kw=None, port_kw=None, rng=5, noise_seed=0, **kw):
    """The loop of ``sampler`` in both packages on the same x_T and draws;
    ``kw`` goes to both, ``jax_kw`` / ``port_kw`` to one."""
    fn_j, cond_j, fn, cond = cfg
    jd, pd = _diffusions(sampler)
    key = jax.random.PRNGKey(rng)
    x_t = _x_t(noise_seed)

    def replay(chunk, step, shape):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, step), shape)))

    want = JAX_LOOPS[sampler](jd, fn_j, SHAPE, key, cond_j, noise=jnp.asarray(x_t),
                              **kw, **(jax_kw or {}))
    got = ps.LOOPS[sampler](pd, fn, SHAPE, cond, generator=torch.Generator(),
                            noise_fn=replay, noise=torch.from_numpy(x_t),
                            **kw, **(port_kw or {}))
    return got, want


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---- each loop against JAX's ------------------------------------------- #
@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_plms_matches_jax(cfg, order):
    got, want = _both("plms", cfg, order=order)
    _close(got, want)


@pytest.mark.parametrize("order", [1, 2])
def test_dpmpp_matches_jax(cfg, order):
    got, want = _both("dpmpp", cfg, order=order)
    _close(got, want)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_drawing_loops_match_jax_under_its_noise(cfg, sampler):
    got, want = _both(sampler, cfg)
    _close(got, want)


def test_ddim_reverse_sample_matches_jax(cfg):
    fn_j, cond_j, fn, cond = cfg
    jd, pd = _diffusions("ddim")
    x = _x_t(1)
    t = np.array([0, 3])
    want = js.ddim_reverse_sample(jd, fn_j, jnp.asarray(x), jnp.asarray(t), cond_j,
                                  clip_denoised=True)
    got = ps.ddim_reverse_sample(pd, fn, torch.from_numpy(x), torch.from_numpy(t).long(), cond,
                                 clip_denoised=True)
    for k in ("sample", "pred_xstart"):
        _close(got[k], want[k])


def _cond_fns():
    def jfn(x, t, c):
        return -0.3 * x + 0.001 * t.astype(jnp.float32)[:, None, None, None]

    def pfn(x, t, c):
        return -0.3 * x + 0.001 * t.float()[:, None, None, None]

    return jfn, pfn


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cond_fn_matches_jax(cfg, sampler):
    """DDPM shifts the mean (condition_mean), the others the score
    (condition_score).  PLMS at order 1: under a guidance field its
    multistep orders turn a 3e-7 change of x_T into 3e-4 on these random
    weights (JAX against itself); test_plms_matches_jax holds them."""
    jfn, pfn = _cond_fns()
    kw = {"order": 1} if sampler == "plms" else {}
    got, want = _both(sampler, cfg, jax_kw={"cond_fn": jfn}, port_kw={"cond_fn": pfn}, **kw)
    _close(got, want)
    plain, _ = _both(sampler, cfg, **kw)
    assert np.abs(got.numpy() - plain.numpy()).max() > 1e-3  # the guidance acts


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_clip_denoised_and_denoised_fn_match_jax(cfg, sampler):
    got, want = _both(sampler, cfg, clip_denoised=True, denoised_fn=lambda x: 0.8 * x)
    _close(got, want)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_skip_timesteps_and_init_image_match_jax(cfg, sampler):
    init = _x_t(7) * 0.5
    got, want = _both(sampler, cfg, skip_timesteps=2, jax_kw={"init_image": jnp.asarray(init)},
                      port_kw={"init_image": torch.from_numpy(init)})
    _close(got, want)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_return_intermediates_match_jax(cfg, sampler):
    kw = {"const_noise": True} if sampler == "ddpm" else {}
    (got, got_ys), (want, want_ys) = _both(sampler, cfg, return_intermediates=True, **kw)
    assert got_ys.shape == (STEPS, *SHAPE) == want_ys.shape
    _close(got, want)
    _close(got_ys, want_ys)
    torch.testing.assert_close(got_ys[-1], got, rtol=0, atol=0)


def test_carry_dtype_matches_jax():
    """A bfloat16 chain state with float32 updates, on a smooth model: a
    float32 rounding apart can round the state to the next bfloat16, so
    the tolerance is bfloat16's (rtol and atol 1e-2, two ulps at 1)."""
    jd, pd = _diffusions(respacing=10)
    key = jax.random.PRNGKey(2)
    x_t = _x_t(3)

    def replay(chunk, step, shape):
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, step), shape)))

    want = js.p_sample_loop(jd, lambda x, t, c: jnp.tanh(x) * 0.4, SHAPE, key, None,
                            noise=jnp.asarray(x_t), carry_dtype=jnp.bfloat16)
    got = ps.p_sample_loop(pd, lambda x, t, c: torch.tanh(x) * 0.4, SHAPE, {},
                           generator=torch.Generator(), noise_fn=replay,
                           noise=torch.from_numpy(x_t), carry_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-2, atol=1e-2)
    f32 = ps.p_sample_loop(pd, lambda x, t, c: torch.tanh(x) * 0.4, SHAPE, {},
                           generator=torch.Generator(), noise_fn=replay,
                           noise=torch.from_numpy(x_t))
    assert 0 < (got - f32).abs().max() < 5e-2  # the state was rounded, and only that


def test_p_mean_variance_processes_x0_as_jax():
    """denoised_fn then the clip, on every mean type, before the mean."""
    rs = np.random.RandomState(0)
    x, out = rs.randn(2, 3, 1, 5).astype(np.float32), 2 * rs.randn(2, 3, 1, 5).astype(np.float32)
    t = np.array([0, 7])
    for mean in ("START_X", "EPSILON", "PREVIOUS_X"):
        jd = jax_create_diffusion(steps=10, model_mean_type=JaxMean[mean])
        pd = create_diffusion(steps=10, model_mean_type=ModelMeanType[mean], device="cpu")
        want = jd.p_mean_variance(lambda *_: jnp.asarray(out), jnp.asarray(x), jnp.asarray(t),
                                  {}, clip_denoised=True, denoised_fn=lambda z: z * 1.5)
        got = pd.p_mean_variance(lambda *_: torch.from_numpy(out), torch.from_numpy(x),
                                 torch.from_numpy(t), {}, clip_denoised=True,
                                 denoised_fn=lambda z: z * 1.5)
        assert float(got["pred_xstart"].abs().max()) <= 1.0
        for k in ("mean", "pred_xstart"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{mean} {k}")


def test_condition_mean_and_score_match_jax():
    rs = np.random.RandomState(1)
    x, out = rs.randn(2, 3, 1, 5).astype(np.float32), rs.randn(2, 3, 1, 5).astype(np.float32)
    t = np.array([2, 8])
    jd, pd = _diffusions(respacing=10)
    jfn, pfn = _cond_fns()
    pmv_j = jd.p_mean_variance(lambda *_: jnp.asarray(out), jnp.asarray(x), jnp.asarray(t), {})
    pmv = pd.p_mean_variance(lambda *_: torch.from_numpy(out), torch.from_numpy(x),
                             torch.from_numpy(t), {})
    args_j, args = (jnp.asarray(x), jnp.asarray(t), {}), (torch.from_numpy(x),
                                                          torch.from_numpy(t), {})
    _close(pd.condition_mean(pfn, pmv, *args), jd.condition_mean(jfn, pmv_j, *args_j),
           rtol=1e-5, atol=1e-6)
    got, want = pd.condition_score(pfn, pmv, *args), jd.condition_score(jfn, pmv_j, *args_j)
    for k in ("mean", "pred_xstart"):
        _close(got[k], want[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampler", ["plms", "dpmpp"])
def test_chunked_take_matches_jax(pair, sampler):
    """A 3-chunk take through ar_chunk_step (the loop the generate and
    serve CLIs run): x_T of chunk k replayed from
    normal(fold_in(fold_in(rng, k), num_steps)), the only draw."""
    jax_model, params, port = pair
    rs = np.random.RandomState(2)
    c = 3
    seed0 = rs.randn(B, J, 1, S).astype(np.float32)
    mfcc = rs.randn(c, B, A, 1, T).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    jd, pd = _diffusions(sampler)
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1)
    want = js.autoregressive_sample_loop(
        jd, fn_j, SHAPE, rng, {"mfcc": jnp.asarray(mfcc), "scale": jnp.full((c, B), GUIDANCE)},
        jnp.asarray(seed0), S, cond_precompute=pre_j, loop=JAX_LOOPS[sampler])
    steps = []

    def replay(chunk, step, shape):
        steps.append((chunk, step))
        key = jax.random.fold_in(jax.random.fold_in(rng, chunk), step)
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))

    pre, fn = make_fast_cfg_fn(port, 0.1)
    got = ps.autoregressive_sample_loop(
        pd, fn, SHAPE, {"mfcc": torch.from_numpy(mfcc), "scale": torch.full((c, B), GUIDANCE)},
        torch.from_numpy(seed0), S, generator=torch.Generator(), noise_fn=replay,
        cond_precompute=pre, loop=ps.sample_loop(sampler))
    assert steps == [(k, STEPS) for k in range(c)]
    _close(got, want)


def test_make_sample_fn_binds_the_loop_and_its_defaults(cfg):
    _, _, fn, cond = cfg
    _, pd = _diffusions("plms")
    x_t = torch.from_numpy(_x_t())
    sample = ps.make_sample_fn(pd, "plms", order=3)
    want = ps.plms_sample_loop(pd, fn, SHAPE, cond, generator=torch.Generator(), noise=x_t,
                               order=3)
    torch.testing.assert_close(sample(fn, SHAPE, cond, generator=torch.Generator(), noise=x_t),
                               want, rtol=0, atol=0)
    assert ps.sample_loop("dpmpp") is ps.dpmpp_sample_loop
    with pytest.raises(ValueError, match="unknown sampler"):
        ps.make_sample_fn(pd, "euler")


# ---- the JAX package's own properties (tests/test_diffusion.py) --------- #
PSHAPE = (4, 6, 1, 8)


def _small(steps=20, respacing=None):
    return create_diffusion(steps=steps, timestep_respacing=respacing, device="cpu")


def _perfect(x_true):
    return lambda x, t, c: x_true.expand(x.shape)


def _run(loop, d, model, **kw):
    return loop(d, model, PSHAPE, {}, generator=torch.Generator().manual_seed(5), **kw)


@pytest.mark.parametrize("loop,kw,atol", [
    (ps.p_sample_loop, {}, 1e-4), (ps.ddim_sample_loop, {}, 1e-4),
    (ps.plms_sample_loop, {"order": 1}, 1e-3), (ps.plms_sample_loop, {"order": 2}, 1e-3),
    (ps.plms_sample_loop, {"order": 4}, 1e-3), (ps.dpmpp_sample_loop, {}, 1e-3),
], ids=["ddpm", "ddim", "plms1", "plms2", "plms4", "dpmpp"])
def test_loops_recover_xstart_with_a_perfect_model(loop, kw, atol):
    x_true = torch.randn(PSHAPE, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(_run(loop, _small(), _perfect(x_true), **kw), x_true,
                               rtol=0, atol=atol)


def _tanh_model(x, t, c):
    return torch.tanh(x) * 0.4  # a smooth, imperfect x0 predictor


def test_dpmpp_order1_equals_ddim():
    """First-order DPM-Solver++ is DDIM at eta 0, step for step."""
    d = _small(40, "8")
    noise = torch.randn(PSHAPE, generator=torch.Generator().manual_seed(3))
    a = _run(ps.dpmpp_sample_loop, d, _tanh_model, noise=noise, order=1)
    b = _run(ps.ddim_sample_loop, d, _tanh_model, noise=noise)
    torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def _ode_error(respacing, loop):
    """max |loop at 8 steps - DDIM at 400 steps| on one x_T."""
    noise = torch.randn(PSHAPE, generator=torch.Generator().manual_seed(3))
    truth = _run(ps.ddim_sample_loop, _small(400), _tanh_model, noise=noise)
    return float((_run(loop, _small(400, respacing), _tanh_model, noise=noise) - truth)
                 .abs().max())


def test_dpmpp_2m_beats_ddim_at_few_steps():
    assert _ode_error("8", ps.dpmpp_sample_loop) < _ode_error("8", ps.ddim_sample_loop)


def test_logsnr_spacing_improves_low_step_error():
    for loop in (ps.ddim_sample_loop, ps.dpmpp_sample_loop):
        assert _ode_error("logsnr8", loop) < _ode_error("8", loop)


@pytest.mark.parametrize("loop,order", [(ps.plms_sample_loop, 0), (ps.plms_sample_loop, 5),
                                        (ps.dpmpp_sample_loop, 3)],
                         ids=["plms0", "plms5", "dpmpp3"])
def test_invalid_orders_raise(loop, order):
    with pytest.raises(ValueError, match="order"):
        _run(loop, _small(8), lambda x, t, c: x, order=order)


def test_dpmpp_keeps_a_half_precision_model_in_float32():
    out = _run(ps.dpmpp_sample_loop, _small(8), lambda x, t, c: _tanh_model(x, t, c).half())
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_const_noise_gives_identical_samples():
    noise = torch.randn(PSHAPE[1:], generator=torch.Generator().manual_seed(0)).expand(PSHAPE)
    out = _run(ps.p_sample_loop, _small(10), lambda x, t, c: torch.zeros_like(x),
               noise=noise.contiguous(), const_noise=True)
    for b in range(1, PSHAPE[0]):
        torch.testing.assert_close(out[0], out[b], rtol=0, atol=1e-6)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_inpainting_imputation_under_every_sampler(sampler):
    gt = torch.randn(PSHAPE, generator=torch.Generator().manual_seed(0))
    mask = torch.zeros(PSHAPE, dtype=torch.bool)
    mask[..., :4] = True
    out = _run(ps.LOOPS[sampler], _small(10), lambda x, t, c: torch.zeros_like(x),
               inpaint=(mask, gt))
    torch.testing.assert_close(out[mask], gt[mask], rtol=0, atol=1e-4)
