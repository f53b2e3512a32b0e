"""The port's streaming session (gesturediffusion_tpu_torch/serve/streaming.py)
and its DDIM loop (diffusion/sampling.py) against the port's batch take and
the JAX package, on the small gesture MDM of torch_port_common.

Tolerances: a session against the port's own batch take is exact (atol 0:
the same ops in the same order on the same draws); against JAX under its
replayed noise rtol 1e-4 / atol 2e-5, the tolerance of
test_torch_long_chunk.py::test_ar_take_matches_jax for the same chain
(float32 rounding the CFG chain amplifies).  The rest follows the JAX
package's tests/test_streaming.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion.gaussian import create_diffusion as jax_create_diffusion
from gesturediffusion_tpu.diffusion.sampling import (
    autoregressive_sample_loop as jax_ar_loop,
    ddim_sample_loop as jax_ddim_loop,
)
from gesturediffusion_tpu.models.mdm_fastpath import make_fast_cfg_fn as jax_fast_cfg
from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
from gesturediffusion_tpu_torch.diffusion.sampling import (
    LOOPS,
    autoregressive_sample_loop,
    ddim_sample_loop,
)
from gesturediffusion_tpu_torch.diffusion.schedules import respacing_string
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_fastpath import (
    make_fast_cfg_fn,
    select_sampling_model_fn,
)
from gesturediffusion_tpu_torch.ops.mfcc import mfcc_for_window
from gesturediffusion_tpu_torch.parallel.mesh import Mesh
from gesturediffusion_tpu_torch.serve.streaming import StreamingGestureSession
from tests.torch_port_common import (
    SMALL,
    build_pair,
    threefry_prng,  # noqa: F401 (autouse fixture)
)

B, T, C, STEPS, SAMPLE_STEPS, GUIDANCE = 2, 16, 3, 20, 4, 2.5
J, S, A = SMALL["njoints"], SMALL["seed_poses"], SMALL["mfcc_dim"]
RTOL, ATOL = 1e-4, 2e-5


@pytest.fixture(scope="module")
def pair():
    """(JAX model, params, port model with the same weights), drawn under
    threefry2x32 whatever PRNG an earlier file left on the worker."""
    return build_pair()


def _inputs(seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, J, 1, S).astype(np.float32),
            rs.randn(C, B, A, 1, T).astype(np.float32))


def _session(port, **kw):
    args = dict(guidance_param=GUIDANCE, streams=B, chunk_frames=T, seed_poses=S,
                diffusion_steps=STEPS, sample_steps=SAMPLE_STEPS, device="cpu")
    args.update(kw)
    return StreamingGestureSession(port, **args)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "plms", "dpmpp"])
def test_session_equals_the_batch_take(pair, sampler):
    """Streamed chunk by chunk = the batch take from a generator of the same
    seed: the JAX package's streamed-equals-batch invariant, exactly."""
    _, _, port = pair
    seed0, mfcc = _inputs()
    session = _session(port, sampler=sampler)
    session.start(seed0, rng=3)
    got = np.stack([session.feed({"mfcc": mfcc[k]}) for k in range(C)])

    diffusion = create_diffusion(steps=STEPS, device="cpu",
                                 timestep_respacing=respacing_string(SAMPLE_STEPS, sampler))
    pre, fn = select_sampling_model_fn(port, GUIDANCE, 0.1)
    want = autoregressive_sample_loop(
        diffusion, fn, (B, J, 1, T),
        {"mfcc": torch.from_numpy(mfcc), "scale": torch.full((C, B), GUIDANCE)},
        torch.from_numpy(seed0), S, generator=torch.Generator().manual_seed(3),
        cond_precompute=pre, loop=LOOPS[sampler],
    ).numpy()
    np.testing.assert_array_equal(got, want)


def _session_against_jax(jax_model, params, port):
    """(the port's streamed take, JAX's batch take) of
    test_session_matches_jax_under_its_noise."""
    seed0, mfcc = _inputs(2)
    rng = jax.random.PRNGKey(7)
    jd = jax_create_diffusion(steps=STEPS, timestep_respacing=str(SAMPLE_STEPS))
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1)
    want = np.asarray(jax.jit(lambda r, cc, s0: jax_ar_loop(
        jd, fn_j, (B, J, 1, T), r, cc, s0, S, cond_precompute=pre_j,
    ))(rng, {"mfcc": jnp.asarray(mfcc), "scale": jnp.full((C, B), GUIDANCE)},
       jnp.asarray(seed0)))

    def noise_fn(chunk, step, shape):
        key = jax.random.fold_in(jax.random.fold_in(rng, chunk), step)
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))

    session = _session(port, noise_fn=noise_fn)
    session.start(seed0)
    got = np.stack([session.feed({"mfcc": mfcc[k]}) for k in range(C)])
    return got, want


def test_session_matches_jax_under_its_noise(pair):
    """A 3-chunk DDPM take respaced to 4 steps, streamed, against JAX's
    batch loop, the session's draws replaced by the JAX chain's keys
    (fold_in(fold_in(rng, chunk), step))."""
    got, want = _session_against_jax(*pair)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pair_built_after_rbg_draws_the_threefry_weights(pair):
    """Every JAX CLI leaves the rbg PRNG on its process; a pair built after
    that draws the weights the tests were written on (threefry2x32), and
    the streamed take holds against JAX on them under the same tolerance."""
    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        jax_model, params, port = build_pair()
        assert jax.config.jax_default_prng_impl == "rbg"  # restored by build_pair
    finally:
        jax.config.update("jax_default_prng_impl", before)
    want = pair[2].state_dict()
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    got, want = _session_against_jax(jax_model, params, port)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_loop_matches_jax_under_its_noise(pair, eta):
    """JAX folds x_T's draw by num_steps and step i's by i
    (sampling.py:51, 262), and draws the per-step normal at eta 0 too."""
    jax_model, params, port = pair
    rs = np.random.RandomState(3)
    cond = {"mfcc": rs.randn(B, A, 1, T).astype(np.float32),
            "seed": rs.randn(B, J, 1, S).astype(np.float32),
            "scale": np.full((B,), GUIDANCE, np.float32)}
    rng = jax.random.PRNGKey(11)
    respacing = respacing_string(SAMPLE_STEPS, "ddim")
    jd = jax_create_diffusion(steps=STEPS, timestep_respacing=respacing)
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1)
    want = np.asarray(jax_ddim_loop(jd, fn_j, (B, J, 1, T), rng,
                                    pre_j({k: jnp.asarray(v) for k, v in cond.items()}),
                                    eta=eta))
    pd = create_diffusion(steps=STEPS, timestep_respacing=respacing, device="cpu")
    pre, fn = make_fast_cfg_fn(port, 0.1)
    steps = []

    def noise_fn(chunk, step, shape):
        steps.append(step)
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(rng, step), shape)))

    got = ddim_sample_loop(pd, fn, (B, J, 1, T), pre({k: torch.from_numpy(v)
                                                      for k, v in cond.items()}),
                           generator=torch.Generator(), noise_fn=noise_fn, eta=eta).numpy()
    assert steps == [SAMPLE_STEPS, *range(SAMPLE_STEPS - 1, -1, -1)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ddim_and_ddpm_take_the_same_draws():
    """At eta 0 DDIM still draws each step's normal, so both loops leave a
    generator in the same state."""
    d = create_diffusion(steps=STEPS, timestep_respacing=str(SAMPLE_STEPS), device="cpu")
    states = []
    for loop in (LOOPS["ddpm"], LOOPS["ddim"]):
        gen = torch.Generator().manual_seed(0)
        loop(d, lambda x, t, c: torch.zeros_like(x), (B, J, 1, T), {}, generator=gen)
        states.append(gen.get_state())
    assert torch.equal(*states)


def test_feed_audio_matches_manual_mfcc(pair):
    _, _, port = pair
    seed0, _ = _inputs()
    rs = np.random.RandomState(4)
    sr, fps = 8000, 30.0
    wav = rs.randn(int(sr * T / fps)).astype(np.float32)
    mean = rs.randn(26).astype(np.float32)
    std = np.abs(rs.randn(26)).astype(np.float32) + 0.5
    torch.manual_seed(0)
    port26 = MDM(**dict(SMALL, mfcc_dim=26)).eval()

    def fresh():
        s = _session(port26, fps=fps)
        s.start(seed0)
        return s

    got = fresh().feed_audio(wav, samplerate=sr, mfcc_mean=mean, mfcc_std=std)
    feats = ((mfcc_for_window(wav, fps=fps, samplerate=sr) - mean) / std).astype(np.float32)[:T]
    mf = np.zeros((B, 26, 1, T), np.float32)
    mf[:, :, 0, : feats.shape[0]] = feats.T
    np.testing.assert_array_equal(got, fresh().feed({"mfcc": mf}))


def test_validation_errors(pair):
    jax_model, params, port = pair
    seed0, mfcc = _inputs()
    session = _session(port)
    with pytest.raises(RuntimeError, match="start"):
        session.feed({"mfcc": mfcc[0]})
    with pytest.raises(ValueError, match="init_seed shape"):
        session.start(np.zeros((B, J, 1, S + 1), np.float32))
    session.start(seed0)
    with pytest.raises(ValueError, match="streams"):
        session.feed_audio(np.zeros((B + 1, 100), np.float32))
    with pytest.raises(ValueError, match="together"):
        session.feed_audio(np.zeros(100, np.float32), mfcc_mean=np.zeros(26))
    prebuilt = create_diffusion(steps=STEPS, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        _session(port, diffusion=prebuilt)
    with pytest.raises(ValueError, match="not both"):
        _session(port, diffusion=prebuilt, sample_steps=None, step_spacing="logsnr")
    with pytest.raises(ValueError, match="unknown sampler"):
        _session(port, sampler="euler")
    for sampler in ("plms", "dpmpp"):  # ported: a session takes them
        _session(port, sampler=sampler)
    # a mesh splits the streams over its data ranks: they must divide
    with pytest.raises(ValueError, match="not divisible"):
        _session(port, mesh=Mesh(data=3, model=1))
    _session(port, mesh=Mesh(data=1, model=1))


def test_latency_accounting_and_reset_stats(pair):
    _, _, port = pair
    seed0, mfcc = _inputs()
    session = _session(port)
    session.start(seed0)
    assert session.stats().chunks == 0
    want = [session.feed({"mfcc": mfcc[k]}) for k in range(C)]
    s = session.stats()
    assert s.chunks == C
    assert s.total_latency_s >= s.worst_latency_s >= s.last_latency_s > 0
    assert s.motion_seconds_per_chunk == pytest.approx(T / 30.0)
    assert s.realtime_speedup > 0
    s.chunks = 99  # a copy
    assert session.stats().chunks == C

    session.start(seed0)
    got = [session.feed({"mfcc": mfcc[0]})]
    session.reset_stats()  # the take goes on
    assert session.stats().chunks == 0
    got += [session.feed({"mfcc": mfcc[k]}) for k in range(1, C)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert session.stats().chunks == C - 1


def test_session_respects_model_nfeats():
    torch.manual_seed(0)
    port = MDM(**SMALL, nfeats=2).eval()
    rs = np.random.RandomState(5)
    session = _session(port)
    session.start(rs.randn(B, J, 2, S).astype(np.float32))
    out = session.feed({"mfcc": rs.randn(B, A, 1, T).astype(np.float32)})
    assert out.shape == (B, J, 2, T) and np.isfinite(out).all()


def test_session_needs_the_card_unless_asked_for_the_cpu(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _session(pair[2], device=None)
