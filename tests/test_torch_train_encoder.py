"""Port parity of the training encoder layer
(gesturediffusion_tpu_torch/ops/fused_encoder_train.py) against
gesturediffusion_tpu/ops/pallas_encoder_train.py on the CPU.

The hash-PRNG masks must equal JAX's bit for bit.  The plain layer's
forward and all 13 gradients (dx and the 12 parameters; the seed has none)
are held against jax.grad of encoder_layer_train_reference and of the
custom-VJP Pallas layer in interpret mode, so the TPU kernels themselves
are the specification.  Tolerance rtol 1e-5 / atol 1e-5: float32 at small
shapes, sums in another order.  The CUDA kernels are held against the
plain layer on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.ops import pallas_encoder_train as jet
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    SITE_ACT,
    SITE_ATTN,
    SITE_FF,
    SITE_POST_ATTN,
    encoder_layer_plain,
)
from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
    encoder_layer_train_plain,
    fused_encoder_layer_train,
    hash_dropout_mask,
    keep_threshold,
)

RTOL = ATOL = 1e-5
SITES = (SITE_ATTN, SITE_POST_ATTN, SITE_ACT, SITE_FF)


@pytest.mark.parametrize("shape,base", [((64, 1024), 0), ((7, 13), 5), ((3, 4, 9, 9), 1000),
                                        ((1000,), 2**31 - 10)])
@pytest.mark.parametrize("seed", [0, 99, 2**31 - 2, -7])
@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("keep", [0.9, 0.5])
def test_hash_mask_equals_jax_bit_for_bit(shape, base, seed, site, keep):
    want = np.asarray(jet.hash_dropout_mask(shape, base, jnp.int32(seed), site, keep))
    got = hash_dropout_mask(shape, base, seed, site, keep).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash_mask_takes_a_seed_tensor_and_keeps_at_the_rate():
    a = hash_dropout_mask((64, 1024), 0, 123, SITE_ATTN, 0.9)
    b = hash_dropout_mask((64, 1024), 0, torch.tensor(123, dtype=torch.int32), SITE_ATTN, 0.9)
    assert torch.equal(a, b)
    assert abs(a.float().mean().item() - 0.9) < 0.01
    assert keep_threshold(0.9) == 3865470566 and keep_threshold(1.0) == 2**32 - 1


def _jax_weights(d, f, seed=0):
    rs = np.random.RandomState(seed)
    shapes = [(d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
              (d, f), (f,), (f, d), (d,), (d,), (d,)]
    ws = []
    for i, s in enumerate(shapes):
        w = 0.2 * rs.randn(*s)
        ws.append((w + 1.0 if i in (4, 10) else w).astype(np.float32))
    return ws


def _to_port(ws):
    """JAX [in, out] weights -> the port's [out, in] layout."""
    return [torch.from_numpy(np.ascontiguousarray(w.T if w.ndim == 2 else w)) for w in ws]


def _port_value_and_grads(x, ws, g, seed, heads, rate):
    xt = torch.from_numpy(x).requires_grad_()
    wt = [w.requires_grad_() for w in _to_port(ws)]
    out = encoder_layer_train_plain(xt, *wt, seed=seed, num_heads=heads, rate=rate)
    (out * torch.from_numpy(g)).sum().backward()
    grads = [xt.grad.numpy()] + [
        (w.grad.T if w.dim() == 2 else w.grad).numpy() for w in wt
    ]
    return out.detach().numpy(), grads


def _jax_value_and_grads(layer, x, ws, g):
    def loss(x, *ws):
        return jnp.sum(layer(x, *ws) * g)

    out = np.asarray(layer(jnp.asarray(x), *map(jnp.asarray, ws)))
    grads = jax.grad(loss, argnums=tuple(range(13)))(jnp.asarray(x), *map(jnp.asarray, ws))
    return out, [np.asarray(a) for a in grads]


def _assert_same(got, want):
    out, grads = got
    want_out, want_grads = want
    np.testing.assert_allclose(out, want_out, rtol=RTOL, atol=ATOL)
    assert len(grads) == len(want_grads) == 13
    for i, (a, b) in enumerate(zip(grads, want_grads)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"grad {i}")


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.4])
def test_plain_layer_matches_the_reference_and_its_gradients(rate):
    b, t, d, f, h, seed = 3, 11, 16, 32, 4, 99
    rs = np.random.RandomState(1)
    x = rs.randn(b, t, d).astype(np.float32)
    g = rs.randn(b, t, d).astype(np.float32)
    ws = _jax_weights(d, f)

    def ref(x, *ws):
        return jet.encoder_layer_train_reference(x, ws, seed, num_heads=h, rate=rate)

    _assert_same(_port_value_and_grads(x, ws, g, seed, h, rate),
                 _jax_value_and_grads(ref, x, ws, g))


@pytest.mark.parametrize("block_b", [2, 4])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_layer_matches_the_pallas_kernels_in_interpret_mode(block_b, rate):
    """The Pallas forward and backward kernels (custom VJP), T padded to 16
    inside them and B to the block: the port's unpadded global indices
    must draw the same masks."""
    b, t, d, f, h, seed = 5, 13, 16, 32, 4, 5
    rs = np.random.RandomState(2)
    x = rs.randn(b, t, d).astype(np.float32)
    g = rs.randn(b, t, d).astype(np.float32)
    ws = _jax_weights(d, f, seed=3)
    fused = jet.make_fused_train_layer(h, rate, block_b=block_b, interpret=True)

    def kernel(x, *ws):
        return fused(x, *ws, jnp.int32(seed))

    _assert_same(_port_value_and_grads(x, ws, g, seed, h, rate),
                 _jax_value_and_grads(kernel, x, ws, g))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_layer_matches_the_pallas_kernels_at_121_rows(rate):
    """The train CLI's default 120 frames plus the token, the length the
    fused layer now takes on the card: the Pallas kernels pad T to 128 and
    B to the block; the port's unpadded indices must draw the same masks."""
    b, t, d, f, h, seed = 3, 121, 16, 32, 4, 21
    rs = np.random.RandomState(7)
    x = rs.randn(b, t, d).astype(np.float32)
    g = rs.randn(b, t, d).astype(np.float32)
    ws = _jax_weights(d, f, seed=8)
    fused = jet.make_fused_train_layer(h, rate, block_b=2, interpret=True)

    def kernel(x, *ws):
        return fused(x, *ws, jnp.int32(seed))

    _assert_same(_port_value_and_grads(x, ws, g, seed, h, rate),
                 _jax_value_and_grads(kernel, x, ws, g))


def test_rate_zero_is_the_inference_layer():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 9, 16).astype(np.float32))
    wt = _to_port(_jax_weights(16, 32, seed=4))
    got = encoder_layer_train_plain(x, *wt, seed=7, num_heads=4, rate=0.0)
    torch.testing.assert_close(got, encoder_layer_plain(x, *wt, num_heads=4), rtol=0, atol=1e-6)


def test_dropout_drops_and_a_seed_tensor_draws_the_same_masks():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 9, 16).astype(np.float32))
    wt = _to_port(_jax_weights(16, 32, seed=5))
    a = encoder_layer_train_plain(x, *wt, seed=7, num_heads=4, rate=0.3)
    b = encoder_layer_train_plain(x, *wt, seed=torch.tensor([7], dtype=torch.int32),
                                  num_heads=4, rate=0.3)
    c = encoder_layer_train_plain(x, *wt, seed=8, num_heads=4, rate=0.3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-2


def test_cpu_wrapper_is_the_plain_layer_and_gradcheck_in_float64():
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(2, 5, 8)).requires_grad_()
    wt = [w.double().requires_grad_() for w in _to_port(_jax_weights(8, 16, seed=6))]

    def layer(x, *ws):
        return fused_encoder_layer_train(x, *ws, seed=3, num_heads=2, rate=0.25)

    torch.testing.assert_close(
        layer(x, *wt),
        encoder_layer_train_plain(x, *wt, seed=3, num_heads=2, rate=0.25), rtol=0, atol=0)
    assert torch.autograd.gradcheck(layer, (x, *wt), eps=1e-6, atol=1e-5)


def test_unsupported_device_raises():
    x = torch.empty(2, 4, 8, device="meta")
    w = [torch.empty(s, device="meta") for s in
         [(24, 8), (24,), (8, 8), (8,), (8,), (8,), (16, 8), (16,), (8, 16), (8,), (8,), (8,)]]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_encoder_layer_train(x, *w, seed=0, num_heads=2, rate=0.1)
