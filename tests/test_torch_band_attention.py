"""Port parity of the windowed local attention and the band-attention
dispatch (gesturediffusion_tpu_torch/ops/{local_attention,band_attention}.py)
against the JAX package: ops/local_attention.py (look_around,
local_attention) and ops/pallas_attention.py (local_attention_pallas in
interpret mode, local_attention_auto).  The CPU path of the band kernel's
wrapper is the windowed form; the CUDA kernel is held against it in
test_torch_cuda.py and chip_smoke.py.  Tolerance atol 2e-5, as the JAX
package's own tests/test_pallas_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.ops.local_attention import (
    local_attention as jax_local_attention,
    look_around as jax_look_around,
)
from gesturediffusion_tpu.ops.pallas_attention import (
    local_attention_auto as jax_auto,
    local_attention_pallas,
)
from gesturediffusion_tpu_torch.ops.band_attention import (
    LOCAL_ATTN_DENSE_MAX_T,
    local_attention_auto,
    local_attention_band,
)
from gesturediffusion_tpu_torch.ops.local_attention import (
    local_attention,
    local_attention_dense,
    look_around,
)

ATOL = 2e-5
# as tests/test_pallas_attention.py:TestDenseBandFormulation.CONFIGS
# (b, h, t, d, ws, causal, lb, lf, exact, use_mask)
CONFIGS = [
    (2, 4, 80, 32, 10, True, 1, 0, False, False),
    (2, 4, 80, 32, 10, True, 1, 0, True, False),
    (1, 2, 64, 16, 8, True, 2, 0, False, True),
    (2, 2, 60, 16, 10, False, 1, 1, False, False),
    (2, 2, 60, 16, 10, False, 1, 1, True, True),
    (1, 1, 40, 8, 20, True, 1, 0, False, False),
]


def _qkv(b, h, t, d, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_windowed_matches_jax(cfg):
    """Queries whose band a key mask empties are undefined in both packages
    (test_pallas_attention.py:82-98): only the valid rows are compared."""
    b, h, t, d, ws, causal, lb, lf, exact, use_mask = cfg
    q, k, v = _qkv(b, h, t, d)
    if use_mask:
        lengths = np.random.RandomState(1).randint(t // 2, t, size=(b,))
    else:
        lengths = np.full((b,), t)
    mask = np.arange(t)[None] < lengths[:, None] if use_mask else None
    kw = dict(window_size=ws, causal=causal, look_backward=lb, look_forward=lf,
              exact_windowsize=exact)
    want = np.asarray(jax_local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), **kw))
    got = local_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask), **kw).numpy()
    valid = np.arange(t)[None, None, :, None] < lengths[:, None, None, None]
    np.testing.assert_allclose(np.where(valid, got, 0.0), np.where(valid, want, 0.0), atol=ATOL)


@pytest.mark.parametrize("backward,forward,pad", [(1, 0, -1.0), (2, 1, 0.0)])
def test_look_around_matches_jax(backward, forward, pad):
    x = np.random.RandomState(2).randn(2, 5, 3, 4).astype(np.float32)
    want = np.asarray(jax_look_around(jnp.asarray(x), backward, forward, pad))
    got = look_around(torch.from_numpy(x), backward, forward, pad).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,h,t,d,w,bq", [
    (2, 4, 80, 32, 10, 80),   # the shapes of test_pallas_attention.py:20-25
    (1, 2, 80, 32, 10, 40),
    (1, 2, 160, 16, 10, 40),
    (1, 1, 60, 8, 10, 20),
    (1, 2, 320, 32, 10, None),  # a long chunk, the JAX block choice (80)
])
def test_band_cpu_path_matches_pallas_interpret(b, h, t, d, w, bq):
    q, k, v = _qkv(b, h, t, d, seed=3)
    want = np.asarray(local_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window_size=w, block_q=bq,
        interpret=True))
    got = local_attention_band(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window_size=w)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("t", [80, 320])
def test_auto_matches_jax(t):
    """T=80 takes the dense form in both packages, T=320 the windowed one
    (on the CPU neither takes a kernel)."""
    q, _, _ = _qkv(2, 4, t, 32, seed=4)
    kw = dict(window_size=10, causal=True, look_backward=1, look_forward=0)
    want = np.asarray(jax_auto(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), **kw))
    x = torch.from_numpy(q)
    got = local_attention_auto(x, x, x, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    form = local_attention_dense if t <= LOCAL_ATTN_DENSE_MAX_T else local_attention
    torch.testing.assert_close(got, form(x, x, x, **kw), rtol=0, atol=0)


@pytest.mark.parametrize("fn", [local_attention, local_attention_band])
def test_window_that_does_not_divide_t_raises_as_jax(fn):
    q, k, v = _qkv(1, 1, 37, 8)
    with pytest.raises(ValueError):
        jax_local_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window_size=10)
    with pytest.raises(ValueError, match="divisible by window size 10"):
        fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window_size=10)


def test_windowed_dropout_draws_from_the_generator():
    """Rate 0 draws nothing; at rate 0.5 the same generator seed gives the
    same output and another seed another one, with kept probabilities
    scaled by 2."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 300, 8, seed=5))
    kw = dict(window_size=10)

    def run(seed, rate):
        return local_attention_auto(q, k, v, dropout_rate=rate,
                                    generator=torch.Generator().manual_seed(seed), **kw)

    torch.testing.assert_close(run(0, 0.0), local_attention(q, k, v, **kw), rtol=0, atol=0)
    torch.testing.assert_close(run(1, 0.5), run(1, 0.5), rtol=0, atol=0)
    assert not torch.equal(run(1, 0.5), run(2, 0.5))
    ones = torch.ones_like(v)
    dropped = local_attention_auto(q, k, ones, dropout_rate=0.5,
                                   generator=torch.Generator().manual_seed(3), **kw)
    assert dropped.max().item() <= 2.0 + 1e-5 and dropped.min().item() >= 0.0


def test_band_wrapper_rejects_other_devices():
    x = torch.empty(1, 2, 20, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        local_attention_band(x, x, x, window_size=10)
