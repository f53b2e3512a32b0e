"""Port parity of the pre-encoder local block (the CPU path of kernel 1's
wrapper; the CUDA kernel is held against it in test_torch_cuda.py and
chip_smoke.py) against the JAX package: models/mdm.py:
pre_encoder_local_block and ops/pallas_local_block.py:fused_local_block in
interpret mode.  Tolerance rtol 2e-4, atol 2e-5 (float32, as the JAX
package's own kernel test)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.models.mdm import pre_encoder_local_block as jax_block
from gesturediffusion_tpu.ops.local_attention import (
    local_attention_dense as jax_dense,
)
from gesturediffusion_tpu.ops.pallas_local_block import (
    fused_local_block as jax_fused_block,
)
from gesturediffusion_tpu_torch.models.embeddings import rotary_freqs
from gesturediffusion_tpu_torch.ops.fused_local_block import (
    fused_local_block,
    pre_encoder_local_block,
    rotary_table,
)
from gesturediffusion_tpu_torch.ops.local_attention import local_attention_dense

RTOL, ATOL = 2e-4, 2e-5
SHAPES = [
    (3, 16, 64, 8, 5),
    (2, 80, 256, 8, 10),   # the gesture shape at a small batch
    (5, 24, 32, 4, 10),
]


def _inputs(b, t, d, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(b, t, d).astype(np.float32), rs.randn(b, d).astype(np.float32)


@pytest.mark.parametrize("b,t,d,h,w", SHAPES)
def test_cpu_path_matches_jax_composition(b, t, d, h, w):
    x, coa = _inputs(b, t, d)
    want = np.asarray(jax_block(jnp.asarray(x), jnp.asarray(coa), num_heads=h, window_size=w))
    got = fused_local_block(torch.from_numpy(x), torch.from_numpy(coa), num_heads=h, window=w)
    assert got.shape == (b, t + 1, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,t,d,h,w", SHAPES)
def test_cpu_path_matches_pallas_interpret(b, t, d, h, w):
    x, coa = _inputs(b, t, d, seed=1)
    want = np.asarray(jax_fused_block(
        jnp.asarray(x), jnp.asarray(coa), num_heads=h, window=w, block_b=2,
        interpret=True,
    ))
    got = pre_encoder_local_block(
        torch.from_numpy(x), torch.from_numpy(coa), num_heads=h, window_size=w
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(causal=True, look_backward=1),
    dict(causal=True, look_backward=1, exact_windowsize=True),
    dict(causal=False, look_backward=1, look_forward=1),
    dict(causal=True, look_backward=2, with_mask=True),
])
def test_local_attention_dense_matches_jax(kw):
    kw = dict(kw)
    with_mask = kw.pop("with_mask", False)
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(2, 3, 20, 8).astype(np.float32) for _ in range(3))
    mask = (rs.rand(2, 20) > 0.3) if with_mask else None
    if mask is not None:
        mask[:, 0] = True  # every query keeps at least its first key
    want = np.asarray(jax_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window_size=5,
        mask=None if mask is None else jnp.asarray(mask), **kw,
    ))
    got = local_attention_dense(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), window_size=5,
        mask=None if mask is None else torch.from_numpy(mask), **kw,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_unsupported_device_raises():
    x = torch.empty(2, 16, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_local_block(x, torch.empty(2, 64, device="meta"), num_heads=8, window=5)


@pytest.mark.parametrize("t,dh", [(81, 32), (11, 6), (257, 48)])
def test_rotary_table_is_the_plain_table(t, dh):
    """The kernel's cached cos and sin tables are the plain version's bit
    for bit (the card test checks the same on the card)."""
    cos, sin = rotary_table(t, dh, torch.device("cpu"))
    freqs = rotary_freqs(t, dh)
    assert cos.shape == sin.shape == (t, dh // 2)
    assert torch.equal(cos, freqs.cos()[:, : dh // 2])
    assert torch.equal(sin, freqs.sin()[:, dh // 2:])
