"""Port parity of the flash self-attention wrapper
(gesturediffusion_tpu_torch/ops/flash_attention.py; its CPU path is the
plain version, the CUDA kernel is held against it in test_torch_cuda.py and
chip_smoke.py) against the JAX package's ops/pallas_flash.py:
fused_self_attention in interpret mode, at the shapes of
tests/test_pallas_flash.py, and the encoder layer's choice between its two
attention stages.  Tolerance atol 2e-5, rtol 2e-5, as the JAX test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.ops.pallas_flash import fused_self_attention as jax_flash
from gesturediffusion_tpu_torch.ops.flash_attention import (
    fused_self_attention,
    self_attention_reference,
)
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    MAX_SMEM_BYTES,
    attention_fits,
    attention_smem_bytes,
    flash_stage,
)

TOL = 2e-5


@pytest.mark.parametrize("b,h,t,d,block,seed", [
    (2, 3, 24, 32, None, 0),    # one block (test_single_block_parity)
    (2, 3, 81, 64, None, 0),
    (2, 3, 200, 128, None, 0),
    (1, 2, 300, 64, 128, 1),    # several key blocks: the online rescale
    (1, 2, 513, 64, 128, 1),
    (1, 1, 130, 32, 128, 2),    # T padded to 256 on the TPU side
])
def test_cpu_path_matches_pallas_interpret(b, h, t, d, block, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    blocks = {} if block is None else dict(block_q=block, block_k=block)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                interpret=True, **blocks))
    got = fused_self_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.shape == (b, h, t, d)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_reference_is_sdpa_on_the_cpu():
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(2, 2, 50, 16).astype(np.float32)) for _ in range(3))
    torch.testing.assert_close(self_attention_reference(q, k, v),
                               torch.nn.functional.scaled_dot_product_attention(q, k, v),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,fits", [(81, True), (384, True), (385, False), (1201, False)])
def test_encoder_attention_stage_choice(t, fits):
    """The byte count of encoder_layer.cu:attention at D=256, 4 heads: 53,008
    bytes at T=81; T=385 is the first length past a block's 232,448."""
    assert attention_fits(t, 256, 4) is fits
    assert (attention_smem_bytes(t, 256, 4) <= MAX_SMEM_BYTES) is fits
    if t == 81:
        assert attention_smem_bytes(t, 256, 4) == 53008


@pytest.mark.parametrize("t,d,heads,flash", [
    (81, 256, 4, True), (1201, 256, 4, True),     # dh 64: flash at every length
    (20, 64, 4, True), (300, 512, 4, True),       # dh 16 and 128
    (81, 256, 32, False), (384, 256, 32, False),  # dh 8: whole-sequence stage where it fits
])
def test_encoder_layer_stage_by_head_width(t, d, heads, flash):
    assert flash_stage(t, d, heads) is flash


def test_encoder_layer_stage_raises_past_shared_memory_without_flash():
    with pytest.raises(ValueError, match="exceed shared memory"):
        flash_stage(2000, 256, 32)


def test_flash_wrapper_rejects_other_devices():
    x = torch.empty(1, 2, 20, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_self_attention(x, x, x)
