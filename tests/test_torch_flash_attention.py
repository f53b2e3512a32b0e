"""Port parity of the flash self-attention wrapper
(gesturediffusion_tpu_torch/ops/flash_attention.py; its CPU path is the
plain version, the CUDA kernel is held against it in test_torch_cuda.py and
chip_smoke.py) against the JAX package's ops/pallas_flash.py:
fused_self_attention in interpret mode, at the shapes of
tests/test_pallas_flash.py, and the dispatch of every head width the model
can have (the kernels pad it to the next multiple of 16 up to 128; wider
heads run in csrc/wide_attention.cuh's wide flash forward, whose block
shape tests/torch_port_common.py's ``wide_block_shape`` gives, and in
128-column slices past 544 and for the band kernels).
Tolerance atol 2e-5, rtol 2e-5, as the JAX test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.ops.pallas_flash import fused_self_attention as jax_flash
from gesturediffusion_tpu_torch.ops.band_attention import (
    SLICE_WIDTH,
    check_attention_args,
    kernel_layout,
    padded_head_width,
)
from gesturediffusion_tpu_torch.ops.flash_attention import (
    fused_self_attention,
    self_attention_reference,
)
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    _check_cuda_args as check_layer_args,
)
from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
    _check_cuda_args as check_train_args,
)
from gesturediffusion_tpu_torch.ops.fused_local_block import (
    _check_cuda_args as check_local_block_args,
)
from tests.torch_port_common import WIDE_MAX_WIDTH, narrow_block_shape, wide_block_shape

TOL = 2e-5


@pytest.mark.parametrize("b,h,t,d,block,seed", [
    (2, 3, 24, 32, None, 0),    # one block (test_single_block_parity)
    (2, 3, 81, 64, None, 0),
    (2, 3, 200, 128, None, 0),
    (1, 2, 300, 64, 128, 1),    # several key blocks: the online rescale
    (1, 2, 513, 64, 128, 1),
    (1, 1, 130, 32, 128, 2),    # T padded to 256 on the TPU side
    (1, 2, 81, 136, None, 3),   # heads past 128: one block of the wide kernel on the card,
    (1, 2, 130, 256, None, 4),  # D padded to a multiple of 128 on the TPU side
    (1, 1, 65, 520, None, 5),   # a cluster of two blocks on the card
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


def _layer(t, d, heads, f=None):
    """x [1, t, d] and the 12 layer weights (zeros) of a D = d layer."""
    f = f or 4 * d
    shapes = [(3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (f, d), (f,), (d, f), (d,),
              (d,), (d,)]
    return torch.zeros(1, t, d), tuple(torch.zeros(s) for s in shapes)


@pytest.mark.parametrize("t,d,heads,width", [
    (81, 256, 4, 64), (1201, 256, 4, 64),     # dh 64: the gesture model
    (20, 64, 4, 16), (300, 512, 4, 128),      # dh 16 and 128
    (81, 256, 32, 16), (384, 256, 32, 16),    # dh 8, padded to 16
])
def test_encoder_layer_stage_by_head_width(t, d, heads, width):
    """The inference layer's one attention stage, the flash kernel, at the
    padded width its head width runs at; the layer's checks take the shape."""
    x, w = _layer(t, d, heads)
    check_layer_args(x, w, heads)
    assert padded_head_width(d // heads) == width


def test_encoder_layer_stage_raises_past_shared_memory_without_flash():
    """2000 rows of 32 heads of 8 (past a block's shared memory for a
    whole-sequence stage) take the flash stage, and so do heads wider than
    128 (in 128-column slices); only a D that does not split into the heads
    is refused."""
    x, w = _layer(2000, 256, 32)
    check_layer_args(x, w, 32)
    assert padded_head_width(8) == 16
    x, w = _layer(4, 272, 2)
    check_layer_args(x, w, 2)
    assert padded_head_width(136) == 256
    with pytest.raises(ValueError, match="must split into 3 heads"):
        check_layer_args(x, w, 3)


# the head widths of --latent_dim 32, 264, 320 and 384 at 4 heads; 80 and 96
# are the flash stage's C1 widths (--latent_dim 320 and 384)
C1_WIDTHS = (8, 66, 80, 96)


@pytest.mark.parametrize("dh", C1_WIDTHS)
@pytest.mark.parametrize("t", [81, 266, 1201])
def test_dispatch_takes_every_head_width_of_the_reference(t, dh):
    """The card path's checks take what the JAX package runs: the inference
    layer, the training layer, the band kernel (its local heads of dh) and
    the local block, at the next multiple of 16."""
    x, w = _layer(t, 4 * dh, 4)
    check_layer_args(x, w, 4)
    check_train_args(x, w, torch.zeros(1, dtype=torch.int32), 4)
    q = torch.zeros(1, 2, t, dh)
    check_attention_args("local_attention_band", q, q, q)
    check_local_block_args(torch.zeros(1, t, 8 * dh), torch.zeros(1, 8 * dh), 8, 10)
    assert padded_head_width(dh) == -(-dh // 16) * 16 <= SLICE_WIDTH


@pytest.mark.parametrize("dh,heads,f", [
    (136, 4, None), (256, 4, None), (264, 4, None), (520, 4, None),  # --latent_dim 544 .. 2080
    (65, 2, 1030),  # D = 130, F = 1030: rows that are not 16-byte aligned
])
def test_dispatch_takes_heads_wider_than_128(dh, heads, f):
    """The card path's checks take the head widths past 128 that the JAX
    package runs (pallas_flash.py pads any width to a multiple of 128), and
    D and F not divisible by 4: the inference layer, the training layer, the
    band kernel and the local block at heads of dh, the local block also at
    local heads of dh (8 of them, as the model's; an odd width only where
    rotary refuses it, as in JAX).  Past 128 the width runs in 128-column
    slices."""
    d = heads * dh
    x, w = _layer(4, d, heads, f)
    check_layer_args(x, w, heads)
    check_train_args(x, w, torch.zeros(1, dtype=torch.int32), heads)
    q = torch.zeros(1, 2, 4, dh)
    check_attention_args("local_attention_band", q, q, q)
    if dh % 2 == 0:
        check_local_block_args(x, torch.zeros(1, d), heads, 10)
        check_local_block_args(torch.zeros(1, 4, 8 * dh), torch.zeros(1, 8 * dh), 8, 10)
    else:  # rotary pairs the two halves of a head
        with pytest.raises(ValueError, match="even width"):
            check_local_block_args(x, torch.zeros(1, d), heads, 10)
    want = -(-dh // 16) * 16 if dh <= SLICE_WIDTH else -(-dh // SLICE_WIDTH) * SLICE_WIDTH
    assert padded_head_width(dh) == want


def test_kernel_layout_copies_a_shared_tensor_once():
    """Operands the kernels read through their strides stay as they are; one
    tensor passed three times with a strided head width is copied once, so
    the kernels still see q = k = v."""
    heads = torch.zeros(2, 5, 3, 8).transpose(1, 2)  # the local block's view
    assert all(y is heads for y in kernel_layout(heads, heads, heads))
    odd = torch.zeros(2, 3, 5, 16)[..., ::2]
    q, k, v = kernel_layout(odd, odd, odd)
    assert q.is_contiguous() and q is k is v
    torch.testing.assert_close(q, odd, rtol=0, atol=0)


def test_flash_wrapper_rejects_other_devices():
    x = torch.empty(1, 2, 20, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_self_attention(x, x, x)


# an H100's shared memory a block may use (csrc/common.cuh:kMaxSmem)
MAX_SMEM = 232448


@pytest.mark.parametrize("t", [81, 1201])
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 96, 112, 128])
def test_narrow_block_fits_shared_memory_and_covers_the_width(dh, t):
    """The inference flash forward's block at every padded width to 128:
    shared memory within a block's 232,448 bytes, the raw boxes of 32
    columns cover the width, whole k8 steps of the key tile split among the
    producer's 128 threads, a 64-row wgmma tile per consumer, and no more
    than one block's worth of registers (the consumers' o and q's big parts
    take DHP / 2 + DHP / 2 registers a thread within the 65,536 of an SM)."""
    shape = narrow_block_shape(dh, t)
    assert shape["dhp"] == dh and shape["smem"] <= MAX_SMEM
    assert 32 * shape["nb"] >= dh > 32 * (shape["nb"] - 1)
    assert shape["bk"] * dh % (128 * 4) == 0 and shape["bk"] % 8 == 0
    assert shape["threads"] * (dh // 2 + dh // 2 + shape["bk"] // 2) <= 65536


@pytest.mark.parametrize("b,h,t", [(65536, 1, 3), (70000, 1, 1), (256, 300, 197), (8, 8, 1201)])
def test_narrow_grid_covers_bh_past_the_grid_y_limit(b, h, t):
    """One grid dimension over (batch * head, query tile): B * H past 65535,
    the training body's grid.y limit, launches, and every query row of
    every head has its block."""
    for dh in (8, 64, 80, 128):
        shape = narrow_block_shape(dh, t)
        blocks = shape["blocks"](b, h, t)
        rows = 64 * shape["nc"]
        assert blocks <= 2**31 - 1 and blocks * rows >= b * h * t
        assert blocks == b * h * -(-t // rows)


@pytest.mark.parametrize("dh", [129, 131, 136, 200, 256, 261, 264, 272, 273, 520, 523, 544])
def test_wide_block_covers_the_width_within_shared_memory(dh):
    """The wide flash forward's block at every width it takes: one block to
    272 columns, a cluster of two past it; the blocks' shares (multiples of
    16, a warpgroup's half a whole number of k8 steps) cover the width, each
    warpgroup's accumulator holds its half, and the shared memory fits."""
    shape = wide_block_shape(dh)
    assert shape["cl"] == (1 if dh <= 272 else 2)
    assert shape["w"] % 16 == 0 and shape["cl"] * shape["w"] >= dh
    assert shape["cl"] * shape["w"] - dh < 16 * shape["cl"]
    assert shape["wo"] >= shape["w"] // 2 and shape["bk"] == 32
    assert shape["smem"] <= MAX_SMEM


@pytest.mark.parametrize("dh", [1, 64, 128, WIDE_MAX_WIDTH + 1, 1024])
def test_wide_block_is_only_past_128_and_to_its_widest(dh):
    """Up to 128 the narrow kernels run; past WIDE_MAX_WIDTH the sliced one."""
    assert wide_block_shape(dh) is None

