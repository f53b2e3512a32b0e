"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here carries the ``cuda`` marker and skips without a card (the
decision is made in a fixture, so every pytest worker collects the same
tests).  The file imports no JAX, so on a machine with a card and no JAX
it runs on its own, without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every product of every kernel runs on the tensor cores in 3xTF32
(f32-level error): the encoder layers' GEMMs, the flash kernel, the
training layer's attention backward and the band attention that the band
kernel and the local block share.  Every head width is taken (up to 128
padded to the next multiple of 16 in shared memory; wider heads in the wide
flash forward's and the attention backward's blocks of the whole width up
to 544, the band and the local block in the same blocks over the band's
key tiles, or in 128-column slices past 544), and so are D and F not
divisible by 4.
Tolerances (float32, TF32 off): local block and band attention rtol 2e-4 /
atol 2e-5 (sums of at most 2w terms); flash attention atol 2e-4 (sums over
up to 1201 keys in another order, online rescaling); encoder layer atol
1e-4, 5e-4 with the flash stage at T = 1201 (sums over K <= 1024 in another
order, two LayerNorms); MDM fast CFG step atol 1e-4; training layer forward
atol 1e-4 and each of its 13 gradients within 5e-4 of that gradient's
largest magnitude (the weight gradients sum over all B*T rows).  The
products on csrc/gemm_ws.cuh are held bit for bit (torch.equal) against
the parent GEMM of csrc/gemm_tf32x3.cuh: the same arithmetic in the same
order.
"""

import ctypes

import numpy as np
import pytest
import torch

from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_fastpath import make_fast_cfg_fn
from gesturediffusion_tpu_torch.models.cfg import classifier_free_guidance
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.ops.band_attention import local_attention_band
from gesturediffusion_tpu_torch.ops.flash_attention import (
    fused_self_attention,
    self_attention_reference,
)
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    encoder_layer_plain,
    fused_encoder_layer,
    kernel_layer_routes,
    layer_product,
    layer_routes,
    split_weight_plain,
    weight_split,
)
from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
    encoder_layer_train_bwd,
    encoder_layer_train_fwd,
    encoder_layer_train_plain,
    fused_encoder_layer_train,
)
from gesturediffusion_tpu_torch.models.embeddings import rotary_freqs
from gesturediffusion_tpu_torch.ops.fused_local_block import (
    fused_local_block,
    pre_encoder_local_block,
    rotary_table,
)
from gesturediffusion_tpu_torch.ops.local_attention import local_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rs, *shape, scale=1.0, device="cpu"):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to(device)


def _encoder_weights(d, f, device, seed=0):
    rs = np.random.RandomState(seed)
    return (
        _randn(rs, 3 * d, d, scale=d**-0.5, device=device), _randn(rs, 3 * d, scale=0.02, device=device),
        _randn(rs, d, d, scale=d**-0.5, device=device), _randn(rs, d, scale=0.02, device=device),
        1.0 + _randn(rs, d, scale=0.1, device=device), _randn(rs, d, scale=0.1, device=device),
        _randn(rs, f, d, scale=d**-0.5, device=device), _randn(rs, f, scale=0.02, device=device),
        _randn(rs, d, f, scale=f**-0.5, device=device), _randn(rs, d, scale=0.02, device=device),
        1.0 + _randn(rs, d, scale=0.1, device=device), _randn(rs, d, scale=0.1, device=device),
    )


@pytest.mark.parametrize("b,t,d,h,w", [
    (82, 80, 256, 8, 10), (3, 16, 64, 8, 5), (5, 24, 32, 4, 10),
    (3, 10, 256, 8, 10), (3, 90, 256, 8, 10), (2, 256, 256, 8, 10),  # one tile; 16 tiles on 5 warps
    (3, 40, 48, 8, 5), (2, 33, 320, 8, 10),  # heads of 6 (one float a copy) and 40
])
def test_local_block_kernel_matches_plain(dev, b, t, d, h, w):
    rs = np.random.RandomState(3)
    x, coa = _randn(rs, b, t, d, device=dev), _randn(rs, b, d, device=dev)
    want = pre_encoder_local_block(x, coa, num_heads=h, window_size=w)
    before = fused_local_block.launches
    got = fused_local_block(x, coa, num_heads=h, window=w)
    torch.cuda.synchronize()
    assert fused_local_block.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("t,dh", [(81, 32), (257, 6), (11, 48)])
def test_rotary_table_is_the_plain_table_on_the_card(dev, t, dh):
    cos, sin = rotary_table(t, dh, dev)
    freqs = rotary_freqs(t, dh, dev)
    assert torch.equal(cos, freqs.cos()[:, : dh // 2])
    assert torch.equal(sin, freqs.sin()[:, : dh // 2])


def test_local_block_kernel_rejects_float64(dev):
    x = torch.zeros(2, 16, 64, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="float32"):
        fused_local_block(x, x[:, 0], num_heads=8, window=5)


@pytest.mark.parametrize("b,t,d,h,f", [
    (82, 81, 256, 4, 1024),  # M = 6642 rows: off every GEMM tile; N 768, 256, 1024; K 256, 1024
    (2, 7, 256, 4, 1024),    # M = 14, under one tile
    (3, 24, 128, 4, 256),
    (2, 7, 64, 2, 96),       # N = 96 and K = 96: off the 64-column tile and the 32-wide K slice
])
def test_encoder_kernel_matches_plain(dev, b, t, d, h, f):
    w = _encoder_weights(d, f, dev)
    x = _randn(np.random.RandomState(4), b, t, d, device=dev)
    want = encoder_layer_plain(x, *w, num_heads=h)
    before = fused_encoder_layer.launches
    got = fused_encoder_layer(x, *w, num_heads=h)
    torch.cuda.synchronize()
    assert fused_encoder_layer.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_encoder_kernel_rejects_wrong_shapes(dev):
    w = list(_encoder_weights(64, 128, dev))
    w[2] = w[2][:, :32]
    with pytest.raises(ValueError, match="wo"):
        fused_encoder_layer(torch.zeros(2, 8, 64, device=dev), *w, num_heads=4)


def test_fast_cfg_step_kernels_match_plain(dev):
    """One guided denoise step of a small MDM through both kernels, against
    the same step with use_kernels=False, and the launch counts."""
    torch.manual_seed(0)
    model = MDM(njoints=12, latent_dim=64, num_layers=2, ff_size=128, seed_poses=4,
                cond_mask_prob=0.1, mfcc_dim=8, window_size=5).to(dev).eval()
    rs = np.random.RandomState(5)
    x = _randn(rs, 3, 12, 1, 20, device=dev)
    cond = {"mfcc": _randn(rs, 3, 8, 1, 20, device=dev),
            "seed": _randn(rs, 3, 12, 1, 4, device=dev),
            "scale": torch.full((3,), 2.5, device=dev)}
    t = torch.tensor([0, 5, 9], device=dev)
    with torch.no_grad():
        pre, guided = make_fast_cfg_fn(model, 0.1)
        lb, enc = fused_local_block.launches, fused_encoder_layer.launches
        got = guided(x, t, pre(cond))
        assert (fused_local_block.launches - lb, fused_encoder_layer.launches - enc) == (1, 2)
        model.use_kernels = False
        want = guided(x, t, pre(cond))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b", [3, 32])
def test_t2m_cfg_forward_kernels_match_plain(dev, b):
    """The humanml-encoder-512 MotionMDM (heads of 128, 197 rows; 2 of its
    8 layers) under CFG at batch 2b = 6 (predict) and 64, through the
    encoder-layer kernel and its flash stage against use_kernels=False,
    with the launch counts.  atol 2e-4: two layers' TOL of 1e-4 each."""
    torch.manual_seed(0)
    model = MotionMDM(latent_dim=512, num_layers=2, ff_size=1024).to(dev).eval()
    rs = np.random.RandomState(6)
    x = _randn(rs, b, 263, 1, 196, device=dev)
    cond = {"text_emb": _randn(rs, b, 512, scale=0.1, device=dev),
            "scale": torch.full((b,), 2.5, device=dev)}
    t = torch.from_numpy(rs.randint(0, 1000, size=b)).to(dev)
    guided = classifier_free_guidance(model, 0.1)
    with torch.no_grad():
        enc, flash = fused_encoder_layer.launches, fused_self_attention.launches
        got = guided(x, t, cond)
        assert (fused_encoder_layer.launches - enc, fused_self_attention.launches - flash) == (2, 2)
        model.use_kernels = False
        want = guided(x, t, cond)
    assert got.shape == (b, 263, 1, 196)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("b,h,t,d,w,strided", [
    (82, 8, 1200, 32, 10, True),   # the long chunk, the local block's transposed heads
    (2, 3, 80, 32, 10, False),
    (1, 2, 160, 16, 10, True),
    (3, 4, 300, 8, 20, False),
])
def test_band_kernel_matches_plain(dev, b, h, t, d, w, strided):
    rs = np.random.RandomState(12)
    if strided:
        q = _randn(rs, b, t, h, d, device=dev).transpose(1, 2)
        k = v = q
    else:
        q, k, v = (_randn(rs, b, h, t, d, device=dev) for _ in range(3))
    want = local_attention(q, k, v, window_size=w)
    before = local_attention_band.launches
    got = local_attention_band(q, k, v, window_size=w)
    torch.cuda.synchronize()
    assert local_attention_band.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


# T and window pairs the band wrapper takes (T divisible by w), around the
# kernel's 64-query tiles and 40-key chunks
BAND_EDGES = [(t, w) for t in (20, 70, 1200, 1210) for w in (5, 10, 16) if t % w == 0]


@pytest.mark.parametrize("layout", ["aliased", "separate", "strided"])
@pytest.mark.parametrize("d", [6, 32, 40, 48])
@pytest.mark.parametrize("t,w", BAND_EDGES)
def test_band_kernel_at_tile_edges_and_widths(dev, t, w, d, layout):
    """One tensor for q, k and v (the local block's) or three, contiguous
    or as the transposed view of [B, T, H, dh]; head widths off the 16-wide
    padding and one not divisible by 4 (copied a float at a time)."""
    b, h = 2, 3
    rs = np.random.RandomState(18)
    if layout == "strided":
        q = _randn(rs, b, t, h, d, device=dev).transpose(1, 2)
        k = _randn(rs, b, t, h, d, device=dev).transpose(1, 2)
        v = q
    elif layout == "aliased":
        q = k = v = _randn(rs, b, h, t, d, device=dev)
    else:
        q, k, v = (_randn(rs, b, h, t, d, device=dev) for _ in range(3))
    want = local_attention(q, k, v, window_size=w)
    got = local_attention_band(q, k, v, window_size=w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


# head widths the reference runs that the kernels pad (8 -> 16, 66 -> 80,
# 80, 96): --latent_dim 32, 264, 320 and 384 at 4 heads
C1_WIDTHS = (8, 66, 80, 96)


@pytest.mark.parametrize("dh", C1_WIDTHS)
@pytest.mark.parametrize("t", [81, 1201])
def test_flash_kernel_at_the_c1_widths(dev, t, dh):
    rs = np.random.RandomState(19)
    q, k, v = (_randn(rs, 2, 4, t, dh, device=dev) for _ in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dh", C1_WIDTHS)
@pytest.mark.parametrize("t", [81, 1201])
def test_encoder_kernel_at_the_c1_widths(dev, t, dh):
    d = 4 * dh
    w = _encoder_weights(d, 4 * d, dev, seed=20)
    x = _randn(np.random.RandomState(20), 2, t, d, device=dev)
    want = encoder_layer_plain(x, *w, num_heads=4)
    got = fused_encoder_layer(x, *w, num_heads=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("dh", C1_WIDTHS)
@pytest.mark.parametrize("t", [81, 121])
def test_train_kernels_at_the_c1_widths(dev, t, dh, rate):
    _check_train_kernels(dev, 2, t, 4 * dh, 4, 4 * dh, rate)


@pytest.mark.parametrize("b,h,t,d", [(4, 4, 1201, 64), (2, 3, 130, 32), (1, 2, 513, 128),
                                     (2, 3, 24, 32)])
def test_flash_kernel_matches_reference(dev, b, h, t, d):
    rs = np.random.RandomState(13)
    q, k, v = (_randn(rs, b, h, t, d, device=dev) for _ in range(3))
    want = self_attention_reference(q, k, v)
    before = fused_self_attention.launches
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_self_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 63, 65, 777, 1201])
def test_flash_kernel_at_tile_edges(dev, t, d, packed):
    """Lengths around the 64-query and the 64- (16 above d 64) key tiles, at
    head widths that need no padding, through [B, H, T, D] tensors and
    through the strides of a packed [B, T, 3, H, D] qkv as the encoder layer
    hands it over."""
    b, h = 2, 2
    rs = np.random.RandomState(16)
    if packed:
        qkv = _randn(rs, b, t, 3, h, d, device=dev)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = (_randn(rs, b, h, t, d, device=dev) for _ in range(3))
    want = self_attention_reference(q, k, v)
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("t,heads,flash", [(81, 4, 1), (1201, 4, 1), (81, 32, 1)])
def test_encoder_layer_takes_the_flash_stage_past_shared_memory(dev, t, heads, flash):
    """The flash stage, the layer's one attention stage, at every length
    and head width: 64 past shared memory and below it, and 8 (padded to
    16)."""
    w = _encoder_weights(256, 1024, dev, seed=14)
    x = _randn(np.random.RandomState(14), 2, t, 256, device=dev)
    want = encoder_layer_plain(x, *w, num_heads=heads)
    before = (fused_encoder_layer.launches, fused_self_attention.launches)
    got = fused_encoder_layer(x, *w, num_heads=heads)
    torch.cuda.synchronize()
    assert (fused_encoder_layer.launches - before[0],
            fused_self_attention.launches - before[1]) == (1, flash)
    torch.testing.assert_close(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("t,band,block", [(80, 0, 1), (320, 1, 0)])
def test_model_local_block_kernel_by_length(dev, t, band, block):
    """Kernel 2 up to 256 frames, the band kernel above; both against the
    plain block."""
    torch.manual_seed(0)
    model = MDM(njoints=12, latent_dim=64, num_layers=1, ff_size=128, seed_poses=4,
                cond_mask_prob=0.1, mfcc_dim=8, window_size=5).to(dev).eval()
    rs = np.random.RandomState(15)
    xseq, coa = _randn(rs, 3, t, 64, device=dev), _randn(rs, 3, 64, device=dev)
    before = (local_attention_band.launches, fused_local_block.launches)
    with torch.no_grad():
        got = model.local_block(xseq, coa)
        torch.cuda.synchronize()
        assert (local_attention_band.launches - before[0],
                fused_local_block.launches - before[1]) == (band, block)
        model.use_kernels = False
        want = model.local_block(xseq, coa)
    assert (local_attention_band.launches - before[0],
            fused_local_block.launches - before[1]) == (band, block)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


GRAD_RTOL = 5e-4


def _train_layer_value_and_grads(layer, x, w, g, **kw):
    x = x.detach().clone().requires_grad_()
    w = [t.detach().clone().requires_grad_() for t in w]
    out = layer(x, *w, **kw)
    out.backward(g)
    return out.detach(), [x.grad] + [t.grad for t in w]


def _check_train_kernels(dev, b, t, d, h, f, rate, row0=0):
    w = _encoder_weights(d, f, dev, seed=7)
    rs = np.random.RandomState(8)
    x, g = _randn(rs, b, t, d, device=dev), _randn(rs, b, t, d, device=dev)
    seed = torch.tensor([12345], dtype=torch.int32, device=dev)
    kw = dict(seed=seed, num_heads=h, rate=rate, row0=row0)
    before = (encoder_layer_train_fwd.launches, encoder_layer_train_bwd.launches)
    got, got_grads = _train_layer_value_and_grads(fused_encoder_layer_train, x, w, g, **kw)
    want, want_grads = _train_layer_value_and_grads(encoder_layer_train_plain, x, w, g, **kw)
    torch.cuda.synchronize()
    assert (encoder_layer_train_fwd.launches - before[0],
            encoder_layer_train_bwd.launches - before[1]) == (1, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    for i, (a, e) in enumerate(zip(got_grads, want_grads)):
        err = (a - e).abs().max().item()
        assert err <= GRAD_RTOL * e.abs().max().item() + 1e-7, (i, err, e.abs().max().item())


@pytest.mark.parametrize("b,t,d,h,f", [(64, 81, 256, 4, 1024), (64, 121, 256, 4, 1024),
                                       (3, 24, 128, 4, 256), (2, 7, 64, 2, 96),
                                       (4, 197, 512, 4, 1024), (4, 61, 512, 4, 1024)])
@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_train_kernels_match_plain(dev, b, t, d, h, f, rate):
    """Forward and backward kernels against autograd through the plain
    hash-dropout layer, with the same seed (so the same masks); 121 rows is
    the train CLI's default of 120 frames and the token, [4, 197, 512] the
    text-to-motion model's layer (heads of 128, 196 frames and the token),
    [4, 61, 512] the action-to-motion model's (60 frames and the token: one
    partial 64-row tile)."""
    _check_train_kernels(dev, b, t, d, h, f, rate)


@pytest.mark.parametrize("b,t,d,h,f,row0", [(64, 81, 256, 4, 1024, 64),
                                            (64, 121, 256, 4, 1024, 192), (2, 7, 64, 2, 96, 3)])
def test_train_kernels_at_a_row_offset(dev, b, t, d, h, f, row0):
    """A data rank's share of a global batch: the kernels' hash dropout
    counts from the share's first row, as the plain twin's does."""
    _check_train_kernels(dev, b, t, d, h, f, 0.1, row0)


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 64, 65, 121, 321])
def test_train_kernels_at_tile_edges(dev, t, dh, rate):
    """Lengths around the attention's 64-row blocks and its 32- (16 above dh
    64) row tiles, past any shared-memory limit, at head widths that need no
    padding (the padded ones: test_train_kernels_at_the_c1_widths)."""
    _check_train_kernels(dev, 2, t, 2 * dh, 2, 4 * dh, rate)


def test_train_backward_is_bit_for_bit_repeatable(dev):
    """No atomics: two backward calls on the same inputs give the same bits."""
    w = _encoder_weights(256, 1024, dev, seed=17)
    rs = np.random.RandomState(17)
    x, g = _randn(rs, 64, 121, 256, device=dev), _randn(rs, 64, 121, 256, device=dev)
    seed = torch.tensor([777], dtype=torch.int32, device=dev)
    kw = dict(seed=seed, g=g, num_heads=4, rate=0.1)
    first = encoder_layer_train_bwd(x, *w, **kw)
    second = encoder_layer_train_bwd(x, *w, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_train_kernels_reject_a_head_width(dev):
    """The training kernels reject no head width: 2 heads of 136 (past
    128: the wide flash forward and backward) are taken as 8 heads
    of 8 at D = 64 are (at the padded width 16), forward and backward
    against the plain layer."""
    _check_train_kernels(dev, 1, 9, 272, 2, 544, 0.1)
    _check_train_kernels(dev, 2, 8, 64, 8, 128, 0.1)


# the inference flash forward to 128 columns (csrc/flash_attention.cuh's
# flash_fwd_narrow_kernel): a producer warpgroup lands K and V by tensor
# copies (a float at a time where rows are not 16-byte aligned) and splits
# them, one or two consumer warpgroups run both products on wgmma
NARROW_WIDTHS = (16, 32, 48, 64, 80, 96, 112, 128)


@pytest.mark.parametrize("dh", NARROW_WIDTHS)
@pytest.mark.parametrize("t", [1, 17, 63, 64, 65, 81, 197, 1201])
def test_flash_kernel_narrow_at_every_width_and_length(dev, t, dh):
    """Lengths around the 64-row consumer tiles and the 32- and 64-key
    tiles, from one row, at every padded width."""
    rs = np.random.RandomState(36)
    q, k, v = (_randn(rs, 2, 2, t, dh, device=dev) for _ in range(3))
    before = fused_self_attention.launches
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused_self_attention.launches == before + 1
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dh", NARROW_WIDTHS)
def test_flash_kernel_narrow_reads_a_packed_qkv_buffer(dev, dh):
    """q, k and v as strided views of one [B, T, 3D] buffer, as the encoder
    layer's chain passes them: the tensor maps order the dimensions by
    stride (H before T)."""
    b, t, h = 2, 97, 2
    d = h * dh
    packed = _randn(np.random.RandomState(37), b, t, 3 * d, device=dev)
    q, k, v = (packed[..., i * d:(i + 1) * d].reshape(b, t, h, dh).transpose(1, 2)
               for i in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dh", [18, 66, 126])
@pytest.mark.parametrize("t", [17, 300])
def test_flash_kernel_narrow_with_unaligned_rows(dev, t, dh):
    """Head widths not divisible by 4: rows copied a float at a time by
    cp.async into the same swizzled raw tiles, in the same kernel."""
    rs = np.random.RandomState(38)
    q, k, v = (_randn(rs, 2, 2, t, dh, device=dev) for _ in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_kernel_narrow_is_bit_for_bit_repeatable(dev, dh):
    """No atomics, every sum in a fixed order: two calls, the same bits."""
    rs = np.random.RandomState(39)
    q, k, v = (_randn(rs, 8, 4, 300, dh, device=dev) for _ in range(3))
    first = fused_self_attention(q, k, v)
    second = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("bh", [65535, 65536])
def test_flash_kernel_narrow_past_the_grid_guard(dev, bh, dh):
    """B * H at and past 65535, the training body's grid.y limit: the
    inference body indexes (batch * head, query tile) in grid.x."""
    rs = np.random.RandomState(40)
    q, k, v = (_randn(rs, bh, 1, 3, dh, device=dev) for _ in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


def test_encoder_layer_runs_the_narrow_flash_stage_at_the_gesture_shape(dev):
    """Kernel 1 at the gesture step's [82, 81, 256] (4 heads of 64): its
    attention stage is the inference flash body, counted once."""
    w = _encoder_weights(256, 1024, dev, seed=41)
    x = _randn(np.random.RandomState(41), 82, 81, 256, device=dev)
    want = encoder_layer_plain(x, *w, num_heads=4)
    before = (fused_encoder_layer.launches, fused_self_attention.launches)
    got = fused_encoder_layer(x, *w, num_heads=4)
    torch.cuda.synchronize()
    assert (fused_encoder_layer.launches - before[0],
            fused_self_attention.launches - before[1]) == (1, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# csrc/gemm_ws.cuh, the inference layer's products: M off every tile, the
# gesture and t2m layers' N and K
GEMM_WS_M, GEMM_WS_N, GEMM_WS_K = (1, 63, 129, 6642), (256, 768, 1024), (256, 512, 1024)


def _product_operands(m, n, k, seed):
    rs = np.random.RandomState(seed)
    return (_randn(rs, m, k, device="cuda"), _randn(rs, n, k, scale=k**-0.5, device="cuda"),
            _randn(rs, n, scale=0.02, device="cuda"), _randn(rs, m, n, device="cuda"))


@pytest.mark.parametrize("k", GEMM_WS_K)
@pytest.mark.parametrize("n", GEMM_WS_N)
@pytest.mark.parametrize("m", GEMM_WS_M)
def test_gemm_ws_matches_the_parent_gemm(dev, m, n, k):
    """The new GEMM against the parent (gemm_tf32x3.cuh's gemm_nt) on the
    same operands, bias epilogue: the same three passes in the same order
    over K (the difference, and whether it is zero, printed), and both
    against the float64 product, within 2e-5 of its largest magnitude: the
    tensor cores truncate each sum into the accumulator, 384 times at K 1024
    (gemm_tf32x3.cuh's note on kTcFlushK)."""
    a, w, bias, _ = _product_operands(m, n, k, 50)
    got = layer_product(a, w, bias)
    parent = layer_product(a, w, bias, parent=True)
    torch.cuda.synchronize()
    want = a.double() @ w.double().T + bias.double()
    scale = want.abs().max().item()
    diff = (got - parent).abs().max().item()
    print(f"gemm_ws vs parent [{m},{n},{k}]: max|diff| {diff:.3e}, bit for bit "
          f"{torch.equal(got, parent)}")
    assert diff <= 2e-5 * scale, diff
    for c in (got, parent):
        assert (c.double() - want).abs().max().item() <= 2e-5 * scale


@pytest.mark.parametrize("epi", ["gelu", "resid"])
@pytest.mark.parametrize("m,n,k", [(6642, 1024, 256), (6642, 256, 1024), (129, 768, 512)])
def test_gemm_ws_epilogues_match_the_parent(dev, m, n, k, epi):
    a, w, bias, resid = _product_operands(m, n, k, 51)
    got = layer_product(a, w, bias, epi=epi, resid=resid)
    parent = layer_product(a, w, bias, epi=epi, resid=resid, parent=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, parent, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [256, 128, 36])
@pytest.mark.parametrize("m,k", [(1, 256), (63, 1024), (129, 512), (6642, 256), (6642, 1024)])
def test_gemm_ws_layernorm_epilogue_matches_plain(dev, m, n, k):
    """bias + residual + LayerNorm in the epilogue (whole rows of N <= 256 in
    one warpgroup; columns past N left out of the statistics) against the
    parent's product and F.layer_norm."""
    a, w, bias, resid = _product_operands(m, n, k, 52)
    rs = np.random.RandomState(53)
    lw, lb = 1.0 + _randn(rs, n, scale=0.1, device=dev), _randn(rs, n, scale=0.1, device=dev)
    got = layer_product(a, w, bias, epi="ln", resid=resid, ln=(lw, lb))
    pre = layer_product(a, w, bias, epi="resid", resid=resid, parent=True)
    want = torch.nn.functional.layer_norm(pre, (n,), lw, lb, 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("n,k", [(768, 256), (256, 1024), (96, 12), (5, 1040)])
def test_weight_split_kernel_is_its_plain_twin(dev, n, k):
    w = _randn(np.random.RandomState(54), n, k, device=dev)
    assert torch.equal(weight_split(w).split, split_weight_plain(w))


def test_gemm_ws_raises_outside_its_rule(dev):
    """K past 1024, or a width not a multiple of 4, is refused, not run."""
    for m, n, k in ((64, 256, 1040), (64, 258, 256)):
        a, w, bias, _ = _product_operands(m, n, k, 55)
        with pytest.raises(RuntimeError, match="encoder_layer"):
            layer_product(a, w, bias)


@pytest.mark.parametrize("d", [32, 64, 130, 198, 256, 264, 512, 1024, 1088])
@pytest.mark.parametrize("f", [128, 1024, 1030, 1040, 4096])
def test_layer_routes_mirror_the_kernels(dev, d, f):
    assert kernel_layer_routes(d, f) == layer_routes(d, f)


def _layer_kernel_count(x, w, heads):
    from torch.profiler import ProfilerActivity, profile

    fused_encoder_layer(x, *w, num_heads=heads)  # the splits, once
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_encoder_layer(x, *w, num_heads=heads)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type != torch.autograd.DeviceType.CPU)


@pytest.mark.parametrize("d,launches", [(256, 5), (512, 7)])
def test_encoder_layer_launches(dev, d, launches):
    """The gesture layer is five kernels (qkv, flash, out + LN1, ff1,
    ff2 + LN2); past D 256 the two LayerNorm launches stay."""
    w = _encoder_weights(d, 1024, dev, seed=56)
    x = _randn(np.random.RandomState(56), 8, 81, d, device=dev)
    assert _layer_kernel_count(x, w, 4) == launches


@pytest.mark.parametrize("change", ["add_", "copy_", "load_state_dict"])
def test_encoder_layer_sees_a_weight_changed_in_place(dev, change):
    """A weight changed in place after a call (an optimizer step, copy_,
    load_state_dict) is split again: the next call is the plain layer's on
    the new values."""
    from gesturediffusion_tpu_torch.models.transformer import TransformerEncoderLayer

    torch.manual_seed(57)
    layer = TransformerEncoderLayer(256, 4, 1024, 0.0).to(dev).eval()
    x = _randn(np.random.RandomState(57), 4, 81, 256, device=dev)
    with torch.no_grad():
        first = layer(x)
        if change == "add_":
            for prm in layer.parameters():
                prm.add_(0.01 * torch.randn_like(prm))
        elif change == "copy_":
            layer.linear2.weight.copy_(torch.randn_like(layer.linear2.weight) * 0.03)
        else:
            other = TransformerEncoderLayer(256, 4, 1024, 0.0).to(dev)
            layer.load_state_dict(other.state_dict())
        got = layer(x)
        want = encoder_layer_plain(x, *layer.weights(), num_heads=4)
    torch.cuda.synchronize()
    assert (got - first).abs().max().item() > 1e-3
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("d", [256, 512])
def test_encoder_layer_of_inference_tensors(dev, d):
    """A layer built under torch.inference_mode(): its weights count no
    versions, so each call splits them anew, and those splits live until the
    layer's launches are queued (the scratch the call allocates after them
    never takes their memory).  Two calls at [82,81,D] against the plain
    layer."""
    from gesturediffusion_tpu_torch.models.transformer import TransformerEncoderLayer

    torch.manual_seed(59)
    with torch.inference_mode():
        layer = TransformerEncoderLayer(d, 4, 1024, 0.0).to(dev).eval()
        assert all(w.is_inference() for w in layer.weights())
        x = _randn(np.random.RandomState(59), 82, 81, d, device=dev)
        before = weight_split.launches
        got = [layer(x) for _ in range(2)]
        want = encoder_layer_plain(x, *layer.weights(), num_heads=4)
    torch.cuda.synchronize()
    assert weight_split.launches - before == 8
    for y in got:
        torch.testing.assert_close(y, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("d,heads,f", [(130, 2, 1030), (198, 3, 792), (256, 4, 1040)])
def test_encoder_layer_outside_the_rule_takes_the_parent(dev, d, heads, f):
    """Products outside gemm_ws.cuh's rule run the parent GEMM (no split of
    their weights) and the layer still matches the plain one."""
    w = _encoder_weights(d, f, dev, seed=58)
    x = _randn(np.random.RandomState(58), 3, 81, d, device=dev)
    before = weight_split.launches
    got = fused_encoder_layer(x, *w, num_heads=heads)
    torch.cuda.synchronize()
    assert weight_split.launches - before == bin(layer_routes(d, f) & 15).count("1")
    torch.testing.assert_close(got, encoder_layer_plain(x, *w, num_heads=heads), rtol=0,
                               atol=1e-4)


# head widths past 128 (csrc/wide_attention.cuh): --latent_dim 544, 1024,
# 1056 and 2080 at 4 heads
WIDE_WIDTHS = (136, 256, 264, 520)
# past 544 the flash forward runs in 128-column slices (flash_sliced_kernel):
# --latent_dim 2240 and 4096 at 4 heads
SLICED_WIDTHS = (560, 1024)


@pytest.mark.parametrize("dh", WIDE_WIDTHS + SLICED_WIDTHS)
@pytest.mark.parametrize("t", [81, 1201])
def test_flash_kernel_at_wide_widths(dev, t, dh):
    rs = np.random.RandomState(21)
    q, k, v = (_randn(rs, 2, 4, t, dh, device=dev) for _ in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dh", WIDE_WIDTHS)
@pytest.mark.parametrize("t", [81, 300])
def test_encoder_kernel_at_wide_widths(dev, t, dh):
    d = 4 * dh
    w = _encoder_weights(d, 4 * d, dev, seed=22)
    x = _randn(np.random.RandomState(22), 2, t, d, device=dev)
    want = encoder_layer_plain(x, *w, num_heads=4)
    got = fused_encoder_layer(x, *w, num_heads=4)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("dh", WIDE_WIDTHS)
@pytest.mark.parametrize("t", [81, 121])
def test_train_kernels_at_wide_widths(dev, t, dh, rate):
    _check_train_kernels(dev, 2, t, 4 * dh, 4, 4 * dh, rate)


# the flash forward's routes past 128: one block (136, 256), a cluster of two
# (520), 128-column slices (560)
WIDE_ROUTES = (136, 256, 520, 560)


@pytest.mark.parametrize("dh", WIDE_ROUTES)
@pytest.mark.parametrize("t", [1, 15, 17, 63, 65, 129, 1201])
def test_flash_kernel_wide_at_ragged_lengths(dev, t, dh):
    """Lengths around the 32-key tiles and the 64-row blocks, from one row."""
    rs = np.random.RandomState(31)
    q, k, v = (_randn(rs, 1, 2, t, dh, device=dev) for _ in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dh", [131, 261, 523, 563])
@pytest.mark.parametrize("t", [17, 300])
def test_flash_kernel_wide_with_unaligned_rows(dev, t, dh):
    """Head widths not divisible by 4: rows copied a float at a time."""
    rs = np.random.RandomState(32)
    q, k, v = (_randn(rs, 2, 2, t, dh, device=dev) for _ in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dh", WIDE_ROUTES)
def test_flash_kernel_wide_reads_a_packed_qkv_buffer(dev, dh):
    """q, k and v as strided views of one [B, T, 3D] buffer, as the encoder
    layer's chain passes them."""
    b, t, h = 2, 97, 2
    d = h * dh
    packed = _randn(np.random.RandomState(33), b, t, 3 * d, device=dev)
    q, k, v = (packed[..., i * d:(i + 1) * d].reshape(b, t, h, dh).transpose(1, 2)
               for i in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


@pytest.mark.parametrize("dh", WIDE_ROUTES)
def test_flash_kernel_wide_is_bit_for_bit_repeatable(dev, dh):
    """No atomics, partial scores added in a fixed order: two calls, the
    same bits."""
    rs = np.random.RandomState(34)
    q, k, v = (_randn(rs, 2, 4, 300, dh, device=dev) for _ in range(3))
    first = fused_self_attention(q, k, v)
    second = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dh", [136, 520])
@pytest.mark.parametrize("bh", [65535, 65536])
def test_flash_kernel_wide_past_the_grid_guard(dev, bh, dh):
    """B * H at and past 65535, the narrow kernels' grid.y limit: the wide
    route indexes (batch * head, query tile) in grid.x."""
    rs = np.random.RandomState(35)
    q, k, v = (_randn(rs, bh, 1, 3, dh, device=dev) for _ in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)


def test_flash_kernel_sliced_stops_at_the_grid_guard(dev):
    """Past 544 the sliced route keeps B * H in grid.y: 65535 runs, 65536
    raises (no launch, no fallback)."""
    rs = np.random.RandomState(35)
    q, k, v = (_randn(rs, 65535, 1, 3, 560, device=dev) for _ in range(3))
    got = fused_self_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, self_attention_reference(q, k, v), rtol=0, atol=2e-4)
    q = torch.zeros(65536, 1, 3, 560, device=dev)
    with pytest.raises(RuntimeError, match="flash_attention"):
        fused_self_attention(q, q, q)


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("dh", [256, 520, 560])
def test_train_kernels_wide_lse_is_the_plain_logsumexp(dev, dh, rate):
    """The training forward's row log-sum-exp (log2 units), read from the
    backward's workspace (its last two [B*H, T] blocks are the LSE and D;
    its first [B*T, 3D] the recomputed qkv), against logsumexp of the
    scores computed from that qkv in plain PyTorch.  The dropout does not
    touch it (the row sums take p before the drop).  atol 1e-4: scores of
    magnitude ~10 in another summation order."""
    from gesturediffusion_tpu_torch.ops import fused_encoder_train as fet

    b, t, h = 2, 81, 2
    d, f = h * dh, 2 * h * dh
    w = _encoder_weights(d, f, dev, seed=36)
    rs = np.random.RandomState(36)
    x, g = _randn(rs, b, t, d, device=dev), _randn(rs, b, t, d, device=dev)
    seed = torch.tensor([4242], dtype=torch.int32, device=dev)
    keep = 1.0 - rate
    _, bwd, ws_floats = fet._kernels()
    ws = torch.empty(ws_floats(b, t, d, f, h, 1), dtype=torch.float32, device=dev)
    outs = [torch.empty_like(x), *(torch.empty_like(y) for y in w)]
    held = fet._splits(w, True)  # the products' splits, as the wrapper passes them
    maps = [None if sp is None else ctypes.addressof(sp.map) for sp in held]
    code = bwd(x.data_ptr(), *(y.data_ptr() for y in w), seed.data_ptr(), g.data_ptr(),
               *(o.data_ptr() for o in outs), ws.data_ptr(), b, t, d, f, h, dh**-0.5,
               fet.keep_threshold(keep), 1.0 / keep, int(rate > 0.0), 0, *maps,
               torch.cuda.current_stream().cuda_stream)
    assert code == 0, code
    torch.cuda.synchronize()
    mh = b * t * h
    lse = ws[ws.numel() - 2 * mh:ws.numel() - mh].reshape(b, h, t)
    qkv = ws[:b * t * 3 * d].reshape(b, t, 3, h, dh)
    q, k = qkv[:, :, 0].transpose(1, 2), qkv[:, :, 1].transpose(1, 2)
    scores = torch.einsum("bhid,bhjd->bhij", q, k) * dh**-0.5
    want = torch.logsumexp(scores, dim=-1) / np.log(2.0)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dh", [256, 520, 560])
def test_train_kernels_wide_dropout_at_300_rows(dev, dh):
    """The training forward's site-0 dropout at the wide route against the
    plain twin under the same hash masks, over ten 32-key tiles (and the
    backward, which recomputes it)."""
    _check_train_kernels(dev, 2, 300, 2 * dh, 2, 2 * dh, 0.1)


# the attention backward's routes past 128: the wide passes in one block
# (136, 256) and in a cluster of two (520); the sliced passes past 544
WIDE_BWD_ROUTES = (136, 256, 520)


@pytest.mark.parametrize("dh", WIDE_BWD_ROUTES)
@pytest.mark.parametrize("t", [1, 15, 17, 31, 33, 63, 65, 129, 300])
def test_train_backward_wide_at_ragged_lengths(dev, t, dh):
    """The wide passes at lengths around their 8-row tiles and 64-row
    blocks, from one row: the 13 gradients against the plain layer's."""
    _check_train_kernels(dev, 1, t, 2 * dh, 2, 2 * dh, 0.1)


@pytest.mark.parametrize("dh", [131, 261, 523])
@pytest.mark.parametrize("t", [17, 81])
def test_train_backward_wide_with_unaligned_rows(dev, t, dh):
    """Head widths not divisible by 4: rows copied a float at a time."""
    _check_train_kernels(dev, 2, t, 2 * dh, 2, 2 * dh, 0.1)


@pytest.mark.parametrize("dh", WIDE_BWD_ROUTES)
def test_train_backward_wide_is_bit_for_bit_repeatable(dev, dh):
    """No atomics, partial scores added in a fixed order: two backward
    calls, the same bits."""
    w = _encoder_weights(2 * dh, 2 * dh, dev, seed=37)
    rs = np.random.RandomState(37)
    x, g = _randn(rs, 2, 300, 2 * dh, device=dev), _randn(rs, 2, 300, 2 * dh, device=dev)
    seed = torch.tensor([777], dtype=torch.int32, device=dev)
    kw = dict(seed=seed, g=g, num_heads=2, rate=0.1)
    first = encoder_layer_train_bwd(x, *w, **kw)
    second = encoder_layer_train_bwd(x, *w, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dh", [136, 520])
@pytest.mark.parametrize("bh", [65535, 65536])
def test_train_backward_wide_past_the_grid_guard(dev, bh, dh):
    """B * H at and past 65535, the sliced passes' grid.y limit: the wide
    passes index (batch * head, row tile) in grid.x."""
    _check_train_kernels(dev, bh, 3, dh, 1, 64, 0.1)


@pytest.mark.parametrize("dh,row0", [(256, 64), (520, 3)])
def test_train_kernels_wide_at_a_row_offset(dev, dh, row0):
    """A data rank's share of a global batch at the wide routes: the
    backward's site-0 mask counts from the share's first row."""
    _check_train_kernels(dev, 4, 81, 2 * dh, 2, 2 * dh, 0.1, row0)


@pytest.mark.parametrize("dh,route", [(256, "wide"), (520, "wide"), (560, "sliced")])
def test_train_backward_takes_its_route_by_width(dev, dh, route):
    """The backward's passes by the profiler's kernel names: the wide ones
    to 544, the sliced ones past it; the gradients against the plain
    layer's."""
    from torch.profiler import ProfilerActivity, profile

    w = _encoder_weights(2 * dh, 2 * dh, dev, seed=38)
    rs = np.random.RandomState(38)
    x, g = _randn(rs, 2, 81, 2 * dh, device=dev), _randn(rs, 2, 81, 2 * dh, device=dev)
    seed = torch.tensor([4242], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        encoder_layer_train_bwd(x, *w, seed=seed, g=g, num_heads=2, rate=0.1)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    for part in ("dq", "dkdv"):
        assert any(f"attn_bwd_{part}_{route}_kernel" in n for n in names), (part, sorted(names))
    other = "sliced" if route == "wide" else "wide"
    assert not any(f"attn_bwd_{part}_{other}_kernel" in n for part in ("dq", "dkdv")
                   for n in names), sorted(names)
    _check_train_kernels(dev, 2, 81, 2 * dh, 2, 2 * dh, 0.1)


def _band_operands(rs, b, h, t, dh, layout, dev):
    """q, k, v of one layout: the local block's transposed heads (q = k = v
    strided), one tensor, or three."""
    if layout == "strided":
        q = _randn(rs, b, t, h, dh, device=dev).transpose(1, 2)
        return q, q, q
    if layout == "aliased":
        q = _randn(rs, b, h, t, dh, device=dev)
        return q, q, q
    return tuple(_randn(rs, b, h, t, dh, device=dev) for _ in range(3))


# lengths on both sides of the wide band's 64-row blocks and 32-key tiles
# that the window divides, as the band wrapper requires, and the long chunk
WIDE_BAND_LENGTHS = [(1, 1), (15, 1), (17, 1), (63, 1), (65, 1), (129, 1), (60, 10), (70, 10),
                     (130, 10), (80, 10), (1200, 10), (64, 64), (128, 64), (192, 64), (320, 64),
                     (300, 100)]


@pytest.mark.parametrize("layout", ["aliased", "separate", "strided"])
@pytest.mark.parametrize("dh", [136, 264])
@pytest.mark.parametrize("t,w", WIDE_BAND_LENGTHS)
def test_band_kernel_at_wide_widths(dev, t, w, dh, layout):
    """The wide band (band_wide_kernel, one block of the whole width): k and
    v landed once where they are one operand, twice where not."""
    q, k, v = _band_operands(np.random.RandomState(23), 2, 4, t, dh, layout, dev)
    got = local_attention_band(q, k, v, window_size=w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, local_attention(q, k, v, window_size=w), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("dh", [520, 560])
@pytest.mark.parametrize("t,w", [(1, 1), (65, 1), (130, 10), (192, 64), (300, 100)])
def test_band_kernel_in_a_cluster_and_in_slices(dev, t, w, dh):
    """The band at 520 (a cluster of two blocks, the scores summed across
    them) and past 544 (128-column slices)."""
    q, k, v = _band_operands(np.random.RandomState(26), 1, 2, t, dh, "strided", dev)
    got = local_attention_band(q, k, v, window_size=w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, local_attention(q, k, v, window_size=w), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("layout", ["aliased", "separate"])
@pytest.mark.parametrize("dh", [131, 262])
@pytest.mark.parametrize("t,w", [(17, 1), (130, 10), (192, 64)])
def test_band_kernel_wide_with_unaligned_rows(dev, t, w, dh, layout):
    """Head widths not divisible by 4: rows copied a float at a time."""
    q, k, v = _band_operands(np.random.RandomState(27), 2, 2, t, dh, layout, dev)
    got = local_attention_band(q, k, v, window_size=w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, local_attention(q, k, v, window_size=w), rtol=2e-4,
                               atol=2e-5)


# where the narrow ring does not fit a block's shared memory: a window of 60
# at DHP 128, three operands at DHP 128, a window of 480 at DHP 32
RING_OVERFLOWS = [(1200, 60, 128, "aliased"), (640, 10, 128, "separate"), (960, 480, 32, "aliased")]


@pytest.mark.parametrize("t,w,dh,layout", RING_OVERFLOWS)
def test_band_kernel_past_the_narrow_ring(dev, t, w, dh, layout):
    q, k, v = _band_operands(np.random.RandomState(28), 2, 3, t, dh, layout, dev)
    got = local_attention_band(q, k, v, window_size=w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, local_attention(q, k, v, window_size=w), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("dh", [136, 264, 520])
def test_band_kernel_wide_is_bit_for_bit_repeatable(dev, dh):
    """No atomics, partial scores added in a fixed order: two calls, the
    same bits."""
    q, _, _ = _band_operands(np.random.RandomState(29), 2, 4, 300, dh, "strided", dev)
    first = local_attention_band(q, q, q, window_size=10)
    second = local_attention_band(q, q, q, window_size=10)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dh", [136, 520])
@pytest.mark.parametrize("bh", [65535, 65536])
def test_band_kernel_wide_past_the_grid_guard(dev, bh, dh):
    """B * H at and past 65535, the sliced kernel's grid.y limit: the wide
    band indexes (batch * head, query tile) in grid.x."""
    q, k, v = _band_operands(np.random.RandomState(30), bh, 1, 10, dh, "separate", dev)
    got = local_attention_band(q, k, v, window_size=5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, local_attention(q, k, v, window_size=5), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("dh,route", [(136, "wide"), (264, "wide"), (520, "wide"),
                                      (560, "sliced")])
def test_band_kernel_takes_its_route_by_width(dev, dh, route):
    """The band's kernel by width, told apart by the grid guard only the
    sliced launcher has: band_wide_kernel to 544 takes B * H = 65536 (its
    query tiles in grid.x), band_sliced_kernel past 544 refuses it (no
    launch, no fallback); each output against the plain twin."""
    q, _, _ = _band_operands(np.random.RandomState(31), 65536, 1, 10, dh, "strided", dev)
    if route == "sliced":
        with pytest.raises(RuntimeError, match="band_attention"):
            local_attention_band(q, q, q, window_size=5)
        q = q[:65535]
    got = local_attention_band(q, q, q, window_size=5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, local_attention(q, q, q, window_size=5), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("dh,one", [(136, True), (264, True), (280, False)])
def test_local_block_wide_is_one_launch(dev, dh, one):
    """Local heads of 136 and 264 (--latent_dim 1088, 2112) run in one
    launch of local_block_wide_kernel: the library asks for no workspace,
    and the three-launch path (rotary into a workspace, the band, rotary
    out) refuses to run without one; past 272 it asks for its workspace."""
    from gesturediffusion_tpu_torch.ops import fused_local_block as flb

    rs = np.random.RandomState(32)
    x, coa = _randn(rs, 4, 80, 8 * dh, device=dev), _randn(rs, 4, 8 * dh, device=dev)
    block, ws_floats = flb._kernels()
    assert (ws_floats(4, 80, 8 * dh, 8) == 0) == one
    cos, sin = rotary_table(81, dh, dev)
    out = torch.empty(4, 81, 8 * dh, device=dev)
    code = block(x.data_ptr(), coa.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                 None, 4, 80, 8 * dh, 8, 10, dh**-0.5, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert (code == 0) == one, code
    if one:
        want = pre_encoder_local_block(x, coa, num_heads=8, window_size=10)
        torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dh", [136, 264, 280, 130])
@pytest.mark.parametrize("t,w", WIDE_BAND_LENGTHS + [(256, 10)])
def test_local_block_kernel_at_wide_widths(dev, t, w, dh):
    """Local heads wider than 128: one launch of the wide kernel up to 272
    (rows roped as they land, the token and the second rotary pass in its
    epilogue; 130: a float at a time), three launches past it (280)."""
    rs = np.random.RandomState(24)
    x, coa = _randn(rs, 2, t, 8 * dh, device=dev), _randn(rs, 2, 8 * dh, device=dev)
    want = pre_encoder_local_block(x, coa, num_heads=8, window_size=w, use_kernels=False)
    before = fused_local_block.launches
    got = fused_local_block(x, coa, num_heads=8, window=w)
    torch.cuda.synchronize()
    assert fused_local_block.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("t", [217, 256])
def test_local_block_kernel_past_a_blocks_rows(dev, t):
    """Local heads of 128 past 216 frames (past the one-block kernel's
    shared memory) take the wide kernel."""
    rs = np.random.RandomState(33)
    x, coa = _randn(rs, 2, t, 1024, device=dev), _randn(rs, 2, 1024, device=dev)
    want = pre_encoder_local_block(x, coa, num_heads=8, window_size=10, use_kernels=False)
    got = fused_local_block(x, coa, num_heads=8, window=10)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_local_block_wide_is_bit_for_bit_repeatable(dev):
    rs = np.random.RandomState(34)
    x, coa = _randn(rs, 4, 80, 8 * 136, device=dev), _randn(rs, 4, 8 * 136, device=dev)
    first = fused_local_block(x, coa, num_heads=8, window=10)
    second = fused_local_block(x, coa, num_heads=8, window=10)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("t", [81, 121])
def test_layers_take_rows_not_16_byte_aligned(dev, t):
    """D = 130 and F = 1030 (2 heads of 65): the products copy their
    rows a float at a time; the inference layer and the training kernels
    against their plain versions."""
    w = _encoder_weights(130, 1030, dev, seed=25)
    x = _randn(np.random.RandomState(25), 3, t, 130, device=dev)
    got = fused_encoder_layer(x, *w, num_heads=2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, encoder_layer_plain(x, *w, num_heads=2), rtol=0, atol=1e-4)
    for rate in (0.1, 0.0):
        _check_train_kernels(dev, 3, t, 130, 2, 1030, rate)


@pytest.mark.parametrize("t", [81, 121])
def test_train_forward_at_rate_zero_is_the_inference_kernel(dev, t):
    w = _encoder_weights(256, 1024, dev, seed=9)
    x = _randn(np.random.RandomState(9), 64, t, 256, device=dev)
    with torch.no_grad():
        got = fused_encoder_layer_train(x, *w, seed=0, num_heads=4, rate=0.0)
        want = fused_encoder_layer(x, *w, num_heads=4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("sampler", ["uniform", "loss-second-moment"])
def test_train_step_launches_both_kernels_once_per_layer_and_microbatch(dev, sampler):
    """One train step of a small MDM with sampled timesteps: 2 layers x 3
    microbatches of each kernel, and the sampler's state updated on the card."""
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.resample import create_named_schedule_sampler
    from gesturediffusion_tpu_torch.train.loop import TrainConfig, TrainState, make_optimizer, train_step

    torch.manual_seed(0)
    model = MDM(njoints=12, latent_dim=64, num_layers=2, ff_size=128, seed_poses=4,
                cond_mask_prob=0.1, mfcc_dim=8, window_size=5,
                use_fused_train_encoder=True).to(dev)
    cfg = TrainConfig(lr=1e-4, microbatch_size=2)
    opt, sched = make_optimizer(model.parameters(), cfg)
    state = TrainState(model, opt, sched, create_named_schedule_sampler(sampler, 10, dev), {})
    rs = np.random.RandomState(10)
    cond = {"mfcc": _randn(rs, 6, 8, 1, 20, device=dev), "seed": _randn(rs, 6, 12, 1, 4, device=dev),
            "mask": torch.ones((6, 1, 1, 20), dtype=torch.bool, device=dev)}
    before = (encoder_layer_train_fwd.launches, encoder_layer_train_bwd.launches)
    m = train_step(state, create_diffusion(steps=10, device=dev), cfg,
                   _randn(rs, 6, 12, 1, 20, device=dev), cond,
                   torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert (encoder_layer_train_fwd.launches - before[0],
            encoder_layer_train_bwd.launches - before[1]) == (6, 6)
    assert np.isfinite(m["loss"].item()) and state.nonfinite_skips == 0
    if sampler == "loss-second-moment":
        assert int(state.sampler.counts.sum()) == 6


def test_plain_train_layer_gradcheck_in_float64(dev):
    rs = np.random.RandomState(11)
    x = torch.from_numpy(rs.randn(2, 5, 8)).to(dev).requires_grad_()
    w = [t.double().requires_grad_() for t in _encoder_weights(8, 16, dev, seed=11)]

    def layer(x, *ws):
        return encoder_layer_train_plain(x, *ws, seed=3, num_heads=2, rate=0.25)

    assert torch.autograd.gradcheck(layer, (x, *w), eps=1e-6, atol=1e-5)


def test_t2m_fused_train_steps_match_the_plain_steps(dev):
    """Two train steps of the humanml-encoder-512 MotionMDM (2 of its 8
    layers, heads of 128, 197 rows, dropout 0.1, cond_mask_prob 0.1) through
    the training kernels against the same steps through the plain
    hash-dropout layer: the same generator draws every mask.  Losses rel
    5e-4, the first step's gradients within 2e-3 of each one's largest
    magnitude (chip_smoke.py's TOL_STEP_LOSS and TOL_STEP_GRAD)."""
    import copy

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.train.loop import TrainConfig, TrainState, make_optimizer, train_step

    torch.manual_seed(0)
    model = MotionMDM(latent_dim=512, num_layers=2, ff_size=1024,
                      use_fused_train_encoder=True).to(dev)
    plain = copy.deepcopy(model)
    plain.use_kernels = False
    rs = np.random.RandomState(13)
    b = 4
    lengths = np.array([196, 120, 41, 77])
    batches = [(_randn(rs, b, 263, 1, 196, scale=0.5, device=dev),
                {"text_emb": _randn(rs, b, 512, scale=0.1, device=dev),
                 "mask": torch.from_numpy(np.arange(196)[None] < lengths[:, None])[:, None, None]
                 .to(dev)},
                torch.from_numpy(rs.randint(0, 1000, size=b)).to(dev),
                _randn(rs, b, 263, 1, 196, device=dev)) for _ in range(2)]
    diffusion = create_diffusion(steps=1000, device=dev)

    def run(m):
        cfg = TrainConfig(lr=1e-4)
        state = TrainState(m, *make_optimizer(m.parameters(), cfg), UniformSampler(1000), {})
        gen = torch.Generator(device=dev).manual_seed(7)
        losses, grads = [], None
        for motion, cond, t, noise in batches:
            losses.append(train_step(state, diffusion, cfg, motion, cond, gen, t, noise)["loss"]
                          .item())
            grads = grads or {n: p.grad.clone() for n, p in m.named_parameters()}
        return losses, grads

    before = (encoder_layer_train_fwd.launches, encoder_layer_train_bwd.launches)
    losses, grads = run(model)
    torch.cuda.synchronize()
    assert (encoder_layer_train_fwd.launches - before[0],
            encoder_layer_train_bwd.launches - before[1]) == (4, 4)
    p_losses, p_grads = run(plain)
    for a, e in zip(losses, p_losses):
        assert abs(a - e) <= 5e-4 * abs(e), (a, e)
    for n, g in p_grads.items():
        err = (grads[n] - g).abs().max().item()
        assert err <= 2e-3 * g.abs().max().item() + 1e-12, (n, err)


def _a2m_batch(rs, b, t, device):
    """Rot6d rows of random rotations and a translation row [B, 25, 6, T]."""
    from gesturediffusion_tpu_torch.ops.rotations import (
        matrix_to_rotation_6d,
        rotation_6d_to_matrix,
    )

    d6 = _randn(rs, b, 24, t, 6, scale=0.3, device=device)
    rot = matrix_to_rotation_6d(rotation_6d_to_matrix(d6))
    trans = torch.zeros(b, 1, t, 6, device=device)
    trans[..., :3] = torch.cumsum(_randn(rs, b, 1, t, 3, scale=0.01, device=device), dim=2)
    return torch.cat([rot, trans], dim=1).permute(0, 1, 3, 2).contiguous()


def test_smpl_joints_on_the_card_match_the_cpu(dev):
    """The training losses' fk_fn (rot6d -> SMPL's chain -> smpl joints) at
    6890 vertices on the card against the same call on the CPU: f32 with
    TF32 off, atol 1e-4; the joints-only path there equals the full one."""
    from gesturediffusion_tpu_torch.models.rotation2xyz import rotation2xyz
    from gesturediffusion_tpu_torch.models.smpl import make_synthetic_smpl

    smpl = make_synthetic_smpl(6890)
    x = _a2m_batch(np.random.RandomState(21), 8, 60, "cpu")
    kw = dict(pose_rep="rot6d", translation=True, glob=True, jointstype="smpl",
              vertstrans=False)
    want = rotation2xyz(smpl, x, **kw)
    got = rotation2xyz(smpl.to(dev), x.to(dev), **kw)
    assert got.shape == (8, 24, 3, 60)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    mats = torch.eye(3, device=dev).expand(4, 24, 3, 3).contiguous()
    full = smpl(mats[:, 1:], mats[:, 0])
    assert torch.equal(smpl(mats[:, 1:], mats[:, 0], sets=("smpl",))["smpl"], full["smpl"])


def test_a2m_fused_train_steps_match_the_plain_steps(dev):
    """Two train steps of the action-mode MotionMDM (2 of its 8 layers,
    heads of 128, 61 rows, dropout 0.1) with the recipe's geometric losses
    through SMPL at 6890 vertices, through the training kernels against the
    plain hash-dropout layer; chip_smoke.py's TOL_STEP_LOSS and
    TOL_STEP_GRAD."""
    import copy

    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler
    from gesturediffusion_tpu_torch.models.rotation2xyz import rotation2xyz
    from gesturediffusion_tpu_torch.models.smpl import make_synthetic_smpl
    from gesturediffusion_tpu_torch.train.loop import TrainConfig, TrainState, make_optimizer, train_step

    torch.manual_seed(0)
    model = MotionMDM(njoints=25, nfeats=6, latent_dim=512, num_layers=2, ff_size=1024,
                      cond_mode="action", cond_mask_prob=0.0,
                      use_fused_train_encoder=True).to(dev)
    plain = copy.deepcopy(model)
    plain.use_kernels = False
    smpl = make_synthetic_smpl(6890).to(dev)

    def fk_fn(sample):
        return rotation2xyz(smpl, sample, pose_rep="rot6d", translation=True, glob=True,
                            jointstype="smpl", vertstrans=False)

    rs = np.random.RandomState(14)
    b = 4
    batches = [(_a2m_batch(rs, b, 60, dev),
                {"action": torch.from_numpy(rs.randint(0, 12, size=b)).to(dev),
                 "mask": torch.ones(b, 1, 1, 60, dtype=torch.bool, device=dev)},
                torch.from_numpy(rs.randint(0, 1000, size=b)).to(dev),
                _randn(rs, b, 25, 6, 60, device=dev)) for _ in range(2)]
    diffusion = create_diffusion(steps=1000, lambda_rcxyz=1.0, lambda_vel=1.0,
                                 lambda_fc=1.0, device=dev)

    def run(m):
        cfg = TrainConfig(lr=1e-4)
        state = TrainState(m, *make_optimizer(m.parameters(), cfg), UniformSampler(1000), {})
        gen = torch.Generator(device=dev).manual_seed(7)
        losses, grads = [], None
        for motion, cond, t, noise in batches:
            metrics = train_step(state, diffusion, cfg, motion, cond, gen, t, noise, fk_fn=fk_fn)
            assert {"rcxyz_mse", "vel_mse", "fc"} <= set(metrics)
            losses.append(metrics["loss"].item())
            grads = grads or {n: p.grad.clone() for n, p in m.named_parameters()}
        return losses, grads

    before = (encoder_layer_train_fwd.launches, encoder_layer_train_bwd.launches)
    losses, grads = run(model)
    torch.cuda.synchronize()
    assert (encoder_layer_train_fwd.launches - before[0],
            encoder_layer_train_bwd.launches - before[1]) == (4, 4)
    p_losses, p_grads = run(plain)
    for a, e in zip(losses, p_losses):
        assert abs(a - e) <= 5e-4 * abs(e), (a, e)
    for n, g in p_grads.items():
        err = (grads[n] - g).abs().max().item()
        assert err <= 2e-3 * g.abs().max().item() + 1e-12, (n, err)


# How far the kernels' a2m gradients may stand from float64, in multiples
# of plain f32's distance, at tools/a2m_f64_check.py's default seed.  On an
# H100 (tools/flush_ab.py, PERF.md section 6): the shipped flush every 128
# of K 2.3x, every 64 1.25x, every 512 7.5x, the unflushed GEMM 8.1x.
A2M_F64_RATIO = 5.0


def test_a2m_kernel_gradients_stay_near_float64(dev):
    """One action-to-motion step at the configuration where the unflushed
    training GEMM missed the step tolerance (batch 64, 8 layers, D 512, 60
    frames, the recipe's lambdas through SMPL at 6890 vertices;
    tools/a2m_f64_check.py): the kernels' worst gradient stands from the
    float64 step within A2M_F64_RATIO times plain f32's distance."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "a2m_f64_check.py")
    spec = importlib.util.spec_from_file_location("a2m_f64_check", path)
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    gaps = check.main(["--device", "cuda"])
    recipe = next(v for k, v in gaps.items() if k.startswith("recipe"))
    kernels = recipe["kernels f32 vs plain f64"][1]
    plain = recipe["plain f32   vs plain f64"][1]
    assert kernels <= A2M_F64_RATIO * plain, (kernels, plain)

# Each teacher-forced step's worst kernel gradient from the float64 step
# (tools/a2m_f64_check.py --steps 5 at its default seed 6, from the plain
# f32 run's states): the shipped GEMM (one accumulator, flushed every 128 of
# K) on an H100, tools/flush_ab.py, PERF.md section 6.  Plain f32 stands
# 5.0e-05, 3.3e-04, 2.3e-04, 2.1e-04, 9.7e-05 there (ROADMAP C6).
A2M_F64_FORCED = (1.158e-04, 2.782e-03, 2.473e-03, 8.310e-04, 1.590e-03)


def test_a2m_teacher_forced_gradients_stay_where_they_were_measured(dev):
    """Five teacher-forced a2m steps (batch 64, 8 layers, D 512, 60 frames,
    the recipe's lambdas through SMPL at 6890 vertices): each step's worst
    kernel gradient stands from the float64 step within 1.5x the distance
    measured for the shipped design (A2M_F64_FORCED; the states come from
    the plain f32 run, whose library products may round otherwise on
    another build), so a coarser accumulation fails here."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "a2m_f64_check.py")
    spec = importlib.util.spec_from_file_location("a2m_f64_check", path)
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    forced = check.main(["--device", "cuda", "--steps", "5"])["teacher_forced"]
    got = [row["kernels f32 vs plain f64"][1] for row in forced]
    assert len(got) == len(A2M_F64_FORCED)
    assert all(g <= 1.5 * w for g, w in zip(got, A2M_F64_FORCED)), (got, A2M_F64_FORCED)


def test_remat_replays_the_masks_from_a_card_generator(dev):
    """--remat with the plain layers on the card: the recompute draws the
    forward's masks again from a CUDA generator's saved state, so the
    gradients equal the stored path's and the generator advances once."""
    kw = dict(njoints=25, nfeats=6, latent_dim=128, num_layers=2, ff_size=256,
              cond_mode="action", cond_mask_prob=0.0, dropout=0.1)
    torch.manual_seed(0)
    stored = MotionMDM(**kw).to(dev)
    remat = MotionMDM(**kw, remat=True).to(dev)
    remat.load_state_dict(stored.state_dict())
    rs = np.random.RandomState(15)
    x = _a2m_batch(rs, 3, 60, dev)
    t, cond = torch.tensor([1, 50, 900], device=dev), {"action": torch.tensor([0, 5, 11], device=dev)}
    grads, states = [], []
    for m in (stored, remat):
        gen = torch.Generator(device=dev).manual_seed(3)
        m(x, t, cond, train=True, generator=gen).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0, atol=0, msg=n)


def test_eval_classifier_features_on_the_card_match_the_cpu(dev):
    """The a2m evaluation's three classifiers (the GRU, the recognition
    ST-GCN, the MoDi ST-GCN; seeded random weights) through their
    evaluation objects on the card against the CPU, called with cuDNN's
    TF32 at PyTorch's default (on): the evaluation's own guard keeps the
    GRU and the convolutions in float32, within 1e-5 of the features' max
    |value| (sums in another order; the modules with cuDNN's TF32 on stand
    ~1e-4 off in chip_smoke.py's phase 14), and hands the setting back."""
    from gesturediffusion_tpu_torch.eval.eval_a2m import A2MEvaluation, STGCNA2MEvaluation
    from gesturediffusion_tpu_torch.eval.eval_unconstrained import UnconstrainedEvaluator

    rs = np.random.RandomState(0)
    batch = {"output_xyz": (rs.randn(64, 24, 3, 60) * 0.3).astype(np.float32),
             "output_rot": (rs.randn(64, 24, 6, 60) * 0.5).astype(np.float32),
             "lengths": rs.randint(30, 61, size=64).astype(np.int32),
             "y": rs.randint(0, 12, size=64)}
    motions = (rs.randn(64, 15, 3, 60) * 0.3).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        for cls in (A2MEvaluation, STGCNA2MEvaluation, UnconstrainedEvaluator):
            feats = [cls(device=d).compute_features(
                motions if cls is UnconstrainedEvaluator else [batch])[0] for d in (dev, "cpu")]
            scale = np.abs(feats[1]).max()
            assert np.abs(feats[0] - feats[1]).max() <= 1e-5 * scale, cls.__name__
            assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False


def test_t2m_evaluator_embeddings_on_the_card_match_the_cpu(dev):
    """The text benchmark's T2M evaluators (the text and motion BiGRUs on
    cuDNN's packed GRU, the movement convolutions; seeded random weights)
    through EvaluatorWrapper on the card against the CPU, called with
    cuDNN's TF32 on: the wrapper's guard keeps them in float32, the text
    and motion co-embeddings and the motion embeddings in the input order
    within 1e-5 of their max |value| (sums in another order over up to 49
    GRU steps), and hands the setting back."""
    from gesturediffusion_tpu_torch.eval.evaluator_wrapper import EvaluatorWrapper

    rs = np.random.RandomState(0)
    m_lens = rs.randint(10, 50, size=32) * 4
    batch = dict(motions=rs.randn(32, 196, 263).astype(np.float32), m_lens=m_lens,
                 word_embs=(rs.randn(32, 22, 300) * 0.1).astype(np.float32),
                 pos_ohot=np.eye(15, dtype=np.float32)[rs.randint(0, 15, (32, 22))],
                 cap_lens=rs.randint(3, 23, size=32))
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = []
        for d in (dev, "cpu"):
            w = EvaluatorWrapper("humanml", device=d)
            out.append((*w.get_co_embeddings(**batch),
                        w.get_motion_embeddings(batch["motions"], m_lens, keep_order=True)))
            assert torch.backends.cudnn.allow_tf32
        for got, want in zip(*out):
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _smplify_case(t, seed=0):
    """A synthetic SMPL at 6890 vertices, SMPL joints of random poses as the
    target [T, 22, 3], and the synthetic GMM prior."""
    from gesturediffusion_tpu_torch.models.smpl import make_synthetic_smpl
    from gesturediffusion_tpu_torch.viz import joints2smpl as j2s
    from gesturediffusion_tpu_torch.viz.prior import MaxMixturePrior, make_synthetic_gmm

    rs = np.random.RandomState(seed)
    smpl = make_synthetic_smpl(6890)
    pose = _randn(rs, t, 24, 3, scale=0.3)
    joints = j2s.fk_joints(smpl, pose, _randn(rs, t, 3, scale=0.2)).numpy()[:, :22]
    gmm = make_synthetic_gmm()
    return smpl, joints, MaxMixturePrior(gmm["means"], gmm["covars"], gmm["weights"])


def test_smplify_stage2_gradient_on_the_card_matches_the_cpu(dev):
    """The SMPLify body stage's objective (the Geman-McClure joint loss, the
    angle prior, the GMM prior) and its gradient at one state of 120 frames,
    on the card against the CPU: the objective rtol 1e-6, the gradient
    within 1e-5 of its max |value| (one float32 chain of 23 links and a
    [120, 8, 69] quadratic form, summed in another order)."""
    from gesturediffusion_tpu_torch.viz import joints2smpl as j2s

    smpl, joints, prior = _smplify_case(120)
    rs = np.random.RandomState(1)
    pose, transl = _randn(rs, 120, 24, 3, scale=0.2), _randn(rs, 120, 3, scale=0.1)
    out = []
    for d in (dev, "cpu"):
        target, subset, conf = j2s.fit_inputs(joints, d, fix_foot=True)
        p = pose.to(d).requires_grad_(True)
        tr = transl.to(d).requires_grad_(True)
        value = j2s.stage_objective(smpl.to(d), p, tr, target, subset, conf, prior.to(d), True)
        value.backward()
        out.append((value.item(), p.grad.cpu(), tr.grad.cpu()))
    (v_card, gp_card, gt_card), (v_cpu, gp_cpu, gt_cpu) = out
    assert abs(v_card - v_cpu) <= 1e-6 * abs(v_cpu)
    gmax = max(gp_cpu.abs().max().item(), gt_cpu.abs().max().item())
    assert (gp_card - gp_cpu).abs().max().item() <= 1e-5 * gmax
    assert (gt_card - gt_cpu).abs().max().item() <= 1e-5 * gmax


def test_smplify_fit_on_the_card_stays_near_the_cpu(dev, monkeypatch, tmp_path):
    """A whole two-stage fit (30 Adam steps a stage, 20 frames) on the card
    and on the CPU: the stage-2 keypoint error below stage 1's on both, and
    the final errors within 2e-2 of each other (the chip smoke's
    TOL_FIT_FREE: Adam's steps read float32 chaos in the poses)."""
    from gesturediffusion_tpu_torch.viz import joints2smpl as j2s

    smpl, joints, prior = _smplify_case(20, seed=2)
    monkeypatch.setenv("SMPL_MEAN_PATH", str(tmp_path / "absent.h5"))
    fits = [j2s.joints2smpl(smpl, joints, num_smplify_iters=30, pose_prior=prior, device=d)
            for d in (dev, "cpu")]
    for fit in fits:
        assert fit["loss"][1] < fit["loss"][0] and np.isfinite(fit["thetas"]).all()
    assert abs(fits[0]["loss"][1] - fits[1]["loss"][1]) <= 2e-2 * fits[1]["loss"][1]


def test_npy2obj_vertices_on_the_card_match_the_cpu(dev, tmp_path):
    """Npy2Obj's rot6d route (no fit): SMPL's skinned vertices [T, 6890, 3]
    on the card against the CPU within 1e-4 (f32 skinning over 24 joints
    and 207 pose blendshapes)."""
    from gesturediffusion_tpu_torch.viz.vis_utils import Npy2Obj

    smpl, _, _ = _smplify_case(1)
    rs = np.random.RandomState(3)
    motion = rs.randn(1, 25, 6, 16).astype(np.float32)
    path = str(tmp_path / "results_rot.npy")
    np.save(path, {"motion": motion, "num_samples": 1})
    verts = [Npy2Obj(path, 0, 0, smpl, device=d).vertices for d in (dev, "cpu")]
    assert verts[0].shape == (16, 6890, 3)
    assert np.abs(verts[0] - verts[1]).max() <= 1e-4


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_wav_encoder_on_the_card_matches_the_cpu(dev, train):
    """The wav encoder (models/mdm.py:WavEncoder, seeded weights and moved
    running statistics) on a chunk of raw audio at the gesture contract's
    80 x 735 samples, on the card against the CPU, called with cuDNN's TF32
    at PyTorch's default (on): its own guard keeps the convolutions in
    float32, within 1e-5 of the features' max |value| (sums in another
    order), hands the setting back, and in training moves the running
    statistics alike (rtol 1e-5)."""
    import copy

    from gesturediffusion_tpu_torch.models.mdm import WavEncoder

    torch.manual_seed(0)
    cpu = WavEncoder()
    with torch.no_grad():
        for bi in (1, 4, 7):
            bn = cpu.feat_extractor[bi]
            bn.running_mean.normal_(0, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    card = copy.deepcopy(cpu).to(dev)
    wav = _randn(np.random.RandomState(5), 8, 80 * 735, scale=0.3)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            got = card.train(train)(wav.to(dev)).cpu()
            want = cpu.train(train)(wav)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert got.shape == want.shape == (8, 32, 59)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    for bi in (1, 4, 7):
        for name in ("running_mean", "running_var"):
            torch.testing.assert_close(getattr(card.feat_extractor[bi], name).cpu(),
                                       getattr(cpu.feat_extractor[bi], name), rtol=1e-5,
                                       atol=1e-6)


def test_seed_dropout_redraws_from_a_cuda_generators_state(dev, monkeypatch):
    """GDT_SEED_DROPOUT=1 on the card: the output, the gradient and the CUDA
    generator's state after the draw equal the default path's bit for bit,
    and the bytes autograd saves drop (the mask stays out)."""
    from gesturediffusion_tpu_torch.ops.dropout import dropout

    x = _randn(np.random.RandomState(3), 64, 4, 81, 81, device=dev).requires_grad_()
    w = _randn(np.random.RandomState(4), 64, 4, 81, 81, device=dev)
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("GDT_SEED_DROPOUT", flag)
        g = torch.Generator(device=dev).manual_seed(5)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t.numel() * t.element_size()) or t, lambda t: t):
            y = dropout(x, 0.1, g)
            loss = (y * w).sum()
        (grad,) = torch.autograd.grad(loss, x)
        runs[flag] = (y.detach(), grad, g.get_state(), sum(saved))
    (y0, g0, s0, b0), (y1, g1, s1, b1) = runs["0"], runs["1"]
    assert torch.equal(y0, y1) and torch.equal(g0, g1) and torch.equal(s0, s1)
    assert b1 < b0


def test_comp_v6_on_the_card_matches_the_cpu(dev):
    """The CompV6 take at the released widths (batch 4, 6 snippets, the noise
    injected) on the card within 1e-4 of the CPU's largest magnitude, the
    length logits within 1e-5."""
    from gesturediffusion_tpu_torch.eval.comp_v6 import CompV6Generator

    torch.manual_seed(0)
    cpu = CompV6Generator(device="cpu")
    card = CompV6Generator(device=dev)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(6)
    word = rs.randn(4, 22, 300).astype(np.float32)
    pos = np.eye(15, dtype=np.float32)[rs.randint(0, 15, (4, 22))]
    lens, m_lens = np.asarray([22, 9, 14, 3]), np.asarray([24, 20, 16, 24])
    noise = rs.randn(6, 4, 128).astype(np.float32)
    want, got = (g.generate(word, pos, lens, m_lens, 6, noise=noise).cpu() for g in (cpu, card))
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    want, got = (g.estimate_length_logits(word, pos, lens).cpu() for g in (cpu, card))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_evaluator_trainer_gradients_on_the_card_match_the_cpu(dev):
    """The text-motion trainer's first step at the released widths: loss
    rel 1e-5, every gradient within 1e-5 of its largest magnitude."""
    from gesturediffusion_tpu_torch.eval.networks import (
        MotionEncoderBiGRUCo,
        MovementConvEncoder,
        TextEncoderBiGRUCo,
    )
    from gesturediffusion_tpu_torch.eval.trainers import TextMotionMatchTrainer

    def build(device):
        torch.manual_seed(0)
        return TextMotionMatchTrainer(TextEncoderBiGRUCo(), MotionEncoderBiGRUCo(),
                                      MovementConvEncoder(259), device=device)

    rs = np.random.RandomState(7)
    batch = (rs.randn(8, 22, 300).astype(np.float32),
             np.eye(15, dtype=np.float32)[rs.randint(0, 15, (8, 22))],
             rs.randint(3, 23, 8), rs.randn(8, 196, 263).astype(np.float32),
             rs.randint(10, 50, 8) * 4, 3)
    cpu, card = build("cpu"), build(dev)
    want, got = cpu.backward(*batch), card.backward(*batch)
    assert abs(got["loss"].item() - want["loss"].item()) <= 1e-5 * abs(want["loss"].item())
    for (name, pw), (_, pg) in zip(cpu.named_parameters(), card.named_parameters()):
        assert (pg.grad.cpu() - pw.grad).abs().max() <= 1e-5 * pw.grad.abs().max(), name


# ---- kernels 5 and 6's products on csrc/gemm_ws.cuh ---------------------- #

def _train_chain(x, w, seed, heads, rate, row0, g=None, parent=False):
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import encoder_layer_train_parent

    if parent:
        return encoder_layer_train_parent(x, *w, seed=seed, num_heads=heads, rate=rate,
                                          row0=row0, g=g)
    if g is None:
        return (encoder_layer_train_fwd(x, *w, seed=seed, num_heads=heads, rate=rate,
                                        row0=row0),)
    return encoder_layer_train_bwd(x, *w, seed=seed, g=g, num_heads=heads, rate=rate, row0=row0)


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("t,d,row0", [(81, 256, 0), (121, 256, 0), (201, 256, 0), (197, 512, 0),
                                      (61, 512, 0), (81, 256, 64)])
def test_train_kernels_are_the_parent_chain_bit_for_bit(dev, t, d, row0, rate):
    """Kernel 5's output and kernel 6's 13 outputs with their products on
    gemm_ws.cuh against the parent chain (every product on gemm_tf32x3.cuh,
    csrc/encoder_layer_train.cu's gdt_encoder_layer_train_parent_*): the
    same k order, flushes, chunks and epilogues, so torch.equal."""
    w = _encoder_weights(d, 1024, dev, seed=60)
    rs = np.random.RandomState(60)
    x, g = _randn(rs, 8, t, d, device=dev), _randn(rs, 8, t, d, device=dev)
    seed = torch.tensor([20240], dtype=torch.int32, device=dev)
    for gg in (None, g):
        got = _train_chain(x, w, seed, 4, rate, row0, gg)
        want = _train_chain(x, w, seed, 4, rate, row0, gg, parent=True)
        torch.cuda.synchronize()
        assert len(got) == (1 if gg is None else 13)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (i, (a - b).abs().max().item())


@pytest.mark.parametrize("m", [1, 100, 5184])
@pytest.mark.parametrize("d,f", [(256, 1024), (512, 1024), (64, 1056)])
def test_train_product_families_are_the_parent_bit_for_bit(dev, m, d, f):
    """Each family alone: the forward products (bias, residual, GELU with
    its pre-activation), the data gradients (plain, GELU', residual) and the
    weight gradients in the parent's row chunks, on gemm_ws.cuh and on
    gemm_tf32x3.cuh, bit for bit; the weight gradient also against float64."""
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import train_product

    rs = np.random.RandomState(61)
    cases = [("forward", f, d, "gelu"), ("forward", 3 * d, d, "bias"),
             ("forward", d, f, "resid"), ("data", f, d, "gelu_grad"), ("data", d, f, "add"),
             ("data", d, 3 * d, "plain")]
    for fam, n, k, epi in cases:
        a = _randn(rs, m, k, device=dev)
        w = _randn(rs, *((n, k) if fam == "forward" else (k, n)), scale=k**-0.5, device=dev)
        kw = dict(epi=epi, bias=_randn(rs, n, scale=0.02, device=dev),
                  resid=_randn(rs, m, n, device=dev), aux=_randn(rs, m, n, device=dev))
        pres = [torch.empty(m, n, device=dev) if epi == "gelu" else None for _ in range(2)]
        got = train_product(fam, a, w, pre=pres[0], **kw)
        want = train_product(fam, a, w, pre=pres[1], parent=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (fam, epi, (got - want).abs().max().item())
        if epi == "gelu":
            assert torch.equal(pres[0], pres[1])
    for i, j in ((d, f), (f, d), (d, d), (3 * d, d)):
        dy, x = _randn(rs, m, i, device=dev), _randn(rs, m, j, device=dev)
        got = train_product("weight", dy, x)
        want = train_product("weight", dy, x, parent=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (i, j, (got - want).abs().max().item())
        exact = dy.double().T @ x.double()
        assert (got.double() - exact).abs().max() <= 2e-5 * exact.abs().max()


@pytest.mark.parametrize("d", [32, 64, 130, 198, 256, 264, 512, 1024])
@pytest.mark.parametrize("f", [128, 1024, 1030, 1056])
def test_train_routes_mirror_the_kernels(dev, d, f):
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
        kernel_train_routes,
        train_routes,
    )

    assert kernel_train_routes(d, f) == train_routes(d, f)


@pytest.mark.parametrize("n,k", [(768, 256), (256, 1024), (12, 96), (1030, 5)])
def test_transposed_split_kernel_is_its_plain_twin(dev, n, k):
    from gesturediffusion_tpu_torch.ops.fused_encoder import split_weight_t_plain, weight_split_t

    w = _randn(np.random.RandomState(62), n, k, device=dev)
    assert torch.equal(weight_split_t(w).split, split_weight_t_plain(w))


def test_train_step_splits_each_weight_once_per_step(dev):
    """Two optimizer steps of 4 microbatches: each layer's 4 weights split
    once in each orientation a step (W's at the first forward, W^T's at the
    first backward), the other microbatches reading the kept splits."""
    from gesturediffusion_tpu_torch.diffusion.gaussian import create_diffusion
    from gesturediffusion_tpu_torch.ops.fused_encoder import weight_split_t
    from gesturediffusion_tpu_torch.train.loop import TrainConfig, TrainState, make_optimizer, train_step
    from gesturediffusion_tpu_torch.diffusion.resample import UniformSampler

    torch.manual_seed(0)
    model = MDM(njoints=12, latent_dim=64, num_layers=2, ff_size=128, seed_poses=4,
                cond_mask_prob=0.1, mfcc_dim=8, window_size=5,
                use_fused_train_encoder=True).to(dev)
    cfg = TrainConfig(lr=1e-4, batch_size=8, microbatch_size=2)
    opt, sched = make_optimizer(model.parameters(), cfg)
    state = TrainState(model, opt, sched, UniformSampler(10), {})
    rs = np.random.RandomState(63)
    diffusion = create_diffusion(steps=10, device=dev)
    for step in range(2):
        cond = {"mfcc": _randn(rs, 8, 8, 1, 20, device=dev),
                "seed": _randn(rs, 8, 12, 1, 4, device=dev),
                "mask": torch.ones((8, 1, 1, 20), dtype=torch.bool, device=dev)}
        before = (encoder_layer_train_fwd.launches, weight_split.launches,
                  weight_split_t.launches)
        train_step(state, diffusion, cfg, _randn(rs, 8, 12, 1, 20, device=dev), cond,
                   torch.Generator(device=dev).manual_seed(step))
        torch.cuda.synchronize()
        after = (encoder_layer_train_fwd.launches, weight_split.launches,
                 weight_split_t.launches)
        assert [a - b for a, b in zip(after, before)] == [8, 8, 8], (step, after, before)


def test_train_forward_of_inference_tensors(dev):
    """The training forward under torch.inference_mode() on weights made
    there: each call splits them anew and holds the splits until its launch
    is queued; the output is the parent chain's bit for bit, twice."""
    w0 = _encoder_weights(256, 1024, dev, seed=64)
    with torch.inference_mode():
        w = [y.clone() for y in w0]
        assert all(y.is_inference() for y in w)
        x = _randn(np.random.RandomState(64), 64, 81, 256, device=dev)
        seed = torch.tensor([7], dtype=torch.int32, device=dev)
        before = weight_split.launches
        got = [encoder_layer_train_fwd(x, *w, seed=seed, num_heads=4, rate=0.1)
               for _ in range(2)]
        want = _train_chain(x, w, seed, 4, 0.1, 0, parent=True)[0]
    torch.cuda.synchronize()
    assert weight_split.launches - before == 8
    for y in got:
        assert torch.equal(y, want)


@pytest.mark.parametrize("d,heads,f", [(130, 2, 1030), (256, 4, 1030)])
def test_train_kernels_outside_the_rule_split_only_what_it_takes(dev, d, heads, f):
    """D 130 / F 1030 splits nothing (every product on the parent); F 1030 at
    D 256 splits wqkv and wo only; both the parent chain bit for bit."""
    from gesturediffusion_tpu_torch.ops.fused_encoder import weight_split_t
    from gesturediffusion_tpu_torch.ops.fused_encoder_train import train_routes

    w = _encoder_weights(d, f, dev, seed=65)
    rs = np.random.RandomState(65)
    x, g = _randn(rs, 4, 81, d, device=dev), _randn(rs, 4, 81, d, device=dev)
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    before = (weight_split.launches, weight_split_t.launches)
    got = _train_chain(x, w, seed, heads, 0.1, 0, g)
    want = _train_chain(x, w, seed, heads, 0.1, 0, g, parent=True)
    torch.cuda.synchronize()
    on = bin(train_routes(d, f)).count("1")
    assert (weight_split.launches - before[0], weight_split_t.launches - before[1]) == (on, on)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
