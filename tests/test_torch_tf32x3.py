"""The numerics of the tensor-core kernels, emulated on the CPU.

The inference encoder layer's products (csrc/gemm_tf32x3.cuh) and both
products of the flash kernel (csrc/flash_attention.cuh) run in 3xTF32: each
f32 operand x is split into big = tf32_rn(x) and small = tf32_rn(x - big),
and big.big + big.small + small.big is accumulated in f32.  This file
emulates that arithmetic in plain PyTorch (TF32 rounding by integer bit
arithmetic on the f32 view, as cvt.rna.tf32.f32 rounds: to nearest, ties
away from zero) and holds it against the JAX package's f32 kernels in
interpret mode, with the same numpy-seeded inputs and weights:
ops/pallas_encoder.py:fused_encoder_layer at [3, 24, 128], 4 heads, ff 256,
within 5e-4 (the card's tolerance for the layer), and
ops/pallas_flash.py:fused_self_attention at [2, 3, 130, 32], within 2e-4
(the flash kernel's).  A single TF32 pass is at least 10x further from the
reference than three: that is why the kernels take three.  The inference
flash forward up to a head width of 128 (csrc/flash_attention.cuh's
flash_fwd_narrow_kernel) is emulated step by step (``narrow_flash``): its
key tiles (tests/torch_port_common.py:narrow_block_shape), the scores over
the whole width in one accumulator, the online softmax in log2 units with
its rescale before each tile's p v; its consumer warpgroups own disjoint
query rows, so nothing is combined across them.  The flash
forward past a head width of 128 (csrc/wide_attention.cuh) is emulated
step by step (``wide_flash``): its 32-key tiles, the scores summed once
from the partial products over the blocks' and warpgroups' column shares,
the online softmax in log2 units with its rescale before each tile's p v,
the output in the warpgroups' column slices, and the training layer's
site-0 dropout and row log-sum-exp.  The band and the local block past a
head width of 128 run the same blocks over the band's key tiles only
(``wide_band``): from the block's first band key, (q0 / w - 1) w, to its
last row, under the band mask, held against JAX's band kernel
(ops/pallas_attention.py:local_attention_pallas) and, with the rotary
passes and the token around it, its local block
(ops/pallas_local_block.py:fused_local_block), both in interpret mode.

The GEMM also takes operands that are not K-contiguous (the training
layer's data and weight gradients) and splits K into row chunks summed in
a fixed order (the weight gradients): ``gemm_tf32x3`` emulates that from
the operands as they lie in memory, held against jax.vjp of the same
product in f32 within 2e-6 of the output's largest magnitude (sums over at
most 242 terms in another order; measured 3e-07 to 7e-07, one TF32 pass
3e-04).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gesturediffusion_tpu.ops.pallas_attention import local_attention_pallas as jax_band
from gesturediffusion_tpu.ops.pallas_encoder import fused_encoder_layer as jax_fused_layer
from gesturediffusion_tpu.ops.pallas_flash import fused_self_attention as jax_flash
from gesturediffusion_tpu.ops.pallas_local_block import fused_local_block as jax_local_block
from gesturediffusion_tpu_torch.models.embeddings import apply_rotary_pos_emb, rotary_freqs
from gesturediffusion_tpu_torch.ops.fused_encoder import LN_EPS, SITE_ATTN, gelu_tanh
from gesturediffusion_tpu_torch.ops.fused_encoder_train import hash_dropout_mask
from tests.torch_port_common import (
    jax_layer_args,
    jax_layer_params,
    narrow_block_shape,
    one_torch_thread,
    threefry_prng,  # noqa: F401 (autouse fixture)
    torch_layer_weights,
    wide_block_shape,
)

TOL_LAYER, TOL_FLASH = 5e-4, 2e-4


def tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: add half a TF32 ulp to the magnitude bits, clear the low 13."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32_rn(x)
    return big, tf32_rn(x - big)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: three TF32 passes, f32 sums."""
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    return a_big @ b_small + a_small @ b_big + a_big @ b_big


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in a single TF32 pass."""
    return tf32_rn(a) @ tf32_rn(b)


def gemm_tf32x3(a, b, *, a_kc=True, b_kc=True, k_chunk=None, mm=matmul_tf32x3):
    """C = A . B^T as csrc/gemm_tf32x3.cuh computes it from the operands as
    they lie in memory: A(m, k) = a[m, k] when a_kc, else a[k, m]; B(n, k) =
    b[n, k] when b_kc, else b[k, n].  With k_chunk, K is split into chunks
    (the kernel's blockIdx.z), each chunk's product a partial sum, and the
    partials are added in chunk order (the weight gradients' split-K)."""
    am, bm = (a if a_kc else a.T), (b if b_kc else b.T)
    step = k_chunk or am.shape[1]
    out = None
    for k0 in range(0, am.shape[1], step):
        part = mm(am[:, k0:k0 + step], bm[:, k0:k0 + step].T)
        out = part if out is None else out + part
    return out


def attention(q, k, v, mm):
    """softmax(q k^T / sqrt(dh)) v on [..., T, dh] with both products by
    ``mm``; scores and softmax in f32."""
    s = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return mm(s.softmax(dim=-1), v)


def encoder_layer(x, wqkv, bqkv, wo, bo, l1w, l1b, w1, b1, w2, b2, l2w, l2b, *, num_heads, mm):
    """The inference layer (ops/fused_encoder.py:encoder_layer_plain) with
    every product by ``mm``."""
    b, t, d = x.shape
    qkv = mm(x, wqkv.T) + bqkv
    q, k, v = (y.reshape(b, t, num_heads, -1).transpose(1, 2) for y in qkv.chunk(3, dim=-1))
    a = attention(q, k, v, mm).transpose(1, 2).reshape(b, t, d)
    h1 = F.layer_norm(x + (mm(a, wo.T) + bo), (d,), l1w, l1b, LN_EPS)
    ff = mm(gelu_tanh(mm(h1, w1.T) + b1), w2.T) + b2
    return F.layer_norm(h1 + ff, (d,), l2w, l2b, LN_EPS)


def test_tf32_rn_rounds_to_nearest_ties_away():
    ulp = 2.0**-10  # TF32 spacing in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2**-20, -(1 + ulp / 2), 1 + 1.5 * ulp,
                      2 - ulp / 4], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 2.0])
    torch.testing.assert_close(tf32_rn(x), want, rtol=0, atol=0)


def test_split_keeps_f32_accuracy():
    """big + small is x to ~2^-22 relative; big alone only to 2^-11."""
    x = torch.from_numpy(np.random.RandomState(0).randn(100_000).astype(np.float32))
    big, small = split(x)
    assert ((big.double() + small.double() - x.double()).abs() / x.abs().double()).max() <= 2.0**-21
    assert ((big.double() - x.double()).abs() / x.abs().double()).max() <= 2.0**-11
    assert torch.equal(tf32_rn(big), big) and torch.equal(tf32_rn(small), small)


@pytest.mark.parametrize("b,t,d,h,f", [(3, 24, 128, 4, 256), (2, 17, 64, 4, 128)])
def test_encoder_layer_in_three_passes_matches_jax(b, t, d, h, f):
    x = np.random.RandomState(4).randn(b, t, d).astype(np.float32)
    _, p = jax_layer_params(d, h, f, seed=4)
    want = np.asarray(jax_fused_layer(jnp.asarray(x), *jax_layer_args(p), num_heads=h,
                                      block_b=2, interpret=True))
    w = torch_layer_weights(p)
    three = encoder_layer(torch.from_numpy(x), *w, num_heads=h, mm=matmul_tf32x3).numpy()
    one = encoder_layer(torch.from_numpy(x), *w, num_heads=h, mm=matmul_tf32).numpy()
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 <= TOL_LAYER, err3
    assert err1 >= 10 * err3, (err1, err3)


@pytest.mark.parametrize("b,h,t,d", [(2, 3, 130, 32), (1, 2, 81, 64)])
def test_flash_in_three_passes_matches_jax(b, h, t, d):
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    three = attention(qt, kt, vt, matmul_tf32x3).numpy()
    one = attention(qt, kt, vt, matmul_tf32).numpy()
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 <= TOL_FLASH, err3
    assert err1 >= 10 * err3, (err1, err3)


def narrow_flash(q, k, v, mm):
    """[B, H, T, dh] attention as csrc/flash_attention.cuh's inference body
    (flash_fwd_narrow_kernel) computes it, dh <= 128: the width padded to
    the next multiple of 16 with zero columns; per key tile of ``bk`` keys
    (narrow_block_shape; the last tile's rows past T read as zeros and
    score -FLT_MAX) S = q k^T over the whole width in one accumulator
    (products by ``mm``), the online softmax in log2 units, o rescaled
    before it takes the tile's p v; out = o / l.  The kernel splits q once a
    block, K and V once a tile (the producer) and P a slice at a time; the
    split is elementwise, so ``mm`` splitting its operands gives the same
    parts."""
    b, h, t, dh = q.shape
    shape = narrow_block_shape(dh, t)
    dhp, bk = shape["dhp"], shape["bk"]
    tp = -(-t // bk) * bk
    qp = F.pad(q, (0, dhp - dh))
    kp, vp = (F.pad(x, (0, dhp - dh, 0, tp - t)) for x in (k, v))
    scale_log2 = dh**-0.5 * 1.4426950408889634
    fmax = torch.finfo(torch.float32).max
    m = torch.full((b, h, t), -fmax, dtype=q.dtype)
    l = q.new_zeros(b, h, t)
    o = q.new_zeros(b, h, t, dhp)
    for j0 in range(0, tp, bk):
        s = mm(qp, kp[:, :, j0:j0 + bk].transpose(-1, -2)) * scale_log2
        s = torch.where(torch.arange(j0, j0 + bk) < t, s, torch.tensor(-fmax))
        mn = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - mn[..., None])
        alpha = torch.exp2(m - mn)
        l, m = alpha * l + p.sum(-1), mn
        o = o * alpha[..., None] + mm(p, vp[:, :, j0:j0 + bk])
    return o[..., :dh] / l[..., None]


@pytest.mark.parametrize("b,h,t,d", [(2, 3, 81, 64), (1, 4, 197, 128), (2, 2, 61, 128),
                                     (1, 2, 130, 80), (1, 2, 100, 72), (2, 2, 90, 16),
                                     (1, 2, 200, 64)])
def test_narrow_flash_schedule_in_three_passes_matches_jax(b, h, t, d):
    """The inference body's schedule up to a head width of 128 (64-key tiles
    to DHP 64 past 128 rows, else 32) in 3xTF32 against JAX's flash kernel in
    interpret mode, within the flash tolerance; one TF32 pass at least 10x
    further off."""
    rs = np.random.RandomState(9)
    q, k, v = (rs.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    three = narrow_flash(qt, kt, vt, matmul_tf32x3).numpy()
    one = narrow_flash(qt, kt, vt, matmul_tf32).numpy()
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 <= TOL_FLASH, err3
    assert err1 >= 10 * err3, (err1, err3)


def wide_flash(q, k, v, mm, keep=None):
    """(out, lse) of [B, H, T, dh] attention as csrc/wide_attention.cuh's
    flash_fwd_wide_kernel computes it: the padded width cut into the
    blocks' shares of w columns and each into two warpgroup halves; per
    32-key tile the partial scores of the halves (products by ``mm``), each
    block's two added first and the blocks' sums in rank order; the online
    softmax in log2 units, o rescaled before it takes the tile's p v in
    the warpgroups' column halves; with ``keep`` (a [B, H, T, T] keep-mask
    and its probability) p dropped after the row sums; lse = m + log2(l)."""
    b, h, t, dh = q.shape
    shape = wide_block_shape(dh)
    cl, w, bk = shape["cl"], shape["w"], shape["bk"]
    qp, kp, vp = (F.pad(x, (0, cl * w - dh)) for x in (q, k, v))
    halves = [[slice(r * w + c * w // 2, r * w + (c + 1) * w // 2) for c in range(2)]
              for r in range(cl)]
    scale_log2 = dh**-0.5 * 1.4426950408889634
    m = torch.full((b, h, t), -torch.finfo(torch.float32).max, dtype=q.dtype)
    l = q.new_zeros(b, h, t)
    o = q.new_zeros(b, h, t, cl * w)
    for j0 in range(0, t, bk):
        kt, vt = kp[:, :, j0:j0 + bk], vp[:, :, j0:j0 + bk]
        s = None
        for block in halves:
            part = [mm(qp[..., c], kt[..., c].transpose(-1, -2)) for c in block]
            s = part[0] + part[1] if s is None else s + (part[0] + part[1])
        s = s * scale_log2
        mn = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - mn[..., None])
        alpha = torch.exp2(m - mn)
        l, m = alpha * l + p.sum(-1), mn
        o = o * alpha[..., None]
        if keep is not None:
            mask, prob = keep
            p = torch.where(mask[..., j0:j0 + bk], p * (1.0 / prob), torch.zeros(()))
        for block in halves:
            for c in block:
                o[..., c] = o[..., c] + mm(p, vt[..., c])
    return o[..., :dh] / l[..., None], m + torch.log2(l)


@pytest.mark.parametrize("b,h,t,d", [(1, 2, 81, 136), (1, 2, 130, 256), (1, 1, 65, 520)])
def test_wide_flash_schedule_in_three_passes_matches_jax(b, h, t, d):
    """The wide kernel's schedule (one block at 136 and 256, a cluster of two
    at 520) in 3xTF32 against JAX's flash kernel in interpret mode, within
    the flash tolerance; one TF32 pass at least 10x further off."""
    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    three = wide_flash(qt, kt, vt, matmul_tf32x3)[0].numpy()
    one = wide_flash(qt, kt, vt, matmul_tf32)[0].numpy()
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 <= TOL_FLASH, err3
    assert err1 >= 10 * err3, (err1, err3)


@pytest.mark.parametrize("d", [256, 520])
def test_wide_flash_dropout_and_lse_match_the_plain_layer(d):
    """The training layer's wide forward at rate 0.1: the schedule with the
    site-0 hash masks against the plain layer's attention (softmax, the same
    masks times 1 / keep, then v), within the flash tolerance, and the row
    log-sum-exp against logsumexp of the scores in log2 units, within 2e-5
    (scores of magnitude ~10 in another order)."""
    b, h, t, keep = 1, 2, 81, 0.9
    rs = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rs.randn(b, h, t, d).astype(np.float32)) for _ in range(3))
    mask = hash_dropout_mask((b, h, t, t), 0, 4242, SITE_ATTN, keep)
    got, lse = wide_flash(q, k, v, matmul_tf32x3, keep=(mask, keep))
    scores = torch.einsum("bhid,bhjd->bhij", q, k) * d**-0.5
    attn = torch.where(mask, scores.softmax(-1) * (1.0 / keep), torch.zeros(()))
    want = torch.einsum("bhij,bhjd->bhid", attn, v)
    assert (got - want).abs().max().item() <= TOL_FLASH
    assert (lse - torch.logsumexp(scores, -1) / np.log(2.0)).abs().max().item() <= 2e-5


@pytest.mark.parametrize("product", ["forward", "data_grad", "weight_grad"])
def test_gemm_operand_layouts_match_jax(product):
    """The training layer's three operand layouts at its ff2 product, 2 x
    121 rows, ff 128, D 64: the forward y = h W2^T (both operands
    K-contiguous), the data gradient dh = dy W2 (W2 read along its other
    axis), the weight gradient dW2 = dy^T h (both operands transposed, the
    242 rows split into chunks of 96: two whole and a ragged one).  Against
    jax.vjp of the same product in f32; one TF32 pass is 10x further off."""
    rs = np.random.RandomState(6)
    m, f, d = 242, 128, 64
    h = rs.randn(m, f).astype(np.float32)
    w2 = (rs.randn(d, f) * f**-0.5).astype(np.float32)
    dy = rs.randn(m, d).astype(np.float32)
    y, vjp = jax.vjp(lambda h, w: jnp.dot(h, w.T, precision=jax.lax.Precision.HIGHEST),
                     jnp.asarray(h), jnp.asarray(w2))
    dh, dw2 = vjp(jnp.asarray(dy))
    h_t, w2_t, dy_t = (torch.from_numpy(a) for a in (h, w2, dy))
    args, kw, want = {
        "forward": ((h_t, w2_t), {}, y),
        "data_grad": ((dy_t, w2_t), dict(b_kc=False), dh),
        "weight_grad": ((dy_t, h_t), dict(a_kc=False, b_kc=False, k_chunk=96), dw2),
    }[product]
    want = np.asarray(want)
    three = gemm_tf32x3(*args, **kw).numpy()
    one = gemm_tf32x3(*args, **kw, mm=matmul_tf32).numpy()
    assert three.shape == want.shape
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 <= 2e-6 * np.abs(want).max(), (err3, np.abs(want).max())
    assert err1 >= 10 * err3, (err1, err3)


def wide_band(q, k, v, window, mm):
    """[B, H, T, dh] causal look-back-one band attention as
    csrc/wide_attention.cuh's band_wide_kernel computes it: per block of 64
    query rows q0 .., the key tiles of ``band_bk`` keys from the block's first
    band key, max(0, (q0 // w - 1) w), to its last row; each tile's scores
    summed once from the partial products of the blocks' and warpgroups'
    column shares (products by ``mm``), each block's two first and the
    blocks' sums in rank order; the band mask (row i sees keys
    max(0, (i // w - 1) w) .. i); the online softmax in log2 units, a
    masked key's p 0 even where a row has seen no key yet; o rescaled before
    it takes the tile's p v in the warpgroups' column halves."""
    b, h, t, dh = q.shape
    shape = wide_block_shape(dh)
    cl, w, bk = shape["cl"], shape["w"], shape["band_bk"]
    qp, kp, vp = (F.pad(x, (0, cl * w - dh)) for x in (q, k, v))
    halves = [[slice(r * w + c * w // 2, r * w + (c + 1) * w // 2) for c in range(2)]
              for r in range(cl)]
    scale_log2 = dh**-0.5 * 1.4426950408889634
    lowest = -torch.finfo(torch.float32).max
    out = q.new_zeros(b, h, t, cl * w)
    for q0 in range(0, t, 64):
        rows = torch.arange(q0, min(q0 + 64, t))
        lo = torch.clamp((rows // window - 1) * window, min=0)
        jbeg, jend = max(0, (q0 // window - 1) * window), min(q0 + 64, t)
        qt = qp[:, :, q0:q0 + 64]
        m = torch.full((b, h, len(rows)), lowest, dtype=q.dtype)
        l = q.new_zeros(b, h, len(rows))
        o = q.new_zeros(b, h, len(rows), cl * w)
        for j0 in range(jbeg, jend, bk):
            kt, vt = kp[:, :, j0:j0 + bk], vp[:, :, j0:j0 + bk]
            s = None
            for block in halves:
                part = [mm(qt[..., c], kt[..., c].transpose(-1, -2)) for c in block]
                s = part[0] + part[1] if s is None else s + (part[0] + part[1])
            j = torch.arange(j0, j0 + kt.shape[2])
            seen = (j[None, :] <= rows[:, None]) & (j[None, :] >= lo[:, None])
            s = torch.where(seen, s * scale_log2, torch.tensor(lowest))
            mn = torch.maximum(m, s.amax(-1))
            p = torch.where(seen, torch.exp2(s - mn[..., None]), torch.zeros(()))
            alpha = torch.exp2(m - mn)
            l, m = alpha * l + p.sum(-1), mn
            o = o * alpha[..., None]
            for block in halves:
                for c in block:
                    o[..., c] = o[..., c] + mm(p, vt[..., c])
        out[:, :, q0:q0 + 64] = o / l[..., None]
    return out[..., :dh]


# lengths on both sides of the 64-row blocks and the 32-key tiles that the
# window divides, as JAX's band kernel requires
BAND_LENGTHS = [(60, 10), (70, 10), (130, 10), (64, 64), (128, 64), (192, 64)]


@pytest.mark.parametrize("d,t,w", [(d, t, w) for d in (136, 264) for t, w in BAND_LENGTHS]
                         + [(520, 70, 10), (520, 128, 64)])
def test_wide_band_schedule_in_three_passes_matches_jax(d, t, w, one_torch_thread):
    """The wide band's schedule (one block at 136 and 264, a cluster of two
    at 520) in 3xTF32 against JAX's band kernel in interpret mode, within
    the flash tolerance; one TF32 pass at least 10x further off."""
    rs = np.random.RandomState(9)
    q, k, v = (rs.randn(1, 2, t, d).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_band(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window_size=w,
                               interpret=True))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    three = wide_band(qt, kt, vt, w, matmul_tf32x3).numpy()
    one = wide_band(qt, kt, vt, w, matmul_tf32).numpy()
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 <= TOL_FLASH, err3
    assert err1 >= 10 * err3, (err1, err3)


def wide_local_block(x, coa, num_heads, window, mm):
    """The local block as csrc/wide_attention.cuh's local_block_wide_kernel
    computes it: x's head rows roped (the plain version's rotary, bit for
    bit: the kernel rounds each product on its own), the wide band over them
    (``wide_band``, q = k = v), then the token prepended and the second
    rotary pass at positions 0 .. T."""
    b, t, d = x.shape
    dh = d // num_heads
    heads = x.reshape(b, t, num_heads, dh).transpose(1, 2)
    heads, _ = apply_rotary_pos_emb(heads, heads, rotary_freqs(t, dh))
    att = wide_band(heads, heads, heads, window, mm).transpose(1, 2).reshape(b, t, d)
    y = torch.cat([coa[:, None], att], dim=1).reshape(b, t + 1, num_heads, dh).transpose(1, 2)
    y, _ = apply_rotary_pos_emb(y, y, rotary_freqs(t + 1, dh))
    return y.transpose(1, 2).reshape(b, t + 1, d)


def test_wide_local_block_schedule_in_three_passes_matches_jax(one_torch_thread):
    """The wide local block at local heads of 136 (--latent_dim 1088), T 80,
    window 10, in 3xTF32 against JAX's fused local block in interpret mode,
    within its rtol 2e-4 / atol 2e-5 (tests/test_torch_local_block.py); one
    TF32 pass at least 10x further off."""
    rs = np.random.RandomState(10)
    x, coa = rs.randn(2, 80, 8 * 136).astype(np.float32), rs.randn(2, 8 * 136).astype(np.float32)
    want = np.asarray(jax_local_block(jnp.asarray(x), jnp.asarray(coa), num_heads=8, window=10,
                                      block_b=2, interpret=True))
    xt, ct = torch.from_numpy(x), torch.from_numpy(coa)
    three = wide_local_block(xt, ct, 8, 10, matmul_tf32x3).numpy()
    one = wide_local_block(xt, ct, 8, 10, matmul_tf32).numpy()
    np.testing.assert_allclose(three, want, rtol=2e-4, atol=2e-5)
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err1 >= 10 * err3, (err1, err3)


@pytest.mark.parametrize("d", [131, 136, 144, 264, 272, 520, 544])
def test_wide_band_blocks_cover_the_width_and_fit(d):
    """The band's blocks (wide_block_shape) cover the head width in shares
    of whole 16-column steps, two warpgroup halves of at most ``wo``
    columns each, and fit a block's shared memory, two blocks an SM's 228
    KB (1 KB each reserved) to 144 columns; the area of 96 rows holds two
    raw 16-key tiles and q's 64 rows."""
    shape = wide_block_shape(d)
    cl, w, wo, bk = shape["cl"], shape["w"], shape["wo"], shape["band_bk"]
    assert cl * w >= d > cl * (w - 16) and w % 16 == 0 and w // 2 <= wo
    assert shape["band_smem"] <= 232448 and 2 * bk + 64 <= 96
    assert (2 * (shape["band_smem"] + 1024) <= 228 * 1024) == (d <= 144)
