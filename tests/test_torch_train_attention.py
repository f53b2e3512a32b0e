"""The training layer's flash-style attention, emulated on the CPU.

csrc/encoder_layer_train.cu computes the layer's attention forward with the
flash kernel (csrc/flash_attention.cuh: an online softmax over key tiles,
site-0 dropout on the undropped-normalised probabilities, the rows'
log-sum-exp in log2 units) and its backward in two tiled passes
(FlashAttention-2 with dropout, no atomics): a dK/dV pass that keeps 64
keys of a (batch, head) and walks the query tiles, and a dQ pass that keeps
64 queries and walks the key tiles.  Both recompute P = exp2(S log2(e) -
lse), use D = rowsum(dO o O) of the dropped forward output and draw the
site-0 mask at each element's physical (query, key) index.  This file runs
that algorithm in plain PyTorch, tile by tile (ragged last tiles zero-filled
and masked as the kernels do), once in float64 and once with every product
in emulated 3xTF32 (tests/test_torch_tf32x3.py), inside the training layer
under autograd, and holds dx and the 12 parameter gradients against JAX
autodiff of gesturediffusion_tpu/ops/pallas_encoder_train.py:
encoder_layer_train_reference, at lengths around the 64-row blocks and the
32-row tiles (head width 32).  Tolerance: 1e-5 of each gradient's largest
magnitude, float32 level against the float32 reference (measured 1.0e-06
to 1.5e-06 in both arithmetics); the single-TF32-pass control (1e-03 to
2e-03 measured) is held to be 10x further off.

Past a head width of 128 the backward runs in the wide passes
(``wide_backward``): 64 resident rows of a (batch, head) and the whole
width, a cluster of two blocks past 272 columns; the other side streamed in
tiles of 8 rows; each score tile (S and dP, or S^T and dP^T) summed once
from the partial products over the blocks' and warpgroups' column shares,
each block's two halves first and the blocks in rank order; dQ, dV and dK
accumulated tile by tile.  It runs in the same layer, after the wide flash
forward's emulation (tests/test_torch_tf32x3.py:wide_flash), against the
same JAX gradients at head widths 136 and 256 (one block) and 520 (a
cluster of two), within the same tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gesturediffusion_tpu.ops import pallas_encoder_train as jet
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    LN_EPS,
    SITE_ACT,
    SITE_ATTN,
    SITE_FF,
    SITE_POST_ATTN,
    gelu_tanh,
)
from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
    hash_dropout_mask,
    hash_u32,
    keep_threshold,
    salt,
)
from tests.test_torch_tf32x3 import matmul_tf32, matmul_tf32x3, wide_flash
from tests.torch_port_common import WIDE_MAX_WIDTH, wide_bwd_block_shape

LOG2E = 1.4426950408889634
FLT_MAX = float(np.finfo(np.float32).max)
ROWS = 64  # resident rows a block of the backward (encoder_layer_train.cu:kBwdRows)
TOL = 1e-5
MAX_SMEM = 232448  # an H100's shared memory a block may use (csrc/common.cuh:kMaxSmem)


def tiles(dh: int) -> tuple[int, int]:
    """(keys a tile of the flash forward, streamed rows a tile of the
    backward): flash_attention.cuh:FlashTile::BK, BwdTile::BN."""
    return (64 if dh <= 64 else 16), (32 if dh <= 64 else 16)


def rows(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of x, zero past its end, as a tile lands."""
    out = x.new_zeros((n,) + x.shape[1:])
    part = x[r0:r0 + n]
    out[:part.shape[0]] = part
    return out


def site0_scale(bh: int, t: int, i: torch.Tensor, j: torch.Tensor, seed: int, rate: float,
                dtype) -> torch.Tensor:
    """Z [len(i), len(j)]: 1 / keep or 0 at the physical query i and key j,
    index ((b*H + h)*T + i)*T + j in uint32 (the kernels' arithmetic)."""
    if rate == 0.0:
        return torch.ones((len(i), len(j)), dtype=dtype)
    idx = ((bh * t + i[:, None]) * t + j[None, :]) & 0xFFFFFFFF
    keep = hash_u32(idx, salt(seed, SITE_ATTN)) < keep_threshold(1.0 - rate)
    return torch.where(keep, torch.tensor(1.0 / (1.0 - rate), dtype=dtype),
                       torch.tensor(0.0, dtype=dtype))


def flash_forward(q, k, v, bh, seed, rate, mm):
    """One (batch, head) [T, dh] -> (o, lse in log2 units), key tile by key
    tile with the online softmax; dropout after the row sums took p."""
    t, dh = q.shape
    bk, _ = tiles(dh)
    sl = dh**-0.5 * LOG2E
    m = torch.full((t,), -FLT_MAX, dtype=q.dtype)
    l = torch.zeros(t, dtype=q.dtype)
    o = torch.zeros_like(q)
    qi = torch.arange(t)
    for j0 in range(0, t, bk):
        kj = torch.arange(j0, j0 + bk)
        s = mm(q, rows(k, j0, bk).T) * sl
        s = torch.where(kj[None, :] < t, s, torch.tensor(-FLT_MAX, dtype=q.dtype))
        mn = torch.maximum(m, s.max(dim=1).values)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s - mn[:, None])
        l = alpha * l + p.sum(dim=1)
        o = o * alpha[:, None] + mm(p * site0_scale(bh, t, qi, kj, seed, rate, q.dtype),
                                    rows(v, j0, bk))
        m = mn
    return o / l[:, None], m + torch.log2(l)


def flash_backward(q, k, v, o, do, lse, bh, seed, rate, mm):
    """One (batch, head): (dq, dk, dv) by the kernels' two tiled passes."""
    t, dh = q.shape
    _, bn = tiles(dh)
    scale = dh**-0.5
    sl = scale * LOG2E
    dvec = (do * o).sum(dim=1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    zero = torch.tensor(0.0, dtype=q.dtype)
    # the dK/dV pass: 64 keys resident, S^T = K Q^T and dP^T = V dO^T a tile
    for k0 in range(0, t, ROWS):
        keys = torch.arange(k0, k0 + ROWS)
        kr, vr = rows(k, k0, ROWS), rows(v, k0, ROWS)
        dkb, dvb = torch.zeros_like(kr), torch.zeros_like(vr)
        for j0 in range(0, t, bn):
            qs = torch.arange(j0, j0 + bn)
            qt, ot = rows(q, j0, bn), rows(do, j0, bn)
            lt, dt = rows(lse, j0, bn), rows(dvec, j0, bn)
            st, dpt = mm(kr, qt.T), mm(vr, ot.T)
            p = torch.where(qs[None, :] < t, torch.exp2(st * sl - lt[None, :]), zero)
            z = site0_scale(bh, t, qs, keys, seed, rate, q.dtype).T
            dvb = dvb + mm(p * z, ot)
            dkb = dkb + mm(p * (dpt * z - dt[None, :]) * scale, qt)
        n = min(ROWS, t - k0)
        dk[k0:k0 + n], dv[k0:k0 + n] = dkb[:n], dvb[:n]
    # the dQ pass: 64 queries resident, S = Q K^T and dP = dO V^T a tile
    for q0 in range(0, t, ROWS):
        qs = torch.arange(q0, q0 + ROWS)
        qr, orr = rows(q, q0, ROWS), rows(do, q0, ROWS)
        lr, dr = rows(lse, q0, ROWS), rows(dvec, q0, ROWS)
        dqb = torch.zeros_like(qr)
        for j0 in range(0, t, bn):
            keys = torch.arange(j0, j0 + bn)
            kt, vt = rows(k, j0, bn), rows(v, j0, bn)
            s, dp = mm(qr, kt.T), mm(orr, vt.T)
            p = torch.where(keys[None, :] < t, torch.exp2(s * sl - lr[:, None]), zero)
            z = site0_scale(bh, t, qs, keys, seed, rate, q.dtype)
            dqb = dqb + mm(p * (dp * z - dr[:, None]) * scale, kt)
        n = min(ROWS, t - q0)
        dq[q0:q0 + n] = dqb[:n]
    return dq, dk, dv


class TiledAttention(torch.autograd.Function):
    """[B, H, T, dh] q, k, v -> the dropped attention output, forward and
    backward by the emulated kernels."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate, mm):
        b, h = q.shape[:2]
        outs = [flash_forward(q[i, j], k[i, j], v[i, j], i * h + j, seed, rate, mm)
                for i in range(b) for j in range(h)]
        o = torch.stack([a for a, _ in outs]).reshape(q.shape)
        lse = torch.stack([c for _, c in outs]).reshape(q.shape[:3])
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (seed, rate, mm)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        b, h = q.shape[:2]
        grads = [flash_backward(q[i, j], k[i, j], v[i, j], o[i, j], do[i, j], lse[i, j],
                                i * h + j, *ctx.args) for i in range(b) for j in range(h)]
        dq, dk, dv = (torch.stack([g[n] for g in grads]).reshape(q.shape) for n in range(3))
        return dq, dk, dv, None, None, None


def tile(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of x [N, T, ...] along dim 1, zero past its end."""
    out = x.new_zeros((x.shape[0], n) + x.shape[2:])
    part = x[:, r0:r0 + n]
    out[:, :part.shape[1]] = part
    return out


def wide_backward(q, k, v, o, do, lse, seed, rate, mm):
    """[N, T, dh] heads (head n the (batch, head) index n) -> (dq, dk, dv)
    as csrc/encoder_layer_train.cu's wide passes compute them past a head
    width of 128: the padded width cut into the blocks' shares of w columns
    and each into two warpgroup halves (wide_bwd_block_shape); 64 resident
    rows (queries for dQ, keys for dK and dV) against tiles of ``bk``
    streamed rows; each score tile summed from the halves' partial products
    (by ``mm``), each block's two first and the blocks' sums in rank order;
    P from the LSE, the site-0 mask at the physical (query, key) index, and
    the outputs accumulated tile by tile."""
    n, t, dh = q.shape
    shape = wide_bwd_block_shape(dh)
    cl, w, bk = shape["cl"], shape["w"], shape["bk"]
    qp, kp, vp, dop = (F.pad(x, (0, cl * w - dh)) for x in (q, k, v, do))
    halves = [[slice(r * w + c * w // 2, r * w + (c + 1) * w // 2) for c in range(2)]
              for r in range(cl)]
    scale = dh**-0.5
    sl = scale * LOG2E
    dvec = (do * o).sum(-1)
    bh = torch.arange(n)[:, None, None]
    zero = torch.tensor(0.0, dtype=q.dtype)

    def scores(a, b):
        s = None
        for block in halves:
            part = [mm(a[..., c], b[..., c].transpose(-1, -2)) for c in block]
            s = part[0] + part[1] if s is None else s + (part[0] + part[1])
        return s

    dq, dk, dv = (torch.zeros_like(x) for x in (qp, kp, vp))
    for r0 in range(0, t, ROWS):
        rs, nr = torch.arange(r0, r0 + ROWS), min(ROWS, t - r0)
        # the dQ pass: queries rs resident, key tiles streamed
        qr, dor = tile(qp, r0, ROWS), tile(dop, r0, ROWS)
        lr, dr = tile(lse, r0, ROWS)[..., None], tile(dvec, r0, ROWS)[..., None]
        dqb = torch.zeros_like(qr)
        for j0 in range(0, t, bk):
            js = torch.arange(j0, j0 + bk)
            kt, vt = tile(kp, j0, bk), tile(vp, j0, bk)
            s, dp = scores(qr, kt), scores(dor, vt)
            p = torch.where(js < t, torch.exp2(s * sl - lr), zero)
            z = site0_scale(bh, t, rs, js, seed, rate, q.dtype)
            dqb = dqb + mm(p * (dp * z - dr) * scale, kt)
        # the dK/dV pass: keys rs resident, query tiles streamed
        kr, vr = tile(kp, r0, ROWS), tile(vp, r0, ROWS)
        dkb, dvb = torch.zeros_like(kr), torch.zeros_like(vr)
        for j0 in range(0, t, bk):
            js = torch.arange(j0, j0 + bk)
            qt, ot = tile(qp, j0, bk), tile(dop, j0, bk)
            lt, dt = tile(lse, j0, bk)[:, None, :], tile(dvec, j0, bk)[:, None, :]
            st, dpt = scores(kr, qt), scores(vr, ot)
            p = torch.where(js < t, torch.exp2(st * sl - lt), zero)
            z = site0_scale(bh, t, js, rs, seed, rate, q.dtype).transpose(-1, -2)
            dvb = dvb + mm(p * z, ot)
            dkb = dkb + mm(torch.where(js < t, p * (dpt * z - dt) * scale, zero), qt)
        dq[:, r0:r0 + nr], dk[:, r0:r0 + nr], dv[:, r0:r0 + nr] = dqb[:, :nr], dkb[:, :nr], dvb[:, :nr]
    return dq[..., :dh], dk[..., :dh], dv[..., :dh]


class WideAttention(torch.autograd.Function):
    """[B, H, T, dh] q, k, v past a head width of 128 -> the dropped
    attention output: the wide flash forward's emulation, then the wide
    passes'."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate, mm):
        b, h, t, _ = q.shape
        keep = (None if rate == 0.0 else
                (hash_dropout_mask((b, h, t, t), 0, seed, SITE_ATTN, 1.0 - rate), 1.0 - rate))
        o, lse = wide_flash(q, k, v, mm, keep)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (seed, rate, mm)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        b, h, t, dh = q.shape
        flat = [x.reshape(b * h, t, dh) for x in (q, k, v, o, do)]
        grads = wide_backward(*flat, lse.reshape(b * h, t), *ctx.args)
        return (*(g.reshape(q.shape) for g in grads), None, None, None)


def layer(x, wqkv, bqkv, wo, bo, l1w, l1b, w1, b1, w2, b2, l2w, l2b, *, seed, num_heads,
          rate, mm, attention=TiledAttention):
    """The training layer (ops/fused_encoder_train.py:encoder_layer_train_plain)
    with its attention by the emulated kernels."""
    b, t, d = x.shape
    keep = 1.0 - rate

    def drop(z, site):
        if rate == 0.0:
            return z
        mask = hash_dropout_mask(z.shape, 0, seed, site, keep)
        return torch.where(mask, z * (1.0 / keep), torch.zeros((), dtype=z.dtype))

    q, k, v = (y.reshape(b, t, num_heads, -1).transpose(1, 2)
               for y in F.linear(x, wqkv, bqkv).chunk(3, dim=-1))
    a = attention.apply(q, k, v, seed, rate, mm).transpose(1, 2).reshape(b, t, d)
    x = F.layer_norm(x + drop(F.linear(a, wo, bo), SITE_POST_ATTN), (d,), l1w, l1b, LN_EPS)
    hd = drop(gelu_tanh(F.linear(x, w1, b1)), SITE_ACT)
    return F.layer_norm(x + drop(F.linear(hd, w2, b2), SITE_FF), (d,), l2w, l2b, LN_EPS)


def _weights(d, f, seed, fan_in=False):
    """JAX [in, out] layer weights from numpy: 0.2 randn, or with
    ``fan_in`` the matrices at 1 / sqrt(their fan-in), as a layer is
    initialised."""
    rs = np.random.RandomState(seed)
    shapes = [(d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
              (d, f), (f,), (f, d), (d,), (d,), (d,)]
    ws = []
    for i, s in enumerate(shapes):
        w = (s[0] ** -0.5 if fan_in and len(s) == 2 else 0.2) * rs.randn(*s)
        ws.append((w + 1.0 if i in (4, 10) else w).astype(np.float32))
    return ws


@functools.lru_cache(maxsize=None)
def _case(t, rate, b, d, h, f, seed, fan_in):
    """The inputs of a comparison and jax.grad of the reference layer (one
    compiled call: both arithmetics of a case share it)."""
    rs = np.random.RandomState(t)
    x = rs.randn(b, t, d).astype(np.float32)
    g = rs.randn(b, t, d).astype(np.float32)
    ws = _weights(d, f, seed=t + 1, fan_in=fan_in)

    def ref(x, *ws):
        return jnp.sum(jet.encoder_layer_train_reference(x, ws, seed, num_heads=h, rate=rate) * g)

    want = jax.jit(jax.grad(ref, argnums=tuple(range(13))))(jnp.asarray(x), *map(jnp.asarray, ws))
    return x, g, ws, [np.asarray(e, np.float64) for e in want]


def _max_rel_errors(t, rate, mm, dtype, b=2, d=64, h=2, f=128, seed=17,
                    attention=TiledAttention, fan_in=False):
    x, g, ws, want = _case(t, rate, b, d, h, f, seed, fan_in)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = [torch.from_numpy(np.ascontiguousarray(w.T if w.ndim == 2 else w)).to(dtype)
          .requires_grad_() for w in ws]
    out = layer(xt, *wt, seed=seed, num_heads=h, rate=rate, mm=mm, attention=attention)
    (out * torch.from_numpy(g).to(dtype)).sum().backward()
    got = [xt.grad] + [w.grad.T if w.dim() == 2 else w.grad for w in wt]
    errs = []
    for a, e in zip(got, want):
        errs.append(np.abs(a.double().numpy() - e).max() / np.abs(e).max())
    return errs


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [7, 64, 65, 121])
@pytest.mark.parametrize("arith", ["f64", "tf32x3"])
def test_tiled_attention_backward_matches_jax_autodiff(arith, t, rate):
    """dx and the 12 parameter gradients of the layer with the emulated
    kernels' attention, against jax.grad of the reference layer: T inside
    one tile, one block exactly, one past it (a ragged 1-row block and
    tile), and the train CLI's default 120 frames plus the token."""
    mm, dtype = ((torch.matmul, torch.float64) if arith == "f64"
                 else (matmul_tf32x3, torch.float32))
    errs = _max_rel_errors(t, rate, mm, dtype)
    assert len(errs) == 13
    assert max(errs) <= TOL, [f"{e:.2e}" for e in errs]


def test_one_tf32_pass_in_the_attention_is_another_result():
    """The control: the same tiles with each attention product in a single
    TF32 pass land at least 10x further from the reference than three
    passes."""
    three = max(_max_rel_errors(65, 0.1, matmul_tf32x3, torch.float32))
    one = max(_max_rel_errors(65, 0.1, matmul_tf32, torch.float32))
    assert one >= 10 * three, (one, three)


@pytest.fixture
def one_thread():
    """One torch thread for the wide emulation (the suite runs in several
    workers), restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (head width, heads): one block at 136 and 256 columns, a cluster of two at 520
WIDE = [(136, 2), (256, 2), (520, 1)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t", [9, 65])
@pytest.mark.parametrize("dh,h", WIDE)
@pytest.mark.parametrize("arith", ["f64", "tf32x3"])
def test_wide_backward_matches_jax_autodiff(one_thread, arith, dh, h, t, rate):
    """dx and the 12 parameter gradients of the layer with the wide passes'
    schedule, against jax.grad of the reference layer: one 8-row tile and
    a ragged one, one 64-row block and a ragged 1-row block.  The weights
    are drawn at 1 / sqrt(fan-in), as a layer is initialised: with the
    narrow test's 0.2 at D 512 the scores reach ~20 and the float32
    reference's own error against float64 JAX is 2.7e-05 of a gradient,
    past the tolerance; at 1 / sqrt(fan-in) it is under 1e-06 (measured),
    and both arithmetics sit within 1.2e-06 of it (one TF32 pass: 4e-04)."""
    mm, dtype = ((torch.matmul, torch.float64) if arith == "f64"
                 else (matmul_tf32x3, torch.float32))
    errs = _max_rel_errors(t, rate, mm, dtype, b=2, d=h * dh, h=h, f=64, attention=WideAttention,
                           fan_in=True)
    assert len(errs) == 13
    assert max(errs) <= TOL, [f"{e:.2e}" for e in errs]


def test_one_tf32_pass_in_the_wide_backward_is_another_result(one_thread):
    """The control at heads of 256: one TF32 pass a product lands at least
    10x further from the reference than three."""
    kw = dict(b=2, d=512, h=2, f=64, attention=WideAttention, fan_in=True)
    three = max(_max_rel_errors(65, 0.1, matmul_tf32x3, torch.float32, **kw))
    one = max(_max_rel_errors(65, 0.1, matmul_tf32, torch.float32, **kw))
    assert one >= 10 * three, (one, three)


@pytest.mark.parametrize("dh", [129, 131, 136, 200, 256, 261, 264, 272, 273, 520, 523, 544])
def test_wide_backward_block_covers_the_width_within_shared_memory(dh):
    """The wide passes' block at every width they take: one block to 272
    columns, a cluster of two past it; the shares (multiples of 16, a
    warpgroup's half a whole number of k8 steps) cover the width, each
    warpgroup's accumulators hold its half, the streamed tile is one k8
    step of wgmma, and the shared memory fits."""
    shape = wide_bwd_block_shape(dh)
    assert shape["cl"] == (1 if dh <= 272 else 2)
    assert shape["w"] % 16 == 0 and shape["cl"] * shape["w"] >= dh
    assert shape["cl"] * shape["w"] - dh < 16 * shape["cl"]
    assert shape["wo"] >= shape["w"] // 2 and shape["bk"] == 8
    assert shape["smem"] <= MAX_SMEM


@pytest.mark.parametrize("dh", [64, 128, WIDE_MAX_WIDTH + 1, 1024])
def test_wide_backward_is_only_past_128_and_to_its_widest(dh):
    """Up to 128 the narrow passes run; past WIDE_MAX_WIDTH the sliced ones."""
    assert wide_bwd_block_shape(dh) is None
