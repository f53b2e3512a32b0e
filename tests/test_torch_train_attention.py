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
"""

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
from tests.test_torch_tf32x3 import matmul_tf32, matmul_tf32x3

LOG2E = 1.4426950408889634
FLT_MAX = float(np.finfo(np.float32).max)
ROWS = 64  # resident rows a block of the backward (encoder_layer_train.cu:kBwdRows)
TOL = 1e-5


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


def layer(x, wqkv, bqkv, wo, bo, l1w, l1b, w1, b1, w2, b2, l2w, l2b, *, seed, num_heads,
          rate, mm):
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
    a = TiledAttention.apply(q, k, v, seed, rate, mm).transpose(1, 2).reshape(b, t, d)
    x = F.layer_norm(x + drop(F.linear(a, wo, bo), SITE_POST_ATTN), (d,), l1w, l1b, LN_EPS)
    hd = drop(gelu_tanh(F.linear(x, w1, b1)), SITE_ACT)
    return F.layer_norm(x + drop(F.linear(hd, w2, b2), SITE_FF), (d,), l2w, l2b, LN_EPS)


def _weights(d, f, seed):
    """JAX [in, out] layer weights from numpy."""
    rs = np.random.RandomState(seed)
    shapes = [(d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
              (d, f), (f,), (f, d), (d,), (d,), (d,)]
    ws = []
    for i, s in enumerate(shapes):
        w = 0.2 * rs.randn(*s)
        ws.append((w + 1.0 if i in (4, 10) else w).astype(np.float32))
    return ws


def _max_rel_errors(t, rate, mm, dtype, b=2, d=64, h=2, f=128, seed=17):
    rs = np.random.RandomState(t)
    x = rs.randn(b, t, d).astype(np.float32)
    g = rs.randn(b, t, d).astype(np.float32)
    ws = _weights(d, f, seed=t + 1)

    def ref(x, *ws):
        return jnp.sum(jet.encoder_layer_train_reference(x, ws, seed, num_heads=h, rate=rate) * g)

    want = jax.grad(ref, argnums=tuple(range(13)))(jnp.asarray(x), *map(jnp.asarray, ws))
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = [torch.from_numpy(np.ascontiguousarray(w.T if w.ndim == 2 else w)).to(dtype)
          .requires_grad_() for w in ws]
    out = layer(xt, *wt, seed=seed, num_heads=h, rate=rate, mm=mm)
    (out * torch.from_numpy(g).to(dtype)).sum().backward()
    got = [xt.grad] + [w.grad.T if w.dim() == 2 else w.grad for w in wt]
    errs = []
    for a, e in zip(got, want):
        e = np.asarray(e, np.float64)
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
