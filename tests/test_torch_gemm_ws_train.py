"""The training layer's products on csrc/gemm_ws.cuh, emulated on the CPU.

csrc/encoder_layer_train.cu runs kernel 5's four forward products and
kernel 6's sixteen (the recompute, four data gradients, four weight
gradients) on csrc/gemm_ws.cuh in three schedules, all built here on
tests/test_torch_gemm_ws.py:gemm_ws, which forms a product k8 step by k8
step from a split as the kernel does:

* the forward products read the weight's split (``split_weight_plain``),
  the data gradients dX = dY . W the split of W^T (``split_weight_t_plain``:
  [2, in, out rounded up to 8], each slice of 8 in the order 0, 2, 4, 6, 1,
  3, 5, 7); both flush the accumulator into a second sum after every 4
  slices of 32 (128 of K) and after the last (``gemm_ws_flushed``);
* the weight gradients dW = dY^T . X sum the rows in the chunks of
  csrc/encoder_layer_train.cu:weight_grad_splits (``weight_grad_splits``),
  each chunk a flushed product of dY's rows against the split of X^T (the
  producer's split of X's slices), the chunks' sums added in chunk order.

Up to K = 128 (no flush) an emulated product is ``gemm_ws``'s bit for bit.
The layer built from these products (attention, LayerNorm, GELU and the
hash dropout as the plain layer has them) and its backward are held
against the JAX package's ops/pallas_encoder_train.py layer and its vjp in
interpret mode at M = 291 rows (off every tile, two row chunks) and K = 160
(a flush), within the card's TOL_TRAIN_FWD (1e-4) and TOL_TRAIN_GRAD (5e-4
of each gradient's max).  Whether the card is bit for bit its parent
chain is held on the card (tests/test_torch_cuda.py, chip_smoke.py phase
3).  Also here: the dispatch rule's Python mirror (``train_routes``) and
the cache of the transposed splits (``weight_split_t``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gesturediffusion_tpu.ops import pallas_encoder_train as jet
from gesturediffusion_tpu_torch.models.transformer import TransformerEncoderLayer
from gesturediffusion_tpu_torch.ops import fused_encoder as fe
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    LN_EPS,
    SITE_ACT,
    SITE_ATTN,
    SITE_FF,
    SITE_POST_ATTN,
    gelu_tanh,
    split_cols,
    split_weight_plain,
    split_weight_t_plain,
    weight_split,
    weight_split_t,
)
from gesturediffusion_tpu_torch.ops.fused_encoder_train import (
    hash_dropout_mask,
    train_routes,
    weight_grad_splits,
)
from tests.test_torch_gemm_ws import gemm_ws
from tests.torch_port_common import (
    one_torch_thread,  # noqa: F401 (fixture)
    threefry_prng,  # noqa: F401 (autouse fixture)
)

TOL_TRAIN_FWD = 1e-4
TOL_TRAIN_GRAD = 5e-4
FLUSH_K = 128  # 4 slices of 32


def gemm_ws_flushed(a, split, k):
    """a [M, k] . B^T from B's split [2, N, kp] as gemm_ws.cuh's training
    instantiations form it: gemm_ws's k8 steps into an accumulator that is
    added into a second sum after every FLUSH_K columns and after the last."""
    kp = split.shape[-1]
    total = torch.zeros(a.shape[0], split.shape[1])
    for c0 in range(0, kp, FLUSH_K):
        c1 = min(c0 + FLUSH_K, kp)
        total = total + gemm_ws(a[:, c0:min(c1, k)], split[:, :, c0:c1], min(c1, k) - c0)
    return total


def weight_grad(dy, x):
    """dW = dy^T . x (dy [M, I], x [M, J]) as gemm_ws_tn_kernel forms it:
    the rows in weight_grad_splits' chunks, each a flushed product of dy's
    rows against the split of x^T, the chunks' sums added in order."""
    m, i = dy.shape
    splits, chunk = weight_grad_splits(i, x.shape[1], m)
    parts = [gemm_ws_flushed(dy[r:r + chunk].T.contiguous(),
                             split_weight_plain(x[r:r + chunk].T.contiguous()),
                             min(chunk, m - r)) for r in range(0, m, chunk)]
    assert len(parts) == splits
    if splits == 1:
        return parts[0]
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


class _Product(torch.autograd.Function):
    """x [M, in] . w [out, in]^T on the emulated forward schedule; its
    backward on the data-gradient and weight-gradient schedules."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return gemm_ws_flushed(x, split_weight_plain(w), x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        return gemm_ws_flushed(g, split_weight_t_plain(w), w.shape[0]), weight_grad(g, x)


def linear(x, w, b):
    lead = x.shape[:-1]
    return _Product.apply(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[0]) + b


def train_layer_ws(x, wqkv, bqkv, wo, bo, l1w, l1b, w1, b1, w2, b2, l2w, l2b, *, seed,
                   num_heads, rate):
    """The training layer with every product on the emulated schedules, the
    rest (attention, LayerNorm, GELU, the hash dropout) as
    ops/fused_encoder.py:encoder_layer_plain has it."""
    keep = 1.0 - rate

    def drop(z, site):
        if rate == 0.0:
            return z
        mask = hash_dropout_mask(z.shape, 0, seed, site, keep)
        return torch.where(mask, z * (1.0 / keep), torch.zeros(()))

    b, t, d = x.shape
    dh = d // num_heads
    q, k, v = (y.reshape(b, t, num_heads, dh).transpose(1, 2)
               for y in linear(x, wqkv, bqkv).chunk(3, dim=-1))
    p = drop((torch.einsum("bhid,bhjd->bhij", q, k) * dh**-0.5).softmax(dim=-1), SITE_ATTN)
    a = torch.einsum("bhij,bhjd->bhid", p, v).transpose(1, 2).reshape(b, t, d)
    y1 = F.layer_norm(x + drop(linear(a, wo, bo), SITE_POST_ATTN), (d,), l1w, l1b, LN_EPS)
    h = drop(gelu_tanh(linear(y1, w1, b1)), SITE_ACT)
    return F.layer_norm(y1 + drop(linear(h, w2, b2), SITE_FF), (d,), l2w, l2b, LN_EPS)


def _jax_weights(d, f, seed):
    rs = np.random.RandomState(seed)
    shapes = [(d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,),
              (d, f), (f,), (f, d), (d,), (d,), (d,)]
    ws = []
    for i, s in enumerate(shapes):
        w = 0.2 * rs.randn(*s) * (s[0] ** -0.5 if len(s) == 2 else 1.0)
        ws.append((w + 1.0 if i in (4, 10) else w).astype(np.float32))
    return ws


@pytest.mark.parametrize("rate", [0.1, 0.0])
def test_emulated_schedules_match_the_jax_layer_and_its_vjp(rate, one_torch_thread):  # noqa: F811
    """B 3 x T 97 = 291 rows (two weight-gradient chunks of 160 and 131),
    D 32, F 160 (ff2's and w1's data gradient's K: a flush), 4 heads."""
    b, t, d, f, h, seed = 3, 97, 32, 160, 4, 11
    rs = np.random.RandomState(24)
    x = rs.randn(b, t, d).astype(np.float32)
    g = rs.randn(b, t, d).astype(np.float32)
    ws = _jax_weights(d, f, 25)
    assert weight_grad_splits(f, d, b * t) == (2, 160)
    fused = jet.make_fused_train_layer(h, rate, block_b=3, interpret=True)

    def loss(x, *ws):
        return jnp.sum(fused(x, *ws, jnp.int32(seed)) * g)

    want_out = np.asarray(fused(jnp.asarray(x), *map(jnp.asarray, ws), jnp.int32(seed)))
    want = jax.grad(loss, argnums=tuple(range(13)))(jnp.asarray(x), *map(jnp.asarray, ws))

    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(np.ascontiguousarray(w.T if w.ndim == 2 else w)).requires_grad_()
          for w in ws]
    out = train_layer_ws(xt, *wt, seed=seed, num_heads=h, rate=rate)
    (out * torch.from_numpy(g)).sum().backward()
    err = np.abs(out.detach().numpy() - want_out).max()
    assert err <= TOL_TRAIN_FWD, err
    got = [xt.grad] + [w.grad.T if w.dim() == 2 else w.grad for w in wt]
    for i, (a, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        rel = np.abs(a.numpy() - w).max() / np.abs(w).max()
        assert rel <= TOL_TRAIN_GRAD, (i, rel)


@pytest.mark.parametrize("k", [8, 20, 64, 128])
def test_without_a_flush_each_schedule_is_gemm_ws_bit_for_bit(k):
    """Up to K = 128 the flushed forward and data-gradient products, and a
    one-chunk weight gradient, are gemm_ws's step-by-step products from the
    same split, bit for bit."""
    rs = np.random.RandomState(26)
    a = torch.from_numpy(rs.randn(37, k).astype(np.float32))
    w = torch.from_numpy(rs.randn(24, k).astype(np.float32))
    s = split_weight_plain(w)
    assert torch.equal(gemm_ws_flushed(a, s, k), gemm_ws(a, s, k))
    wt = torch.from_numpy(rs.randn(k, 20).astype(np.float32))  # a data gradient's W [out, in]
    st = split_weight_t_plain(wt)
    assert torch.equal(gemm_ws_flushed(a, st, k), gemm_ws(a, st, k))
    dy = torch.from_numpy(rs.randn(k, 12).astype(np.float32))   # k rows: one chunk
    x = torch.from_numpy(rs.randn(k, 16).astype(np.float32))
    assert weight_grad_splits(12, 16, k) == (1, -(-k // 32) * 32)
    assert torch.equal(weight_grad(dy, x), gemm_ws(dy.T.contiguous(),
                                                   split_weight_plain(x.T.contiguous()), k))


def test_flush_and_chunks_change_the_order_but_not_the_product():
    """Past 128 the flushed product differs from the unflushed one in its last
    bits only, and the chunked weight gradient stays at the f32 product's
    accuracy (against float64, 2e-6 of the largest output)."""
    rs = np.random.RandomState(27)
    a = torch.from_numpy(rs.randn(70, 1000).astype(np.float32))
    w = torch.from_numpy((rs.randn(48, 1000) * 1000**-0.5).astype(np.float32))
    s = split_weight_plain(w)
    flushed, plain = gemm_ws_flushed(a, s, 1000), gemm_ws(a, s, 1000)
    want = a.double() @ w.double().T
    assert not torch.equal(flushed, plain)
    for got in (flushed, plain):
        assert (got.double() - want).abs().max() <= 2e-6 * want.abs().max()
    dy = torch.from_numpy(rs.randn(600, 24).astype(np.float32))
    x = torch.from_numpy(rs.randn(600, 20).astype(np.float32))
    assert weight_grad_splits(24, 20, 600)[0] == 4
    want = dy.double().T @ x.double()
    assert (weight_grad(dy, x).double() - want).abs().max() <= 2e-6 * want.abs().max()


def test_transposed_split_is_the_split_of_the_transpose():
    """split_weight_t_plain(w) for w [out, in]: [2, in, out rounded up to 8],
    column 8j + i of a part holding w's row 8j + 2i (i < 4) or 8j + 2(i - 4)
    + 1, zero past out."""
    rs = np.random.RandomState(28)
    w = torch.from_numpy(rs.randn(20, 6).astype(np.float32))
    s = split_weight_t_plain(w)
    assert s.shape == (2, 6, split_cols(20))
    src = [8 * j + (2 * i if i < 4 else 2 * (i - 4) + 1) for j in range(3) for i in range(8)]
    for c, row in enumerate(src):
        if row < 20:
            assert torch.equal(s[0, :, c], fe.tf32_rn(w[row]))
            assert torch.equal(s[1, :, c], fe.tf32_rn(w[row] - s[0, :, c]))
        else:
            assert not s[:, :, c].any()


@pytest.mark.parametrize("i,j,m,want", [
    (1024, 256, 5184, (9, 576)),    # the gesture layer's dW1 at [64, 81, 256]
    (256, 256, 5184, (33, 160)),    # dWo: 5-slice chunks
    (768, 256, 5184, (11, 480)),    # dWqkv
    (1536, 512, 12608, (3, 4224)),  # t2m's dWqkv: past 1024 rows a chunk
    (16, 16, 100, (1, 128)),        # under 128 rows: one chunk
])
def test_weight_grad_splits_mirror_the_parent_tiles(i, j, m, want):
    assert weight_grad_splits(i, j, m) == want
    splits, chunk = want
    assert chunk % 32 == 0 and (splits - 1) * chunk < m <= splits * chunk


@pytest.mark.parametrize("d,f,want", [
    (256, 1024, 0b1111),  # the gesture layer
    (512, 1024, 0b1111),  # t2m and a2m
    (264, 1056, 0b1111),  # heads of 66: K 1056 past 1024, flushed as the parent
    (130, 1030, 0),       # heads of 65: rows not 16-byte aligned
    (256, 1030, 0b0011),  # F not a multiple of 4: w1 and w2 stay on the parent
    (198, 792, 0),        # 3 heads of 66
    (1024, 1024, 0b1111),
])
def test_train_routes_follow_the_rule(d, f, want):
    assert train_routes(d, f) == want
    for i, (out, inn) in enumerate(((3 * d, d), (d, d), (f, d), (d, f))):
        assert bool(want >> i & 1) == (out % 4 == 0 and inn % 4 == 0)


def _layer():
    torch.manual_seed(29)
    return TransformerEncoderLayer(64, 4, 128, 0.0)


@pytest.mark.parametrize("change", ["add_", "copy_", "load_state_dict"])
def test_transposed_split_is_kept_until_the_weight_changes(change):
    """One transposed split per weight and version, beside the weight's own
    split: an in-place change makes both afresh at their next call."""
    layer = _layer()
    w = layer.linear2.weight
    first, first_t = weight_split(w), weight_split_t(w)
    assert weight_split_t(w) is first_t and weight_split(w) is first
    assert torch.equal(first_t.split, split_weight_t_plain(w.detach()))
    with torch.no_grad():
        if change == "add_":
            w.add_(0.25)
        elif change == "copy_":
            w.copy_(torch.randn_like(w))
        else:
            other = _layer()
            for prm in other.parameters():
                prm.mul_(3.0)
            layer.load_state_dict(other.state_dict())
    fresh = weight_split_t(w)
    assert fresh is not first_t and not torch.equal(fresh.split, first_t.split)
    assert torch.equal(fresh.split, split_weight_t_plain(w.detach()))
    assert weight_split_t(w) is fresh and weight_split(w) is not first


def test_a_dead_transient_leaves_no_split():
    """A gathered weight (a transient of one launch under --mesh_model_axis)
    is split at its call; its entries die with it, stale or leaked none."""
    before = (len(fe._splits), len(fe._splits_t))
    w = torch.randn(12, 8)
    weight_split(w)
    weight_split_t(w)
    assert (len(fe._splits), len(fe._splits_t)) == (before[0] + 1, before[1] + 1)
    del w
    assert (len(fe._splits), len(fe._splits_t)) == before
    v = torch.randn(12, 8)
    assert torch.equal(weight_split_t(v).split, split_weight_t_plain(v))
    del v
    assert (len(fe._splits), len(fe._splits_t)) == before


def test_an_inference_weight_is_split_at_every_call():
    with torch.inference_mode():
        w = torch.randn(8, 12)
    before = len(fe._splits_t)
    a, b = weight_split_t(w), weight_split_t(w)
    assert a is not b and torch.equal(a.split, b.split) and len(fe._splits_t) == before
    assert math.prod(a.split.shape) == 2 * 12 * 8
