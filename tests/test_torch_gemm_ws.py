"""The inference layer's products on csrc/gemm_ws.cuh, emulated on the CPU.

csrc/gemm_ws.cuh runs the four products of csrc/encoder_layer.cu on weights
split once: ``split_weight_plain`` (the split kernel's twin) writes each
weight [N, K] as its TF32 big and small parts [2, N, K rounded up to 8], each
slice of 8 columns in the order 0, 2, 4, 6, 1, 3, 5, 7, which is the order in
which the GEMM reads A's columns into its fragments (elements k = t and t + 4
are A's physical columns 2t and 2t + 1).  ``gemm_ws`` emulates the product
from that split as the kernel forms it: A read in the same order and split in
registers, and per k8 step big.small + small.big + big.big added into one f32
accumulator, over K in order.  ``ln_epilogue`` emulates the LayerNorm
epilogue at D <= 256 (a row's sum, its mean, the sum of squared deviations,
then (v - mean) * rsqrt(var + eps) * w + b).  The whole layer so emulated is
held against the JAX package's ops/pallas_encoder.py:fused_encoder_layer in
interpret mode at the gesture width (D 256, ff 1024: both LayerNorms in an
epilogue) and at 512 (the row kernel), with M = B * T off every tile, within
5e-4 (the card's tolerance for the layer); a single TF32 pass is at least
10x further off.

Also here: the dispatch rule's Python mirror (``layer_routes``, held against
the kernel's own on the card by tests/test_torch_cuda.py), and the cache of
splits (``weight_split``): one split per weight tensor and version, a fresh
one after an in-place ``add_``, ``copy_`` or ``load_state_dict``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gesturediffusion_tpu.ops.pallas_encoder import fused_encoder_layer as jax_fused_layer
from gesturediffusion_tpu_torch.models.transformer import TransformerEncoderLayer
from gesturediffusion_tpu_torch.ops import fused_encoder as fe
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    LN_EPS,
    ROUTE_FF1,
    ROUTE_FF2,
    ROUTE_LN1,
    ROUTE_LN2,
    ROUTE_OUT,
    ROUTE_QKV,
    gelu_tanh,
    layer_routes,
    split_cols,
    split_weight_plain,
    tf32_rn,
    weight_split,
    ws_takes,
)
from tests.torch_port_common import (
    jax_layer_args,
    jax_layer_params,
    threefry_prng,  # noqa: F401 (autouse fixture)
    torch_layer_weights,
)

TOL_LAYER = 5e-4
ALL_WS = ROUTE_QKV | ROUTE_OUT | ROUTE_FF1 | ROUTE_FF2


def k_order(kp: int) -> torch.Tensor:
    """The columns of A (and W) in the order the GEMM reads them: each slice
    of 8 as 0, 2, 4, 6, 1, 3, 5, 7."""
    i = torch.arange(kp)
    q = i % 8
    return i - q + torch.where(q < 4, 2 * q, 2 * q - 7)


def gemm_ws(a, split, k, mm=None):
    """a [M, k] . W^T from W's split [2, N, kp] as csrc/gemm_ws.cuh forms it:
    a's columns in the split's order, zeros past k, each k8 step's three
    TF32 passes added into one f32 accumulator in order (``mm``: the single
    TF32 pass, big . big only)."""
    kp = split.shape[-1]
    ap = F.pad(a, (0, kp - k))[:, k_order(kp)]
    a_big = tf32_rn(ap)
    a_small = tf32_rn(ap - a_big)
    w_big, w_small = split[0], split[1]
    acc = torch.zeros(a.shape[0], split.shape[1])
    for s in range(0, kp, 8):
        ab, asm, wb, ws = (y[:, s:s + 8] for y in (a_big, a_small, w_big, w_small))
        if mm is None:
            acc = acc + ab @ ws.T
            acc = acc + asm @ wb.T
        acc = acc + ab @ wb.T
    return acc


def ln_epilogue(v, w, b):
    """The LayerNorm of csrc/gemm_ws.cuh's epilogue on rows v [M, N]."""
    n = v.shape[-1]
    mu = v.sum(-1, keepdim=True) / n
    q = ((v - mu) ** 2).sum(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(q / n + LN_EPS) * w + b


def attention(q, k, v, one_pass):
    """softmax(q k^T / sqrt(dh)) v in three TF32 passes (one with one_pass)."""
    def mm(x, y):
        xb, yb = tf32_rn(x), tf32_rn(y)
        if one_pass:
            return xb @ yb
        return xb @ tf32_rn(y - yb) + tf32_rn(x - xb) @ yb + xb @ yb

    s = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return mm(s.softmax(dim=-1), v)


def encoder_layer_ws(x, wqkv, bqkv, wo, bo, l1w, l1b, w1, b1, w2, b2, l2w, l2b, *, num_heads,
                     one_pass=False):
    """The inference layer as csrc/encoder_layer.cu runs it where every
    product takes gemm_ws.cuh: qkv, attention, out-projection with LN1,
    ff1 with GELU, ff2 with LN2; the LayerNorms in the epilogue at D <= 256,
    else F.layer_norm (the row kernel)."""
    b, t, d = x.shape
    f = w1.shape[0]
    routes = layer_routes(d, f)
    assert routes & ALL_WS == ALL_WS
    mm = "one" if one_pass else None
    rows = x.reshape(b * t, d)
    qkv = gemm_ws(rows, split_weight_plain(wqkv), d, mm) + bqkv
    q, k, v = (y.reshape(b, t, num_heads, -1).transpose(1, 2) for y in qkv.chunk(3, dim=-1))
    a = attention(q, k, v, one_pass).transpose(1, 2).reshape(b * t, d)

    def norm(v, w, bias, bit):
        if routes & bit:
            return ln_epilogue(v, w, bias)
        return F.layer_norm(v, (d,), w, bias, LN_EPS)

    h1 = norm((gemm_ws(a, split_weight_plain(wo), d, mm) + bo) + rows, l1w, l1b, ROUTE_LN1)
    ff = gelu_tanh(gemm_ws(h1, split_weight_plain(w1), d, mm) + b1)
    out = norm((gemm_ws(ff, split_weight_plain(w2), f, mm) + b2) + h1, l2w, l2b, ROUTE_LN2)
    return out.reshape(b, t, d)


@pytest.mark.parametrize("b,t,d,h,f", [(2, 37, 256, 4, 1024), (1, 45, 512, 4, 1024)])
def test_gemm_ws_schedule_in_three_passes_matches_jax(b, t, d, h, f):
    """M = 74 and 45 rows: inside one 128-row (64-row) tile, ragged."""
    x = np.random.RandomState(23).randn(b, t, d).astype(np.float32)
    _, p = jax_layer_params(d, h, f, seed=23)
    want = np.asarray(jax_fused_layer(jnp.asarray(x), *jax_layer_args(p), num_heads=h,
                                      block_b=1, interpret=True))
    w = torch_layer_weights(p)
    xt = torch.from_numpy(x)
    three = encoder_layer_ws(xt, *w, num_heads=h).numpy()
    one = encoder_layer_ws(xt, *w, num_heads=h, one_pass=True).numpy()
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 <= TOL_LAYER, err3
    assert err1 >= 10 * err3, (err1, err3)
    assert (layer_routes(d, f) & (ROUTE_LN1 | ROUTE_LN2) != 0) == (d <= 256)


@pytest.mark.parametrize("n,k", [(768, 256), (256, 1024), (96, 12)])
def test_gemm_ws_product_is_the_f32_product(n, k):
    """The emulated product from the split against float64, within 2e-6 of
    the output's largest magnitude (as the parent GEMM's emulation in
    tests/test_torch_tf32x3.py); K = 12 pads the split to 16 columns."""
    rs = np.random.RandomState(24)
    a = torch.from_numpy(rs.randn(70, k).astype(np.float32))
    w = torch.from_numpy((rs.randn(n, k) * k**-0.5).astype(np.float32))
    want = a.double() @ w.double().T
    got = gemm_ws(a, split_weight_plain(w), k)
    assert got.shape == want.shape
    err = (got.double() - want).abs().max().item()
    assert err <= 2e-6 * want.abs().max().item(), err


def test_split_twin_orders_rounds_and_pads():
    """Column 8j + i of each part holds W's column 8j + 2i (i < 4) or
    8j + 2(i - 4) + 1; the big part is rounded to TF32 (what wgmma reads);
    big + small is W to ~2^-22; columns past K are zero."""
    rs = np.random.RandomState(25)
    w = torch.from_numpy(rs.randn(6, 20).astype(np.float32))
    s = split_weight_plain(w)
    assert s.shape == (2, 6, 24) and split_cols(20) == 24
    src = [8 * j + (2 * i if i < 4 else 2 * (i - 4) + 1) for j in range(3) for i in range(8)]
    for c, col in enumerate(src):
        if col < 20:
            torch.testing.assert_close(s[0, :, c], tf32_rn(w[:, col]), rtol=0, atol=0)
            torch.testing.assert_close(s[1, :, c], tf32_rn(w[:, col] - s[0, :, c]), rtol=0,
                                       atol=0)
            rel = ((s[0, :, c].double() + s[1, :, c].double() - w[:, col].double()).abs()
                   / w[:, col].abs().double()).max().item()
            assert rel <= 2.0**-21, rel
        else:
            assert not s[:, :, c].any()
    assert torch.equal(tf32_rn(s[0]), s[0]) and torch.equal(tf32_rn(s[1]), s[1])


@pytest.mark.parametrize("d,f,want", [
    (256, 1024, ALL_WS | ROUTE_LN1 | ROUTE_LN2),  # the gesture layer: five launches
    (512, 1024, ALL_WS),                          # t2m and a2m: the LayerNorm launches stay
    (32, 128, ALL_WS | ROUTE_LN1 | ROUTE_LN2),    # 4 heads of 8
    (264, 1056, ROUTE_QKV | ROUTE_OUT | ROUTE_FF1),  # 4 heads of 66: ff2's K 1056
    (198, 792, 0),                                # 3 heads of 66: rows not 16-byte aligned
    (130, 1030, 0),                               # 2 heads of 65
    (256, 1040, ROUTE_QKV | ROUTE_OUT | ROUTE_FF1 | ROUTE_LN1),  # ff2's K 1040: the parent
    (1024, 4096, ROUTE_QKV | ROUTE_OUT | ROUTE_FF1),
    (1088, 1024, ROUTE_FF2),                      # K 1088 past 1024 for three; ff2's is 1024
])
def test_layer_routes_follow_the_rule(d, f, want):
    assert layer_routes(d, f) == want
    shapes = ((3 * d, d), (d, d), (f, d), (d, f))
    for i, (n, k) in enumerate(shapes):
        assert bool(layer_routes(d, f) >> i & 1) == ws_takes(n, k)


@pytest.mark.parametrize("n,k,takes", [(768, 256, True), (256, 1024, True), (256, 1040, False),
                                       (258, 256, False), (256, 254, False), (4, 4, True)])
def test_ws_takes_aligned_rows_up_to_1024(n, k, takes):
    assert ws_takes(n, k) == takes


def _layer():
    torch.manual_seed(26)
    return TransformerEncoderLayer(64, 4, 128, 0.0)


@pytest.mark.parametrize("change", ["add_", "copy_", "load_state_dict"])
def test_weight_split_is_kept_until_the_weight_changes(change):
    """The same weight gives the same split; an in-place change gives a
    fresh one, the plain twin's split of the new values."""
    layer = _layer()
    w = layer.linear1.weight
    first = weight_split(w)
    assert weight_split(w) is first
    assert torch.equal(first.split, split_weight_plain(w.detach()))
    with torch.no_grad():
        if change == "add_":
            w.add_(0.25)
        elif change == "copy_":
            w.copy_(torch.randn_like(w))
        else:
            other = _layer()
            with torch.no_grad():
                for prm in other.parameters():
                    prm.mul_(3.0)
            layer.load_state_dict(other.state_dict())
    fresh = weight_split(w)
    assert fresh is not first
    assert torch.equal(fresh.split, split_weight_plain(w.detach()))
    assert not torch.equal(fresh.split, first.split)
    assert weight_split(w) is fresh


def test_weight_split_forgets_a_dead_weight():
    """A weight's death drops its split, so a new tensor at the same address
    (and the same version count) is split anew."""
    w = torch.randn(16, 8)
    before = len(fe._splits)
    weight_split(w)
    assert w in fe._splits and len(fe._splits) == before + 1
    del w
    assert len(fe._splits) == before
    v = torch.randn(16, 8)
    assert torch.equal(weight_split(v).split, split_weight_plain(v))


def test_weight_split_follows_reassigned_data():
    """A parameter whose ``.data`` is reassigned (parallel/mesh.py cuts and
    rejoins its blocks so) is split again from its new storage, and its one
    entry is replaced, not kept beside the old one."""
    layer = _layer()
    w = layer.linear2.weight
    first = weight_split(w)
    size = len(fe._splits)
    w.data = torch.randn_like(w)
    fresh = weight_split(w)
    assert fresh is not first and len(fe._splits) == size
    assert torch.equal(fresh.split, split_weight_plain(w.detach()))


def test_weight_split_of_an_inference_tensor_is_not_kept():
    with torch.inference_mode():
        w = torch.randn(8, 8)
    before = len(fe._splits)
    s = weight_split(w)
    assert torch.equal(s.split, split_weight_plain(w)) and len(fe._splits) == before
