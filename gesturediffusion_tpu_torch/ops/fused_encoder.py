"""One post-LN transformer encoder layer: CUDA kernel and plain version.

``fused_encoder_layer`` is the counterpart of
gesturediffusion_tpu/ops/pallas_encoder.py:fused_encoder_layer, and
``encoder_layer_plain`` of the deterministic
gesturediffusion_tpu/models/transformer.py:TransformerEncoderLayer (the
kernel's specification; torch ``nn.TransformerEncoderLayer`` post-LN
order with GELU in its tanh form):

    a = selfattn(x); x = LN1(x + a); x = LN2(x + linear2(gelu(linear1(x))))

The plain version also serves training: ``drop(z, site)`` applies the
dropout of one of the four sites (attention probabilities, attention
output, activation, feed-forward output), with Bernoulli masks
(models/transformer.py) or hash masks (ops/fused_encoder_train.py).  Its
four products are parallel/tensor.py:linear, so a weight that is a
tensor-parallel block runs the column-parallel product.

Weights use PyTorch's [out, in] layout: wqkv [3D, D] (the packed
``in_proj_weight``), wo [D, D], w1 [F, D], w2 [D, F]; LayerNorm weight
and bias [D].  On a CUDA tensor the wrapper launches
csrc/encoder_layer.cu (its four products on the tensor cores in 3xTF32,
f32-level error); on a CPU tensor it runs the plain version.  The chain's
attention stage is the flash kernel of ops/flash_attention.py at every T
and head width (``padded_head_width``); any D and F (rows that are not
16-byte aligned are copied a float at a time).

The products that ``layer_routes`` (the mirror of
csrc/encoder_layer.cu:layer_routes) sends to csrc/gemm_ws.cuh read each
weight's TF32 big and small parts, split once (``weight_split``: a CUDA
kernel, its plain twin ``split_weight_plain`` on the CPU) and kept per
weight tensor and version with the split's tensor map, so an optimizer
step, ``load_state_dict`` or any other in-place change is split again at
the next call.  The training layer (ops/fused_encoder_train.py) reads the
same splits for its forward products, and for its data gradients the
splits of the transposed weights (``weight_split_t``, twin
``split_weight_t_plain``), kept beside them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from gesturediffusion_tpu_torch.ops import _build
from gesturediffusion_tpu_torch.ops.band_attention import padded_head_width
from gesturediffusion_tpu_torch.ops.flash_attention import fused_self_attention
from gesturediffusion_tpu_torch.parallel.tensor import linear

LN_EPS = 1e-5
# the training dropout sites, in the order the layer reaches them
SITE_ATTN, SITE_POST_ATTN, SITE_ACT, SITE_FF = 0, 1, 2, 3
# drop(z, site) -> z with the dropout of that site applied
Drop = Optional[Callable[[torch.Tensor, int], torch.Tensor]]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU in the tanh form, as jax.nn.gelu and flax nn.gelu compute it
    (torch's default F.gelu is the erf form)."""
    return F.gelu(x, approximate="tanh")


def self_attention_plain(
    x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
    wo: torch.Tensor, bo: torch.Tensor, num_heads: int, drop: Drop = None,
) -> torch.Tensor:
    """Packed-QKV multi-head self-attention, scores and softmax in at least
    f32; ``drop`` drops the probabilities [B, H, T, T]."""
    b, t, d = x.shape
    dh = d // num_heads
    ct = torch.promote_types(x.dtype, torch.float32)
    q, k, v = linear(x, wqkv, bqkv).chunk(3, dim=-1)
    q, k, v = (y.reshape(b, t, num_heads, dh).transpose(1, 2) for y in (q, k, v))
    attn = (torch.einsum("bhid,bhjd->bhij", q.to(ct), k.to(ct)) * (dh**-0.5)).softmax(dim=-1)
    if drop is not None:
        attn = drop(attn, SITE_ATTN)
    out = torch.einsum("bhij,bhjd->bhid", attn.to(x.dtype), v)
    return linear(out.transpose(1, 2).reshape(b, t, d), wo, bo)


def encoder_layer_plain(
    x, wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b,
    *, num_heads: int, drop: Drop = None,
) -> torch.Tensor:
    """Plain PyTorch version of the layer; ``drop`` is None for inference
    and applies each site's dropout in training."""
    def dropped(z, site):
        return z if drop is None else drop(z, site)

    d = x.shape[-1]
    a = self_attention_plain(x, wqkv, bqkv, wo, bo, num_heads, drop)
    x = F.layer_norm(x + dropped(a, SITE_POST_ATTN), (d,), ln1_w, ln1_b, LN_EPS)
    h = dropped(gelu_tanh(linear(x, w1, b1)), SITE_ACT)
    h = dropped(linear(h, w2, b2), SITE_FF)
    return F.layer_norm(x + h, (d,), ln2_w, ln2_b, LN_EPS)


# csrc/gemm_ws.cuh's rule: the widest reduction it takes (gemm_tf32x3.cuh's
# kTcFlushK) and the widest D whose LayerNorm runs in its epilogue
WS_MAX_K, WS_LN_COLS = 1024, 256
# the bits of layer_routes: product i takes gemm_ws.cuh (qkv, out-projection,
# ff1, ff2), then LN1 and LN2 in an epilogue
ROUTE_QKV, ROUTE_OUT, ROUTE_FF1, ROUTE_FF2, ROUTE_LN1, ROUTE_LN2 = (1 << i for i in range(6))


def ws_takes(n: int, k: int) -> bool:
    """Whether C[M, n] = A[M, k] . W[n, k]^T takes csrc/gemm_ws.cuh: rows
    16-byte aligned for the tensor maps (n and k multiples of 4) and k <=
    WS_MAX_K (its accumulator is not flushed)."""
    return n % 4 == 0 and k % 4 == 0 and k <= WS_MAX_K


def layer_routes(d: int, f: int) -> int:
    """The routes of a layer of width d and ff f, as
    csrc/encoder_layer.cu:layer_routes gives them: ROUTE_QKV .. ROUTE_FF2
    where the product takes gemm_ws.cuh (the others take gemm_tf32x3.cuh),
    ROUTE_LN1 and ROUTE_LN2 where its LayerNorm epilogue (d <= WS_LN_COLS)
    replaces the row kernel."""
    shapes = ((3 * d, d), (d, d), (f, d), (d, f))
    r = sum(ws_takes(n, k) << i for i, (n, k) in enumerate(shapes))
    if d <= WS_LN_COLS:
        r |= (r & ROUTE_OUT) << 3 | (r & ROUTE_FF2) << 2
    return r


def tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as csrc/mma_tf32x3.cuh:tf32_rn rounds it: half a
    TF32 ulp added to the magnitude bits, the low 13 cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_cols(k: int) -> int:
    """The columns of a weight's split: k rounded up to a slice of 8."""
    return (k + 7) // 8 * 8


def split_weight_plain(w: torch.Tensor) -> torch.Tensor:
    """csrc/gemm_ws.cuh:split_weight_kernel in plain PyTorch: w [N, K] ->
    [2, N, split_cols(K)], big = tf32_rn(w) and small = tf32_rn(w - big),
    each slice of 8 columns in the order 0, 2, 4, 6, 1, 3, 5, 7 (the k order
    of the GEMM's A fragments), zeros past K."""
    n, k = w.shape
    kp = split_cols(k)
    i = torch.arange(kp, device=w.device)
    q = i % 8
    order = i - q + torch.where(q < 4, 2 * q, 2 * q - 7)
    x = F.pad(w.float(), (0, kp - k))[:, order]
    big = tf32_rn(x)
    return torch.stack((big, tf32_rn(x - big)))


def split_weight_t_plain(w: torch.Tensor) -> torch.Tensor:
    """csrc/gemm_ws.cuh:split_weight_t_kernel in plain PyTorch: the split of
    w^T for w [out, in], [2, in, split_cols(out)] (the B operand of the data
    gradient dX = dY . w)."""
    return split_weight_plain(w.t())


@dataclass
class WeightSplit:
    """A weight's split ([2, N, split_cols(K)]) and, on the card, its tensor
    map (a host buffer), made from the weight at ``key`` = (data_ptr,
    version, shape, device)."""

    split: torch.Tensor
    map: Optional[ctypes.Array]
    key: tuple = ()


# weight tensor -> its split (and its transpose's); an entry dies with its tensor
_splits = WeakIdKeyDictionary()
_splits_t = WeakIdKeyDictionary()


def _split(w: torch.Tensor, library: str, transposed: bool) -> WeightSplit:
    if w.device.type == "cpu":
        return WeightSplit((split_weight_t_plain if transposed else split_weight_plain)(w), None)
    n, k = w.shape[::-1] if transposed else w.shape
    split = torch.empty((2, n, split_cols(k)), dtype=torch.float32, device=w.device)
    fn, map_bytes = _split_kernel(library, transposed)
    tmap = ctypes.create_string_buffer(map_bytes)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        code = fn(w.data_ptr(), split.data_ptr(), n, k, ctypes.addressof(tmap), stream)
    _build.check(library, code)
    (weight_split_t if transposed else weight_split).launches += 1
    return WeightSplit(split, tmap)


def _cached(cache, w: torch.Tensor, library: str, transposed: bool) -> WeightSplit:
    if w.is_inference():
        return _split(w, library, transposed)
    key = (w.data_ptr(), w._version, tuple(w.shape), w.device)
    entry = cache.get(w)
    if entry is None or entry.key != key:
        entry = _split(w, library, transposed)
        entry.key = key
        cache[w] = entry
    return entry


def weight_split(w: torch.Tensor, library: str = "encoder_layer") -> WeightSplit:
    """The split of weight ``w`` [N, K] (float32, contiguous): the kernel's
    on the card (``weight_split.launches`` counts its launches; ``library``
    is the kernel library that splits it, the same kernel in each), the
    plain twin on the CPU.  Kept per tensor object while it lives, and made
    again when its storage (``.data`` reassigned), shape or version counter
    moves: every in-place change moves the counter (an optimizer step,
    ``copy_``, ``load_state_dict``).  Inference tensors, which count no
    versions, are split at every call.  The caller holds the returned split
    until its launch is queued: the map and the tensor die with it."""
    return _cached(_splits, w, library, False)


def weight_split_t(w: torch.Tensor, library: str = "encoder_layer_train") -> WeightSplit:
    """The split of ``w``^T for a weight w [out, in]: [2, in, split_cols(out)],
    the training layer's data gradients' operand, kept beside
    ``weight_split``'s as that one is (``weight_split_t.launches`` counts
    its kernel's launches)."""
    return _cached(_splits_t, w, library, True)


weight_split.launches = 0
weight_split_t.launches = 0


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load_function(
        "encoder_layer", "gdt_encoder_layer_f32",
        [p] * 19 + [i] * 5 + [ctypes.c_float] + [p] * 5,
    )


@functools.cache
def _split_kernel(library: str, transposed: bool):
    p, i = ctypes.c_void_p, ctypes.c_int
    name = "gdt_split_weight_t_f32" if transposed else "gdt_split_weight_f32"
    fn = _build.load_function(library, name, [p, p, i, i, p, p])
    map_bytes = _build.load_function(library, "gdt_tensor_map_bytes", [])()
    return fn, map_bytes


# the epilogues of csrc/encoder_layer.cu:gdt_gemm_ws_f32 (LayerNorm: N <= 256)
EPILOGUES = {"bias": 0, "gelu": 1, "resid": 2, "ln": 3}


@functools.cache
def _product_kernels():
    p, i = ctypes.c_void_p, ctypes.c_int
    ws = _build.load_function("encoder_layer", "gdt_gemm_ws_f32", [p] * 3 + [i] * 4 + [p] * 5)
    parent = _build.load_function("encoder_layer", "gdt_gemm_parent_f32",
                                  [p] * 3 + [i] * 4 + [p] * 3)
    routes = _build.load_function("encoder_layer", "gdt_encoder_layer_routes", [i, i])
    return ws, parent, routes


def kernel_layer_routes(d: int, f: int) -> int:
    """csrc/encoder_layer.cu's own layer_routes (``layer_routes`` mirrors it)."""
    return _product_kernels()[2](d, f)


def layer_product(a, w, bias, *, epi="bias", resid=None, ln=None, parent=False):
    """One of the layer's products alone on the card, for the card tests and
    the tools: C = epi(a [M, K] . w [N, K]^T) by csrc/gemm_ws.cuh on w's
    split, or with ``parent`` by gemm_tf32x3.cuh's gemm_nt on w.  ``epi``:
    "bias", "gelu" (bias, then GELU-tanh), "resid" (bias, then + resid),
    "ln" (bias, + resid, then LayerNorm by ``ln`` = (weight, bias); gemm_ws
    only, N <= 256).  Raises where the kernel refuses the shape."""
    m, n = a.shape[0], w.shape[0]
    for y in (a, w, bias, resid, *(ln or ())):
        if y is not None and (y.device.type != "cuda" or y.dtype != torch.float32
                              or not y.is_contiguous()):
            raise ValueError("layer_product takes contiguous float32 CUDA tensors")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ws, nt, _ = _product_kernels()
    ptr = lambda y: None if y is None else y.data_ptr()  # noqa: E731
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if parent:
            code = nt(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, a.shape[1],
                      EPILOGUES[epi], bias.data_ptr(), ptr(resid), stream)
        else:
            split = weight_split(w)  # held until the launch is queued
            lw, lb = ln if ln is not None else (None, None)
            code = ws(a.data_ptr(), ctypes.addressof(split.map), out.data_ptr(), m, n, a.shape[1],
                      EPILOGUES[epi], bias.data_ptr(), ptr(resid), ptr(lw), ptr(lb), stream)
    _build.check("encoder_layer", code)
    return out


def _check_cuda_args(x, weights, num_heads):
    if x.dim() != 3:
        raise ValueError(f"expected x [B, T, D], got {tuple(x.shape)}")
    d, f = x.shape[2], weights[6].shape[0]
    shapes = [(3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,),
              (f, d), (f,), (d, f), (d,), (d,), (d,)]
    for name, w, shape in zip(
        ("wqkv", "bqkv", "wo", "bo", "ln1_w", "ln1_b",
         "w1", "b1", "w2", "b2", "ln2_w", "ln2_b"), weights, shapes,
    ):
        if tuple(w.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(w.shape)}")
    if d % num_heads:
        raise ValueError(f"D={d} must split into {num_heads} heads")
    padded_head_width(d // num_heads)
    for w in (x, *weights):
        if w.dtype != torch.float32:
            raise TypeError("the encoder-layer kernel takes float32 tensors")
        if w.device != x.device:
            raise ValueError("all tensors must be on the same device")
        if not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(
                "the encoder-layer kernel takes contiguous, 16-byte aligned tensors"
            )


def fused_encoder_layer(
    x, wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b,
    *, num_heads: int,
) -> torch.Tensor:
    """One post-LN encoder layer.  x [B, T, D] -> [B, T, D].

    CPU tensors run ``encoder_layer_plain``; CUDA tensors launch the
    kernel chain of csrc/encoder_layer.cu (counted once per call in
    ``fused_encoder_layer.launches``), whose attention stage is the flash
    kernel (counted in ``fused_self_attention.launches``) and whose products
    on gemm_ws.cuh read the weights' splits (``weight_split``)."""
    weights = (wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b)
    if x.device.type == "cpu":
        return encoder_layer_plain(x, *weights, num_heads=num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda_args(x, weights, num_heads)
    b, t, d = x.shape
    f = w1.shape[0]
    m = b * t
    routes = layer_routes(d, f)
    # the splits are held until the launch is queued (an inference tensor's
    # is made for this call alone)
    splits = [weight_split(w) if routes >> i & 1 else None
              for i, w in enumerate((wqkv, wo, w1, w2))]
    maps = [None if s is None else ctypes.addressof(s.map) for s in splits]
    both_ln = ROUTE_LN1 | ROUTE_LN2
    new = functools.partial(torch.empty, dtype=x.dtype, device=x.device)
    qkv, attn, h1, ff = new((m, 3 * d)), new((m, d)), new((m, d)), new((m, f))
    tmp = None if (routes & both_ln) == both_ln else new((m, d))
    out = new((b, t, d))
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), *(w.data_ptr() for w in weights),
            qkv.data_ptr(), attn.data_ptr(), None if tmp is None else tmp.data_ptr(),
            h1.data_ptr(), ff.data_ptr(), out.data_ptr(), b, t, d, f, num_heads,
            (d // num_heads) ** -0.5, *maps, stream,
        )
    _build.check("encoder_layer", code)
    fused_encoder_layer.launches += 1
    fused_self_attention.launches += 1
    return out


fused_encoder_layer.launches = 0
