"""The training encoder layer: hash-PRNG dropout, plain version, and the
CUDA forward and backward kernels behind one autograd Function.

Counterpart of gesturediffusion_tpu/ops/pallas_encoder_train.py.  One
post-LN layer (torch ``nn.TransformerEncoderLayer`` order, GELU in its tanh
form) with dropout at four sites: the attention probabilities, the
attention output, the activation and the feed-forward output (the site ids
of ops/fused_encoder.py).  A site's
mask is drawn from a murmur3 fmix32 hash of (global element index, site,
seed) and is therefore the same on every device and in every pass:

    keep = hash_u32(idx, salt(seed, site)) < keep_threshold(1 - rate)

``encoder_layer_train_plain`` is the port of encoder_layer_train_reference
(:629) and _forward_core (:102) under ordinary autograd: the CPU path and
the kernels' specification.  ``fused_encoder_layer_train`` runs the plain
version on a CPU tensor; on a CUDA tensor it launches
csrc/encoder_layer_train.cu, whose forward saves only x, the weights and
the seed, and whose backward recomputes the layer from x (launches counted
in ``encoder_layer_train_fwd.launches`` and ``encoder_layer_train_bwd.launches``).

Weights use PyTorch's [out, in] layout, as ops/fused_encoder.py; their
gradients come back in it.  The global indices count from batch row
``row0``: 0 for a whole batch, as a separate TPU kernel call does, and a
rank's first row of the global batch when the batch is split over ranks
(a pallas_call under a mesh runs on the global batch, so its indices are
global).

The kernels' attention is flash-style in both directions (the flash kernel
of ops/flash_attention.py with site-0 dropout, and a tiled backward), so T
is bounded by device memory only, and takes any head width, D and F, as
the inference layer does.

The products of a weight whose rows are 16-byte aligned (``train_routes``,
the mirror of csrc/encoder_layer_train.cu:train_routes) run on
csrc/gemm_ws.cuh: the forward products read the weight's split
(ops/fused_encoder.py:weight_split, the inference layer's), the data
gradients its transpose's (``weight_split_t``), both kept per weight and
version; the weight gradients split X's slices as they land.  Every
product is bit for bit what csrc/gemm_tf32x3.cuh gives (the parent chain,
``encoder_layer_train_parent``, which the card tests hold it against).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from gesturediffusion_tpu_torch.ops import _build
from gesturediffusion_tpu_torch.ops.fused_encoder import (
    _check_cuda_args as _check_layer_args,
    encoder_layer_plain,
    weight_split,
    weight_split_t,
)
from gesturediffusion_tpu_torch.parallel.distributed import all_gather_cat
from gesturediffusion_tpu_torch.parallel.tensor import block_of, whole

_U32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _mul_u32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2**32 for a in [0, 2**32) held in int64, without
    overflowing int64: the product is split at 16 bits of ``a``."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _U32


def hash_u32(idx: torch.Tensor, salt) -> torch.Tensor:
    """murmur3 fmix32 over (idx, salt) with uint32 wraparound
    (pallas_encoder_train.py:_hash_u32).  Integer tensors in, int64 values
    in [0, 2**32) out."""
    h = (_mul_u32(idx.long() & _U32, _M1) + salt) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul_u32(h, _M2)
    return h ^ (h >> 16)


def salt(seed, site: int):
    """(seed + ((site * 0x9E3779B9) & 0xFFFFFFFF)) | 1 as uint32, for an int
    seed or an integer tensor (pallas_encoder_train.py:_salt)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.long()
    return (((seed & _U32) + ((site * _GOLD) & _U32)) & _U32) | 1


def keep_threshold(keep_prob: float) -> int:
    """The uint32 threshold, computed in double precision as the TPU kernel
    does (:82).  3865470566 at keep 0.9."""
    return min(int(keep_prob * 2**32), 2**32 - 1)


def keep_from_idx(idx: torch.Tensor, seed, site: int, keep_prob: float) -> torch.Tensor:
    """Boolean keep-mask of the global element indices ``idx``."""
    return hash_u32(idx, salt(seed, site)) < keep_threshold(keep_prob)


def hash_dropout_mask(shape, base: int, seed, site: int, keep_prob: float,
                      device=None) -> torch.Tensor:
    """The keep-mask of the global flat indices base .. base + prod(shape)
    (pallas_encoder_train.py:hash_dropout_mask)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device) + base
    return keep_from_idx(idx, seed, site, keep_prob).reshape(shape)


def encoder_layer_train_plain(
    x, wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b,
    *, seed, num_heads: int, rate: float, row0: int = 0,
) -> torch.Tensor:
    """Plain PyTorch training layer.  x [B, T, D] -> [B, T, D]; ``seed`` is
    an int or an integer tensor of one element; rate 0 draws nothing.  The
    global indices are those of each site's row-major layout: [B, H, T, T]
    for the probabilities, [B, T, width] for the other three, x being rows
    ``row0`` on of the batch they count."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(())
    keep = 1.0 - rate

    def drop(z, site):
        base = row0 * math.prod(z.shape[1:])
        mask = hash_dropout_mask(z.shape, base, seed, site, keep, device=z.device)
        # times 1 / keep (not divided by keep), as the kernels
        return torch.where(mask, z * (1.0 / keep), torch.zeros((), dtype=z.dtype, device=z.device))

    return encoder_layer_plain(
        x, wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b,
        num_heads=num_heads, drop=drop if rate > 0.0 else None,
    )


def train_routes(d: int, f: int) -> int:
    """The routes of a training layer of width d and ff f, as
    csrc/encoder_layer_train.cu:train_routes gives them: bit i set where
    weight i's products (0 wqkv, 1 wo, 2 w1, 3 w2: its forward product, data
    gradient and weight gradient) take csrc/gemm_ws.cuh, the others
    csrc/gemm_tf32x3.cuh.  The rule asks each weight's rows to be 16-byte
    aligned, its out and in both multiples of 4; the products flush, so no
    reduction is too long."""
    shapes = ((3 * d, d), (d, d), (f, d), (d, f))
    return sum((n % 4 == 0 and k % 4 == 0) << i for i, (n, k) in enumerate(shapes))


def weight_grad_splits(i: int, j: int, m: int) -> tuple[int, int]:
    """(chunks, rows a chunk) of a weight gradient [i, j] summed over m rows,
    as csrc/encoder_layer_train.cu:weight_grad_splits cuts them: enough of
    csrc/gemm_tf32x3.cuh's 128 x 64 tiles to fill 264 blocks, at most m /
    128 chunks, the chunk a multiple of 32 rows.  Both GEMMs take these."""
    def cdiv(a, b):
        return -(-a // b)

    tiles = cdiv(i, 128) * cdiv(j, 64)
    splits = max(1, min(cdiv(264, tiles), m // 128))
    chunk = cdiv(cdiv(m, splits), 32) * 32
    return cdiv(m, chunk), chunk


# the four [out, in] weights among the layer's twelve, in train_routes' order
WEIGHT_INDEX = (0, 2, 6, 8)
LIBRARY = "encoder_layer_train"

_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, ctypes.c_int,
                               ctypes.c_int]
_PARENT_FWD_ARGS = [ctypes.c_void_p] * 16 + _TAIL + [ctypes.c_void_p]
_PARENT_BWD_ARGS = [ctypes.c_void_p] * 29 + _TAIL + [ctypes.c_void_p]
_FWD_ARGS = [ctypes.c_void_p] * 16 + _TAIL + [ctypes.c_void_p] * 5
_BWD_ARGS = [ctypes.c_void_p] * 29 + _TAIL + [ctypes.c_void_p] * 9


@functools.cache
def _kernels(parent: bool = False):
    prefix = "gdt_encoder_layer_train_parent" if parent else "gdt_encoder_layer_train"
    fwd = _build.load_function(LIBRARY, prefix + "_fwd_f32",
                               _PARENT_FWD_ARGS if parent else _FWD_ARGS)
    bwd = _build.load_function(LIBRARY, prefix + "_bwd_f32",
                               _PARENT_BWD_ARGS if parent else _BWD_ARGS)
    ws = _build.load_function(LIBRARY, "gdt_encoder_layer_train_workspace", [ctypes.c_int] * 6)
    ws.restype = ctypes.c_size_t
    return fwd, bwd, ws


def kernel_train_routes(d: int, f: int) -> int:
    """csrc/encoder_layer_train.cu's own train_routes (``train_routes``
    mirrors it)."""
    return _build.load_function(LIBRARY, "gdt_encoder_layer_train_routes",
                                [ctypes.c_int] * 2)(d, f)


def _check_cuda_args(x, weights, seed, num_heads):
    _check_layer_args(x, weights, num_heads)
    if seed.dtype != torch.int32 or seed.numel() != 1 or seed.device != x.device:
        raise ValueError("seed must be one int32 element on the device of x")


def _splits(weights, backward: bool) -> list:
    """The splits the products on gemm_ws.cuh read (W's, then with
    ``backward`` W^T's), None where train_routes sends a weight's products
    to gemm_tf32x3.cuh.  The caller holds them until its launch is queued."""
    d, f = weights[0].shape[1], weights[6].shape[0]
    routes = train_routes(d, f)
    on = [routes >> i & 1 for i in range(4)]
    held = [weight_split(weights[j], LIBRARY) if r else None for j, r in zip(WEIGHT_INDEX, on)]
    if backward:
        held += [weight_split_t(weights[j], LIBRARY) if r else None
                 for j, r in zip(WEIGHT_INDEX, on)]
    return held


def _launch(backward: bool, x, weights, seed, g, num_heads: int, rate: float, row0: int,
            parent: bool = False):
    _check_cuda_args(x, weights, seed, num_heads)
    if row0 < 0:
        raise ValueError(f"row0 must be >= 0, got {row0}")
    b, t, d = x.shape
    f = weights[6].shape[0]
    keep = 1.0 - rate
    fwd, bwd, ws_floats = _kernels(parent)
    ws = torch.empty(ws_floats(b, t, d, f, num_heads, int(backward)),
                     dtype=torch.float32, device=x.device)
    tail = (b, t, d, f, num_heads, (d // num_heads) ** -0.5,
            keep_threshold(keep), 1.0 / keep, int(rate > 0.0), row0)
    # held until the launch is queued (an inference tensor's are made for it)
    held = [] if parent else _splits(weights, backward)
    maps = [None if s is None else ctypes.addressof(s.map) for s in held]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [x.data_ptr(), *(w.data_ptr() for w in weights), seed.data_ptr()]
        if not backward:
            outs = (torch.empty_like(x),)
            code = fwd(*ptrs, outs[0].data_ptr(), ws.data_ptr(), *tail, *maps, stream)
        else:
            if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
                raise ValueError("g must be a contiguous float32 tensor shaped like x")
            outs = (torch.empty_like(x), *(torch.empty_like(w) for w in weights))
            code = bwd(*ptrs, g.data_ptr(), *(o.data_ptr() for o in outs),
                       ws.data_ptr(), *tail, *maps, stream)
    _build.check(LIBRARY, code)
    del held
    return outs


def encoder_layer_train_parent(x, *weights, seed, num_heads: int, rate: float, row0: int = 0,
                               g=None):
    """The training layer's forward (``g`` None) or backward with every
    product on csrc/gemm_tf32x3.cuh (the chain before gemm_ws.cuh took its
    products): the parent that the card tests and chip_smoke.py hold the
    kernels against bit for bit.  Not counted; the main path never calls it."""
    return _launch(g is not None, x, weights, seed, g, num_heads, rate, row0, parent=True)


# the product families of csrc/encoder_layer_train.cu:gdt_train_product_f32
# and their epilogues (the Epilogue enum of csrc/gemm_tf32x3.cuh)
FAMILIES = {"forward": 0, "data": 1, "weight": 2}
TRAIN_EPILOGUES = {"plain": 0, "bias": 1, "resid": 2, "gelu": 3, "gelu_grad": 4, "add": 5}


@functools.cache
def _product_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load_function(LIBRARY, "gdt_train_product_f32",
                                [i] * 2 + [p] * 5 + [i] * 4 + [p] * 5)


def train_product(family: str, a, w, *, epi="plain", bias=None, resid=None, aux=None, pre=None,
                  parent=False):
    """One product of the training layer alone on the card, without dropout,
    for the card tests and the tools: on csrc/gemm_ws.cuh (or with
    ``parent`` on gemm_tf32x3.cuh).  "forward": epi(a [M, K] . w [N, K]^T),
    epi "bias", "resid" (bias, + resid) or "gelu" (bias, ``pre`` <- the
    pre-activation, GELU); "data": epi(a [M, K] . w [K, N]) by w^T's split,
    epi "plain", "gelu_grad" (times GELU'(aux)) or "add" (+ resid);
    "weight": a [K, M]^T . w [K, N] in the layer's row chunks.  Raises where
    the kernel refuses the shape."""
    for y in (a, w, bias, resid, aux, pre):
        if y is not None and (y.device.type != "cuda" or y.dtype != torch.float32
                              or not y.is_contiguous()):
            raise ValueError("train_product takes contiguous float32 CUDA tensors")
    fam = FAMILIES[family]
    if fam == 2:
        (k, m), n = a.shape, w.shape[1]
        split = None
    else:
        m, k = a.shape
        n = w.shape[0] if fam == 0 else w.shape[1]
        split = None if parent else (weight_split if fam == 0 else weight_split_t)(w, LIBRARY)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    part = torch.empty(weight_grad_splits(m, n, k)[0] * m * n if fam == 2 else 1,
                       dtype=torch.float32, device=a.device)  # the chunks' sums
    fn = _product_kernel()
    ptr = lambda y: None if y is None else y.data_ptr()  # noqa: E731
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = fn(fam, int(not parent), a.data_ptr(), w.data_ptr(),
                  None if split is None else ctypes.addressof(split.map), out.data_ptr(),
                  part.data_ptr(), m, n, k, TRAIN_EPILOGUES[epi], ptr(bias), ptr(resid),
                  ptr(aux), ptr(pre), stream)
    _build.check(LIBRARY, code)
    return out


def encoder_layer_train_fwd(x, *weights, seed, num_heads: int, rate: float,
                            row0: int = 0) -> torch.Tensor:
    """The forward kernel on CUDA tensors (seed: one int32 on the device; x
    rows ``row0`` on of the batch the dropout counts), counted in
    ``encoder_layer_train_fwd.launches``."""
    (out,) = _launch(False, x, weights, seed, None, num_heads, rate, row0)
    encoder_layer_train_fwd.launches += 1
    return out


def encoder_layer_train_bwd(x, *weights, seed, g, num_heads: int, rate: float, row0: int = 0):
    """The backward kernel on CUDA tensors: recomputes the layer from x and
    returns (dx, 12 weight gradients) for the output gradient g, counted
    in ``encoder_layer_train_bwd.launches``."""
    outs = _launch(True, x, weights, seed, g, num_heads, rate, row0)
    encoder_layer_train_bwd.launches += 1
    return outs


encoder_layer_train_fwd.launches = 0
encoder_layer_train_bwd.launches = 0


class _EncoderLayerTrain(torch.autograd.Function):
    """Forward kernel; the backward kernel recomputes from x.  Saved for
    backward: x, the 12 weights as they are held and the seed tensor (and
    the row offset), nothing else.  A weight that is a tensor-parallel
    block (parallel/tensor.py) is gathered whole into a transient for each
    kernel, and the backward returns its block's slice of the whole
    gradient (every rank of the model group holds the same rows, so the
    whole gradient is the same on each)."""

    @staticmethod
    def forward(ctx, x, seed, num_heads, rate, row0, *weights):
        ctx.num_heads, ctx.rate, ctx.row0 = num_heads, rate, row0
        ctx.blocks = [block_of(w) for w in weights]
        ctx.save_for_backward(x, seed, *weights)
        return encoder_layer_train_fwd(x, *_gathered(weights, ctx.blocks), seed=seed,
                                       num_heads=num_heads, rate=rate, row0=row0)

    @staticmethod
    def backward(ctx, g):
        x, seed, *weights = ctx.saved_tensors
        dx, *dws = encoder_layer_train_bwd(x, *_gathered(weights, ctx.blocks), seed=seed,
                                           g=g.contiguous(), num_heads=ctx.num_heads,
                                           rate=ctx.rate, row0=ctx.row0)
        dws = [dw if blk is None else blk.of(dw).contiguous()
               for dw, blk in zip(dws, ctx.blocks)]
        return (dx, None, None, None, None, *dws)


def _gathered(weights, blocks) -> list:
    """The whole weights of ``weights`` (blocks gathered, without autograd)."""
    with torch.no_grad():
        return [w if blk is None else all_gather_cat(w, blk.group)
                for w, blk in zip(weights, blocks)]


def fused_encoder_layer_train(
    x, wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b,
    *, seed, num_heads: int, rate: float, row0: int = 0,
) -> torch.Tensor:
    """One training encoder layer.  CPU tensors run
    ``encoder_layer_train_plain``; CUDA tensors run the forward kernel and,
    under autograd, the backward kernel.  On the card ``seed`` is one int32
    element on the device (an int is moved there).  x holds rows ``row0``
    on of the batch the dropout indices count.  A weight that is a
    tensor-parallel block (parallel/tensor.py) is gathered whole for the
    call, as a pallas_call under GSPMD gets its operands gathered: on the
    card into a transient that each kernel's launch builds and drops (one
    layer's weights at a time), on the CPU under autograd."""
    weights = (wqkv, bqkv, wo, bo, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b)
    if x.device.type == "cpu":
        return encoder_layer_train_plain(x, *(whole(w) for w in weights), seed=seed,
                                         num_heads=num_heads, rate=rate, row0=row0)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([seed], dtype=torch.int32, device=x.device)
    seed = seed.reshape(1)
    return _EncoderLayerTrain.apply(x, seed, num_heads, float(rate), int(row0), *weights)

