"""Causal banded local attention: CUDA kernel, plain version and dispatch.

Counterpart of gesturediffusion_tpu/ops/pallas_attention.py.
``local_attention_band`` computes ``local_attention(causal=True,
look_backward=1, look_forward=0)`` of ops/local_attention.py: query i sees
the keys j <= i of its own window and of the previous one, softmax in
float32.  On a CUDA tensor it launches csrc/band_attention.cu; on a CPU
tensor it runs the windowed plain version.

``local_attention_auto`` dispatches as pallas_attention.py:161-199 does:
T <= LOCAL_ATTN_DENSE_MAX_T takes the dense form; a simple band (causal,
look-back 1, look-forward 0, no key mask, no dropout, T divisible by the
window) on a CUDA tensor takes the kernel, with "on a CUDA tensor" in the
place of JAX's "on the TPU"; everything else the windowed plain form.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gesturediffusion_tpu_torch.ops import _build
from gesturediffusion_tpu_torch.ops.local_attention import (
    local_attention,
    local_attention_dense,
)

# below this length the dense band-masked formulation is taken
LOCAL_ATTN_DENSE_MAX_T = 256
# the widest padded head width the attention kernels hold in registers and
# shared memory (csrc/common.cuh:kMaxPaddedWidth); wider heads run in
# slices of this many columns (csrc/wide_attention.cuh)
SLICE_WIDTH = 128


def padded_head_width(dh: int) -> int:
    """The width the attention kernels run head width ``dh`` at: up to
    ``SLICE_WIDTH`` the next multiple of 16 (csrc/ instantiates 16, 32, ...,
    128), columns past dh zero-filled in shared memory; past it the next
    multiple of ``SLICE_WIDTH``, the output's column slices.  Raises a
    ValueError for a width below 1."""
    if dh < 1:
        raise ValueError(f"head width {dh}: the attention kernels take widths >= 1")
    step = 16 if dh <= SLICE_WIDTH else SLICE_WIDTH
    return -(-dh // step) * step


@functools.cache
def _kernel():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load_function(
        "band_attention", "gdt_band_attention_f32",
        [p] * 4 + [ll] * 12 + [i] * 5 + [ctypes.c_float, p],
    )


def kernel_layout(*xs: torch.Tensor) -> tuple:
    """The operands as the attention kernels read them: each tensor itself
    when its head width (last axis) is contiguous, whatever its other
    strides and alignment, else one contiguous copy of it; a tensor passed
    more than once is copied once, so aliased operands stay aliased."""
    laid = {}
    return tuple(laid.setdefault(id(x), x if x.stride(-1) == 1 else x.contiguous())
                 for x in xs)


def check_attention_args(name: str, q, k, v) -> None:
    """Shape, type and device checks shared by the attention kernels."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"{name}: expected q, k, v [B, H, T, D] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if any(x.dtype != torch.float32 for x in (q, k, v)):
        raise TypeError(f"{name}: the kernel takes float32 tensors")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k and v must be on the same device")


def local_attention_band(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window_size: int) -> torch.Tensor:
    """Causal banded attention, look-back one window.  q, k, v [B, H, T, D]
    with T % window_size == 0 -> [B, H, T, D].

    CPU tensors run the windowed ``local_attention``; CUDA tensors launch
    the kernel, which reads q, k and v through their strides (the local
    block's rotated heads are a transposed view: no copy) and writes an
    output laid out as q (counted in ``local_attention_band.launches``)."""
    t = q.shape[-2]
    if t % window_size != 0:
        raise ValueError(
            f"sequence length {t} must be divisible by window size {window_size}"
        )
    if q.device.type == "cpu":
        return local_attention(q, k, v, window_size=window_size, causal=True,
                               look_backward=1, look_forward=0)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_attention_args("local_attention_band", q, k, v)
    padded_head_width(q.shape[-1])
    q, k, v = kernel_layout(q, k, v)
    out = torch.empty_like(q)
    b, h, _, d = q.shape
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  b, h, t, d, window_size, d**-0.5, stream)
    _build.check("band_attention", code)
    local_attention_band.launches += 1
    return out


local_attention_band.launches = 0


def local_attention_auto(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window_size: int,
    causal: bool = True, look_backward: int = 1, look_forward: int = 0,
    mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None, use_kernels: bool = True,
) -> torch.Tensor:
    """Dense form at T <= LOCAL_ATTN_DENSE_MAX_T, the band kernel for a
    simple band on a CUDA tensor (unless ``use_kernels`` is False), the
    windowed plain form otherwise (pallas_attention.py:161)."""
    kw = dict(window_size=window_size, causal=causal, look_backward=look_backward,
              look_forward=look_forward, mask=mask, dropout_rate=dropout_rate,
              generator=generator)
    t = q.shape[2]
    if t <= LOCAL_ATTN_DENSE_MAX_T:
        return local_attention_dense(q, k, v, **kw)
    simple_band = (causal and look_backward == 1 and look_forward == 0
                   and mask is None and dropout_rate == 0.0 and t % window_size == 0)
    if use_kernels and simple_band and q.device.type == "cuda":
        return local_attention_band(q, k, v, window_size=window_size)
    return local_attention(q, k, v, **kw)
