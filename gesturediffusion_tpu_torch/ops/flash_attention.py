"""Non-causal self-attention: flash CUDA kernel and plain version.

Counterpart of gesturediffusion_tpu/ops/pallas_flash.py:fused_self_attention
(softmax(q k^T / sqrt(D)) v per (batch, head), f32 scores, online softmax).
On a CUDA tensor ``fused_self_attention`` launches csrc/flash_attention.cu
(both products on the tensor cores in 3xTF32, f32-level error); on a CPU
tensor it runs ``self_attention_reference``.  The inference encoder
layer's chain launches the same device code on its packed qkv buffer as its
attention stage (ops/fused_encoder.py), and counts those launches here too.
The kernel takes any head width (``padded_head_width``), as pallas_flash.py
pads D to a multiple of 128: up to 128 at the next multiple of 16 with
zero-filled columns, in the inference body flash_fwd_narrow_kernel (a
producer warpgroup lands K and V by the copy engine's tensor maps, or a
float at a time where rows are not 16-byte aligned, and splits them into
big and small once a block; one or two consumer warpgroups of 64 query rows
run S = q k^T and o += p v on wgmma; one grid dimension over (batch * head,
query tile), so B * H may pass 65535); from 129 to 544 in
csrc/wide_attention.cuh's flash_fwd_wide_kernel: one block, or a cluster of
two past 272 columns, takes 64 query rows over the whole width, each
warpgroup a share of the columns for both products; the scores are
computed once (the shares' partial sums added through the cluster's shared
memory), each K and V element is split into big and small tiles once, S
runs on mma.sync and o += p v on wgmma; wider heads in 128-column slices.
The training layer's attention stage keeps the mma.sync body of the same
header (its dropout and log-sum-exp).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gesturediffusion_tpu_torch.ops import _build
from gesturediffusion_tpu_torch.ops.band_attention import (
    check_attention_args,
    kernel_layout,
    padded_head_width,
)

def self_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T * D**-0.5) v on [B, H, T, D], scores and softmax in
    float32 (tests/test_pallas_flash.py:xla_attention)."""
    d = q.shape[-1]
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * (d**-0.5)
    return torch.einsum("bhij,bhjd->bhid", s.softmax(dim=-1).to(v.dtype), v)


@functools.cache
def _kernel():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load_function(
        "flash_attention", "gdt_flash_attention_f32",
        [p] * 4 + [ll] * 12 + [i] * 4 + [ctypes.c_float, p],
    )


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full (non-causal) attention, q, k, v [B, H, T, D] -> [B, H, T, D].

    CPU tensors run ``self_attention_reference``; CUDA tensors launch the
    flash kernel, which reads q, k and v through their strides, masks keys
    past T itself and pads the head width in shared memory, so nothing is
    padded in device memory (counted in ``fused_self_attention.launches``)."""
    if q.device.type == "cpu":
        return self_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check_attention_args("fused_self_attention", q, k, v)
    b, h, t, d = q.shape
    padded_head_width(d)
    q, k, v = kernel_layout(q, k, v)
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                  b, h, t, d, d**-0.5, stream)
    _build.check("flash_attention", code)
    fused_self_attention.launches += 1
    return out


fused_self_attention.launches = 0
