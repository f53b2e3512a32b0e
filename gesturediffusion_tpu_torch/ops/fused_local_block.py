"""The MDM-V2 pre-encoder local block: CUDA kernel and plain version.

``fused_local_block`` is the counterpart of
gesturediffusion_tpu/ops/pallas_local_block.py:fused_local_block, and
``pre_encoder_local_block`` of gesturediffusion_tpu/models/mdm.py:
pre_encoder_local_block (the kernel's specification):

    split heads -> rotary -> causal banded attention with q = k = v
    (window w, look back one window) -> merge heads -> prepend the
    conditioning token -> rotary over T + 1 -> merge heads

xseq [B, T, D], coa [B, D] -> [B, T + 1, D].  On a CUDA tensor the wrapper
launches csrc/local_block.cu; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gesturediffusion_tpu_torch.models.embeddings import (
    apply_rotary_pos_emb,
    rotary_freqs,
)
from gesturediffusion_tpu_torch.ops import _build
from gesturediffusion_tpu_torch.ops.local_attention import local_attention_dense


def pre_encoder_local_block(
    xseq: torch.Tensor, coa: torch.Tensor, *, num_heads: int, window_size: int
) -> torch.Tensor:
    """Plain PyTorch version (inference: no dropout)."""
    bs, nt, d = xseq.shape
    dh = d // num_heads
    heads = xseq.reshape(bs, nt, num_heads, dh).transpose(1, 2)
    heads, _ = apply_rotary_pos_emb(heads, heads, rotary_freqs(nt, dh, xseq.device))
    heads = local_attention_dense(
        heads, heads, heads, window_size=window_size, causal=True,
        look_backward=1, look_forward=0,
    ).to(xseq.dtype)
    xseq = heads.transpose(1, 2).reshape(bs, nt, d)

    xseq = torch.cat([coa[:, None, :], xseq], dim=1)
    heads = xseq.reshape(bs, nt + 1, num_heads, dh).transpose(1, 2)
    heads, _ = apply_rotary_pos_emb(
        heads, heads, rotary_freqs(nt + 1, dh, xseq.device)
    )
    return heads.transpose(1, 2).reshape(bs, nt + 1, d)


@functools.cache
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load_function(
        "local_block", "gdt_local_block_f32",
        [p, p, p, i, i, i, i, i, ctypes.c_float, p],
    )


def _check_cuda_args(xseq, coa, num_heads, window):
    if xseq.dtype != torch.float32 or coa.dtype != torch.float32:
        raise TypeError("the local-block kernel takes float32 tensors")
    if xseq.dim() != 3 or coa.dim() != 2 or coa.shape != (xseq.shape[0], xseq.shape[2]):
        raise ValueError(
            f"expected xseq [B, T, D] and coa [B, D], got {tuple(xseq.shape)} "
            f"and {tuple(coa.shape)}"
        )
    if coa.device != xseq.device:
        raise ValueError("xseq and coa must be on the same device")
    d = xseq.shape[2]
    if d % num_heads or (d // num_heads) % 2 or window < 1:
        raise ValueError(
            f"D={d} must split into {num_heads} heads of even width; window >= 1"
        )
    if not (xseq.is_contiguous() and coa.is_contiguous()):
        raise ValueError("the local-block kernel takes contiguous tensors")


def fused_local_block(
    xseq: torch.Tensor, coa: torch.Tensor, *, num_heads: int, window: int
) -> torch.Tensor:
    """rotary + causal band attention + prepend(coa) + rotary, one launch.

    CPU tensors run ``pre_encoder_local_block``; CUDA tensors launch the
    kernel (and count the launch in ``fused_local_block.launches``)."""
    if xseq.device.type == "cpu":
        return pre_encoder_local_block(
            xseq, coa, num_heads=num_heads, window_size=window
        )
    if xseq.device.type != "cuda":
        raise ValueError(f"unsupported device {xseq.device}")
    _check_cuda_args(xseq, coa, num_heads, window)
    b, t, d = xseq.shape
    out = torch.empty((b, t + 1, d), dtype=xseq.dtype, device=xseq.device)
    fn = _kernel()
    with torch.cuda.device(xseq.device):
        stream = torch.cuda.current_stream(xseq.device).cuda_stream
        code = fn(xseq.data_ptr(), coa.data_ptr(), out.data_ptr(), b, t, d,
                  num_heads, window, (d // num_heads) ** -0.5, stream)
    _build.check("local_block", code)
    fused_local_block.launches += 1
    return out


fused_local_block.launches = 0
