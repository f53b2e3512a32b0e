"""The MDM-V2 pre-encoder local block: CUDA kernel and plain version.

``fused_local_block`` is the counterpart of
gesturediffusion_tpu/ops/pallas_local_block.py:fused_local_block, and
``pre_encoder_local_block`` of gesturediffusion_tpu/models/mdm.py:
pre_encoder_local_block (the kernel's specification):

    split heads -> rotary -> causal banded attention with q = k = v
    (window w, look back one window) -> merge heads -> prepend the
    conditioning token -> rotary over T + 1 -> merge heads

xseq [B, T, D], coa [B, D] -> [B, T + 1, D].  On a CUDA tensor the wrapper
launches csrc/local_block.cu (its band attention on the tensor cores in
3xTF32, through the routine it shares with the band kernel) with the rotary
tables of ``rotary_table``, built once per shape and device; on a CPU
tensor it runs the plain version.  A head whose rows do not fit a block's
shared memory (local heads wider than 128, or 128 past 216 frames) runs
the kernel's wide path: one launch up to local heads of 272
(csrc/wide_attention.cuh's local_block_wide_kernel), three past it, in a
workspace the wrapper allocates for the call where the library asks for
one (gdt_local_block_workspace).
``pre_encoder_local_block`` takes its attention from
ops/band_attention.py:local_attention_auto, as mdm.py:70 does: the dense
form up to 256 frames, beyond that the band kernel on a CUDA tensor
(unless ``use_kernels`` is False) and the windowed form otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gesturediffusion_tpu_torch.models.embeddings import (
    apply_rotary_pos_emb,
    rotary_freqs,
)
from gesturediffusion_tpu_torch.ops import _build
from gesturediffusion_tpu_torch.ops.band_attention import (
    local_attention_auto,
    padded_head_width,
)


def pre_encoder_local_block(
    xseq: torch.Tensor, coa: torch.Tensor, *, num_heads: int, window_size: int,
    dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """The block composed from torch ops around ``local_attention_auto``:
    the plain version of the fused kernel up to 256 frames, and the
    long-chunk path (band kernel on the card) above.  Training passes
    ``dropout_rate`` and the generator that draws the attention-probability
    masks; ``use_kernels=False`` keeps the attention plain on the card."""
    bs, nt, d = xseq.shape
    dh = d // num_heads
    heads = xseq.reshape(bs, nt, num_heads, dh).transpose(1, 2)
    heads, _ = apply_rotary_pos_emb(heads, heads, rotary_freqs(nt, dh, xseq.device))
    heads = local_attention_auto(
        heads, heads, heads, window_size=window_size, causal=True,
        look_backward=1, look_forward=0, dropout_rate=dropout_rate,
        generator=generator, use_kernels=use_kernels,
    ).to(xseq.dtype)
    xseq = heads.transpose(1, 2).reshape(bs, nt, d)

    xseq = torch.cat([coa[:, None, :], xseq], dim=1)
    heads = xseq.reshape(bs, nt + 1, num_heads, dh).transpose(1, 2)
    heads, _ = apply_rotary_pos_emb(
        heads, heads, rotary_freqs(nt + 1, dh, xseq.device)
    )
    return heads.transpose(1, 2).reshape(bs, nt + 1, d)


@functools.cache
def rotary_table(positions: int, dh: int, device: torch.device) -> tuple:
    """(cos, sin) [positions, dh / 2] of the rotary frequencies
    (``rotary_freqs``, whose two halves are equal): the kernel's tables,
    built once per shape and device with the plain version's own ops, so
    they are its tables bit for bit."""
    freqs = rotary_freqs(positions, dh, device)[:, : dh // 2]
    return freqs.cos().contiguous(), freqs.sin().contiguous()


@functools.cache
def _kernels():
    p, i = ctypes.c_void_p, ctypes.c_int
    block = _build.load_function(
        "local_block", "gdt_local_block_f32",
        [p] * 6 + [i] * 5 + [ctypes.c_float, p],
    )
    ws_floats = _build.load_function("local_block", "gdt_local_block_workspace", [i] * 4)
    ws_floats.restype = ctypes.c_size_t
    return block, ws_floats


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
    padded_head_width(d // num_heads)
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
    dh = d // num_heads
    cos, sin = rotary_table(t + 1, dh, xseq.device)
    out = torch.empty((b, t + 1, d), dtype=xseq.dtype, device=xseq.device)
    fn, ws_floats = _kernels()
    n_ws = ws_floats(b, t, d, num_heads)
    ws = torch.empty(n_ws, dtype=torch.float32, device=xseq.device) if n_ws else None
    with torch.cuda.device(xseq.device):
        stream = torch.cuda.current_stream(xseq.device).cuda_stream
        code = fn(xseq.data_ptr(), coa.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                  out.data_ptr(), None if ws is None else ws.data_ptr(), b, t, d, num_heads,
                  window, dh**-0.5, stream)
    _build.check("local_block", code)
    fused_local_block.launches += 1
    return out


fused_local_block.launches = 0
