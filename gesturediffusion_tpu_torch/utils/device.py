"""Device choice for the port's entry points: the card unless asked; and
float32 products on it."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` means the CUDA card, which must be present;
    ``"cpu"`` runs the plain PyTorch versions of the kernels.  Nothing
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def full_f32():
    """float32 products inside: cuBLAS's and cuDNN's TF32 switched off (PyTorch
    leaves cuDNN's on by default, and one TF32 pass rounds to ~1e-3), the
    settings found restored on the way out."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
