"""Device choice for the port's entry points: the card unless asked."""

from __future__ import annotations

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
