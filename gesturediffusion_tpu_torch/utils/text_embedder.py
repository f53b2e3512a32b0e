"""Text embedder: the CLIP tower where its files are present, else a hash.

PyTorch counterpart of gesturediffusion_tpu/utils/text_embedder.py:
``HashTextEmbedder`` (:20; md5-seeded vectors, byte-identical to the JAX
package's) and ``get_text_encoder`` (:42).  The same environment picks the
same branch in both packages: ``$CLIP_CHECKPOINT`` (default
``assets/clip/ViT-B-32.pt``) and a BPE file (``$CLIP_BPE_PATH`` or
``assets/clip/bpe_simple_vocab_16e6.txt.gz``) both present -> the CLIP
text tower of models/clip_text.py on ``device``; otherwise the hash
embedder.  The branch taken is logged.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable

import numpy as np

from gesturediffusion_tpu_torch.models.clip_text import CLIPTextEmbedder, default_bpe_path
from gesturediffusion_tpu_torch.utils import logger as log_lib


class HashTextEmbedder:
    """A deterministic pseudo-embedding per caption (a pipeline stand-in
    where CLIP's files are absent)."""

    def __init__(self, dim: int = 512):
        self.dim = dim

    def __call__(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            # a stable digest: Python's hash() is salted per process
            seed = int.from_bytes(hashlib.md5(t.encode()).digest()[:4], "little")
            out[i] = np.random.RandomState(seed).randn(self.dim).astype(np.float32) * 0.1
        return out


def get_text_encoder(dim: int = 512, device=None) -> Callable:
    """The CLIP text tower if its checkpoint and BPE file are present, else
    the hash embedder; texts -> [B, dim] (a tensor on ``device`` from
    CLIP, a numpy array from the hash)."""
    ckpt = os.environ.get("CLIP_CHECKPOINT", "assets/clip/ViT-B-32.pt")
    bpe = default_bpe_path()
    if bpe and os.path.isfile(ckpt):
        log_lib.log(f"loading CLIP text tower from {ckpt}")
        return CLIPTextEmbedder.from_torch_checkpoint(ckpt, bpe, device=device)
    log_lib.log("CLIP assets not found — using deterministic hash text embedder "
                "(set CLIP_CHECKPOINT and CLIP_BPE_PATH for the real tower)")
    return HashTextEmbedder(dim)
