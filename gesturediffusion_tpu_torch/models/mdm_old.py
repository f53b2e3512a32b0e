"""MDM V1 gesture denoiser.

PyTorch counterpart of gesturediffusion_tpu/models/mdm_old.py:MDMOld
(:26-107), the reference's V1 model: the MFCCs are concatenated onto the
pose channels ([B, J+A, F, T]), token 0 is the timestep embedding plus the
seed-pose embedding, then the additive sinusoidal positional encoding with
dropout, the post-LN encoder of models/transformer.py (each layer one
launch of the encoder-layer kernel on the card) and the output projection.
No project_to_lat, no local block, no text.  Parameter and buffer names
follow the reference V1 state dict that
gesturediffusion_tpu/utils/convert_torch.py:convert_mdm_old_state_dict
reads, so such a ``model*.pt`` loads with ``load_state_dict``.  The CLIs
build the V2 model only, as JAX's (convert_torch.py:112-119): a V1 file is
loaded onto this class by a caller (utils/convert.py:load_weights).

Training (``train=True`` with a ``torch.Generator``) draws the seed
stream's conditioning mask, the positional encoding's dropout and the
encoder's dropout from the generator, in that order.

cond: ``mfcc`` [B, A, F, T], ``seed`` [B, J, F, S], ``uncond`` [B] float,
the CFG mask (1 drops the seed poses).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gesturediffusion_tpu_torch.models.embeddings import (
    PositionalEncoding,
    TimestepEmbedder,
    mask_cond,
)
from gesturediffusion_tpu_torch.models.mdm import InputProcess, OutputProcess, SeedPoseEncoder
from gesturediffusion_tpu_torch.models.transformer import TransformerEncoder


class MDMOld(nn.Module):
    """[B, J, F, T] -> [B, J, F, T].  ``use_kernels=False`` runs the plain
    PyTorch encoder layers on any device; by default a CUDA model launches
    the encoder-layer kernel."""

    def __init__(
        self,
        njoints: int = 498,
        nfeats: int = 1,
        latent_dim: int = 256,
        ff_size: int = 1024,
        num_layers: int = 8,
        num_heads: int = 4,
        dropout: float = 0.1,
        cond_mask_prob: float = 0.0,
        seed_poses: int = 10,
        mfcc_dim: int = 26,
        use_kernels: bool = True,
    ):
        super().__init__()
        self.njoints, self.nfeats, self.latent_dim = njoints, nfeats, latent_dim
        self.num_layers, self.mfcc_dim = num_layers, mfcc_dim
        self.cond_mask_prob = cond_mask_prob
        self.use_kernels = use_kernels
        d = latent_dim
        self.input_process = InputProcess((njoints + mfcc_dim) * nfeats, d)
        self.output_process = OutputProcess(d, njoints * nfeats)
        self.sequence_pos_encoder = PositionalEncoding(d, dropout=dropout)
        self.embed_timestep = TimestepEmbedder(d, self.sequence_pos_encoder)
        self.seed_pose_encoder = SeedPoseEncoder(njoints * nfeats * seed_poses, d)
        self.seqTransEncoder = TransformerEncoder(num_layers, d, num_heads, ff_size, dropout)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: dict,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bs, njoints, nfeats, nframes = x.shape
        uncond = cond.get("uncond")
        if uncond is None:
            uncond = torch.zeros((bs,), dtype=x.dtype, device=x.device)
        emb = self.embed_timestep(timesteps).to(x.dtype)
        flat_seed = cond["seed"].to(x.dtype).reshape(bs, -1)
        emb = emb + self.seed_pose_encoder(
            mask_cond(flat_seed, uncond, self.cond_mask_prob, train, generator))

        xa = torch.cat([x, cond["mfcc"].to(x.dtype)], dim=1)              # [B, J+A, F, T]
        h = self.input_process.poseEmbedding(xa.reshape(bs, -1, nframes).transpose(1, 2))
        xseq = torch.cat([emb[:, None, :], h], dim=1)                     # [B, T+1, D]
        xseq = self.sequence_pos_encoder(xseq, train, generator)
        out = self.seqTransEncoder(xseq.contiguous(), self.use_kernels, train, generator)[:, 1:]
        out = self.output_process.poseFinal(out)
        out = out.reshape(bs, nframes, self.njoints, self.nfeats)
        return out.permute(0, 2, 3, 1).float()
