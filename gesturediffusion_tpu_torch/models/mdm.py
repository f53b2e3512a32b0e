"""MDM V2 gesture denoiser.

PyTorch counterpart of gesturediffusion_tpu/models/mdm.py (SeedPoseEncoder,
MDM with MFCC audio input).  Parameter and buffer names follow the
reference torch state dict that
gesturediffusion_tpu/utils/convert_torch.py:export_mdm_state_dict writes,
so a ``model*.pt`` loads with ``load_state_dict``.

Shape flow: [B,J,F,T] -> input_process -> [B,T,D] -> cat audio [B,T,D+A]
-> cat conditioning token [B,T,2D+A] -> project_to_lat [B,T,D] -> local
block (rotary + causal band attention + cond token + rotary) [B,T+1,D] ->
8-layer post-LN encoder -> drop token -> output_process -> [B,J,F,T].

``forward(..., train=True, generator=g)`` is the training mode of
mdm.py:MDM.__call__ (:276-299): conditioning dropout with probability
``cond_mask_prob`` (independent draws for the text and the seed-pose
streams), the plain local block with attention-probability dropout, and
the encoder in train mode; every mask comes from ``g``.  The wav-encoder
audio input waits for a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gesturediffusion_tpu_torch.models.embeddings import (
    PositionalEncoding,
    RotaryInvFreq,
    TimestepEmbedder,
    mask_cond,
)
from gesturediffusion_tpu_torch.models.transformer import TransformerEncoder
from gesturediffusion_tpu_torch.ops.band_attention import LOCAL_ATTN_DENSE_MAX_T
from gesturediffusion_tpu_torch.ops.fused_local_block import (
    fused_local_block,
    pre_encoder_local_block,
)


class SeedPoseEncoder(nn.Module):
    """Flattened seed poses -> latent (mdm.py:SeedPoseEncoder)."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.seed_embed = nn.Linear(in_dim, latent_dim)

    def forward(self, flat_seed: torch.Tensor) -> torch.Tensor:
        return self.seed_embed(flat_seed)


class InputProcess(nn.Module):
    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(in_dim, latent_dim)


class OutputProcess(nn.Module):
    def __init__(self, latent_dim: int, out_dim: int):
        super().__init__()
        self.poseFinal = nn.Linear(latent_dim, out_dim)


class MDM(nn.Module):
    """MDM V2 gesture denoiser (mdm.py:MDM, ``mfcc_input=True``).

    ``use_kernels=False`` runs the plain PyTorch versions of the CUDA
    kernels on any device; by default a CUDA model launches the kernels.
    ``use_fused_train_encoder`` trains through the fused training layer
    (the parameters are the same either way); ``remat`` recomputes the
    plain training layers in the backward pass."""

    def __init__(
        self,
        njoints: int = 498,
        nfeats: int = 1,
        latent_dim: int = 256,
        text_dim: int = 64,
        ff_size: int = 1024,
        num_layers: int = 8,
        num_heads: int = 4,
        dropout: float = 0.1,
        clip_dim: int = 512,
        use_text: bool = False,
        cond_mask_prob: float = 0.0,
        seed_poses: int = 10,
        mfcc_dim: int = 26,
        cl_head: int = 8,
        window_size: int = 10,
        use_kernels: bool = True,
        use_fused_train_encoder: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        if use_text and text_dim >= latent_dim:
            raise ValueError("text_dim must be < latent_dim (seed encoder gets the rest)")
        self.njoints, self.nfeats, self.latent_dim = njoints, nfeats, latent_dim
        self.use_text, self.mfcc_dim = use_text, mfcc_dim
        self.cond_mask_prob = cond_mask_prob  # training-time CFG dropout rate
        self.dropout = dropout
        self.cl_head, self.window_size = cl_head, window_size
        self.use_kernels = use_kernels
        pose_dim = njoints * nfeats
        d = latent_dim

        self.input_process = InputProcess(pose_dim, d)
        self.project_to_lat = nn.Linear(2 * d + mfcc_dim, d)
        self.output_process = OutputProcess(d, pose_dim)
        self.sequence_pos_encoder = PositionalEncoding(d)
        self.embed_timestep = TimestepEmbedder(d, self.sequence_pos_encoder)
        self.seed_pose_encoder = SeedPoseEncoder(
            pose_dim * seed_poses, d - text_dim if use_text else d
        )
        if use_text:
            self.embed_text = nn.Linear(clip_dim, text_dim)
        self.seqTransEncoder = TransformerEncoder(
            num_layers, d, num_heads, ff_size, dropout,
            use_fused_train_layer=use_fused_train_encoder, remat=remat,
        )
        self.rel_pos = RotaryInvFreq(d // cl_head)

    @property
    def audio_feat_dim(self) -> int:
        return self.mfcc_dim

    def local_block(self, xseq: torch.Tensor, coa: torch.Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, D] latent + [B, D] token -> [B, T+1, D].

        Inference with kernels: up to LOCAL_ATTN_DENSE_MAX_T (256) frames
        the fused local-block kernel; above, ``pre_encoder_local_block``,
        whose attention is the band kernel on the card.  The JAX package
        picks the fused block only under ``--use_fused_encoder``, which
        the port does not have (utils/parser.py), and its default path
        takes the band kernel above 256 frames (mdm.py:70,
        pallas_attention.py:181-194); the fused block's CUDA port cannot
        hold more than 792 frames in shared memory either.  Training runs
        the plain block with dropout (the band kernel has no backward),
        ``use_kernels=False`` the plain block."""
        kw = dict(num_heads=self.cl_head, window_size=self.window_size)
        if train:
            return pre_encoder_local_block(xseq, coa, **kw, dropout_rate=self.dropout,
                                           generator=generator, use_kernels=False)
        if self.use_kernels and xseq.shape[1] <= LOCAL_ATTN_DENSE_MAX_T:
            return fused_local_block(
                xseq, coa, num_heads=self.cl_head, window=self.window_size
            )
        return pre_encoder_local_block(xseq, coa, **kw, use_kernels=self.use_kernels)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: dict,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bs, njoints, nfeats, nframes = x.shape
        uncond = cond.get("uncond")
        if uncond is None:
            uncond = torch.zeros((bs,), dtype=x.dtype, device=x.device)

        def masked(c):
            return mask_cond(c, uncond, self.cond_mask_prob, train, generator)

        # the text stream draws its mask before the seed stream (mdm.py:215-220)
        if self.use_text:
            emb_text = self.embed_text(masked(cond["text_emb"].to(x.dtype)))
        emb_seed = self.seed_pose_encoder(masked(cond["seed"].reshape(bs, -1)))
        if self.use_text:
            stxt = torch.cat([emb_text, emb_seed], dim=-1)
        else:
            stxt = emb_seed
        emb_t = self.embed_timestep(timesteps).to(x.dtype)

        emb_audio = cond["mfcc"][:, :, 0, :].transpose(1, 2).to(x.dtype)  # [B, T, A]
        pose = x.reshape(bs, njoints * nfeats, nframes).transpose(1, 2)
        emb_pose = self.input_process.poseEmbedding(pose)
        coa = stxt + emb_t
        coa_rep = coa[:, None, :].expand(bs, nframes, self.latent_dim)
        xseq = self.project_to_lat(torch.cat([emb_pose, emb_audio, coa_rep], dim=-1))

        xseq = self.local_block(xseq.contiguous(), coa.contiguous(), train, generator)
        out = self.seqTransEncoder(xseq, self.use_kernels, train, generator)[:, 1:]
        out = self.output_process.poseFinal(out)
        out = out.reshape(bs, nframes, self.njoints, self.nfeats)
        return out.permute(0, 2, 3, 1).float()
