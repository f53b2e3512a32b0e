"""MotionMDM: the original MDM denoiser for text-to-motion, action-to-motion
and unconstrained generation.

PyTorch counterpart of gesturediffusion_tpu/models/mdm_t2m.py:MotionMDM
(:34-136), the architecture of the released ``humanml-encoder-512``
checkpoints.  Token 0 is the conditioning: the timestep embedding plus the
CLIP sentence embedding through ``embed_text`` (cond_mode ``text``), plus
the action's row of ``embed_action`` (``action``), or the timestep alone
(``no_cond``).  Then the additive sinusoidal positional encoding, the post-LN
encoder of models/transformer.py and the output projection.  Parameter
and buffer names follow the upstream torch state dict that
gesturediffusion_tpu/utils/convert_torch.py:export_motion_mdm_state_dict
writes.  The action embedding trains in JAX's layout, a Dense over the
one-hot with a kernel [num_actions, D] and a bias [D] (mdm_t2m.py:101-103):
under AdamW the bias takes every action's gradient and a row only its own,
so folding the bias into the rows would train differently.  Its state
dict is the upstream bare [num_actions, D] matrix, the bias folded into
every row as that exporter does (convert_torch.py:338-340); loading one
sets the kernel to the rows and the bias to 0 (convert_torch.py:202-205).

Shape flow: [B,J,F,T] -> input_process [B,T,D] -> prepend token 0
[B,T+1,D] + pe -> encoder (each layer one launch of the encoder-layer
kernel on the card) -> drop token 0 -> output_process -> [B,J,F,T].  The
263 -> D and D -> 263 projections stay plain products, as in JAX, outside
any kernel.

Training (``train=True`` with a ``torch.Generator``) draws, in this
order, the conditioning mask (``cond_mask_prob``), the positional
encoding's dropout and the encoder's dropout from the generator.  With
``use_fused_train_encoder`` each encoder layer is the fused training layer
(the CUDA forward and backward kernels for CUDA tensors, the plain
hash-dropout layer for CPU tensors; transformer.py:FusedTrainEncoderLayer),
else the plain layer with Bernoulli dropout.

cond: ``text_emb`` [B, clip_dim] (text), ``action`` [B] int (action),
``uncond`` [B] float, the CFG mask (1 drops the conditioning).
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
from gesturediffusion_tpu_torch.models.mdm import InputProcess, OutputProcess
from gesturediffusion_tpu_torch.models.transformer import TransformerEncoder
from gesturediffusion_tpu_torch.parallel.tensor import Linear

COND_MODES = ("text", "action", "no_cond")


class EmbedAction(nn.Module):
    """The action embedding: one_hot(action) @ kernel + bias, as a row
    lookup.  ``action_embedding`` is the kernel; the state dict holds the
    upstream matrix, kernel + bias."""

    def __init__(self, num_actions: int, latent_dim: int):
        super().__init__()
        self.action_embedding = nn.Parameter(torch.randn(num_actions, latent_dim))
        self.bias = nn.Parameter(torch.zeros(latent_dim))

    def forward(self, action: torch.Tensor) -> torch.Tensor:
        return self.action_embedding[action.reshape(-1).long()] + self.bias

    def unfolded_state(self) -> dict[str, torch.Tensor]:
        """The kernel and bias as they train (the state dict folds them)."""
        return {"kernel": self.action_embedding.detach(), "bias": self.bias.detach()}

    @torch.no_grad()
    def load_unfolded_state(self, state: dict[str, torch.Tensor]) -> None:
        self.action_embedding.copy_(state["kernel"])
        self.bias.copy_(state["bias"])

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        rows = self.action_embedding + self.bias[None, :]
        destination[prefix + "action_embedding"] = rows if keep_vars else rows.detach()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata, strict,
                              missing_keys, unexpected_keys, error_msgs):
        key = prefix + "action_embedding"
        if key not in state_dict:
            missing_keys.append(key)
            return
        rows = state_dict[key]
        if rows.shape != self.action_embedding.shape:
            error_msgs.append(f"size mismatch for {key}: copying a param with shape "
                              f"{tuple(rows.shape)}, the model holds "
                              f"{tuple(self.action_embedding.shape)}")
            return
        with torch.no_grad():
            self.action_embedding.copy_(rows)
            self.bias.zero_()
        if strict:
            unexpected_keys.extend(k for k in state_dict
                                   if k.startswith(prefix) and k != key)


class MotionMDM(nn.Module):
    """[B, J, F, T] -> [B, J, F, T].  ``use_kernels=False`` runs the plain
    PyTorch encoder layers on any device; by default a CUDA model launches
    the encoder-layer kernel (inference) or the training-layer kernels
    (training under ``use_fused_train_encoder``)."""

    def __init__(
        self,
        njoints: int = 263,
        nfeats: int = 1,
        latent_dim: int = 512,
        ff_size: int = 1024,
        num_layers: int = 8,
        num_heads: int = 4,
        dropout: float = 0.1,
        clip_dim: int = 512,
        cond_mode: str = "text",
        cond_mask_prob: float = 0.1,
        num_actions: int = 12,
        use_kernels: bool = True,
        use_fused_train_encoder: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        if cond_mode not in COND_MODES:
            raise ValueError(f"unknown cond_mode {cond_mode}")
        self.njoints, self.nfeats, self.latent_dim = njoints, nfeats, latent_dim
        self.num_layers, self.cond_mode = num_layers, cond_mode
        self.cond_mask_prob = cond_mask_prob
        self.use_kernels = use_kernels
        d = latent_dim
        self.input_process = InputProcess(njoints * nfeats, d)
        self.output_process = OutputProcess(d, njoints * nfeats)
        self.sequence_pos_encoder = PositionalEncoding(d, dropout=dropout)
        self.embed_timestep = TimestepEmbedder(d, self.sequence_pos_encoder)
        if cond_mode == "text":
            self.embed_text = Linear(clip_dim, d)
        elif cond_mode == "action":
            self.embed_action = EmbedAction(num_actions, d)
        self.seqTransEncoder = TransformerEncoder(
            num_layers, d, num_heads, ff_size, dropout,
            use_fused_train_layer=use_fused_train_encoder, remat=remat,
        )

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: dict,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bs, njoints, nfeats, nframes = x.shape
        uncond = cond.get("uncond")
        if uncond is None:
            uncond = torch.zeros((bs,), dtype=x.dtype, device=x.device)

        def masked(c):
            return mask_cond(c, uncond, self.cond_mask_prob, train, generator)

        emb = self.embed_timestep(timesteps).to(x.dtype)
        if self.cond_mode == "text":
            emb = emb + self.embed_text(masked(cond["text_emb"].to(x.dtype)))
        elif self.cond_mode == "action":
            # masked after the embedding, as the reference masks its lookup
            # (mdm_t2m.py:94-104): masking before would leak a bias into
            # the unconditional CFG branch
            emb = emb + masked(self.embed_action(cond["action"]).to(x.dtype))

        feats = x.reshape(bs, njoints * nfeats, nframes).transpose(1, 2)   # [B, T, J*F]
        h = self.input_process.poseEmbedding(feats)
        xseq = torch.cat([emb[:, None, :], h], dim=1)
        xseq = self.sequence_pos_encoder(xseq, train, generator)
        out = self.seqTransEncoder(xseq.contiguous(), self.use_kernels, train, generator)[:, 1:]
        out = self.output_process.poseFinal(out)
        out = out.reshape(bs, nframes, self.njoints, self.nfeats)
        return out.permute(0, 2, 3, 1).float()
