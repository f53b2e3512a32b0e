"""MDM V2 gesture denoiser.

PyTorch counterpart of gesturediffusion_tpu/models/mdm.py (SeedPoseEncoder,
WavEncoder, MDM).  Parameter and buffer names follow the
reference torch state dict that
gesturediffusion_tpu/utils/convert_torch.py:export_mdm_state_dict writes,
so a ``model*.pt`` loads with ``load_state_dict``.

Shape flow: [B,J,F,T] -> input_process -> [B,T,D] -> cat audio [B,T,D+A]
-> cat conditioning token [B,T,2D+A] -> project_to_lat [B,T,D] -> local
block (rotary + causal band attention + cond token + rotary) [B,T+1,D] ->
8-layer post-LN encoder -> drop token -> output_process -> [B,J,F,T].

Its Linear layers are parallel/tensor.py:Linear: nn.Linear, whose weight
may be a tensor-parallel block under ``--mesh_model_axis``.

``forward(..., train=True, generator=g)`` is the training mode of
mdm.py:MDM.__call__ (:276-299): conditioning dropout with probability
``cond_mask_prob`` (independent draws for the text and the seed-pose
streams), the plain local block with attention-probability dropout, and
the encoder in train mode; every mask comes from ``g``.

Audio enters as MFCCs (``mfcc_input``, cond['mfcc'] [B, A, 1, T]) or, with
``use_wav_enc`` and not ``mfcc_input``, as raw audio (cond['audio'] [B, L])
through ``WavEncoder`` (mdm.py:97-127), whose 32 channels are cropped or
zero-padded to the motion's T frames (mdm.py:242-256).  The MFCC branch wins
when both are set (mdm.py:165-173).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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
from gesturediffusion_tpu_torch.parallel.distributed import all_reduce_sum, current_rows
from gesturediffusion_tpu_torch.parallel.tensor import Linear
from gesturediffusion_tpu_torch.utils.device import full_f32

WAV_FEATURES = 32  # the wav encoder's output channels, the audio width it gives the model


class SeedPoseEncoder(nn.Module):
    """Flattened seed poses -> latent (mdm.py:SeedPoseEncoder)."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.seed_embed = Linear(in_dim, latent_dim)

    def forward(self, flat_seed: torch.Tensor) -> torch.Tensor:
        return self.seed_embed(flat_seed)


class BatchNorm1d(nn.Module):
    """Batch normalisation over [B, C, L] by flax ``nn.BatchNorm``'s rule,
    the JAX package's (flax 0.12.3 defaults), under torch BatchNorm1d's
    parameter and buffer names.  In training the batch's mean and its
    biased variance E[x^2] - E[x]^2 (clamped at 0) normalise, and the
    running statistics move 1 % a call towards them (flax's momentum 0.99);
    torch's own BatchNorm1d moves them 10 % and stores the unbiased
    variance.  In evaluation the running statistics normalise.  Either way
    y = (x - mean) * (rsqrt(var + eps) * weight) + bias, flax's order.
    ``num_batches_tracked`` counts the training calls as torch's does; the
    reference layout carries it and nothing reads it.  Where the batch is
    split over ranks (parallel/distributed.py:global_rows with a group) the
    sums of x and x^2 are reduced over them, so every rank normalises with,
    and moves its running statistics towards, the global batch's; torch's
    SyncBatchNorm follows torch's rule and would not do."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            rows = current_rows()
            if rows is not None and rows.group is not None:
                # the global batch's statistics: sums over the ranks' rows
                sums = all_reduce_sum(torch.stack([x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2))]),
                                      rows.group)
                mean, sq = sums / (x.shape[2] * x.shape[0] * rows.total / rows.count)
            else:
                mean, sq = x.mean(dim=(0, 2)), (x * x).mean(dim=(0, 2))
            var = torch.clamp_min(sq - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class WavEncoder(nn.Module):
    """Raw audio [B, L] -> frame features [B, 32, T'] (mdm.py:WavEncoder):
    four Conv1d of kernel 15 and stride 5 with (channels, dilation,
    padding) (16, 1, 1600), (32, 4, 0), (64, 7, 0), (32, 13, 0), the first
    three each followed by BatchNorm1d and leaky_relu(0.3).  The reference
    layout ``feat_extractor.{0,1,3,4,6,7,9}`` (convert_torch.py:136-158).
    The convolutions run in float32 on the card, cuDNN's TF32 off
    (utils/device.py:full_f32), forward and, under the train step's guard,
    backward; ``features`` is the stack without the guard."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 1
        for i, (c, dilation, padding) in enumerate(((16, 1, 1600), (32, 4, 0), (64, 7, 0),
                                                     (WAV_FEATURES, 13, 0))):
            layers.append(nn.Conv1d(c_in, c, 15, stride=5, padding=padding, dilation=dilation))
            if i < 3:
                layers += [BatchNorm1d(c), nn.LeakyReLU(0.3)]
            c_in = c
        self.feat_extractor = nn.Sequential(*layers)

    def features(self, wav: torch.Tensor) -> torch.Tensor:
        x = self.feat_extractor[:-1](wav[:, None, :])
        last = self.feat_extractor[-1]
        if x.shape[-1] < last.dilation[0] * (last.kernel_size[0] - 1) + 1:
            # under ~1 s of audio the last convolution has no whole window:
            # no frames, as XLA's convolution gives (the model pads them)
            return x.new_zeros((x.shape[0], last.out_channels, 0))
        return last(x)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return self.features(wav)


class InputProcess(nn.Module):
    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = Linear(in_dim, latent_dim)


class OutputProcess(nn.Module):
    def __init__(self, latent_dim: int, out_dim: int):
        super().__init__()
        self.poseFinal = Linear(latent_dim, out_dim)


class MDM(nn.Module):
    """MDM V2 gesture denoiser (mdm.py:MDM).

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
        mfcc_input: bool = True,
        use_wav_enc: bool = False,
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
        if not (mfcc_input or use_wav_enc):
            raise ValueError("audio conditioning required: mfcc_input or use_wav_enc")
        self.njoints, self.nfeats, self.latent_dim = njoints, nfeats, latent_dim
        self.use_text, self.mfcc_dim = use_text, mfcc_dim
        self.mfcc_input, self.use_wav_enc = mfcc_input, use_wav_enc
        self.cond_mask_prob = cond_mask_prob  # training-time CFG dropout rate
        self.dropout = dropout
        self.cl_head, self.window_size = cl_head, window_size
        self.use_kernels = use_kernels
        pose_dim = njoints * nfeats
        d = latent_dim

        self.input_process = InputProcess(pose_dim, d)
        self.project_to_lat = Linear(2 * d + self.audio_feat_dim, d)
        self.output_process = OutputProcess(d, pose_dim)
        self.sequence_pos_encoder = PositionalEncoding(d)
        self.embed_timestep = TimestepEmbedder(d, self.sequence_pos_encoder)
        self.seed_pose_encoder = SeedPoseEncoder(
            pose_dim * seed_poses, d - text_dim if use_text else d
        )
        if use_text:
            self.embed_text = Linear(clip_dim, text_dim)
        if self.reads_audio:
            self.wav_encoder = WavEncoder()
        self.seqTransEncoder = TransformerEncoder(
            num_layers, d, num_heads, ff_size, dropout,
            use_fused_train_layer=use_fused_train_encoder, remat=remat,
        )
        self.rel_pos = RotaryInvFreq(d // cl_head)

    @property
    def reads_audio(self) -> bool:
        """Whether the model reads raw audio (the wav encoder) over MFCCs."""
        return self.use_wav_enc and not self.mfcc_input

    @property
    def audio_feat_dim(self) -> int:
        return WAV_FEATURES if self.reads_audio else self.mfcc_dim

    def audio_features(self, cond: dict, nframes: int) -> torch.Tensor:
        """The audio stream [B, T, A]: the MFCCs, or the wav encoder's
        features cropped or zero-padded to ``nframes`` (mdm.py:242-256)."""
        if not self.reads_audio:
            return cond["mfcc"][:, :, 0, :].transpose(1, 2)
        feats = self.wav_encoder(cond["audio"])
        tw = feats.shape[-1]
        feats = feats[..., :nframes] if tw >= nframes else F.pad(feats, (0, nframes - tw))
        return feats.transpose(1, 2)

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

        emb_audio = self.audio_features(cond, nframes).to(x.dtype)  # [B, T, A]
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
