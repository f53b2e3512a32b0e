"""Sampling fast path for the MDM gesture denoiser.

PyTorch counterpart of gesturediffusion_tpu/models/mdm_fastpath.py
(make_fast_model_fn with the canonical "bjft" layout, make_fast_cfg_fn,
select_sampling_model_fn).  The denoise loop calls the model once per step
with the same conditioning, so:

  * ``precompute(cond)`` runs the loop-invariant pieces once per chunk
    (seed encoder, audio projection, conditioning-token projection);
  * the per-step function's glue is one [B*T, J] x [J, D] product plus
    adds: input_process and project_to_lat compose into one weight (no
    nonlinearity between them, composed in float32), and the concat
    disappears because a Linear over a concat is the sum of Linears over
    the parts.

Per step the latent then goes through the local block (kernel 1) and the
encoder layers (kernel 2) of the model itself.  The time-major "btj"
layout waits for a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gesturediffusion_tpu_torch.models.cfg import (
    classifier_free_guidance,
    stack_cfg_cond,
)
from gesturediffusion_tpu_torch.models.mdm import MDM


def _compose(model: MDM) -> dict:
    """The glue weights in [in, out] orientation (mdm_fastpath.py:81-101)."""
    d, a = model.latent_dim, model.audio_feat_dim
    w_in = model.input_process.poseEmbedding.weight.float().T      # [J*F, D]
    b_in = model.input_process.poseEmbedding.bias.float()
    w_proj = model.project_to_lat.weight.float().T                 # [2D+A, D]
    b_proj = model.project_to_lat.bias.float()
    out = {
        "w_pose": w_in @ w_proj[:d],
        "b_glue": b_in @ w_proj[:d] + b_proj,
        "w_audio": w_proj[d:d + a],
        "w_coa": w_proj[d + a:],
        "w_seed": model.seed_pose_encoder.seed_embed.weight.T,
        "b_seed": model.seed_pose_encoder.seed_embed.bias,
        "w_out": model.output_process.poseFinal.weight.T,          # [D, J*F]
        "b_out": model.output_process.poseFinal.bias,
    }
    if model.use_text:
        out["w_text"] = model.embed_text.weight.T
        out["b_text"] = model.embed_text.bias
    return {k: v.detach() for k, v in out.items()}


def make_fast_model_fn(model: MDM) -> tuple[Callable, Callable]:
    """Build (precompute, fast_fn) for inference-time MDM sampling in the
    canonical [B, J, F, T] layout.  ``fast_fn(x, t, precompute(cond))``
    equals ``model(x, t, cond)`` up to float32 reassociation."""
    with torch.no_grad():
        W = _compose(model)

    def precompute(cond: dict) -> dict:
        """Run the loop-invariant conditioning; returns cond + '_fast'."""
        seed = cond["seed"]
        b = seed.shape[0]
        uncond = cond.get("uncond")
        if uncond is None:
            uncond = torch.zeros((b,), device=seed.device)
        keep = 1.0 - uncond.float()[:, None]
        emb_seed = (seed.reshape(b, -1) * keep) @ W["w_seed"] + W["b_seed"]
        if model.use_text:
            emb_text = (cond["text_emb"].float() * keep) @ W["w_text"] + W["b_text"]
            stxt = torch.cat([emb_text, emb_seed], dim=-1)
        else:
            stxt = emb_seed
        audio = cond["mfcc"][:, :, 0, :].transpose(1, 2)
        out = dict(cond)
        out["_fast"] = {
            "base": audio @ W["w_audio"] + W["b_glue"],                # [B, T, D]
            "stxt": stxt,
            "stxt_proj": stxt @ W["w_coa"],                            # [B, D]
        }
        return out

    def to_pose(x: torch.Tensor) -> torch.Tensor:
        bs, nj, nf, nt = x.shape
        return x.reshape(bs, nj * nf, nt).transpose(1, 2)             # [B, T, J*F]

    def latent_forward(xseq: torch.Tensor, coa: torch.Tensor) -> torch.Tensor:
        """[B, T, D] latent + cond token -> model output [B, T, J*F]."""
        xseq = model.local_block(xseq, coa)
        out = model.seqTransEncoder(xseq, model.use_kernels)
        return out[:, 1:] @ W["w_out"] + W["b_out"]

    def from_tm(out: torch.Tensor, shape) -> torch.Tensor:
        bs, nj, nf, nt = shape
        return out.reshape(bs, nt, nj, nf).permute(0, 2, 3, 1)

    def temb(t: torch.Tensor) -> torch.Tensor:
        return model.embed_timestep(t)

    def fast_fn(x: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        pc = cond["_fast"]
        emb_t = temb(t)
        coa = pc["stxt"] + emb_t
        xseq = (
            to_pose(x) @ W["w_pose"]
            + pc["base"]
            + (pc["stxt_proj"] + emb_t @ W["w_coa"])[:, None, :]
        )
        return from_tm(latent_forward(xseq, coa), x.shape)

    fast_fn.internals = {
        "to_pose": to_pose,
        "latent_forward": latent_forward,
        "from_tm": from_tm,
        "temb": temb,
        "w_pose": W["w_pose"],
        "w_coa": W["w_coa"],
    }
    return precompute, fast_fn


def make_fast_cfg_fn(model: MDM, cond_mask_prob: float = 0.1) -> tuple[Callable, Callable]:
    """Fast-path twin of models/cfg.py:classifier_free_guidance.  Returns
    (precompute_cfg, guided_fn): the cond/uncond problems are stacked once
    per chunk, and each step runs one 2B forward and the guided combine
    with the per-sample scale from cond['scale']."""
    if not cond_mask_prob > 0.0:
        raise ValueError("Cannot run CFG on a model trained without conditioning dropout")
    precompute, fast_fn = make_fast_model_fn(model)
    ins = fast_fn.internals

    def precompute_cfg(cond: dict) -> dict:
        out = precompute(stack_cfg_cond(cond, cond["seed"].shape[0]))
        out["scale"] = cond["scale"]  # the original [B] scale for the combine
        return out

    def guided(x: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        b = x.shape[0]
        pc = cond["_fast"]
        # the cond and uncond passes share x: project the pose once at B
        xp = ins["to_pose"](x) @ ins["w_pose"]                         # [B, T, D]
        emb_t2 = ins["temb"](torch.cat([t, t]))                        # [2B, D]
        coa2 = pc["stxt"] + emb_t2
        xseq2 = (
            torch.cat([xp, xp])
            + pc["base"]
            + (pc["stxt_proj"] + emb_t2 @ ins["w_coa"])[:, None, :]
        )
        out = ins["latent_forward"](xseq2, coa2)
        scale = cond["scale"].reshape(b, 1, 1).to(out.dtype)
        out_cond, out_uncond = out[:b], out[b:]
        return ins["from_tm"](out_uncond + scale * (out_cond - out_uncond), x.shape)

    return precompute_cfg, guided


def select_sampling_model_fn(
    model: MDM, guidance: float, cond_mask_prob: float, no_fast: bool = False
) -> tuple[Optional[Callable], Callable]:
    """Returns (cond_precompute, model_fn) as
    mdm_fastpath.py:select_sampling_model_fn does: the fast path unless
    ``no_fast``, CFG-wrapped when guidance != 1 (for guidance 0 the
    cond_mask_prob guard is clamped away from zero)."""
    p = max(cond_mask_prob, 1e-9) if guidance == 0 else cond_mask_prob
    if not no_fast:
        if guidance != 1:
            return make_fast_cfg_fn(model, p)
        return make_fast_model_fn(model)
    if guidance != 1:
        return None, classifier_free_guidance(model, p)
    return None, model
