"""Carry MDM and MotionMDM weights into the port.

``state_dict_from_params`` turns the JAX package's MDM parameter tree
(nested dicts of arrays: flax Dense ``kernel`` [in, out] / ``bias``,
LayerNorm ``scale`` / ``bias``) into the port's state dict, which is the
reference torch layout that
gesturediffusion_tpu/utils/convert_torch.py:export_mdm_state_dict writes
(nn.Linear ``weight`` [out, in]; the packed ``in_proj_weight`` [3D, D];
the ``pe`` and ``inv_freq`` buffers).  ``load_checkpoint`` reads a
``model*.pt`` file of that layout.  ``motion_mdm_state_dict_from_params``
does the same for the JAX MotionMDM (models/mdm_t2m.py), in the layout of
convert_torch.py:export_motion_mdm_state_dict: the action embedding's
Dense bias is folded into its rows, as that exporter does (:334-341).
Loading that state dict sets the trainable kernel to the rows and its
bias to 0 (models/mdm_t2m.py:EmbedAction).  The other way, a port
checkpoint holds the folded rows, which JAX's load_torch_checkpoint reads
as kernel = rows, bias = 0.  The wav encoder waits for a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from gesturediffusion_tpu_torch.models.embeddings import sinusoidal_table


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _linear(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _f32(p["kernel"]).T
    out[f"{name}.bias"] = _f32(p["bias"])


def _layernorm(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _f32(p["scale"])
    out[f"{name}.bias"] = _f32(p["bias"])


def _encoder_layers(out: dict, enc: dict) -> None:
    for i in range(len(enc)):
        lp, p = enc[f"layer_{i}"], f"seqTransEncoder.layers.{i}"
        out[f"{p}.self_attn.in_proj_weight"] = _f32(lp["self_attn"]["in_proj"]["kernel"]).T
        out[f"{p}.self_attn.in_proj_bias"] = _f32(lp["self_attn"]["in_proj"]["bias"])
        _linear(out, f"{p}.self_attn.out_proj", lp["self_attn"]["out_proj"])
        _linear(out, f"{p}.linear1", lp["linear1"])
        _linear(out, f"{p}.linear2", lp["linear2"])
        _layernorm(out, f"{p}.norm1", lp["norm1"])
        _layernorm(out, f"{p}.norm2", lp["norm2"])


def _pe(out: dict, d: int) -> None:
    """The positional table, registered under both module paths."""
    pe = sinusoidal_table(5000, d).astype(np.float32)[:, None, :]
    out["sequence_pos_encoder.pe"] = pe
    out["embed_timestep.sequence_pos_encoder.pe"] = pe


def _tensors(out: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def state_dict_from_params(params: dict, *, cl_head: int = 8) -> dict[str, torch.Tensor]:
    """JAX MDM params ({'params': tree} or the tree) -> port state dict.
    ``cl_head`` (the local-attention head count) sizes the rotary buffer;
    everything else is read off the tree."""
    P = params.get("params", params)
    if "wav_encoder" in P:
        raise NotImplementedError("the wav encoder waits for a later slice")
    out: dict = {}
    _linear(out, "input_process.poseEmbedding", P["input_process"])
    _linear(out, "project_to_lat", P["project_to_lat"])
    _linear(out, "output_process.poseFinal", P["output_process"])
    _linear(out, "embed_timestep.time_embed.0", P["embed_timestep"]["time_embed_0"])
    _linear(out, "embed_timestep.time_embed.2", P["embed_timestep"]["time_embed_1"])
    _linear(out, "seed_pose_encoder.seed_embed", P["seed_pose_encoder"]["seed_embed"])
    if "embed_text" in P:
        _linear(out, "embed_text", P["embed_text"])
    _encoder_layers(out, P["seqTransEncoder"])
    d = out["project_to_lat.weight"].shape[0]
    _pe(out, d)
    dh = d // cl_head
    out["rel_pos.inv_freq"] = (
        1.0 / (10000 ** (np.arange(0, dh, 2, dtype=np.float64) / dh))
    ).astype(np.float32)
    return _tensors(out)


def motion_mdm_state_dict_from_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX MotionMDM params ({'params': tree} or the tree) -> port state
    dict (models/mdm_t2m.py).  The cond_mode is read off the tree: an
    ``embed_text`` Dense (text), an ``embed_action`` one (action) or
    neither (no_cond)."""
    P = params.get("params", params)
    out: dict = {}
    _linear(out, "input_process.poseEmbedding", P["input_process"])
    _linear(out, "output_process.poseFinal", P["output_process"])
    _linear(out, "embed_timestep.time_embed.0", P["embed_timestep"]["time_embed_0"])
    _linear(out, "embed_timestep.time_embed.2", P["embed_timestep"]["time_embed_1"])
    if "embed_text" in P:
        _linear(out, "embed_text", P["embed_text"])
    if "embed_action" in P:
        # one_hot @ W + b == one_hot @ (W + b): the bias folded into every row
        out["embed_action.action_embedding"] = (
            _f32(P["embed_action"]["kernel"]) + _f32(P["embed_action"]["bias"])[None, :])
    _encoder_layers(out, P["seqTransEncoder"])
    _pe(out, out["input_process.poseEmbedding.weight"].shape[0])
    return _tensors(out)


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a reference-layout ``model*.pt`` state dict (tensors only),
    without the frozen CLIP tower an upstream text-to-motion checkpoint
    may carry (``clip_model.*``; the text embedder loads its own)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: v for k, v in sd.items() if not k.startswith("clip_model.")}
