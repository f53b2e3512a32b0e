"""Carry MDM weights into the port.

``state_dict_from_params`` turns the JAX package's MDM parameter tree
(nested dicts of arrays: flax Dense ``kernel`` [in, out] / ``bias``,
LayerNorm ``scale`` / ``bias``) into the port's state dict, which is the
reference torch layout that
gesturediffusion_tpu/utils/convert_torch.py:export_mdm_state_dict writes
(nn.Linear ``weight`` [out, in]; the packed ``in_proj_weight`` [3D, D];
the ``pe`` and ``inv_freq`` buffers).  ``load_checkpoint`` reads a
``model*.pt`` file of that layout.  The wav encoder waits for a later
slice.
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
    enc = P["seqTransEncoder"]
    for i in range(len(enc)):
        lp, p = enc[f"layer_{i}"], f"seqTransEncoder.layers.{i}"
        out[f"{p}.self_attn.in_proj_weight"] = _f32(lp["self_attn"]["in_proj"]["kernel"]).T
        out[f"{p}.self_attn.in_proj_bias"] = _f32(lp["self_attn"]["in_proj"]["bias"])
        _linear(out, f"{p}.self_attn.out_proj", lp["self_attn"]["out_proj"])
        _linear(out, f"{p}.linear1", lp["linear1"])
        _linear(out, f"{p}.linear2", lp["linear2"])
        _layernorm(out, f"{p}.norm1", lp["norm1"])
        _layernorm(out, f"{p}.norm2", lp["norm2"])

    d = out["project_to_lat.weight"].shape[0]
    pe = sinusoidal_table(5000, d).astype(np.float32)[:, None, :]
    out["sequence_pos_encoder.pe"] = pe
    out["embed_timestep.sequence_pos_encoder.pe"] = pe
    dh = d // cl_head
    out["rel_pos.inv_freq"] = (
        1.0 / (10000 ** (np.arange(0, dh, 2, dtype=np.float64) / dh))
    ).astype(np.float32)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a reference-layout ``model*.pt`` state dict (tensors only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return sd
