"""Carry MDM, MotionMDM and evaluator-classifier weights into the port.

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
as kernel = rows, bias = 0.  ``motion_discriminator_state_dict_from_params``
and ``stgcn_state_dict_from_variables`` carry the JAX evaluator classifiers
(eval/networks.py:MotionDiscriminator, eval/stgcn.py:STGCN) into the
reference torch layout the port's classifiers load: the inverse of
networks.py:convert_motion_discriminator (:333) and stgcn.py:convert_stgcn
(:290), BatchNorm ``batch_stats`` as ``running_mean`` / ``running_var``;
``t2m_evaluator_state_dicts_from_params`` carries the JAX T2M evaluators
into the released finest.tar's layout, ``comp_v6_state_dicts_from_params``
the JAX CompV6 generator into the released CompV6 and length-estimator
tars' (the inverse of comp_v6.py:convert_comp_v6_checkpoint, the
``positional_encoder.pe`` buffers included), and
``movement_encoder_state_dict_from_params``,
``movement_decoder_state_dict_from_params`` and
``len_estimator_state_dict_from_params`` the modules the evaluator trainers
train alone (eval/trainers.py: the movement autoencoder, the length
estimator; the text-motion trainer's encoders go through the finest.tar
converter, the action classifier's through the MotionDiscriminator's).  A wav-encoder MDM's variables
({'params', 'batch_stats'}) carry the wav encoder across as
convert_torch.py:export_mdm_state_dict does (flax Conv [K, in, out] ->
Conv1d [out, in, K]; BatchNorm scale / bias -> weight / bias, mean / var ->
the running buffers).  ``mdm_old_state_dict_from_params`` carries the JAX
MDMOld (models/mdm_old.py) into the reference V1 layout that
convert_torch.py:convert_mdm_old_state_dict reads.  ``load_weights`` loads
a ``model*.pt`` onto a model and refuses a V1 file for the V2 MDM, as the
JAX CLIs do (convert_torch.py:112-119).
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


# the wav encoder's Sequential indices: Conv1d at 0/3/6/9, BatchNorm1d at 1/4/7
WAV_CONVS, WAV_NORMS = (0, 3, 6, 9), (1, 4, 7)


def _wav_encoder(out: dict, p: dict, stats: dict) -> None:
    for i, ci in enumerate(WAV_CONVS):
        out[f"wav_encoder.feat_extractor.{ci}.weight"] = _f32(
            p[f"conv_{i}"]["kernel"]).transpose(2, 1, 0)
        out[f"wav_encoder.feat_extractor.{ci}.bias"] = _f32(p[f"conv_{i}"]["bias"])
    for i, bi in enumerate(WAV_NORMS):
        _batchnorm(out, f"wav_encoder.feat_extractor.{bi}", p[f"bn_{i}"], stats[f"bn_{i}"])


def state_dict_from_params(params: dict, *, cl_head: int = 8) -> dict[str, torch.Tensor]:
    """JAX MDM variables ({'params': tree[, 'batch_stats': ...]} or the
    params tree) -> port state dict.  ``cl_head`` (the local-attention head
    count) sizes the rotary buffer; everything else is read off the tree.
    A wav-encoder MDM needs its ``batch_stats`` (the running statistics)."""
    P = params.get("params", params)
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
    if "wav_encoder" in P:
        stats = params.get("batch_stats", {}).get("wav_encoder")
        if stats is None:
            raise ValueError("a wav-encoder MDM needs the 'batch_stats' collection (the "
                             "BatchNorm running statistics) beside its 'params'")
        _wav_encoder(out, P["wav_encoder"], stats)
    sd = _tensors(out)
    if "wav_encoder" in P:  # an integer buffer, as JAX's exporter writes it (:314)
        for bi in WAV_NORMS:
            sd[f"wav_encoder.feat_extractor.{bi}.num_batches_tracked"] = torch.tensor(0)
    return sd


def mdm_old_state_dict_from_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX MDMOld params ({'params': tree} or the tree) -> the reference V1
    state dict the port's MDMOld loads (models/mdm_old.py): the inverse of
    convert_torch.py:convert_mdm_old_state_dict, the ``pe`` buffers
    included."""
    P = params.get("params", params)
    out: dict = {}
    _linear(out, "input_process.poseEmbedding", P["input_process"])
    _linear(out, "output_process.poseFinal", P["output_process"])
    _linear(out, "embed_timestep.time_embed.0", P["embed_timestep"]["time_embed_0"])
    _linear(out, "embed_timestep.time_embed.2", P["embed_timestep"]["time_embed_1"])
    _linear(out, "seed_pose_encoder.seed_embed", P["seed_pose_encoder"]["seed_embed"])
    _encoder_layers(out, P["seqTransEncoder"])
    _pe(out, out["input_process.poseEmbedding.weight"].shape[0])
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


def motion_discriminator_state_dict_from_params(params: dict, hidden_layer: int = 2
                                                 ) -> dict[str, torch.Tensor]:
    """JAX MotionDiscriminator params ({'params': tree} or the tree) ->
    the port's (the reference's) state dict: ``recurrent.{weight,bias}_{ih,hh}_l{i}``,
    ``linear1``, ``linear2``."""
    P = params.get("params", params)
    out: dict = {}
    for layer in range(hidden_layer):
        for short, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                            ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            out[f"recurrent.{name}_l{layer}"] = _f32(P[f"gru_l{layer}_{short}"])
    _linear(out, "linear1", P["linear1"])
    _linear(out, "linear2", P["linear2"])
    return _tensors(out)


def _conv2d(out: dict, name: str, p: dict) -> None:
    """flax Conv kernel [kh, kw, in, out] -> torch Conv2d weight [out, in, kh, kw]."""
    out[f"{name}.weight"] = _f32(p["kernel"]).transpose(3, 2, 0, 1)
    out[f"{name}.bias"] = _f32(p["bias"])


def _batchnorm(out: dict, name: str, p: dict, stats: dict) -> None:
    _layernorm(out, name, p)
    out[f"{name}.running_mean"] = _f32(stats["mean"])
    out[f"{name}.running_var"] = _f32(stats["var"])


def stgcn_state_dict_from_variables(variables: dict) -> dict[str, torch.Tensor]:
    """JAX STGCN variables ({'params', 'batch_stats'}) -> the port's (the
    reference's) state dict: ``data_bn``, ``st_gcn_networks.{i}.gcn.conv``,
    ``.tcn.{0,2,3}``, ``.residual.{0,1}``, ``edge_importance.{i}``, ``fcn``
    (a 1x1 Conv2d)."""
    P, S = variables["params"], variables["batch_stats"]
    out: dict = {}
    _batchnorm(out, "data_bn", P["data_bn"], S["data_bn"])
    out["fcn.weight"] = _f32(P["fcn"]["kernel"]).T[:, :, None, None]
    out["fcn.bias"] = _f32(P["fcn"]["bias"])
    i = 0
    while f"st_gcn_{i}" in P:
        blk, st, p = P[f"st_gcn_{i}"], S[f"st_gcn_{i}"], f"st_gcn_networks.{i}"
        _conv2d(out, f"{p}.gcn.conv", blk["gcn"]["conv"])
        _batchnorm(out, f"{p}.tcn.0", blk["tcn_bn1"], st["tcn_bn1"])
        _conv2d(out, f"{p}.tcn.2", blk["tcn_conv"])
        _batchnorm(out, f"{p}.tcn.3", blk["tcn_bn2"], st["tcn_bn2"])
        if "res_conv" in blk:
            _conv2d(out, f"{p}.residual.0", blk["res_conv"])
            _batchnorm(out, f"{p}.residual.1", blk["res_bn"], st["res_bn"])
        if f"edge_importance_{i}" in P:
            out[f"edge_importance.{i}"] = _f32(P[f"edge_importance_{i}"])
        i += 1
    return _tensors(out)


def _bigru_co(out: dict, trunk: dict) -> None:
    _linear(out, "input_emb", trunk["input_emb"])
    out["hidden"] = _f32(trunk["hidden"])
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        for short, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                            ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            out[f"gru.{name}_l0{suffix}"] = _f32(trunk[f"gru_{direction}_{short}"])
    _linear(out, "output_net.0", trunk["output_net_0"])
    _layernorm(out, "output_net.1", trunk["output_net_1"])
    _linear(out, "output_net.3", trunk["output_net_3"])


def t2m_evaluator_state_dicts_from_params(params: dict) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX T2M evaluators' params ({'text', 'motion', 'movement'}, as
    eval/evaluator_wrapper.py holds them) -> the released finest.tar's
    ``text_encoder``, ``motion_encoder`` and ``movement_encoder`` state
    dicts, which the port's modules load: the inverse of
    networks.py:convert_text_encoder, convert_motion_encoder (:256-310) and
    convert_movement_encoder (:313; flax Conv [k, in, out] -> Conv1d
    [out, in, k] at ``main.0`` and ``main.3``)."""
    text, motion = {}, {}
    _linear(text, "pos_emb", params["text"]["pos_emb"])
    _bigru_co(text, params["text"]["trunk"])
    _bigru_co(motion, params["motion"]["trunk"])
    return {"text_encoder": _tensors(text), "motion_encoder": _tensors(motion),
            "movement_encoder": movement_encoder_state_dict_from_params(params["movement"])}


def movement_encoder_state_dict_from_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX MovementConvEncoder params -> the reference's state dict: the
    inverse of networks.py:convert_movement_encoder (:313; flax Conv
    [k, in, out] -> Conv1d [out, in, k] at ``main.0`` and ``main.3``)."""
    out: dict = {}
    for name, key in (("main.0", "conv0"), ("main.3", "conv1")):
        out[f"{name}.weight"] = _f32(params[key]["kernel"]).transpose(2, 1, 0)
        out[f"{name}.bias"] = _f32(params[key]["bias"])
    _linear(out, "out_net", params["out_net"])
    return _tensors(out)


def movement_decoder_state_dict_from_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX MovementConvDecoder params (comp_v6.py:175) -> the reference's
    state dict: the inverse of comp_v6.py:convert_movement_decoder (:326;
    flax ConvTranspose [k, in, out], flipped in k -> ConvTranspose1d
    [in, out, k] at ``main.0`` and ``main.2``)."""
    out: dict = {}
    for name, key in (("main.0", "deconv0"), ("main.2", "deconv1")):
        out[f"{name}.weight"] = _f32(params[key]["kernel"])[::-1].transpose(1, 2, 0)
        out[f"{name}.bias"] = _f32(params[key]["bias"])
    _linear(out, "out_net", params["out_net"])
    return _tensors(out)


def _bigru(out: dict, p: dict) -> None:
    """The flat ``gru_{fwd,bwd}_*`` of comp_v6.py's BiGRUs -> nn.GRU's
    ``gru.*_l0[_reverse]``, with ``pos_emb``, ``input_emb`` and ``hidden``."""
    _linear(out, "pos_emb", p["pos_emb"])
    _linear(out, "input_emb", p["input_emb"])
    out["hidden"] = _f32(p["hidden"])
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        for short, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                            ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            out[f"gru.{name}_l0{suffix}"] = _f32(p[f"gru_{direction}_{short}"])


def len_estimator_state_dict_from_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX MotionLenEstimatorBiGRU params (comp_v6.py:197) -> the
    reference's state dict: the inverse of comp_v6.py:convert_len_estimator
    (:341)."""
    out: dict = {}
    _bigru(out, params)
    for i in (0, 3, 6, 9):
        _linear(out, f"output.{i}", params[f"output_{i}"])
        if i < 9:
            _layernorm(out, f"output.{i + 1}", params[f"output_{i + 1}"])
    return _tensors(out)


def _snippet_rnn(out: dict, p: dict, z2init: dict) -> None:
    """emb, the GRU cells, z2init and the 300-row positional table of
    comp_v6.py's TextDecoder / TextVAEDecoder."""
    _linear(out, "emb.0", p["emb_0"])
    _layernorm(out, "emb.1", p["emb_1"])
    cells = p["gru"]
    i = 0
    while f"gru_{i}_w_ih" in cells:
        for short, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                            ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            out[f"gru.{i}.{name}"] = _f32(cells[f"gru_{i}_{short}"])
        i += 1
    _linear(out, "z2init", z2init)
    out["positional_encoder.pe"] = sinusoidal_table(300, out["emb.0.weight"].shape[0])


def comp_v6_state_dicts_from_params(params: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX CompV6Generator.params (comp_v6.py:379; numpy or JAX arrays) ->
    the released tars' state dicts, keyed as the tars key them
    (``text_enc``, ``seq_pri``, ``seq_dec``, ``att_layer``, ``mov_enc``,
    ``mov_dec``, and the length estimator tar's ``estimator``), which
    eval/comp_v6.py:CompV6Generator loads: the inverse of
    comp_v6.py:convert_comp_v6_checkpoint (:355)."""
    text: dict = {}
    _bigru(text, params["text_enc"])
    pri: dict = {}
    _snippet_rnn(pri, params["seq_pri"], params["z2init_pri"])
    _linear(pri, "mu_net", params["seq_pri"]["mu_net"])
    _linear(pri, "logvar_net", params["seq_pri"]["logvar_net"])
    dec: dict = {}
    _snippet_rnn(dec, params["seq_dec"], params["z2init_dec"])
    _linear(dec, "output.0", params["seq_dec"]["output_0"])
    _layernorm(dec, "output.1", params["seq_dec"]["output_1"])
    _linear(dec, "output.3", params["seq_dec"]["output_3"])
    att: dict = {}
    _linear(att, "W_q", params["att_layer"]["W_q"])
    att["W_k.weight"] = _f32(params["att_layer"]["W_k"]["kernel"]).T
    _linear(att, "W_v", params["att_layer"]["W_v"])
    return {"text_enc": _tensors(text), "seq_pri": _tensors(pri), "seq_dec": _tensors(dec),
            "att_layer": _tensors(att),
            "mov_enc": movement_encoder_state_dict_from_params(params["mov_enc"]),
            "mov_dec": movement_decoder_state_dict_from_params(params["mov_dec"]),
            "estimator": len_estimator_state_dict_from_params(params["len_estimator"])}


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load the ``model*.pt`` at ``path`` onto ``model`` and return it.  A
    V1 (MDMOld) state dict, which has no ``project_to_lat.*``, is refused
    for the V2 MDM with the JAX converter's answer (convert_torch.py:
    112-119): the CLIs build V2 only, and a V1 file loads onto
    models/mdm_old.py:MDMOld."""
    sd = load_checkpoint(path)
    if hasattr(model, "project_to_lat") and "project_to_lat.weight" not in sd:
        raise ValueError(
            "checkpoint has no 'project_to_lat.*' — this looks like an MDM V1 (mdm_old) "
            "state dict; load it onto gesturediffusion_tpu_torch.models.mdm_old.MDMOld "
            "(the CLIs build the V2 model only, matching the reference)")
    model.load_state_dict(sd)
    return model


def load_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a reference-layout ``model*.pt`` state dict (tensors only),
    without the frozen CLIP tower an upstream text-to-motion checkpoint
    may carry (``clip_model.*``; the text embedder loads its own)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: v for k, v in sd.items() if not k.startswith("clip_model.")}
