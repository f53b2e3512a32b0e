"""Flags of the train, generate, edit, serve and eval CLIs and the
checkpoint-args override.

PyTorch-port counterpart of gesturediffusion_tpu/utils/parser.py, with the
JAX flag names for the gesture paths.  As there, generation, serving and
evaluation re-read the dataset, model and diffusion groups from the
``args.json`` next to the checkpoint, and ``cond_mask_prob == 0`` forces
``guidance_param = 1``.  ``--device`` defaults to the CUDA card.  Only
flags that the port reads are accepted: an unknown flag is an argparse
error, and a training flag that the port cannot honour yet raises
NotImplementedError.  Left out of the JAX set because nothing here would
read them: ``--emb_trans_dec`` (trans_dec only), ``--use_audio`` (read by
no model), ``--prng`` (the port draws from torch generators), edit's
``--no_fast_sampler`` (a gesture model samples through its fast path only),
the train CLI's ``--use_fused_encoder`` (the inference layer takes no
part in training) and the generate CLI's ``--input_text``,
``--action_file``, ``--text_prompt`` and ``--action_name`` (the JAX
parser accepts them, gesturediffusion_tpu/utils/parser.py:236-239, and
nothing there reads them; the predict CLI takes its prompt as
``--text``).  A JAX ``args.json`` that carries them still loads:
generation copies only the keys its parser has.
"""

from __future__ import annotations

import argparse
import json
import os
from argparse import ArgumentParser

from gesturediffusion_tpu_torch.utils.model_factory import GESTURE_DATASETS, gesture_audio_input


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def default_output_dir(model_path: str, prefix: str, *parts: str) -> str:
    """<ckpt dir>/<prefix>_<run>_<iter>[_parts...], as the JAX CLIs name it."""
    model_path = os.path.normpath(model_path)
    name = os.path.basename(os.path.dirname(model_path))
    niter = os.path.basename(model_path).replace("model", "")
    for suffix in (".pt", ".pth"):
        niter = niter.removesuffix(suffix)
    return os.path.join(
        os.path.dirname(model_path), "_".join([f"{prefix}_{name}_{niter}", *parts])
    )


def _add_checkpoint_groups(parser: ArgumentParser) -> None:
    """The dataset, model and diffusion groups."""
    data = parser.add_argument_group("dataset")
    data.add_argument("--dataset", default="genea2023",
                      choices=["genea2022", "genea2023", "humanml", "kit", "humanact12",
                               "uestc", "synthetic"])
    data.add_argument("--data_dir", default="", type=str)
    data.add_argument("--num_frames", default=120, type=int)
    model = parser.add_argument_group("model")
    model.add_argument("--arch", default="trans_enc",
                       choices=["trans_enc", "trans_dec", "gru"], type=str)
    model.add_argument("--layers", default=8, type=int)
    model.add_argument("--latent_dim", default=256, type=int)
    model.add_argument("--cond_mask_prob", default=0.1, type=float)
    model.add_argument("--lambda_rcxyz", default=0.0, type=float)
    model.add_argument("--lambda_vel", default=0.0, type=float)
    model.add_argument("--lambda_fc", default=0.0, type=float)
    model.add_argument("--unconstrained", action="store_true",
                       help="A text dataset's MotionMDM without conditioning (no_cond).")
    model.add_argument("--use_text", action="store_true")
    model.add_argument("--mfcc_input", action="store_true")
    model.add_argument("--use_wav_enc", action="store_true")
    model.add_argument("--seed_poses", default=10, type=int)
    diffusion = parser.add_argument_group("diffusion")
    diffusion.add_argument("--noise_schedule", default="cosine",
                           choices=["linear", "cosine"])
    diffusion.add_argument("--diffusion_steps", default=1000, type=int)
    diffusion.add_argument("--sigma_small", default=True, type=str2bool)


def _sampling_parser(prog: str) -> ArgumentParser:
    """The flags the generate and serve CLIs share (parser.py:add_sampling_options)."""
    parser = ArgumentParser(prog=prog)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path).")
    parser.add_argument("--seed", default=10, type=int)
    parser.add_argument("--model_path", required=True, type=str)
    parser.add_argument("--output_dir", default="", type=str)
    parser.add_argument("--num_samples", default=10, type=int)
    parser.add_argument("--guidance_param", default=2.5, type=float)
    parser.add_argument("--use_fused_encoder", action="store_true",
                        help="Accepted for JAX command lines; the device "
                             "decides which code runs.")
    return parser


def _parse_and_load_from_model(parser: ArgumentParser, argv) -> argparse.Namespace:
    """Parse, then take the dataset, model and diffusion flags from the
    args.json beside the checkpoint (parser.py:parse_and_load_from_model)."""
    _add_checkpoint_groups(parser)
    args = parser.parse_args(argv)

    args.model_path = os.path.normpath(args.model_path)
    args_path = os.path.join(os.path.dirname(args.model_path), "args.json")
    if not os.path.exists(args_path):
        raise FileNotFoundError(f"no args.json next to the checkpoint: {args_path}")
    with open(args_path) as f:
        model_args = json.load(f)
    for group in parser._action_groups:
        if group.title in ("dataset", "model", "diffusion"):
            for action in group._group_actions:
                if action.dest in model_args:
                    setattr(args, action.dest, model_args[action.dest])
    if args.cond_mask_prob == 0:
        args.guidance_param = 1
    return args


SAMPLERS = ["ddpm", "ddim", "plms", "dpmpp"]


def generate_args(argv=None) -> argparse.Namespace:
    """Flags of ``python -m gesturediffusion_tpu_torch.sample.generate``."""
    parser = _sampling_parser("python -m gesturediffusion_tpu_torch.sample.generate")
    parser.add_argument("--sampler", default="ddpm", choices=SAMPLERS, type=str)
    parser.add_argument("--timestep_respacing", default="", type=str,
                        help='e.g. "50", "ddim50" or "logsnr50".')
    return _parse_and_load_from_model(parser, argv)


def edit_args(argv=None) -> argparse.Namespace:
    """Flags of ``python -m gesturediffusion_tpu_torch.sample.edit``
    (parser.py:edit_args, the edit group :248-256)."""
    parser = _sampling_parser("python -m gesturediffusion_tpu_torch.sample.edit")
    parser.add_argument("--num_repetitions", default=3, type=int)
    edit = parser.add_argument_group("edit")
    edit.add_argument("--edit_mode", default="in_between", choices=["in_between", "upper_body"],
                      type=str)
    edit.add_argument("--text_condition", default="", type=str)
    edit.add_argument("--prefix_end", default=0.25, type=float)
    edit.add_argument("--suffix_start", default=0.75, type=float)
    return _parse_and_load_from_model(parser, argv)


def serve_args(argv=None) -> argparse.Namespace:
    """Flags of ``python -m gesturediffusion_tpu_torch.serve.demo``
    (parser.py:serve_args)."""
    parser = _sampling_parser("python -m gesturediffusion_tpu_torch.serve.demo")
    serve = parser.add_argument_group("serve")
    serve.add_argument("--wav", default="", type=str,
                       help="Raw mono wav to stream (22050 Hz). Default: "
                            "stream the val split's own audio windows.")
    serve.add_argument("--streams", default=1, type=int,
                       help="Concurrent takes batched per chunk (multi-tenant serving).")
    serve.add_argument("--num_chunks", default=0, type=int,
                       help="Chunks to serve; 0 = as many as the source provides.")
    serve.add_argument("--sampler", default="ddpm", choices=SAMPLERS, type=str)
    serve.add_argument("--sample_steps", default=0, type=int,
                       help="Respace the sampler to N steps (the latency knob); "
                            "0 = the full trained chain.")
    serve.add_argument("--step_spacing", default="uniform", choices=["uniform", "logsnr"],
                       type=str, help="Respaced steps uniform in timestep or in log-SNR.")
    return _parse_and_load_from_model(parser, argv)


def train_args(argv=None) -> argparse.Namespace:
    """Flags of ``python -m gesturediffusion_tpu_torch.train.train_mdm``
    (parser.py:train_args)."""
    parser = ArgumentParser(prog="python -m gesturediffusion_tpu_torch.train.train_mdm")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path).")
    parser.add_argument("--seed", default=10, type=int)
    parser.add_argument("--batch_size", default=256, type=int)
    _add_checkpoint_groups(parser)
    train = parser.add_argument_group("training")
    train.add_argument("--save_dir", required=True, type=str)
    train.add_argument("--overwrite", action="store_true")
    train.add_argument("--train_platform_type", default="NoPlatform",
                       choices=["NoPlatform", "ClearmlPlatform", "TensorboardPlatform"])
    train.add_argument("--lr", default=1e-4, type=float)
    train.add_argument("--weight_decay", default=0.0, type=float)
    train.add_argument("--lr_anneal_steps", default=0, type=int)
    train.add_argument("--eval_batch_size", default=32, type=int)
    train.add_argument("--eval_split", default="test", choices=["val", "test"], type=str,
                       help="The split the text benchmark of --eval_during_training scores "
                            "on humanml / kit.")
    train.add_argument("--eval_during_training", action="store_true",
                       help="Evaluate after every in-loop save: the text benchmark on "
                            "humanml / kit, the a2m benchmark on humanact12 / uestc, the "
                            "validation loss elsewhere.")
    train.add_argument("--eval_rep_times", default=3, type=int)
    train.add_argument("--eval_num_samples", default=1_000, type=int)
    train.add_argument("--log_interval", default=1_000, type=int)
    train.add_argument("--save_interval", default=10_000, type=int)
    train.add_argument("--num_steps", default=600_000, type=int)
    train.add_argument("--resume_checkpoint", default="", type=str,
                       help="'latest' or a model*.pt path.")
    perf = parser.add_argument_group("performance")
    perf.add_argument("--use_bf16", action="store_true",
                      help="Round the model input to bfloat16, as the JAX step does; "
                           "every product stays float32.")
    perf.add_argument("--ema_rate", default=0.0, type=float,
                      help="EMA decay for params (0 disables).")
    perf.add_argument("--schedule_sampler", default="uniform",
                      choices=["uniform", "loss-second-moment"])
    perf.add_argument("--mesh_model_axis", default=1, type=int,
                      help="Ranks on the model axis: each large weight trains as a "
                           "1/N row block of it (tensor parallelism).")
    perf.add_argument("--use_fused_train_encoder", action="store_true",
                      help="Train the encoder through the fused training "
                           "layer (CUDA forward and backward kernels, only the "
                           "layer input saved for backward).")
    perf.add_argument("--microbatch_size", default=0, type=int,
                      help="Gradient-accumulation microbatch size (0 = whole batch).")
    perf.add_argument("--device_batch_pool", default=0, type=int,
                      help="Stage this many batches on the device once and cycle them "
                           "for the whole run (0 = off).")
    perf.add_argument("--remat", action="store_true",
                      help="Recompute the plain training layers in the backward pass "
                           "(a memory knob; the fused training layer keeps only its input).")
    args = parser.parse_args(argv)

    if args.mesh_model_axis < 1:
        parser.error(f"--mesh_model_axis must be >= 1, got {args.mesh_model_axis}")
    if args.dataset in GESTURE_DATASETS:
        gesture_audio_input(args)  # refused before anything is written
    if args.device_batch_pool < 0:
        parser.error(f"--device_batch_pool must be >= 0, got {args.device_batch_pool}")
    return args


def evaluation_args(argv=None, prog: str = "python -m gesturediffusion_tpu_torch.eval.eval_a2m"
                    ) -> argparse.Namespace:
    """Flags of the eval CLIs, ``eval.eval_a2m`` and ``eval.eval_humanml``
    (parser.py:evaluation_parser: the base flags and
    add_evaluation_options :280-289), the model's from its args.json.  The
    a2m benchmark runs ``debug`` and ``full``, the text benchmark
    ``debug``, ``wo_mm`` and ``mm_short``."""
    parser = ArgumentParser(prog=prog)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path).")
    parser.add_argument("--seed", default=10, type=int)
    parser.add_argument("--batch_size", default=256, type=int)
    ev = parser.add_argument_group("eval")
    ev.add_argument("--model_path", required=True, type=str)
    ev.add_argument("--eval_mode", default="wo_mm", choices=["wo_mm", "mm_short", "debug", "full"],
                    type=str)
    ev.add_argument("--guidance_param", default=2.5, type=float)
    ev.add_argument("--use_fused_encoder", action="store_true",
                    help="Accepted for JAX command lines; the device decides which code runs.")
    return _parse_and_load_from_model(parser, argv)
