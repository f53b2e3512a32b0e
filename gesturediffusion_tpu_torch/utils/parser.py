"""Flags of the generation CLI and the checkpoint-args override.

PyTorch-port counterpart of gesturediffusion_tpu/utils/parser.py, reduced
to the flags the gesture generation path uses.  As there, the dataset,
model and diffusion groups are re-read from the ``args.json`` that sits
next to the checkpoint, and ``cond_mask_prob == 0`` forces
``guidance_param = 1``.
"""

from __future__ import annotations

import argparse
import json
import os
from argparse import ArgumentParser


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
    data = parser.add_argument_group("dataset")
    data.add_argument("--dataset", default="genea2023",
                      choices=["genea2022", "genea2023", "synthetic"])
    data.add_argument("--data_dir", default="", type=str)
    data.add_argument("--num_frames", default=120, type=int)
    model = parser.add_argument_group("model")
    model.add_argument("--layers", default=8, type=int)
    model.add_argument("--latent_dim", default=256, type=int)
    model.add_argument("--cond_mask_prob", default=0.1, type=float)
    model.add_argument("--use_text", action="store_true")
    model.add_argument("--mfcc_input", action="store_true")
    model.add_argument("--use_wav_enc", action="store_true")
    model.add_argument("--seed_poses", default=10, type=int)
    diffusion = parser.add_argument_group("diffusion")
    diffusion.add_argument("--noise_schedule", default="cosine",
                           choices=["linear", "cosine"])
    diffusion.add_argument("--diffusion_steps", default=1000, type=int)
    diffusion.add_argument("--sigma_small", default=True, type=str2bool)


def generate_args(argv=None) -> argparse.Namespace:
    parser = ArgumentParser(prog="python -m gesturediffusion_tpu_torch.sample.generate")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path).")
    parser.add_argument("--seed", default=10, type=int)
    parser.add_argument("--model_path", required=True, type=str)
    parser.add_argument("--output_dir", default="", type=str)
    parser.add_argument("--num_samples", default=10, type=int)
    parser.add_argument("--guidance_param", default=2.5, type=float)
    parser.add_argument("--timestep_respacing", default="", type=str)
    parser.add_argument("--use_fused_encoder", action="store_true",
                        help="Accepted for JAX command lines; the device "
                             "decides which code runs.")
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
