"""Export a train run's checkpoint as a reference-layout ``.pt``, with its
EMA weights under ``--ema``.

    python -m gesturediffusion_tpu_torch.utils.export_torch \
        --model_path save/run/model000400000.pt --out ema000400000.pt [--ema]

Counterpart of gesturediffusion_tpu/utils/export_torch.py.  The model is
rebuilt from the ``args.json`` beside the checkpoint and loads the model
file; without ``--ema`` the output equals that file tensor by tensor.  A
run keeps its EMA only in the ``opt*.pt`` beside ``model*.pt``
(train/loop.py:TrainLoop.save), keyed by ``named_parameters()``: ``--ema``
copies it into the parameters and keeps the model file's buffers (the wav
encoder's BatchNorm statistics, which the EMA does not track), so every
sampling CLI can load the EMA weights.  Reads and writes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", required=True,
                        help="a train run's model{step:09d}.pt")
    parser.add_argument("--out", required=True, help="output .pt path")
    parser.add_argument("--ema", action="store_true",
                        help="export the EMA weights instead")
    args = parser.parse_args(argv)

    args.model_path = os.path.normpath(args.model_path)
    args_json = os.path.join(os.path.dirname(args.model_path), "args.json")
    if not os.path.isfile(args_json):
        raise FileNotFoundError(
            f"{args_json} not found — the training args are needed to "
            "rebuild the model architecture"
        )
    with open(args_json) as f:
        train_args = argparse.Namespace(**json.load(f))

    from gesturediffusion_tpu_torch.models.mdm import MDM
    from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
    from gesturediffusion_tpu_torch.utils.convert import load_weights
    from gesturediffusion_tpu_torch.utils.model_factory import create_model

    model = create_model(train_args)
    if not isinstance(model, (MDM, MotionMDM)):
        raise NotImplementedError(
            "torch export covers the gesture MDM and upstream MotionMDM "
            f"families (got {type(model).__name__})"
        )
    load_weights(model, args.model_path)
    if args.ema:
        name = os.path.basename(args.model_path).replace("model", "opt", 1)
        opt_path = os.path.join(os.path.dirname(args.model_path), name)
        if not os.path.isfile(opt_path):
            raise ValueError(
                f"--ema requested but {opt_path} does not exist: the EMA weights "
                "live only in a train run's opt*.pt (a reference or exported .pt "
                "has none) — rerun without --ema"
            )
        ema = torch.load(opt_path, map_location="cpu", weights_only=True).get("ema")
        if not ema:
            raise ValueError(
                "--ema requested but the checkpoint has no EMA weights "
                "(trained with ema_rate=0) — rerun without --ema"
            )
        # through the module: the EMA holds EmbedAction's kernel and bias
        # apart, the state dict folds them (models/mdm_t2m.py)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(ema[n])
    torch.save(model.state_dict(), args.out)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
