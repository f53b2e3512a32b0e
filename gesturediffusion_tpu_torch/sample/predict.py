"""Text-to-motion CLI: ``python -m gesturediffusion_tpu_torch.sample.predict``.

PyTorch counterpart of gesturediffusion_tpu/sample/predict.py (:27-222):
the ``Predictor`` of the reference's hardcoded humanml-encoder-512
configuration (MotionMDM, 263 features, latent 512, 8 layers of 4 heads,
ff 1024, text conditioning, DDPM cosine 1000 steps predicting x0, CFG
guidance 2.5, 196 frames): prompt -> CLIP embedding (or the hash stand-in,
utils/text_embedder.py) -> the ancestral chain at CFG batch 2R for R
repetitions -> de-normalised features -> xyz joints (ops/motion_process.py).
Mean and Std come from ``--dataset_root`` (default ./dataset/HumanML3D)
where present, else unit statistics.  The CLI writes ``results.npy`` and
``results.txt`` and prints one JSON line; it runs on the CUDA card unless
``--device cpu`` is given.  Each of the 8 encoder layers of a denoise step
is one launch of the encoder-layer kernel on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from gesturediffusion_tpu_torch.diffusion.gaussian import ModelMeanType, create_diffusion
from gesturediffusion_tpu_torch.diffusion.sampling import NoiseFn, p_sample_loop
from gesturediffusion_tpu_torch.models.cfg import classifier_free_guidance
from gesturediffusion_tpu_torch.models.mdm_t2m import MotionMDM
from gesturediffusion_tpu_torch.ops.motion_process import joints_of_features, recover_from_ric
from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
from gesturediffusion_tpu_torch.utils.device import resolve_device
from gesturediffusion_tpu_torch.utils.parser import default_output_dir
from gesturediffusion_tpu_torch.utils.text_embedder import get_text_encoder

FPS = 20  # HumanML3D


class Predictor:
    """humanml-encoder-512 text-to-motion predictor.  ``model`` and
    ``diffusion`` default to the reference configuration; other trained
    configurations (and the tests' tiny ones) pass their own."""

    def __init__(
        self,
        model_path: str,
        dataset_root: Optional[str] = None,
        guidance_param: float = 2.5,
        num_frames: int = 196,
        model: Optional[MotionMDM] = None,
        diffusion=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.num_frames = num_frames
        self.guidance_param = guidance_param
        self.model = model or MotionMDM(
            njoints=263, nfeats=1, latent_dim=512, ff_size=1024, num_layers=8, num_heads=4,
            cond_mode="text", cond_mask_prob=0.1,
        )
        self.njoints = self.model.njoints
        self.diffusion = diffusion or create_diffusion(
            steps=1000, noise_schedule="cosine", model_mean_type=ModelMeanType.START_X,
            device=self.device,
        )
        self.model.load_state_dict(load_checkpoint(model_path))
        self.model.to(self.device).eval()

        root = dataset_root or "./dataset/HumanML3D"
        mean_p, std_p = os.path.join(root, "Mean.npy"), os.path.join(root, "Std.npy")
        if os.path.isfile(mean_p):
            mean, std = np.load(mean_p), np.load(std_p)
            if mean.shape[0] != self.njoints:
                raise ValueError(
                    f"dataset stats at {mean_p} are {mean.shape[0]}-dim but the model expects "
                    f"{self.njoints} features — pass the dataset_root matching this model (or "
                    f"none for unit stats)")
        else:
            mean = np.zeros(self.njoints, np.float32)
            std = np.ones(self.njoints, np.float32)
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=self.device)
        self.std = torch.as_tensor(std, dtype=torch.float32, device=self.device)

        self.text_encoder = get_text_encoder(device=self.device)
        # the model's own dropout rate, so that CFG on a model trained
        # without conditioning dropout is refused
        self.model_fn = (classifier_free_guidance(self.model, self.model.cond_mask_prob)
                         if guidance_param != 1 else self.model)

    @torch.no_grad()
    def predict(self, prompt: str, num_repetitions: int = 3, seed: int = 0,
                motion_length: float = 6.0, noise_fn: Optional[NoiseFn] = None) -> dict:
        """prompt -> {motion_xyz [R, J, 3, T], features [R, T, D], length,
        prompt}; the chain draws from a generator seeded with ``seed``
        (or from ``noise_fn``)."""
        n_frames = min(self.num_frames, int(motion_length * FPS))
        b, dev = num_repetitions, self.device
        cond = {
            "text_emb": torch.as_tensor(self.text_encoder([prompt] * b), dtype=torch.float32,
                                        device=dev),
            "mask": (torch.arange(self.num_frames, device=dev) < n_frames)
            .reshape(1, 1, 1, -1).expand(b, 1, 1, -1),
            "lengths": torch.full((b,), n_frames, dtype=torch.int32, device=dev),
        }
        if self.guidance_param != 1:
            cond["scale"] = torch.full((b,), self.guidance_param, device=dev)
        generator = torch.Generator(device=dev).manual_seed(seed)
        sample = p_sample_loop(self.diffusion, self.model_fn,
                               (b, self.njoints, 1, self.num_frames), cond,
                               generator=generator, noise_fn=noise_fn)
        feats = sample[:, :, 0, :].transpose(1, 2) * self.std + self.mean
        xyz = recover_from_ric(feats, joints_of_features(self.njoints))  # [R, T, J, 3]
        return {
            "motion_xyz": xyz[:, :n_frames].permute(0, 2, 3, 1).cpu().numpy(),
            "features": feats[:, :n_frames].cpu().numpy(),
            "length": n_frames,
            "prompt": prompt,
        }


def main(argv=None) -> str:
    """python -m gesturediffusion_tpu_torch.sample.predict --model_path
    save/run/model000600000.pt --text "a person walks forward" [--device cpu]"""
    ap = argparse.ArgumentParser(prog="python -m gesturediffusion_tpu_torch.sample.predict",
                                 description=main.__doc__)
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--text", required=True, help="text prompt")
    ap.add_argument("--num_repetitions", type=int, default=3)
    ap.add_argument("--motion_length", type=float, default=6.0,
                    help="seconds (reference predict.py caps at 9.8)")
    ap.add_argument("--guidance_param", type=float, default=2.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset_root", default="",
                    help="dataset dir with Mean.npy/Std.npy (optional)")
    ap.add_argument("--output_dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path).")
    # small-config overrides (the reference hardcodes humanml-512)
    ap.add_argument("--latent_dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--njoints", type=int, default=263)
    ap.add_argument("--ff_size", type=int, default=1024)
    ap.add_argument("--diffusion_steps", type=int, default=1000)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = MotionMDM(njoints=args.njoints, nfeats=1, latent_dim=args.latent_dim,
                      ff_size=args.ff_size, num_layers=args.layers, num_heads=4,
                      cond_mode="text", cond_mask_prob=0.1)
    diffusion = create_diffusion(steps=args.diffusion_steps, noise_schedule="cosine",
                                 model_mean_type=ModelMeanType.START_X, device=device)
    predictor = Predictor(args.model_path, guidance_param=args.guidance_param,
                          dataset_root=args.dataset_root or None, model=model,
                          diffusion=diffusion, device=device)
    out = predictor.predict(args.text, num_repetitions=args.num_repetitions, seed=args.seed,
                            motion_length=args.motion_length)

    out_path = args.output_dir or default_output_dir(args.model_path, "predict",
                                                     f"seed{args.seed}")
    os.makedirs(out_path, exist_ok=True)
    np.save(os.path.join(out_path, "results.npy"), {
        "motion": out["motion_xyz"],
        "text": [args.text] * args.num_repetitions,
        "lengths": np.full((args.num_repetitions,), out["length"]),
        "num_samples": args.num_repetitions,
    })
    with open(os.path.join(out_path, "results.txt"), "w") as f:
        f.write("\n".join([args.text] * args.num_repetitions))
    print(json.dumps({"output_dir": os.path.abspath(out_path), "frames": out["length"],
                      "repetitions": args.num_repetitions}))
    return out_path


if __name__ == "__main__":
    main(sys.argv[1:])
