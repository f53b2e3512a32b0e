"""Gesture generation CLI: ``python -m gesturediffusion_tpu_torch.sample.generate``.

PyTorch counterpart of gesturediffusion_tpu/sample/generate.py:main
(:94-311): load the checkpoint and its args.json, collate every chunk of
every take, run chunked autoregressive DDPM sampling with the fast CFG
model function (the last ``seed_poses`` frames of a chunk seed the next),
invert the normalisation, split positions from rotations and write
``results.npy`` (+ ``results.txt``, ``results_len.txt``).  It runs on the
CUDA card unless ``--device cpu`` is given.  BVH export, video and the
GENEA loaders wait for later slices; a dataset without take structure
(``synthetic``) generates one chunk per take.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np
import torch

from gesturediffusion_tpu_torch.data.collate import collate_gesture, device_cond
from gesturediffusion_tpu_torch.data.synthetic import get_dataset
from gesturediffusion_tpu_torch.diffusion.gaussian import (
    ModelMeanType,
    ModelVarType,
    create_diffusion,
)
from gesturediffusion_tpu_torch.diffusion.sampling import autoregressive_sample_loop
from gesturediffusion_tpu_torch.models.mdm import MDM
from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
from gesturediffusion_tpu_torch.utils.convert import load_checkpoint
from gesturediffusion_tpu_torch.utils.device import resolve_device
from gesturediffusion_tpu_torch.utils.parser import default_output_dir, generate_args


def split_pose_vector(vec: np.ndarray, n_joints: int):
    """Interleaved 6-per-joint pose vector [..., J*6] with per-joint layout
    [rx, ry, rz, px, py, pz] -> (positions [..., J, 3], rotations [..., J, 3])."""
    idx_pos = np.asarray([[i * 6 + 3, i * 6 + 4, i * 6 + 5] for i in range(n_joints)]).flatten()
    idx_rot = np.asarray([[i * 6, i * 6 + 1, i * 6 + 2] for i in range(n_joints)]).flatten()
    pos = vec[..., idx_pos].reshape(vec.shape[:-1] + (n_joints, 3))
    rot = vec[..., idx_rot].reshape(vec.shape[:-1] + (n_joints, 3))
    return pos, rot


def create_model_and_diffusion(args, dataset, device: torch.device):
    """The gesture MDM V2 and its diffusion from the (checkpoint) flags."""
    if args.use_wav_enc:
        raise NotImplementedError("the wav-encoder audio input waits for a later slice")
    model = MDM(
        njoints=dataset.pose_dim, nfeats=1, latent_dim=args.latent_dim,
        ff_size=1024, num_layers=args.layers, num_heads=4,
        cond_mask_prob=args.cond_mask_prob, use_text=args.use_text,
        seed_poses=args.seed_poses,
    )
    diffusion = create_diffusion(
        noise_schedule=args.noise_schedule,
        steps=args.diffusion_steps,
        timestep_respacing=args.timestep_respacing or None,
        model_mean_type=ModelMeanType.START_X,
        model_var_type=(
            ModelVarType.FIXED_SMALL if args.sigma_small else ModelVarType.FIXED_LARGE
        ),
        device=device,
    )
    return model, diffusion


def main(argv=None) -> str:
    args = generate_args(argv)
    device = resolve_device(args.device)
    out_path = args.output_dir or default_output_dir(
        args.model_path, "samples", f"seed{args.seed}"
    )

    dataset = get_dataset(args.dataset, args.num_frames, n_seed_poses=args.seed_poses)
    n_joints = dataset.pose_dim // 6
    n_takes = min(args.num_samples, len(dataset))
    chunks_per_take = 1
    take_starts = np.arange(n_takes)
    print(f"Generating {n_takes} takes x {chunks_per_take} chunks of "
          f"{args.num_frames} frames on {device}")

    model, diffusion = create_model_and_diffusion(args, dataset, device)
    model.load_state_dict(load_checkpoint(args.model_path))
    model.to(device).eval()
    cond_precompute, model_fn = select_sampling_model_fn(
        model, args.guidance_param, args.cond_mask_prob
    )

    chunk_dconds, all_text, all_lengths = [], [], []
    for chunk in range(chunks_per_take):
        items = [dataset[int(take_starts[take]) + chunk] for take in range(n_takes)]
        _, cond = collate_gesture(items, max_frames=args.num_frames)
        chunk_dconds.append(device_cond(cond))
        all_text += cond.get("text", [""] * n_takes)
        all_lengths.append(np.asarray(cond["lengths"]))

    init_seed = torch.from_numpy(chunk_dconds[0]["seed"]).to(device)
    stacked_conds = {
        k: torch.from_numpy(np.stack([d[k] for d in chunk_dconds])).to(device)
        for k in chunk_dconds[0] if k != "seed"
    }
    if args.guidance_param != 1:
        stacked_conds["scale"] = torch.full(
            (chunks_per_take, n_takes), args.guidance_param, device=device
        )
    generator = torch.Generator(device=device).manual_seed(args.seed)
    outs = autoregressive_sample_loop(
        diffusion, model_fn, (n_takes, dataset.pose_dim, 1, args.num_frames),
        stacked_conds, init_seed, args.seed_poses,
        generator=generator, cond_precompute=cond_precompute,
    ).cpu().numpy()  # [C, B, J, 1, T]

    motions = np.concatenate([
        split_pose_vector(
            dataset.inv_transform(outs[chunk][:, :, 0, :].transpose(0, 2, 1)), n_joints
        )[0]                                                        # [B, T, J, 3]
        for chunk in range(chunks_per_take)
    ], axis=1)
    all_text = all_text[:n_takes]
    lengths = np.concatenate(all_lengths)[:n_takes] * chunks_per_take

    if os.path.exists(out_path):
        shutil.rmtree(out_path)
    os.makedirs(out_path)
    npy_path = os.path.join(out_path, "results.npy")
    np.save(npy_path, {
        "motion": motions.transpose(0, 2, 3, 1),  # [B, J, 3, T]
        "text": all_text,
        "lengths": lengths,
        "num_samples": n_takes,
        "num_chunks": chunks_per_take,
    })
    with open(npy_path.replace(".npy", ".txt"), "w") as fw:
        fw.write("\n".join(all_text))
    with open(npy_path.replace(".npy", "_len.txt"), "w") as fw:
        fw.write("\n".join(str(int(n)) for n in lengths))
    print(f"saved {npy_path}")
    return out_path


if __name__ == "__main__":
    main(sys.argv[1:])
