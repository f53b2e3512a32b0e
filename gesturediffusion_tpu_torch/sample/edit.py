"""Motion editing CLI: ``python -m gesturediffusion_tpu_torch.sample.edit``.

PyTorch counterpart of gesturediffusion_tpu/sample/edit.py
(``build_edit_masks`` :38, ``load_edit_dataset`` :75, ``main`` :97): the
test split of a text-to-motion dataset (``humanml``, ``kit``; 196 frames)
or a gesture split (``genea2023`` / ``genea2022`` val, ``synthetic``) with
its motions, an inpainting mask that keeps the ground truth where set
(``in_between``: every frame outside [prefix_end, suffix_start) of each
length; ``upper_body``: the lower-body features of HumanML3D's codec),
and the ancestral chain with the ground truth imputed into every step's
x0 prediction (diffusion/sampling.py ``inpaint``), all repetitions from one
generator seeded with ``--seed``.  A text model is conditioned on
``--text_condition``; an empty one samples with guidance 0 (the
unconditional pass).  A gesture model runs its fast CFG path (the
encoder-layer and local-block kernels on the card).  ``results.npy``
holds xyz joints for the text datasets and the raw features for the
gesture ones.  The text datasets also get a stick-figure video a sample
and repetition (viz/plot.py, ``sampleNN_repMM.mp4`` or ``.gif``), the
ground truth's frames tinted blue under ``in_between``; each is skipped
with the JAX CLI's log line where matplotlib is not installed.  It runs
on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gesturediffusion_tpu_torch.data.collate import collate_gesture, device_cond
from gesturediffusion_tpu_torch.data.humanml import Text2MotionDatasetV2
from gesturediffusion_tpu_torch.data.humanml_utils import HML_LOWER_BODY_MASK
from gesturediffusion_tpu_torch.data.registry import TEXT_DATASETS, get_dataset
from gesturediffusion_tpu_torch.diffusion.sampling import p_sample_loop
from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
from gesturediffusion_tpu_torch.ops.motion_process import joints_of_features, recover_from_ric
from gesturediffusion_tpu_torch.utils import logger as log_lib
from gesturediffusion_tpu_torch.utils import paramutil
from gesturediffusion_tpu_torch.utils.convert import load_weights
from gesturediffusion_tpu_torch.utils.device import resolve_device
from gesturediffusion_tpu_torch.utils.model_factory import create_model_and_diffusion
from gesturediffusion_tpu_torch.utils.parser import default_output_dir, edit_args
from gesturediffusion_tpu_torch.utils.text_embedder import get_text_encoder
from gesturediffusion_tpu_torch.viz.plot import render_or_log


def build_edit_masks(
    edit_mode: str,
    motion: np.ndarray,  # [B, D, 1, T]
    lengths: np.ndarray,
    prefix_end: float = 0.25,
    suffix_start: float = 0.75,
    feature_mask: np.ndarray | None = None,
) -> np.ndarray:
    """Boolean inpainting mask [B, D, 1, T]; True keeps the ground truth."""
    b, d, _, t = motion.shape
    if edit_mode == "in_between":
        # the reference's: the ground truth everywhere, the padding after
        # the length included, but [prefix_end * length, suffix_start * length)
        mask = np.ones((b, d, 1, t), bool)
        for i, length in enumerate(np.asarray(lengths)):
            mask[i, :, :, int(float(length) * prefix_end):int(float(length) * suffix_start)] = False
        return mask
    if edit_mode == "upper_body":
        if feature_mask is None and d != HML_LOWER_BODY_MASK.shape[0]:
            raise ValueError(
                f"upper_body editing needs a per-feature mask: the built-in lower-body mask "
                f"covers the HumanML3D {HML_LOWER_BODY_MASK.shape[0]}-dim codec, not this "
                f"{d}-dim representation — pass feature_mask explicitly")
        feat = feature_mask if feature_mask is not None else HML_LOWER_BODY_MASK
        return np.broadcast_to(np.asarray(feat, bool)[None, :, None, None], (b, d, 1, t)).copy()
    raise ValueError(f"unknown edit_mode {edit_mode}")


def load_edit_dataset(args):
    """The split with motions that edit reads for ``args.dataset``."""
    if args.dataset in TEXT_DATASETS:
        return Text2MotionDatasetV2(args.data_dir or f"./dataset/{args.dataset}", split="test",
                                    dataset_name="t2m" if args.dataset == "humanml" else "kit")
    split = "val" if args.dataset in ("genea2022", "genea2023") else "train"
    return get_dataset(args.dataset, args.num_frames, split=split,
                       datapath=args.data_dir or None, n_seed_poses=args.seed_poses)


def run(argv=None) -> dict:
    """The CLI: parse, sample, write.  Returns what it computed: the output
    directory, the raw samples [R * N, D, 1, T] (model space), the ground
    truth [N, D, 1, T] and the inpainting mask."""
    args = edit_args(argv)
    device = resolve_device(args.device)
    text_data = args.dataset in TEXT_DATASETS
    max_frames = 196 if text_data else args.num_frames
    out_path = args.output_dir or default_output_dir(
        args.model_path, "edit", args.edit_mode, f"seed{args.seed}")

    log_lib.log("Loading dataset...")
    dataset = load_edit_dataset(args)
    n = min(args.num_samples, len(dataset))
    motion, cond = collate_gesture([dataset[i] for i in range(n)], max_frames=max_frames)

    log_lib.log("Creating model and diffusion...")
    model, diffusion = create_model_and_diffusion(args, dataset, device)
    load_weights(model, args.model_path)
    model.to(device).eval()

    # an empty prompt edits unconditioned (guidance 0), but only for a text
    # model: a gesture model's CFG branch would drop its seed poses
    text_conditioned = getattr(model, "cond_mode", None) == "text"
    guidance = 0.0 if text_conditioned and not args.text_condition else args.guidance_param
    cond_precompute, model_fn = select_sampling_model_fn(model, guidance, args.cond_mask_prob)
    inpainting_mask = build_edit_masks(args.edit_mode, motion, cond["lengths"],
                                       args.prefix_end, args.suffix_start)

    dcond = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in device_cond(cond).items()}
    if guidance != 1:
        dcond["scale"] = torch.full((n,), guidance, device=device)
    if text_conditioned:
        dcond["text_emb"] = torch.as_tensor(
            get_text_encoder(device=device)([args.text_condition] * n),
            dtype=torch.float32, device=device)
    if cond_precompute is not None:
        dcond = cond_precompute(dcond)
    inpaint = (torch.from_numpy(inpainting_mask).to(device), torch.from_numpy(motion).to(device))

    generator = torch.Generator(device=device).manual_seed(args.seed)
    samples, all_motions, all_lengths, all_text = [], [], [], []
    for rep_i in range(args.num_repetitions):
        log_lib.log(f"### Start sampling [repetitions #{rep_i}]")
        sample = p_sample_loop(diffusion, model_fn, motion.shape, dcond, generator=generator,
                               inpaint=inpaint)
        if text_data:
            feats = dataset.inv_transform(sample[:, :, 0, :].transpose(1, 2).cpu().numpy())
            xyz = recover_from_ric(torch.from_numpy(np.asarray(feats, np.float32)),
                                   joints_of_features(sample.shape[1]))  # [B, T, J, 3]
            all_motions.append(xyz.permute(0, 2, 3, 1).numpy())
        else:
            all_motions.append(sample.cpu().numpy())
        samples.append(sample.cpu().numpy())
        all_lengths.append(np.asarray(cond["lengths"]))
        all_text += cond.get("text", [""] * n)

    os.makedirs(out_path, exist_ok=True)
    npy_path = os.path.join(out_path, "results.npy")
    log_lib.log(f"saving results file to [{npy_path}]")
    np.save(npy_path, {
        "motion": np.concatenate(all_motions, axis=0),
        "text": all_text,
        "lengths": np.concatenate(all_lengths, axis=0),
        "num_samples": n,
        "num_repetitions": args.num_repetitions,
    })
    with open(npy_path.replace(".npy", ".txt"), "w") as fw:
        fw.write("\n".join(all_text))
    if text_data:
        chains = (paramutil.t2m_kinematic_chain if args.dataset == "humanml"
                  else paramutil.kit_kinematic_chain)
        fps = 12.5 if args.dataset == "kit" else 20
        motions = np.concatenate(all_motions, axis=0)
        for rep_i in range(args.num_repetitions):
            for i in range(n):
                length = int(np.asarray(cond["lengths"])[i])
                gt_frames = (list(range(int(length * args.prefix_end)))
                             + list(range(int(length * args.suffix_start), length))
                             if args.edit_mode == "in_between" else [])
                render_or_log(
                    log_lib.log, os.path.join(out_path, f"sample{i:02d}_rep{rep_i:02d}.mp4"),
                    chains, motions[rep_i * n + i, :, :, :length].transpose(2, 0, 1),
                    dataset=args.dataset, title=all_text[rep_i * n + i], fps=fps,
                    vis_mode=args.edit_mode, gt_frames=gt_frames)
    log_lib.log(f"[Done] Results are at [{os.path.abspath(out_path)}]")
    return {"out_path": out_path, "samples": np.concatenate(samples, axis=0), "gt": motion,
            "mask": inpainting_mask}


def main(argv=None) -> str:
    return run(argv)["out_path"]


if __name__ == "__main__":
    main(sys.argv[1:])
