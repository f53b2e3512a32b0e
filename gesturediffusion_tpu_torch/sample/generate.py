"""Gesture generation CLI: ``python -m gesturediffusion_tpu_torch.sample.generate``.

PyTorch counterpart of gesturediffusion_tpu/sample/generate.py:main
(:94-378): load the checkpoint and its args.json, take the val split of
the dataset, collate every chunk of every take, run chunked
autoregressive sampling (``--sampler ddpm|ddim|plms|dpmpp``) with the fast CFG model
function (the last ``seed_poses`` frames of a chunk seed the next, the
first chunk seeded by the dataset's poses), invert the normalisation,
split positions from rotations and write ``results.npy`` (+
``results.txt``, ``results_len.txt``), a ``<take>.bvh`` and
``<take>_gt.bvh`` per take (on the dataset's reference skeleton when it
has one), the take's audio as ``<take>.wav`` and its stick-figure video
(viz/plot.py: ``<take>.mp4`` through ffmpeg, else ``<take>.gif``; skipped
with a log line where matplotlib is not installed), muxed with the audio
into ``<take>_audio.mp4`` where ffmpeg is on the PATH.  A GENEA split
generates as many chunks a take as its shortest take holds; a dataset
without take structure (``synthetic``) one chunk a take.  It runs on the
CUDA card unless ``--device cpu`` is given.

Several ranks (GDT_COORDINATOR_ADDRESS, GDT_NUM_PROCESSES, GDT_PROCESS_ID;
parallel/distributed.py) split the takes over the data ranks
(generate.py:225-246): each samples its rows, drawing the global initial
and chain noise from the generator all ranks seed alike and keeping its
rows, so the take equals the single-process take; rank 0 gathers the takes
and writes every file, the others write none.  A take count the data width
does not divide raises, as JAX's multi-process mesh does.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np
import torch
from scipy.io import wavfile

from gesturediffusion_tpu_torch.data.collate import collate_gesture, device_cond
from gesturediffusion_tpu_torch.data.registry import get_dataset
from gesturediffusion_tpu_torch.diffusion.sampling import (
    autoregressive_sample_loop,
    sample_loop,
)
from gesturediffusion_tpu_torch.models.mdm_fastpath import select_sampling_model_fn
from gesturediffusion_tpu_torch.parallel.distributed import (
    GlobalRows,
    all_gather_cat,
    maybe_initialize,
    process_index,
    rank_device,
    using_rows,
)
from gesturediffusion_tpu_torch.parallel.mesh import make_data_mesh_for_batch
from gesturediffusion_tpu_torch.utils import logger as log_lib
from gesturediffusion_tpu_torch.utils import paramutil
from gesturediffusion_tpu_torch.utils.convert import load_weights
from gesturediffusion_tpu_torch.utils.model_factory import (
    GESTURE_DATASETS,
    create_model_and_diffusion,
)
from gesturediffusion_tpu_torch.utils.parser import default_output_dir, generate_args
from gesturediffusion_tpu_torch.viz.bvh import export_gesture_bvh, read_bvh
from gesturediffusion_tpu_torch.viz.plot import render_or_log

FPS = 30
SR = 22050


def split_pose_vector(vec: np.ndarray, n_joints: int):
    """Interleaved 6-per-joint pose vector [..., J*6] with per-joint layout
    [rx, ry, rz, px, py, pz] -> (positions [..., J, 3], rotations [..., J, 3])."""
    idx_pos = np.asarray([[i * 6 + 3, i * 6 + 4, i * 6 + 5] for i in range(n_joints)]).flatten()
    idx_rot = np.asarray([[i * 6, i * 6 + 1, i * 6 + 2] for i in range(n_joints)]).flatten()
    pos = vec[..., idx_pos].reshape(vec.shape[:-1] + (n_joints, 3))
    rot = vec[..., idx_rot].reshape(vec.shape[:-1] + (n_joints, 3))
    return pos, rot


def take_layout(dataset):
    """Per-take window layout of a dataset split, in the split's own item
    indices (those ``dataset[i]`` takes): ``(counts, starts, take_ids)``
    over the takes with at least one window in the split (``take_ids``
    indexes ``dataset.takes``), or None for a dataset without takes.
    ``samples_cumulative`` counts over the whole corpus, so a split that
    windows a slice of it (Genea2022's 70/30 split, offset ``begin``) has
    the offset subtracted (generate.py:59)."""
    if not hasattr(dataset, "samples_cumulative"):
        return None
    cum = np.asarray(dataset.samples_cumulative, dtype=np.int64)
    begin = int(getattr(dataset, "begin", 0))
    bounds = np.clip(cum - begin, 0, len(dataset))
    starts = np.concatenate([[0], bounds[:-1]])
    counts = bounds - starts
    (keep,) = np.nonzero(counts > 0)
    return counts[keep], starts[keep], keep


def load_reference_skeleton(dataset):
    """The dataset's reference BVH skeleton (joint names and offsets), read
    once, or None where the file is absent (synthetic data)."""
    path = os.path.join(getattr(dataset, "datapath", ""), "trn/main-agent/bvh/reference.bvh")
    return read_bvh(path, skip_motion=True) if os.path.isfile(path) else None


def main(argv=None) -> str:
    args = generate_args(argv)
    if args.dataset not in GESTURE_DATASETS:
        # the gesture generator only, as JAX's (generate.py:109-120)
        raise SystemExit(
            f"sample.generate is the GESTURE generator (audio-conditioned chunked AR), like "
            f"the reference fork's; --dataset {args.dataset} has no audio takes. Use "
            f"gesturediffusion_tpu_torch.sample.predict (text-to-motion) or "
            f"gesturediffusion_tpu_torch.sample.edit instead.")
    maybe_initialize(args.device)  # before anything touches the card
    device = rank_device(args.device)
    loop = sample_loop(args.sampler)
    out_path = args.output_dir or default_output_dir(
        args.model_path, "samples", f"seed{args.seed}"
    )

    dataset = get_dataset(args.dataset, args.num_frames, split="val",
                          datapath=args.data_dir or None, n_seed_poses=args.seed_poses)
    n_joints = dataset.pose_dim // 6

    # as many takes as asked and the split has, as many chunks a take as
    # its shortest take holds
    layout = take_layout(dataset)
    if layout is not None:
        per_take, take_starts, take_ids = layout
        n_takes = min(args.num_samples, len(per_take))
        chunks_per_take = int(per_take[:n_takes].min())
        step = int(getattr(dataset, "step", args.num_frames))
        if chunks_per_take > 1 and step != args.num_frames:
            # chunk k + 1 must start where chunk k ends for the seed
            # hand-off and the concatenation to form one take; Genea2022's
            # step of 30 < window makes consecutive windows overlap
            raise SystemExit(
                f"chunked AR generation needs non-overlapping windows "
                f"(dataset step {step} != num_frames {args.num_frames}); "
                f"this split's windows overlap — use --num_samples per "
                f"single window or a split with step == window (like the "
                f"genea2023 val split)"
            )
    else:
        n_takes = min(args.num_samples, len(dataset))
        chunks_per_take = 1
        take_starts = np.arange(len(dataset), dtype=np.int64)
        take_ids = take_starts
    print(f"Generating {n_takes} takes x {chunks_per_take} chunks of "
          f"{args.num_frames} frames on {device} ({args.sampler})")

    model, diffusion = create_model_and_diffusion(args, dataset, device)
    load_weights(model, args.model_path)
    model.to(device).eval()
    cond_precompute, model_fn = select_sampling_model_fn(
        model, args.guidance_param, args.cond_mask_prob
    )

    # every chunk of every take, collated on the host
    chunk_dconds, chunk_gts = [], []
    all_text, all_audio, all_lengths = [], [], []
    for chunk in range(chunks_per_take):
        items = [dataset[int(take_starts[take]) + chunk] for take in range(n_takes)]
        gt_motion, cond = collate_gesture(items, max_frames=args.num_frames)
        chunk_dconds.append(device_cond(cond))
        chunk_gts.append(gt_motion)
        all_text += cond.get("text", [""] * n_takes)
        if "audio" in cond:
            all_audio.append(cond["audio"])
        all_lengths.append(cond["lengths"])

    # the first chunk's dataset seed poses start the AR carry; later chunks'
    # are superseded by the hand-off
    if "seed" in chunk_dconds[0]:
        init_seed = torch.from_numpy(chunk_dconds[0]["seed"]).to(device)
    else:
        init_seed = torch.zeros((n_takes, dataset.pose_dim, 1, args.seed_poses),
                                dtype=torch.float32, device=device)
    stacked_conds = {
        k: torch.from_numpy(np.stack([d[k] for d in chunk_dconds])).to(device)
        for k in chunk_dconds[0] if k != "seed"
    }
    if args.guidance_param != 1:
        stacked_conds["scale"] = torch.full(
            (chunks_per_take, n_takes), args.guidance_param, device=device
        )
    generator = torch.Generator(device=device).manual_seed(args.seed)
    # several ranks: the takes split over the data ranks, each drawing the
    # global noise and keeping its rows
    mesh = make_data_mesh_for_batch(n_takes)
    rows, per = None, n_takes
    if mesh.data > 1:
        per = n_takes // mesh.data
        rows = GlobalRows(mesh.data_index * per, per, n_takes)
        mine = slice(rows.start, rows.start + per)
        stacked_conds = {k: v[:, mine] for k, v in stacked_conds.items()}
        init_seed = init_seed[mine]
        log_lib.log(f"sampling data-parallel over {mesh.data} ranks")
    with using_rows(rows):
        outs = autoregressive_sample_loop(
            diffusion, model_fn, (per, dataset.pose_dim, 1, args.num_frames),
            stacked_conds, init_seed, args.seed_poses,
            generator=generator, cond_precompute=cond_precompute, loop=loop,
        )
    # [C, B, J, 1, T], the takes of every rank in rank order
    outs = all_gather_cat(outs.transpose(0, 1), mesh.data_group).transpose(0, 1)
    outs = outs.cpu().numpy()
    if process_index() != 0:
        return out_path

    def poses(motion):  # [B, J, 1, T] in model space -> (positions, rotations)
        return split_pose_vector(dataset.inv_transform(motion[:, :, 0, :].transpose(0, 2, 1)),
                                 n_joints)

    sampled = [poses(outs[c]) for c in range(chunks_per_take)]
    truth = [poses(chunk_gts[c]) for c in range(chunks_per_take)]
    motions = np.concatenate([p for p, _ in sampled], axis=1)  # [B, T_total, J, 3]
    rotations = np.concatenate([r for _, r in sampled], axis=1)
    gt_pos = np.concatenate([p for p, _ in truth], axis=1)
    gt_rot = np.concatenate([r for _, r in truth], axis=1)
    audios = np.concatenate(all_audio, axis=1) if all_audio else None
    # text and lengths pair 1:1 with the motion rows; lengths are the take
    # totals (generate.py:282-293)
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

    chains = (paramutil.genea2022_kinematic_chain if n_joints >= 83
              else [[i, i + 1] for i in range(n_joints - 1)])
    takes = getattr(dataset, "takes", [f"take_{i}" for i in range(n_takes)])
    reference = load_reference_skeleton(dataset)
    for i in range(n_takes):
        t = int(take_ids[i])
        save_file = str(takes[t] if t < len(takes) else f"take_{t}")
        anim_path = os.path.join(out_path, save_file)
        log_lib.log(f"Saving take {i}: {save_file}")
        render_or_log(log_lib.log, anim_path + ".mp4", chains, motions[i],
                      dataset=args.dataset, title="", fps=FPS)
        export_gesture_bvh(anim_path + ".bvh", rotations[i], motions[i][:, 0, :],
                           reference=reference, fps=FPS)
        export_gesture_bvh(anim_path + "_gt.bvh", gt_rot[i], gt_pos[i][:, 0, :],
                           reference=reference, fps=FPS)
        if audios is not None:
            wavfile.write(anim_path + ".wav", SR, (audios[i] * 32767).astype(np.int16))
            if shutil.which("ffmpeg") and os.path.isfile(anim_path + ".mp4"):
                r = subprocess.run(
                    ["ffmpeg", "-y", "-loglevel", "warning", "-i", anim_path + ".mp4",
                     "-i", anim_path + ".wav", "-c:v", "copy", "-map", "0:v:0",
                     "-map", "1:a:0", "-c:a", "aac", "-b:a", "192k", anim_path + "_audio.mp4"])
                if r.returncode != 0:
                    log_lib.log(f"  (audio mux failed: ffmpeg rc {r.returncode})")
    print(f"saved {npy_path} and {n_takes} takes")
    return out_path


if __name__ == "__main__":
    main(sys.argv[1:])
