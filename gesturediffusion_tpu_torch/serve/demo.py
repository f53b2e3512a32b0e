"""Live-serving demo CLI: ``python -m gesturediffusion_tpu_torch.serve.demo``.

PyTorch counterpart of gesturediffusion_tpu/serve/demo.py.  The batch
generator (sample/generate.py) needs every audio chunk up front; this CLI
drives the incremental path instead (serve/streaming.py): chunks are fed
one at a time, as a live agent receives audio, with the seed-pose carry
held on the device, and each chunk's wall latency is reported as it
happens.

Two chunk sources:
  * default: the val split's own windows (the batch path's conditioning,
    so the output matches ``sample.generate`` for the same seed);
  * ``--wav somefile.wav``: a raw mono 22050 Hz recording, run through
    the dataset's MFCC and z-normalisation per window (chunk 0 seeds from
    zeros in z-normalised space, the dataset's mean pose).

Outputs: ``results.npy`` (the contract of sample/generate.py, with the
``serving_report``), one ``stream_<s>.bvh`` per stream and
``serving_report.json`` (first-chunk and steady-state latency, real-time
factor).  It runs on the CUDA card unless ``--device cpu`` is given.

Example (the JAX demo's serving configuration):
    python -m gesturediffusion_tpu_torch.serve.demo \\
        --model_path save/run/model000600000.pt \\
        --sampler ddim --sample_steps 50 --streams 1
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
from scipy.io import wavfile

from gesturediffusion_tpu_torch.data.collate import collate_gesture, device_cond
from gesturediffusion_tpu_torch.data.registry import get_dataset
from gesturediffusion_tpu_torch.diffusion.schedules import respacing_string
from gesturediffusion_tpu_torch.sample.generate import (
    load_reference_skeleton,
    split_pose_vector,
    take_layout,
)
from gesturediffusion_tpu_torch.serve.streaming import StreamingGestureSession
from gesturediffusion_tpu_torch.utils.convert import load_weights
from gesturediffusion_tpu_torch.utils.device import resolve_device
from gesturediffusion_tpu_torch.utils.model_factory import (
    GESTURE_DATASETS,
    create_gaussian_diffusion,
    create_model_and_diffusion,
)
from gesturediffusion_tpu_torch.utils.parser import default_output_dir, serve_args
from gesturediffusion_tpu_torch.viz.bvh import export_gesture_bvh

FPS = 30
SR = 22050


def _dataset_chunk_feeder(dataset, streams: int, num_frames: int, seed_poses: int):
    """Per-chunk cond dicts from the val split (the batch path's layout:
    stream s serves take s, chunk k is that take's k-th window), their
    count, and the seed poses of chunk 0.  A dataset without takes
    (``synthetic``) is cut into ``streams`` runs of consecutive windows."""
    layout = take_layout(dataset)
    if layout is not None:
        per_take, take_starts, _ = layout
        if streams > len(per_take):
            raise SystemExit(f"--streams {streams} > {len(per_take)} takes in the val split")
        chunks_per_take = int(per_take[:streams].min())
        starts = [int(take_starts[s]) for s in range(streams)]
    else:
        chunks_per_take = len(dataset) // streams
        if chunks_per_take == 0:
            raise SystemExit(f"--streams {streams} > {len(dataset)} windows in the val split")
        starts = [s * chunks_per_take for s in range(streams)]

    def chunk_cond(k):
        items = [dataset[starts[s] + k] for s in range(streams)]
        _, cond = collate_gesture(items, max_frames=num_frames)
        # every conditioning key but 'seed', the session's own carry
        return {k2: v for k2, v in device_cond(cond).items() if k2 != "seed"}, cond

    first_cond, cond0 = chunk_cond(0)
    if "seed" in cond0:
        init_seed = np.asarray(cond0["seed"], np.float32)
    else:
        # no seed poses in the dataset: the z-normalised mean pose (zeros),
        # as for a wav
        j = np.asarray(dataset[starts[0]]["motion"]).shape[-1]
        init_seed = np.zeros((streams, j, 1, seed_poses), np.float32)

    def conds():
        yield first_cond  # chunk 0 was collated for its seed poses
        for k in range(1, chunks_per_take):
            yield chunk_cond(k)[0]

    return conds(), chunks_per_take, init_seed


def _wav_chunk_feeder(path: str, dataset, streams: int, num_frames: int, seed_poses: int):
    """Raw-audio windows of a wav file (each given to every stream), their
    count, and zero seed poses (the z-normalised mean pose)."""
    sr, audio = wavfile.read(path)
    if sr != SR:
        raise SystemExit(f"--wav must be {SR} Hz mono (got {sr} Hz); "
                         f"resample first (e.g. ffmpeg -ar {SR})")
    # integer to float before a stereo downmix, whose mean would skip the
    # integer scale
    if np.issubdtype(audio.dtype, np.integer):
        audio = audio.astype(np.float32) / np.iinfo(audio.dtype).max
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    window = int(num_frames * SR / FPS)
    n = len(audio) // window
    if n == 0:
        raise SystemExit(f"--wav shorter than one {num_frames}-frame chunk")

    def windows():
        for k in range(n):
            yield audio[k * window: (k + 1) * window].astype(np.float32)

    init_seed = np.zeros((streams, dataset.pose_dim, 1, seed_poses), np.float32)
    return windows(), n, init_seed


def main(argv=None) -> str:
    args = serve_args(argv)
    if args.dataset not in GESTURE_DATASETS:
        raise SystemExit(
            f"serve.demo streams gestures from audio; --dataset {args.dataset} has no audio "
            f"takes. Use gesturediffusion_tpu_torch.sample.predict (text-to-motion) instead.")
    device = resolve_device(args.device)
    out_path = args.output_dir or default_output_dir(args.model_path, "serve", f"seed{args.seed}")
    if args.num_chunks < 0:
        raise SystemExit(f"--num_chunks must be >= 0, got {args.num_chunks}")

    dataset = get_dataset(args.dataset, args.num_frames, split="val",
                          datapath=args.data_dir or None, n_seed_poses=args.seed_poses)
    model, _ = create_model_and_diffusion(args, dataset, device)
    if args.wav and model.reads_audio:
        # the wav front end makes MFCCs (streaming.py:feed_audio), which a
        # wav-encoder model does not read: JAX's demo fails on it with a
        # KeyError at the model's cond['audio']; refused here before any work
        raise KeyError("audio: --wav streams MFCCs, and this checkpoint's model reads raw "
                       "audio (--use_wav_enc); stream the val split's own windows instead "
                       "(no --wav)")
    load_weights(model, args.model_path)
    # the checkpoint's own diffusion flags with the serving respacing
    diffusion = create_gaussian_diffusion(
        args, device,
        timestep_respacing=respacing_string(args.sample_steps or None, args.sampler,
                                            args.step_spacing),
    )
    session = StreamingGestureSession(
        model, guidance_param=args.guidance_param, cond_mask_prob=args.cond_mask_prob,
        sampler=args.sampler, diffusion=diffusion, streams=args.streams,
        chunk_frames=args.num_frames, seed_poses=args.seed_poses, fps=FPS, device=device,
    )

    from_wav = bool(args.wav)
    if from_wav:
        feeder, n_chunks, init_seed = _wav_chunk_feeder(
            args.wav, dataset, args.streams, args.num_frames, args.seed_poses)
    else:
        feeder, n_chunks, init_seed = _dataset_chunk_feeder(
            dataset, args.streams, args.num_frames, args.seed_poses)
    if args.num_chunks:
        n_chunks = min(n_chunks, args.num_chunks)
    print(f"Serving {n_chunks} chunks x {args.streams} stream(s) on {device}, {args.sampler}"
          + (f"-{args.sample_steps}" if args.sample_steps else "-full"))
    session.start(init_seed, rng=args.seed)

    motion_s = args.num_frames / FPS
    chunks, first_latency = [], 0.0
    for k, payload in enumerate(feeder):
        if k >= n_chunks:
            break
        if from_wav:
            out = session.feed_audio(payload, samplerate=SR,
                                     mfcc_mean=getattr(dataset, "mfcc_mean", None),
                                     mfcc_std=getattr(dataset, "mfcc_std", None))
        else:
            out = session.feed(payload)
        chunks.append(out)
        dt = session.stats().last_latency_s
        note = " (includes the kernels' build and load)" if k == 0 else ""
        print(f"chunk {k}: {dt * 1e3:7.1f} ms ({motion_s / dt:5.1f}x realtime){note}")
        if k == 0:
            first_latency = dt
            if n_chunks > 1:
                # steady-state numbers leave the first chunk out; with one
                # chunk there is no steady state and the stats keep it
                session.reset_stats()
    if not chunks:
        raise SystemExit("no chunks served (empty source)")

    stats = session.stats()
    report = {
        "streams": args.streams,
        "chunks_served": len(chunks),
        "sampler": args.sampler,
        "sample_steps": args.sample_steps or diffusion.num_timesteps,
        "first_chunk_s": round(first_latency, 4),
        "steady_mean_latency_s": round(stats.mean_latency_s, 4),
        "steady_worst_latency_s": round(stats.worst_latency_s, 4),
        "realtime_speedup": round(stats.realtime_speedup, 2),
    }
    if len(chunks) == 1:
        report["note"] = "single chunk: steady fields include the first chunk"
    print("serving report: " + json.dumps(report))

    reference = load_reference_skeleton(dataset)
    if os.path.exists(out_path):
        shutil.rmtree(out_path)
    os.makedirs(out_path)
    outs = np.stack(chunks)  # [C, B, J, 1, T]
    n_joints = dataset.pose_dim // 6
    pos_chunks, rot_chunks = [], []
    for c in range(outs.shape[0]):
        pos, rot = split_pose_vector(
            dataset.inv_transform(outs[c][:, :, 0, :].transpose(0, 2, 1)), n_joints)
        pos_chunks.append(pos)
        rot_chunks.append(rot)
    motions = np.concatenate(pos_chunks, axis=1)  # [B, T_total, J, 3]
    rotations = np.concatenate(rot_chunks, axis=1)
    np.save(os.path.join(out_path, "results.npy"), {
        "motion": motions.transpose(0, 2, 3, 1),  # [B, J, 3, T]
        "text": [""] * args.streams,
        "lengths": np.full((args.streams,), motions.shape[1]),
        "num_samples": args.streams,
        "num_chunks": len(chunks),
        "serving_report": report,
    })
    for s in range(args.streams):
        export_gesture_bvh(os.path.join(out_path, f"stream_{s}.bvh"), rotations[s],
                           motions[s][:, 0, :], reference=reference, fps=FPS)
    with open(os.path.join(out_path, "serving_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"[Done] Results are at [{os.path.abspath(out_path)}]")
    return out_path


if __name__ == "__main__":
    main(sys.argv[1:])
