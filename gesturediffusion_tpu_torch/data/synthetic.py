"""Synthetic gesture data for tests, smoke runs and the CLIs.

Copy of gesturediffusion_tpu/data/synthetic.py: ``make_synthetic_genea2023``
and ``make_synthetic_genea2022`` write the exact on-disk layout of the
GENEA loaders (data/genea.py), filled with band-limited random-walk
"gestures" and sine-mixture "speech", the same bytes as the JAX package's
makers from the same seed; ``SyntheticGesture`` is the in-memory dataset of
the same items (random MFCC frames and raw audio, the first frames as seed
poses).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from gesturediffusion_tpu_torch.ops.mfcc import mfcc as mfcc_fn


def make_synthetic_genea2023(
    root: str,
    *,
    n_takes: int = 3,
    frames_per_take: int = 400,
    pose_dim: int = 498,
    fps: int = 30,
    sr: int = 22050,
    n_mfcc: int = 26,
    seed: int = 0,
    splits: tuple[str, ...] = ("trn", "val"),
) -> str:
    """Create a synthetic Genea2023-layout dataset under `root`.

    Returns `root` (pass as `datapath` to data.genea.Genea2023).
    """
    rng = np.random.RandomState(seed)

    for split in splits:
        src = os.path.join(root, split, "main-agent")
        os.makedirs(os.path.join(src, "motion_npy_rotpos"), exist_ok=True)
        os.makedirs(os.path.join(src, "audio_npy"), exist_ok=True)
        os.makedirs(os.path.join(src, "tsv"), exist_ok=True)

        frames = []
        take_names = []
        for k in range(n_takes):
            name = f"{split}_take_{k:03d}"
            take_names.append(name)
            nf = frames_per_take
            frames.append(nf)

            # band-limited random walk "gesture"
            motion = np.cumsum(
                rng.randn(nf, pose_dim).astype(np.float32) * 0.05, axis=0
            )
            np.save(
                os.path.join(src, "motion_npy_rotpos", name + "_main-agent.npy"),
                motion,
            )

            # sine-mixture "speech"
            n_samples = int(nf * sr / fps)
            tgrid = np.arange(n_samples) / sr
            audio = sum(
                np.sin(2 * np.pi * f * tgrid + rng.rand() * 6)
                * rng.uniform(0.05, 0.3)
                for f in rng.uniform(80, 4000, size=6)
            ).astype(np.float32)
            np.save(
                os.path.join(src, "audio_npy", name + "_main-agent.npy"), audio
            )

            # word timings
            with open(
                os.path.join(src, "tsv", name + "_main-agent.tsv"), "w"
            ) as f:
                t0 = 0.0
                words = ["hello", "world", "gesture", "model", "speech"]
                while t0 < nf / fps - 0.5:
                    dur = rng.uniform(0.2, 0.5)
                    f.write(
                        f"{t0:.3f}\t{t0 + dur:.3f}\t{words[rng.randint(5)]}\n"
                    )
                    t0 += dur + rng.uniform(0.05, 0.2)

        np.save(
            os.path.join(src, "rotpos_frames.npy"),
            np.asarray(frames, np.int64),
        )
        with open(os.path.join(root, split, "metadata.csv"), "w") as f:
            w = csv.writer(f)
            w.writerow(["take", "speaker"])
            for name in take_names:
                w.writerow([name, "spk0"])

    # normalization stats from the training motion + mfcc
    trn = os.path.join(root, "trn", "main-agent")
    motions = [
        np.load(os.path.join(trn, "motion_npy_rotpos", fn))
        for fn in sorted(os.listdir(os.path.join(trn, "motion_npy_rotpos")))
    ]
    cat = np.concatenate(motions, axis=0)
    np.save(os.path.join(trn, "rotpos_Mean.npy"), cat.mean(0).astype(np.float32))
    np.save(os.path.join(trn, "rotpos_Std.npy"), cat.std(0).astype(np.float32))

    mfccs = []
    for fn in sorted(os.listdir(os.path.join(trn, "audio_npy"))):
        audio = np.load(os.path.join(trn, "audio_npy", fn))
        mfccs.append(mfcc_fn(audio, samplerate=sr, winstep=1.0 / fps))
    mcat = np.concatenate(mfccs, axis=0)
    np.save(os.path.join(trn, "mfccs_Mean.npy"), mcat.mean(0).astype(np.float32))
    np.save(
        os.path.join(trn, "mfccs_Std.npy"),
        np.where(mcat.std(0) == 0, 1, mcat.std(0)).astype(np.float32),
    )
    return root


def make_synthetic_genea2022(
    root: str,
    *,
    n_takes: int = 3,
    frames_per_take: int = 400,
    pose_dim: int = 498,
    fps: int = 30,
    sr: int = 22050,
    seed: int = 0,
) -> str:
    """Create a synthetic Genea2022-layout dataset under `root`
    (reference layout: data_loaders/gesture/data/dataset.py:129-162)."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "motion_npy"), exist_ok=True)
    os.makedirs(os.path.join(root, "audio_npy"), exist_ok=True)
    os.makedirs(os.path.join(root, "tsv"), exist_ok=True)

    frames, names = [], []
    for k in range(n_takes):
        name = f"take_{k:03d}"
        names.append(name)
        frames.append(frames_per_take)
        motion = np.cumsum(
            rng.randn(frames_per_take, pose_dim).astype(np.float32) * 0.05, 0
        )
        np.save(os.path.join(root, "motion_npy", name + ".npy"), motion)
        n_samples = int(frames_per_take * sr / fps)
        tgrid = np.arange(n_samples) / sr
        audio = np.sin(2 * np.pi * 440 * tgrid).astype(np.float32) * 0.1
        np.save(os.path.join(root, "audio_npy", name + ".npy"), audio)
        with open(os.path.join(root, "tsv", name + ".tsv"), "w") as f:
            t0 = 0.0
            while t0 < frames_per_take / fps - 0.5:
                f.write(f"{t0:.3f}\t{t0 + 0.3:.3f}\thello\n")
                t0 += 0.5

    np.save(os.path.join(root, "frames.npy"), np.asarray(frames, np.int64))
    cat = np.concatenate(
        [np.load(os.path.join(root, "motion_npy", n + ".npy")) for n in names]
    )
    np.save(os.path.join(root, "Mean.npy"), cat.mean(0).astype(np.float32))
    np.save(os.path.join(root, "Std.npy"), cat.std(0).astype(np.float32))
    mfccs = np.concatenate(
        [
            mfcc_fn(np.load(os.path.join(root, "audio_npy", n + ".npy")),
                    samplerate=sr, winstep=1.0 / fps)
            for n in names
        ]
    )
    np.save(os.path.join(root, "mfccs_Mean.npy"),
            mfccs.mean(0).astype(np.float32))
    np.save(os.path.join(root, "mfccs_Std.npy"),
            np.where(mfccs.std(0) == 0, 1, mfccs.std(0)).astype(np.float32))
    with open(os.path.join(root, "trn_2022_v1_metadata.csv"), "w") as f:
        for name in names:
            f.write(f"{name},spk0\n")
    return root


class SyntheticGesture:
    """In-memory synthetic gesture dataset (no disk IO)."""

    def __init__(
        self,
        n_items: int = 64,
        window: int = 80,
        pose_dim: int = 498,
        mfcc_dim: int = 26,
        n_seed_poses: int = 10,
        seed: int = 0,
    ):
        rng = np.random.RandomState(seed)
        self.window = window
        self.pose_dim = pose_dim
        self.items = []
        # raw-audio samples per frame at the production 22050 Hz / 30 fps
        spf = 735
        for _ in range(n_items):
            motion = np.cumsum(
                rng.randn(window, pose_dim).astype(np.float32) * 0.05, axis=0
            )
            self.items.append(
                {
                    "motion": motion,
                    "text": "synthetic speech",
                    "length": window,
                    "mfcc": rng.randn(window, mfcc_dim).astype(np.float32),
                    "audio": rng.randn(window * spf).astype(np.float32) * 0.1,
                    "seed": motion[:n_seed_poses].copy(),
                }
            )
        self.mean = np.zeros((pose_dim,), np.float32)
        self.std = np.ones((pose_dim,), np.float32)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]

    def inv_transform(self, data):
        return data * self.std + self.mean

