"""In-memory synthetic gesture dataset for tests, smoke runs and the CLI.

Copy of gesturediffusion_tpu/data/synthetic.py:SyntheticGesture (the same
items from the same seed): band-limited random-walk "gestures", random
MFCC frames and raw audio, the first frames as seed poses.
"""

from __future__ import annotations

import numpy as np


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


def get_dataset(name: str, num_frames: int, n_seed_poses: int = 10):
    """The dataset registry of this slice: ``synthetic`` only.  The GENEA
    loaders wait for a later slice."""
    if name != "synthetic":
        raise NotImplementedError(
            f"dataset {name!r}: the port loads only 'synthetic' so far"
        )
    return SyntheticGesture(window=num_frames, n_seed_poses=n_seed_poses)
