"""Fixed-shape batch collation (numpy).

Copy of gesturediffusion_tpu/data/collate.py (collate_gesture,
device_cond) without its optional C data path: the same arrays, filled
by numpy.  The canonical batch contract:

    motion [B, J, 1, T] float32
    cond = {mask [B,1,1,T] bool, lengths [B] i32, mfcc [B, C, 1, T],
            audio [B, L], seed [B, J, 1, S], text: list[str]}
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# gesture audio contract: 22050 Hz at 30 fps
AUDIO_SAMPLES_PER_FRAME = 22050 // 30


def lengths_to_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    return np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]


def collate_gesture(
    items: Sequence[dict], max_frames: Optional[int] = None,
    audio_samples_per_frame: int = AUDIO_SAMPLES_PER_FRAME,
) -> tuple[np.ndarray, dict]:
    """Collate gesture dataset items into the canonical batch contract.

    ``audio_samples_per_frame`` sets the fixed audio pad target (t frames x
    samples a frame); the registry passes round(sr / fps) of the dataset."""
    b = len(items)
    t = max_frames or max(it["motion"].shape[0] for it in items)
    d = items[0]["motion"].shape[1]

    motion = np.zeros((b, d, 1, t), np.float32)
    lengths = np.zeros((b,), np.int32)
    for i, it in enumerate(items):
        src = it["motion"][:t]
        motion[i, :, 0, : src.shape[0]] = src.T
        lengths[i] = min(int(it["length"]), t)

    cond: dict = {
        "mask": lengths_to_mask(lengths, t)[:, None, None, :],
        "lengths": lengths,
    }
    if "mfcc" in items[0]:
        c = items[0]["mfcc"].shape[1]
        mf = np.zeros((b, c, 1, t), np.float32)
        for i, it in enumerate(items):
            src = it["mfcc"][:t]
            mf[i, :, 0, : src.shape[0]] = src.T
        cond["mfcc"] = mf
    if "seed" in items[0]:
        s = items[0]["seed"].shape[0]
        seed = np.zeros((b, d, 1, s), np.float32)
        for i, it in enumerate(items):
            seed[i, :, 0, :] = it["seed"].T
        cond["seed"] = seed
    if "audio" in items[0]:
        la = t * audio_samples_per_frame
        audio = np.zeros((b, la), np.float32)
        for i, it in enumerate(items):
            n = min(it["audio"].shape[0], la)
            audio[i, :n] = it["audio"][:n]
        cond["audio"] = audio
    if "text" in items[0]:
        cond["text"] = [it["text"] for it in items]
    return motion, cond


def _is_host_only(key, value) -> bool:
    """True for string-valued fields, which never go to the device."""
    if key == "text" or isinstance(value, str):
        return True
    if isinstance(value, (list, tuple)):
        return len(value) == 0 or isinstance(value[0], str)
    return False


def device_cond(cond: dict) -> dict:
    """Strip host-only fields from a collated cond."""
    return {k: v for k, v in cond.items() if not _is_host_only(k, v)}
