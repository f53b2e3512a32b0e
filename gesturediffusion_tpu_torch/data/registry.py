"""Dataset registry and loader factory.

Counterpart of gesturediffusion_tpu/data/registry.py (get_dataset_class,
get_dataset, get_dataset_loader) for the gesture datasets the port loads:
``genea2023``, ``genea2022`` and the in-memory ``synthetic`` set.  The
text and action datasets raise NotImplementedError until their slices
(ROADMAP A7, A8).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

from gesturediffusion_tpu_torch.data.collate import collate_gesture
from gesturediffusion_tpu_torch.data.genea import Genea2022, Genea2023
from gesturediffusion_tpu_torch.data.loader import DataLoader
from gesturediffusion_tpu_torch.data.synthetic import SyntheticGesture

_WAITING = {"humanml": "A7", "kit": "A7", "humanact12": "A8", "uestc": "A8"}


def get_dataset_class(name: str):
    if name == "genea2023":
        return Genea2023
    if name == "genea2022":
        return Genea2022
    if name == "synthetic":
        return SyntheticGesture
    if name in _WAITING:
        raise NotImplementedError(
            f"dataset [{name}] is not ported yet (ROADMAP {_WAITING[name]})")
    raise ValueError(f"Unsupported dataset name [{name}]")


def get_dataset(
    name: str,
    num_frames: int,
    split: str = "train",
    datapath: Optional[str] = None,
    n_seed_poses: int = 10,
    **kwargs,
):
    cls = get_dataset_class(name)
    if name == "synthetic":
        return cls(window=num_frames, n_seed_poses=n_seed_poses, **kwargs)
    kw = dict(split=split, window=num_frames, **kwargs)
    if datapath:
        kw["datapath"] = datapath
    if name == "genea2023":
        kw["n_seed_poses"] = n_seed_poses
    return cls(**kw)


def get_dataset_loader(
    name: str,
    batch_size: int,
    num_frames: int,
    split: str = "train",
    datapath: Optional[str] = None,
    num_workers: int = 8,
    n_seed_poses: int = 10,
    seed: int = 0,
    **kwargs,
) -> DataLoader:
    if name == "synthetic" and "n_items" not in kwargs:
        # two batches' worth of items, so that epochs reorder the batches
        kwargs["n_items"] = max(64, 2 * batch_size)
    dataset = get_dataset(
        name, num_frames, split, datapath, n_seed_poses=n_seed_poses, **kwargs
    )
    if len(dataset) < batch_size:
        # with drop_last the loader would yield no batch at all (say,
        # num_frames longer than every take)
        raise ValueError(
            f"dataset [{name}] split={split!r} has {len(dataset)} usable "
            f"items < batch_size={batch_size} (check --num_frames "
            f"{num_frames} against the clip lengths and the data_dir)"
        )
    # the fixed audio pad target from the dataset's own audio rate (735
    # samples a frame holds only at 22050 Hz and 30 fps)
    spf = (round(dataset.sr / dataset.fps)
           if hasattr(dataset, "sr") and hasattr(dataset, "fps") else None)
    collate_fn = (partial(collate_gesture, max_frames=num_frames, audio_samples_per_frame=spf)
                  if spf else partial(collate_gesture, max_frames=num_frames))
    return DataLoader(
        dataset,
        batch_size=batch_size,
        collate_fn=collate_fn,
        shuffle=(split == "train"),
        drop_last=True,
        num_workers=num_workers,
        seed=seed,
    )
