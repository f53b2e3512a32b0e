"""Dataset registry and loader factory.

Counterpart of gesturediffusion_tpu/data/registry.py (get_dataset_class,
get_dataset, get_dataset_loader) for the datasets the port loads: the
gesture sets ``genea2023``, ``genea2022`` and the in-memory ``synthetic``
set, the text-to-motion sets ``humanml`` and ``kit``
(data/humanml.py:Text2MotionDatasetV2) and the action-to-motion sets
``humanact12`` (data/a2m.py:HumanAct12Poses) and ``uestc``
(data/uestc.py:UESTC), whose items collate_a2m pads to ``num_frames``
(registry.py:30-37,59-63,102-105).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

from gesturediffusion_tpu_torch.data.a2m import HumanAct12Poses, collate_a2m
from gesturediffusion_tpu_torch.data.collate import collate_gesture
from gesturediffusion_tpu_torch.data.genea import Genea2022, Genea2023
from gesturediffusion_tpu_torch.data.humanml import Text2MotionDatasetV2
from gesturediffusion_tpu_torch.data.loader import DataLoader
from gesturediffusion_tpu_torch.data.synthetic import SyntheticGesture
from gesturediffusion_tpu_torch.data.uestc import UESTC

TEXT_DATASETS = ("humanml", "kit")
ACTION_DATASETS = ("humanact12", "uestc")


def get_dataset_class(name: str):
    if name == "genea2023":
        return Genea2023
    if name == "genea2022":
        return Genea2022
    if name == "synthetic":
        return SyntheticGesture
    if name in TEXT_DATASETS:
        return Text2MotionDatasetV2
    if name == "humanact12":
        return HumanAct12Poses
    if name == "uestc":
        return UESTC
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
    if name in TEXT_DATASETS:
        return cls(
            datapath or f"./dataset/{'HumanML3D' if name == 'humanml' else 'KIT-ML'}",
            split=split, dataset_name="t2m" if name == "humanml" else "kit", **kwargs,
        )
    if name in ACTION_DATASETS:
        kw = dict(split=split, num_frames=num_frames, **kwargs)
        if datapath:
            kw["datapath"] = datapath
        return cls(**kw)
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
    process_count: int = 1,
    process_index: int = 0,
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
    if name in ACTION_DATASETS:
        collate_fn = partial(collate_a2m, max_frames=num_frames)
    elif name in TEXT_DATASETS:
        # a text clip's items are padded to 196 frames, whatever num_frames
        collate_fn = partial(collate_gesture, max_frames=196)
    elif spf:
        collate_fn = partial(collate_gesture, max_frames=num_frames, audio_samples_per_frame=spf)
    else:
        collate_fn = partial(collate_gesture, max_frames=num_frames)
    return DataLoader(
        dataset,
        batch_size=batch_size,
        collate_fn=collate_fn,
        shuffle=(split == "train"),
        drop_last=True,
        num_workers=num_workers,
        seed=seed,
        process_count=process_count,
        process_index=process_index,
    )
