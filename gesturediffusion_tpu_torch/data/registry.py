"""Dataset loader factory.

Counterpart of gesturediffusion_tpu/data/registry.py:get_dataset_loader for
the datasets the port loads so far: ``synthetic``.  The GENEA loaders wait
for a later slice.
"""

from __future__ import annotations

from functools import partial

from gesturediffusion_tpu_torch.data.collate import collate_gesture
from gesturediffusion_tpu_torch.data.loader import DataLoader
from gesturediffusion_tpu_torch.data.synthetic import SyntheticGesture


def get_dataset_loader(
    name: str,
    batch_size: int,
    num_frames: int,
    n_seed_poses: int = 10,
    seed: int = 0,
    num_workers: int = 8,
) -> DataLoader:
    if name != "synthetic":
        raise NotImplementedError(f"dataset {name!r}: the port loads only 'synthetic' so far")
    # two batches' worth of items, so that epochs reorder the batches
    dataset = SyntheticGesture(n_items=max(64, 2 * batch_size), window=num_frames,
                               n_seed_poses=n_seed_poses)
    return DataLoader(
        dataset, batch_size=batch_size,
        collate_fn=partial(collate_gesture, max_frames=num_frames),
        shuffle=True, drop_last=True, num_workers=num_workers, seed=seed,
    )
