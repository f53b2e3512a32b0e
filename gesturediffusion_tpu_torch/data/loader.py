"""Threaded prefetching data loader.

Copy of gesturediffusion_tpu/data/loader.py: item fetch and collation of
batch k+1 run on a thread pool while the card works on batch k.  The
shuffled index order comes from a numpy RandomState seeded once.  With
``process_count`` > 1 every process (the data ranks of a run) builds the
same order and loads only its contiguous slice of each global batch
(parallel/distributed.py:local_batch_slice); the ranks of one model group
share a data index and load the same rows.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Full, Queue
from typing import Callable, Iterator, Sequence

import numpy as np

from gesturediffusion_tpu_torch.parallel.distributed import local_batch_slice


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable[[Sequence[dict]], object],
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        seed: int = 0,
        prefetch: int = 2,
        process_count: int = 1,
        process_index: int = 0,
    ):
        """``batch_size`` is the global batch."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed)
        self._local_slice = None
        if process_count > 1:
            if not drop_last:
                raise ValueError(
                    "process-sharded loading requires drop_last=True "
                    "(a short final batch would yield unequal or empty "
                    "local shards)"
                )
            # validates divisibility + process_index range
            self._local_slice = local_batch_slice(batch_size, process_count, process_index)
        self.process_count = process_count
        self.process_index = process_index

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]
        if self._local_slice is not None:
            batches = [b[self._local_slice] for b in batches]
        return batches

    def __iter__(self) -> Iterator:
        batches = self._batches()
        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list[BaseException] = []

        def put_or_stop(x) -> bool:
            """A put that gives up once the consumer has stopped iterating."""
            while True:
                try:
                    q.put(x, timeout=0.1)
                    return True
                except Full:
                    if stop.is_set():
                        return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, batch_idx))
                        if not put_or_stop(self.collate_fn(items)):
                            return
            except BaseException as e:  # surfaces in the consumer
                error.append(e)
            finally:
                put_or_stop(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            stop.set()
            while producer.is_alive():
                try:
                    q.get_nowait()
                except Exception:
                    break


def infinite_batches(loader: DataLoader) -> Iterator:
    """Cycle the loader forever (each epoch reshuffles)."""
    while True:
        yield from loader
