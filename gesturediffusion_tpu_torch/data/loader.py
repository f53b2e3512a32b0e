"""Threaded prefetching data loader.

Copy of gesturediffusion_tpu/data/loader.py for one process: item fetch and
collation of batch k+1 run on a thread pool while the card works on batch
k.  The shuffled index order comes from a numpy RandomState seeded once.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Full, Queue
from typing import Callable, Iterator, Sequence

import numpy as np


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
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

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
