"""Host-side data loader with threaded prefetch (port of
``pointcloudmatters_tpu/data/loader.py``).

A sample's work (slicing trajectories, numpy transforms, voxel hashing, the
native grid sampler) is numpy- or C-bound and mostly releases the GIL, so a
pool of threads builds and collates batches a bounded window ahead of the
training loop, without worker processes.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

from pointcloudmatters_tpu_torch.data.collate import default_collate

__all__ = ["DataLoader"]


class DataLoader:
    """Batches of ``dataset`` in index order or, with ``shuffle``, in the
    permutation of ``np.random.RandomState(seed + epoch)``; ``epoch`` goes up
    by one at every ``__iter__``.

    Data parallelism splits every global batch of ``world * batch_size``
    rows into contiguous blocks, block ``rank`` to process ``rank``, and
    keeps only full global batches. ``(rank, world)`` is
    ``(process_index, process_count)`` where given, else the
    ``torch.distributed`` group's when it is initialised, else ``(0, 1)``.
    Every process then yields as many batches, of ``batch_size`` rows each,
    which the trainer's mean of the ranks' means needs.

    Each process collates its own block, so the padded point count of a
    batch may differ across the ranks (the collate pads to the block's
    largest cloud), and with it the kNN route (``ops/pointops.py``
    ``knn_route``: kernel 2 up to 16,384 points, kernel 12 above) or the
    builder's. Every route computes the same function, so the global step
    does not depend on it; parity tests feed the ranks equal padded widths.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 0,
        collate_fn: Callable | None = None,
        drop_last: bool = False,
        seed: int = 0,
        prefetch_batches: int = 2,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.collate_fn = collate_fn or default_collate
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = max(1, prefetch_batches)
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count

    def _proc(self) -> tuple[int, int]:
        if self.process_count is not None:
            return self.process_index or 0, self.process_count
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1

    def set_epoch(self, epoch: int) -> None:
        """The next ``__iter__`` shuffles with ``RandomState(seed + epoch)``
        (and then counts on from ``epoch + 1``)."""
        self.epoch = epoch

    def __len__(self) -> int:
        _, world = self._proc()
        if world > 1:
            # every process must yield the same number of batches
            return len(self.dataset) // (self.batch_size * world)
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState((self.seed + self.epoch) % (2**31))
            rng.shuffle(idx)
        rank, world = self._proc()
        if world > 1:
            gb = self.batch_size * world
            lo = rank * self.batch_size
            return [idx[i * gb + lo: i * gb + lo + self.batch_size]
                    for i in range(len(idx) // gb)]
        batches = [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _make_batch(self, indices: np.ndarray):
        return self.collate_fn([self.dataset[int(i)] for i in indices])

    def __iter__(self) -> Iterator:
        batches = self._index_batches()
        self.epoch += 1
        if self.num_workers <= 0:
            for b in batches:
                yield self._make_batch(b)
            return
        # workers build batches a bounded window ahead of the consumer, which
        # takes them in order; the producer stops when the consumer does
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        window = max(self.num_workers + self.prefetch_batches, 2)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                pending: deque = deque()
                it = iter(batches)
                try:
                    while not stop.is_set():
                        while len(pending) < window:
                            nxt = next(it, None)
                            if nxt is None:
                                break
                            pending.append(pool.submit(self._make_batch, nxt))
                        if not pending:
                            put(("done", None))
                            return
                        if not put(("ok", pending.popleft().result())):
                            break
                except Exception as e:  # handed to the consumer, which raises it
                    put(("err", e))
                finally:
                    for f in pending:
                        f.cancel()

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
            thread.join()
