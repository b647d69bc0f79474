"""Infinite shuffling sampler + threaded prefetch loader (port of
``octfusion_tpu/data/loader.py``).

``InfiniteSampler`` is the JAX package's, index for index: an endless
stream of epochs, epoch e shuffled by ``np.random.RandomState(seed + e)``,
strided across ``world_size`` ranks (the reference's ``InfSampler`` /
``DistributedInfSampler``, ``datasets/sampler.py:12-57``).

``DataLoader`` collates batches on ``num_workers`` threads and yields them
in the sampler's order: batch i is the collate of the sampler's indices
[i*B, (i+1)*B), whatever ``num_workers`` is.  (The JAX loader's workers
race on one output queue, so its order is fixed only with one worker;
that order is this loader's with any number.)
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Iterator

import numpy as np

from .dataset import collate


class InfiniteSampler:
    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            order = np.arange(self.size)
            if self.shuffle:
                rng = np.random.RandomState(self.seed + epoch)
                rng.shuffle(order)
            for i in range(self.rank, self.size, self.world_size):
                yield int(order[i])
            epoch += 1


PREFETCH = 4    # batches in flight


class DataLoader:
    """Batches samples on background threads, yields collated numpy dicts
    in the sampler's order, with up to ``PREFETCH`` batches in flight."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 2, rank: int = 0,
                 world_size: int = 1):
        """``rank`` / ``world_size`` stripe the sampler: under data
        parallelism, the data index and the data axis's size."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = InfiniteSampler(len(dataset), shuffle, seed, rank,
                                       world_size)
        self.num_workers = max(1, num_workers)

    def __len__(self):
        """Batches per epoch of this rank's stripe."""
        return max(1, len(self.dataset)
                   // (self.batch_size * self.sampler.world_size))

    def _batch(self, idxs):
        return collate([self.dataset[i] for i in idxs])

    def __iter__(self):
        """Endless batches; closing the generator cancels the batches not
        yet started (a batch being collated runs to its end)."""
        indices = iter(self.sampler)
        pool = concurrent.futures.ThreadPoolExecutor(
            self.num_workers, thread_name_prefix="loader")
        pending = collections.deque()
        try:
            while True:
                while len(pending) < PREFETCH:
                    idxs = [next(indices) for _ in range(self.batch_size)]
                    pending.append(pool.submit(self._batch, idxs))
                yield pending.popleft().result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
