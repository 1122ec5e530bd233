"""Host-side batch samplers (port of
``nerf_replication_tpu/datasets/samplers.py``; numpy on the host, the same
draws from the same seeds).

The training hot path does not use these: ray batches are drawn on the
device inside the train step (``datasets/sampling.py``). These samplers
serve the host-side loader contract (``run --type dataset``, tasks that
iterate images rather than rays) and the config schema:
``cfg.train.batch_sampler`` / ``sampler_meta`` select them by name.

ImageSizeBatchSampler quantizes the random (H, W) of each batch to
multiples of ``divisor`` (default 32), as the JAX package does, so both
packages draw the same sizes from the same seed.
"""

from __future__ import annotations

import numpy as np


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler:
    """Epoch-seeded permutation (≙ torch RandomSampler + the reference's
    wall-clock worker seeding made deterministic)."""

    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        return iter(rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class DistributedSampler(RandomSampler):
    """Epoch-seeded permutation, padded to divisibility, rank-sliced
    (reference samplers.py:75-131)."""

    def __init__(self, n: int, rank: int, world: int, seed: int = 0,
                 shuffle: bool = True):
        super().__init__(n, seed)
        self.rank, self.world, self.shuffle = rank, world, shuffle

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        order = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        total = -(-self.n // self.world) * self.world
        # pad by tiling: a single slice under-pads when world > 2·n (e.g.
        # 1 image on 4 processes needs 3 repeats), leaving high ranks with
        # short/empty slices while __len__ still promises ceil(n/world)
        reps = -(-total // self.n)
        order = np.tile(order, reps)[:total]
        return iter(order[self.rank : total : self.world].tolist())

    def __len__(self):
        return -(-self.n // self.world)


class BatchSampler:
    """Group a sampler's indices into fixed-size batches."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


class ImageSizeBatchSampler:
    """Batches of ``(index, h, w)`` tuples with a random bucketed size per
    batch (reference samplers.py:10-47: min/max/strides from
    ``sampler_meta``).

    The reference contract: the DATASET's ``__getitem__`` receives the
    ``(index, h, w)`` tuple and resizes its item — tasks opting into this
    sampler must accept tuple indices (the template's light-stage datasets
    do; the ray-bank datasets don't, and configuring them together is a
    loud TypeError, not a silent no-op). Sizes are multiples of ``divisor``
    so the shape set is static (see the module docstring). The RNG stream
    is instance state, so successive epochs draw fresh sizes.
    """

    def __init__(self, sampler, batch_size: int, drop_last: bool = False,
                 min_hw=(256, 256), max_hw=(480, 640), divisor: int = 32,
                 seed: int = 0):
        self.sampler = sampler  # exposed: IterationBased re-seeds epochs here
        self.inner = BatchSampler(sampler, batch_size, drop_last)
        self.min_hw, self.max_hw, self.divisor = min_hw, max_hw, divisor
        self._rng = np.random.default_rng(seed)

    def _buckets(self, lo: int, hi: int):
        q = self.divisor
        return list(range((lo + q - 1) // q * q, hi // q * q + 1, q)) or [lo]

    def __iter__(self):
        hs = self._buckets(self.min_hw[0], self.max_hw[0])
        ws = self._buckets(self.min_hw[1], self.max_hw[1])
        for batch in self.inner:
            h, w = int(self._rng.choice(hs)), int(self._rng.choice(ws))
            yield [(idx, h, w) for idx in batch]

    def __len__(self):
        return len(self.inner)


class IterationBasedBatchSampler:
    """Re-yield batches from a batch sampler until exactly ``num_iterations``
    have been produced (reference samplers.py:50-72 — the ``ep_iter``
    mechanism)."""

    def __init__(self, batch_sampler, num_iterations: int, start_iter: int = 0):
        self.batch_sampler = batch_sampler
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self):
        it = self.start_iter
        epoch = 0
        while it < self.num_iterations:
            sampler = getattr(self.batch_sampler, "sampler", None)
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            epoch += 1
            produced = False
            for batch in self.batch_sampler:
                produced = True
                if it >= self.num_iterations:
                    return
                it += 1
                yield batch
            if not produced:
                raise ValueError(
                    "inner batch sampler yielded no batches (empty dataset "
                    "or empty rank slice?) — refusing to spin forever"
                )

    def __len__(self):
        return self.num_iterations - self.start_iter
