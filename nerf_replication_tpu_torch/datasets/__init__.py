"""Dataset factory: resolves the ``*_dataset_module`` plugin key, and the
host-side loader (port of ``nerf_replication_tpu/datasets/__init__.py``).

Two data paths exist, as in the JAX package:

* :func:`make_dataset` — the training hot path: a Dataset exposing
  ``ray_bank()``, which the trainer moves to the device once and samples
  there. No loader object.
* :func:`make_data_loader` — the host-side loader contract of ``run --type
  dataset`` and of image-shaped tasks: sampler selection (random /
  sequential), batch-sampler selection (``default`` / ``image_size`` via
  ``cfg.train.batch_sampler`` + ``sampler_meta``), ``ep_iter`` iteration
  capping, a named-collator registry, and a thread prefetch of
  ``num_workers`` batches. numpy on the host throughout: the same seeds give
  the JAX loader's batches bitwise.
"""

from __future__ import annotations

from ..registry import load_attr


def _module_key(split: str) -> str:
    return "train_dataset_module" if split == "train" else "test_dataset_module"


def make_dataset(cfg, split: str = "train"):
    """The split's full dataset (images and ray bank)."""
    dataset_cls = load_attr(cfg[_module_key(split)], "Dataset")
    return dataset_cls.from_cfg(cfg, split)


def make_camera(cfg, split: str = "test"):
    """The split's camera metadata alone (H/W/focal/near/far), which
    serving needs; no image is read."""
    camera_cls = load_attr(cfg[_module_key(split)], "Camera")
    return camera_cls.from_cfg(cfg, split)


class DataLoader:
    """Minimal iterable: batch sampler → ``__getitem__`` → collate, with an
    optional ``num_workers``-thread prefetch pipeline.

    Batch entries are passed to ``dataset[entry]`` verbatim — plain indices
    from the default sampler, ``(index, h, w)`` tuples from the image_size
    sampler (the dataset-side resize contract).
    """

    def __init__(self, dataset, batch_sampler, collate, num_workers: int = 0):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate = collate
        self.num_workers = int(num_workers)

    def _load(self, batch):
        return self.collate([self.dataset[entry] for entry in batch])

    def __iter__(self):
        if self.num_workers <= 0:
            for batch in self.batch_sampler:
                yield self._load(batch)
            return
        # bounded prefetch: at most num_workers + 1 batches submitted
        # (Executor.map would submit the whole sampler at once)
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            window: deque = deque()
            it = iter(self.batch_sampler)
            try:
                for batch in it:
                    window.append(pool.submit(self._load, batch))
                    if len(window) > self.num_workers:
                        yield window.popleft().result()
                while window:
                    yield window.popleft().result()
            finally:
                for fut in window:
                    fut.cancel()

    def __len__(self):
        return len(self.batch_sampler)


def make_data_loader(cfg, split: str = "train", is_distributed: bool = False,
                     max_iter: int = -1):
    """The JAX package's loader factory. ``is_distributed`` gives each
    process its slice of the images (``DistributedSampler``), with the rank
    and world of the process group, or (0, 1) without one, as JAX's
    ``process_index()`` / ``process_count()``."""
    from ..parallel.collectives import process_count
    from ..parallel.mesh import is_initialized
    from .collate import make_collator
    from .samplers import (
        BatchSampler,
        DistributedSampler,
        ImageSizeBatchSampler,
        IterationBasedBatchSampler,
        RandomSampler,
        SequentialSampler,
    )

    dataset = make_dataset(cfg, split)
    node = cfg.train if split == "train" else cfg.test
    n = dataset.n_images if hasattr(dataset, "n_images") else len(dataset)

    shuffle = bool(node.get("shuffle", split == "train"))
    seed = int(cfg.get("seed", 0))
    if is_distributed:
        import torch.distributed as dist

        rank = dist.get_rank() if is_initialized() else 0
        sampler = DistributedSampler(n, rank, process_count(), seed=seed,
                                     shuffle=shuffle)
    elif shuffle:
        sampler = RandomSampler(n, seed=seed)
    else:
        sampler = SequentialSampler(n)

    batch_size = int(node.get("batch_size", 1))
    kind = str(node.get("batch_sampler", "default"))
    if kind == "image_size":
        meta = node.get("sampler_meta", {}) or {}
        batch_sampler = ImageSizeBatchSampler(
            sampler, batch_size,
            min_hw=tuple(meta.get("min_hw", (256, 256))),
            max_hw=tuple(meta.get("max_hw", (480, 640))),
            divisor=int(meta.get("strides", 32)),
            seed=seed,
        )
    else:
        batch_sampler = BatchSampler(sampler, batch_size)

    if max_iter == -1:
        ep_iter = int(cfg.get("ep_iter", -1))
        max_iter = ep_iter if split == "train" else -1
    if max_iter > 0:
        batch_sampler = IterationBasedBatchSampler(batch_sampler, max_iter)

    return DataLoader(
        dataset, batch_sampler, make_collator(cfg, split),
        num_workers=int(node.get("num_workers", 0)),
    )
