"""On-device ray-batch sampling (port of
``nerf_replication_tpu/datasets/sampling.py``).

The JAX package folds its base key with the step (and process index) and
draws each batch inside the jitted step. The port's counterpart of the key
fold is :func:`step_generator`: a ``torch.Generator`` on the device whose
seed is a hash of ``(seed, step, process_index)``, made fresh for every
step. A run resumed at step ``s`` therefore draws the same batches (and the
same stratified and importance-sampling noise, which come from the same
generator in a fixed order) as an uninterrupted run does at step ``s``.
torch's Philox numbers are not JAX's threefry numbers: the two packages draw
different batches from the same seed.
"""

from __future__ import annotations

import hashlib

import torch


def step_seed(seed: int, step: int, process_index: int = 0) -> int:
    """A 63-bit seed for ``(seed, step, process_index)``."""
    digest = hashlib.sha256(
        f"{int(seed)}:{int(step)}:{int(process_index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def step_generator(seed: int, step: int, device,
                   process_index: int = 0) -> torch.Generator:
    """The per-step random stream (the ``sample_step_key`` counterpart)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(seed, step, process_index))
    return gen


def sample_rays(gen: torch.Generator, rays: torch.Tensor, rgbs: torch.Tensor,
                n_rays: int, index_pool: torch.Tensor | None = None):
    """Draw ``n_rays`` rays uniformly with replacement from the bank (on
    its device); ``index_pool`` restricts the draw to those flat indices
    (the precrop warm-up)."""
    dev = rays.device
    if index_pool is None:
        idx = torch.randint(0, rays.shape[0], (n_rays,), generator=gen,
                            device=dev)
    else:
        pick = torch.randint(0, index_pool.shape[0], (n_rays,),
                             generator=gen, device=dev)
        idx = index_pool[pick]
    return rays[idx], rgbs[idx]
