"""The random draws a training step makes, re-derived from the seed.

A training step's randomness is one counter-based stream on the device,
seeded before step ``s`` of a run seeded ``seed`` with the first 63 bits
(little-endian) of ``sha256(f"{seed}:{s}:{rank}")``, and drawn in a fixed
order. The reference takes the same draws in the same order, so both sides
train on the same rays, jitter and quantiles.
"""

from __future__ import annotations

import hashlib

import torch


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{int(step)}:{int(rank)}".encode())
    return int.from_bytes(digest.digest()[:8], "little") & ((1 << 63) - 1)


def step_stream(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(step_seed(seed, step))


def batch_rows(gen: torch.Generator, n_bank: int, n_rays: int, device):
    """The bank rows of one step's batch (uniform, with replacement)."""
    return torch.randint(0, n_bank, (n_rays,), generator=gen, device=device)


def uniform(gen: torch.Generator, shape, device):
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)
