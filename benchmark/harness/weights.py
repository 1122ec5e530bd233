"""Seeded weights made on the device, in a few large draws.

Every matrix is LeCun-normal (standard deviation ``1/sqrt(fan_in)``), cut
from one normal draw; biases start at zero. The program and the reference
are given the same tensors.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for ``tag`` under the run's seed."""
    digest = hashlib.sha256(f"{tag}:{int(seed)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


@torch.no_grad()
def make_weights(layout, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for ``layout`` = ``[(name, shape)]``:
    a name ending in ``.weight`` is a matrix, any other a bias (zero)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    mats = [(n, s) for n, s in layout if n.endswith(".weight")]
    out = {}
    normal = torch.randn(sum(math.prod(s) for _, s in mats),
                         generator=gen, dtype=torch.float32, device=device)
    off = 0
    for name, shape in mats:
        size = math.prod(shape)
        out[name] = normal[off:off + size].view(shape) / math.sqrt(shape[1])
        off += size
    for name, shape in layout:
        if name not in out:
            out[name] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
    return {name: out[name] for name, _ in layout}


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``module``'s parameters of the same names and
    shapes; refuses a module whose parameters are not exactly these."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            "the program's parameters are not the configuration's: missing "
            f"{sorted(set(weights) - set(params))}, extra "
            f"{sorted(set(params) - set(weights))}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, "
                             f"configuration {tuple(weights[name].shape)}")
        p.copy_(weights[name])
