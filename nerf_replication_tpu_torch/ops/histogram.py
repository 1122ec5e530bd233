"""Indexed row sums (port of ``nerf_replication_tpu/ops/histogram.py``).

The JAX package sums update rows into table buckets with a sort + cumsum +
merge-extraction histogram, because the TPU's scatter-add is slow; its
float32 result is a difference of prefix sums, off by ~eps·|prefix|. The
port sums directly with ``index_add_`` in float32 (sequential on the CPU;
atomics on the card, so the order of the float32 sums varies there).
"""

from __future__ import annotations

import torch


def indexed_row_sum(idx: torch.Tensor, rows: torch.Tensor,
                    num_buckets: int) -> torch.Tensor:
    """``out[b] = sum(rows[i] for i where idx[i] == b)``: ``idx [R]`` in
    ``[0, num_buckets)``, ``rows [R, W]`` (any float dtype, summed in
    float32) → ``[num_buckets, W]`` float32."""
    out = torch.zeros((int(num_buckets), rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, idx.to(torch.int64), rows.to(torch.float32))
