"""Hierarchical traversal caps (port of ``hierarchical_caps`` in
``nerf_replication_tpu/renderer/packed_march.py``; the packed march itself
comes with a later slice)."""

from __future__ import annotations


def hierarchical_caps(n_steps: int, options) -> tuple[int, int]:
    """Static (S_c coarse blocks per ray, K_c kept-interval budget).

    K_c defaults to ceil(S_c / 4); rays crossing more than K_c occupied
    coarse blocks are clipped and report ``truncated``."""
    r = options.coarse_block
    s_c = -(-n_steps // r)
    k_c = options.coarse_cap if options.coarse_cap > 0 else max(1, -(-s_c // 4))
    return s_c, min(k_c, s_c)
