"""The ray bank and the precrop pool split over the data axis (port of the
data-parallel half of ``nerf_replication_tpu/parallel/sharding.py``).

A JAX array sharded over the data axis holds rows ``[d·L, (d+1)·L)`` on
shard ``d``; the port's rank ``d`` holds exactly those rows and nothing
else. The tensor-parallel rule table (``tree_specs``, ``tree_shardings``,
``tree_shard_nbytes``, ``chunk_sharding``) comes with ROADMAP item 8
part 2.
"""

from __future__ import annotations

import numpy as np

from .mesh import DATA_AXIS


def data_sharding(mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row array split over the data axis
    (``n`` divisible by the world size, as ``shard_bank`` leaves it)."""
    local = n // int(mesh.shape[DATA_AXIS])
    return slice(mesh.rank * local, (mesh.rank + 1) * local)


def shard_bank(bank_rays, bank_rgbs, mesh):
    """This rank's slice of the ray bank (numpy arrays or tensors), after
    truncating the bank to a size the world size divides, and saying so: a
    dropped tail is announced on stdout and as a ``bank_shard`` row (the
    "no silent caps" rule)."""
    from ..obs import get_emitter

    n_data = int(mesh.shape[DATA_AXIS])
    total = int(bank_rays.shape[0])
    n = (total // n_data) * n_data
    dropped = total - n
    if dropped:
        print(f"[shard_bank] bank of {total} rays truncated to {n} "
              f"({dropped} dropped) to divide over {n_data} data shards")
    get_emitter().emit("bank_shard", n_rays=total, n_kept=n,
                       n_dropped=dropped, n_shards=n_data)
    sl = data_sharding(mesh, n)
    return bank_rays[sl], bank_rgbs[sl]


def shard_index_pool(pool, bank_n: int, mesh) -> np.ndarray:
    """This rank's segment of a precrop index pool, as LOCAL indices into
    its bank slice: the pool members inside ``[d·L, (d+1)·L)`` rebased by
    ``d·L``, padded by cycling to the longest segment's length (the JAX
    layout's segment ``d``). A rank with no pool member draws from its
    whole slice."""
    n_data = int(mesh.shape[DATA_AXIS])
    local = bank_n // n_data
    pool = np.asarray(pool)
    segments = []
    for d in range(n_data):
        seg = pool[(pool >= d * local) & (pool < (d + 1) * local)] - d * local
        if seg.size == 0:
            seg = np.arange(local, dtype=pool.dtype)
        segments.append(seg)
    cap = max(s.size for s in segments)
    return np.resize(segments[mesh.rank], cap)
