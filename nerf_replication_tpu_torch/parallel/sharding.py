"""Partition rules over the ``(data, model)`` mesh (port of
``nerf_replication_tpu/parallel/sharding.py``).

* The ray bank and the precrop pool split over the data axis: a JAX array
  sharded over the data axis holds rows ``[d·L, (d+1)·L)`` on shard ``d``;
  every rank of data index ``d`` holds exactly those rows.
* The tensor-parallel rule table ``_TP_RULES``, with JAX's regexes over JAX
  parameter paths: MLP hidden width column-split over the model axis
  (kernels ``P(None, "model")``, biases ``P("model")``), heads replicated,
  hash tables split by rows. A port parameter is looked up by its JAX path
  through the name map of ``convert.py`` (``jax_path``). A spec is a tuple
  with one entry per dimension of the tensor it names, in the tensor's own
  layout: a JAX ``Dense`` kernel is ``[in, out]`` and a port weight ``[out,
  in]``, so JAX's ``(None, "model")`` is the port's ``("model", None)``.
* ``tree_shard_nbytes``: the per-device peak bytes of a tree under those
  rules (each split dimension rounded up: ``ceil(dim / axis)``), what the
  fleet's HBM admission checks. ``chunk_sharding``: a rank's serve chunks.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..convert import jax_path, transposed
from .mesh import DATA_AXIS, MODEL_AXIS

# path-regex -> (kernel spec, bias spec) in JAX's layout; first match wins
_TP_RULES: list[tuple[str, tuple[tuple, tuple]]] = [
    # output heads stay replicated: tiny, and compositing wants full vectors
    (r"(alpha_linear|rgb_linear|output_linear)", ((), ())),
    # trunk / feature / view branches: column-parallel over hidden width
    (r"(pts_linear_\d+|feature_linear|views_linear_\d+)",
     ((None, MODEL_AXIS), (MODEL_AXIS,))),
    # hash/grid embedding tables: shard the (large) entries dim over model
    (r"(embeddings|table)", ((MODEL_AXIS,), (MODEL_AXIS,))),
]


def _jax_spec(path: str, ndim: int) -> tuple:
    """JAX ``spec_for_path`` on a path string and a rank, trimmed to the
    rank as JAX trims it (a shorter spec leaves trailing dims whole)."""
    if ndim == 0:
        return ()
    for pattern, (kernel_spec, bias_spec) in _TP_RULES:
        if re.search(pattern, path):
            spec = kernel_spec if ndim >= 2 else bias_spec
            return tuple(spec)[:ndim]
    return ()


def spec_for_path(name: str, leaf) -> tuple:
    """The spec of one port tensor named ``name`` (a state-dict key), one
    entry per dimension (None: whole), in the tensor's own layout."""
    ndim = int(getattr(leaf, "ndim", 0))
    spec = _jax_spec(jax_path(name), ndim)
    spec = spec + (None,) * (ndim - len(spec))
    return spec[::-1] if transposed(name) and ndim == 2 else spec


def tree_specs(tree: dict) -> dict:
    """``{name: spec}`` over a flat ``{name: tensor}`` tree (a state dict)."""
    return {k: spec_for_path(k, v) for k, v in tree.items()}


def split_dim(spec: tuple) -> int | None:
    """The dimension ``spec`` splits over the model axis (None:
    replicated); the rules split at most one."""
    dims = [i for i, ax in enumerate(spec) if ax == MODEL_AXIS]
    return dims[0] if dims else None


def _leaf_shard_nbytes(spec: tuple, leaf, mesh) -> int:
    """Per-device bytes of one leaf under ``spec`` over ``mesh``: each split
    dim rounded up to ``ceil(dim / axis_size)`` (the largest shard)."""
    dtype = getattr(leaf, "dtype", None)
    if isinstance(dtype, torch.dtype):
        n = torch.empty((), dtype=dtype).element_size()
    else:
        n = int(getattr(dtype, "itemsize", 4))
    for dim, ax in zip(tuple(leaf.shape), spec):
        size = 1 if ax is None else int(mesh.shape[ax])
        n *= -(-int(dim) // size)
    return n


def tree_shard_nbytes(tree: dict, mesh) -> int:
    """Per-device peak bytes of a flat ``{name: tensor}`` tree under the TP
    rules; with ``model = 1`` the whole tree's bytes."""
    return sum(_leaf_shard_nbytes(spec_for_path(k, v), v, mesh)
               for k, v in tree.items())


def chunk_sharding(mesh, n_chunks: int) -> slice:
    """This rank's whole chunks of ``[n_chunks, chunk, C]`` serve rays,
    split over the data axis (``n_chunks`` divisible by its size: the serve
    path's own contract)."""
    n_data = int(mesh.shape[DATA_AXIS])
    if n_chunks % n_data:
        raise ValueError(f"n_chunks={n_chunks} must divide the data axis "
                         f"({n_data})")
    local = n_chunks // n_data
    return slice(mesh.data_index * local, (mesh.data_index + 1) * local)


def data_sharding(mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row array split over the data axis (by
    its data index)
    (``n`` divisible by the world size, as ``shard_bank`` leaves it)."""
    local = n // int(mesh.shape[DATA_AXIS])
    return slice(mesh.data_index * local, (mesh.data_index + 1) * local)


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
    return np.resize(segments[mesh.data_index], cap)
