"""Collectives over a :class:`~.mesh.Mesh` (port of
``nerf_replication_tpu/parallel/collectives.py``).

The JAX package's collectives run inside ``shard_map`` on a named axis;
the port's run eagerly on the mesh's process group (a gloo collective
stages through the host and cannot be captured in a CUDA graph, so the
train steps keep them between captured segments: ``parallel/step.py``).
``psum`` / ``pmean`` / ``pmax`` return new tensors, as JAX's do;
``all_reduce_`` works in place. ``pmean`` is a sum followed by a division
by the world size, so two ranks give ``(a + b) / 2`` bitwise.

``COUNTS`` and ``BYTES`` count the collectives this process issued (calls
and payload bytes by kind), the way the kernel wrappers count launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import is_initialized

COUNTS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0, "barrier": 0}
BYTES = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_counts() -> None:
    for d in (COUNTS, BYTES):
        for k in d:
            d[k] = 0


def _count(kind: str, t: torch.Tensor | None = None) -> None:
    COUNTS[kind] += 1
    if t is not None:
        BYTES[kind] += t.numel() * t.element_size()


def all_reduce_(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """All-reduce ``x`` in place over ``mesh`` (``op``: sum or max)."""
    _count("all_reduce", x)
    dist.all_reduce(x, op=_OPS[op], group=mesh.group)
    return x


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-reduce sum (the DDP gradient all-reduce's seat)."""
    return all_reduce_(x.clone(), mesh, "sum")


def pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-reduce mean: the sum, then a division by the world size."""
    return psum(x, mesh).div_(mesh.size)


def pmax(x: torch.Tensor, mesh) -> torch.Tensor:
    """All-reduce max (the NGP grid EMA's merge; exact)."""
    return all_reduce_(x.clone(), mesh, "max")


def all_gather(x: torch.Tensor, mesh, tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x``, stacked on a new leading axis (``tiled``:
    concatenated along axis 0). Gloo gathers CUDA tensors too (measured on
    the H100 machine's torch, whatever torch's backend table says), so
    both backends gather where the tensor lies."""
    _count("all_gather", x)
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts) if tiled else torch.stack(parts)


def axis_index(mesh) -> int:
    """This rank's index on the data axis."""
    return 0 if mesh is None else mesh.rank


def barrier(mesh=None, name: str = "barrier") -> None:
    """Host-level barrier across the ranks; a no-op without a process
    group. ``name`` labels the call site, as in JAX."""
    if not is_initialized() or dist.get_world_size() == 1:
        return
    _count("barrier")
    group = None if mesh is None else mesh.group
    if dist.get_backend(group) == "nccl" and mesh is not None:
        dist.barrier(group=group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=group)


def broadcast_from_chief(x, mesh=None):
    """Rank 0's ``x`` on every rank: a tensor (or a list / dict of them) in
    place, any other object by pickling. Returns ``x`` (the object: rank
    0's). The identity without a process group."""
    if not is_initialized():
        return x
    group = None if mesh is None else mesh.group
    if torch.is_tensor(x):
        _count("broadcast", x)
        dist.broadcast(x, src=0, group=group)
        return x
    if isinstance(x, (list, tuple)) and x and all(torch.is_tensor(t)
                                                   for t in x):
        for t in x:
            broadcast_from_chief(t, mesh)
        return x
    if isinstance(x, dict) and x and all(torch.is_tensor(t)
                                         for t in x.values()):
        for t in x.values():
            broadcast_from_chief(t, mesh)
        return x
    _count("broadcast")
    box = [x]
    dist.broadcast_object_list(box, src=0, group=group,
                               device=None if mesh is None
                               or mesh.backend != "nccl" else mesh.device)
    return box[0]


def device_count() -> int:
    """Devices of the process group: one a rank (1 without a group)."""
    return dist.get_world_size() if is_initialized() else 1


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def tree_pmean(tree, mesh):
    """:func:`pmean` of every tensor of a dict / list / tuple, through one
    float32 buffer and one all-reduce; the same structure back, each leaf
    in its own dtype."""
    if isinstance(tree, dict):
        keys = list(tree)
        leaves = [tree[k] for k in keys]
    else:
        leaves = list(tree)
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    all_reduce_(flat, mesh, "sum").div_(mesh.size)
    out, off = [], 0
    for t in leaves:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    if isinstance(tree, dict):
        return dict(zip(keys, out))
    return type(tree)(out)
