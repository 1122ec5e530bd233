"""Process group and mesh (port of ``nerf_replication_tpu/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` over the chips and lets XLA
place the collectives. The port's counterpart is a ``torch.distributed``
process group with one rank a card: :class:`Mesh` carries the group, this
rank's index and the world size, the rank's device and the backend, with
the JAX axis names. Collectives (``parallel/collectives.py``) take the mesh
explicitly.

* :func:`multihost_init` starts the process group when torchrun's
  environment is there (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or ``parallel.multihost: true`` asks for it (the JAX
  coordinator check). A failed init raises: a job launched with
  ``WORLD_SIZE > 1`` never trains alone on one card.
* The backend is chosen from the topology before init, and printed:
  ``nccl`` when every local rank has a card of its own, ``gloo`` when
  ranks share a card or run on the CPU (NCCL refuses two ranks on one
  card). There is no "try NCCL, then gloo".
* A rank's device is ``cuda:(LOCAL_RANK % device_count)`` unless the
  caller asks for the CPU.
* One process: :func:`make_mesh_from_cfg` returns no mesh, as JAX does with
  one device.
* The ``(data, model)`` mesh: ``model_axis`` divides the world size and
  ``data_axis`` is -1 or ``world // model_axis`` (processes cannot carve a
  sub-mesh). Rank ``r`` sits at data index ``r // M`` and model index
  ``r % M`` (JAX's ``np.asarray(devices).reshape(data, model)``). Under
  tensor parallelism (``model_axis > 1``) the mesh carries a model group
  (the ranks of one data index) and a data group (the ranks of one model
  index), made with ``torch.distributed.new_group`` on every rank in one
  order: every data group's ranks, then every model group's. With
  ``model_axis 1`` the data group is the mesh's own group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` mesh over the ranks of a process group: ``group``
    (None: the default group), this ``rank``, the world ``size``, the
    rank's ``device``, the group's ``backend``, the ``model`` axis size and,
    under tensor parallelism, this rank's ``data_group`` and
    ``model_group``."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)
    model: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size // self.model, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def data_mesh(self) -> "Mesh":
        """The data-parallel view: this rank's data group as a mesh of its
        own (rank = the data index). The mesh itself when ``model == 1``."""
        if self.model == 1:
            return self
        return Mesh(self.data_group, self.data_index,
                    self.size // self.model, self.device, self.backend)


def torchrun_env() -> bool:
    """Whether torchrun (or another launcher) set the rendezvous variables."""
    return all(k in os.environ for k in _TORCHRUN_ENV)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if is_initialized() else 0


def choose_backend(device="cuda") -> tuple[str, str]:
    """``(backend, reason)`` from the topology: ``nccl`` when each local
    rank has a card of its own, ``gloo`` when ranks share a card or run on
    the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", "ranks on the CPU"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return "nccl", f"{local_world} local ranks on {cards} cards"
    return "gloo", (f"{local_world} local ranks share {cards} card(s): NCCL "
                    "refuses two ranks on one card")


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` for a bare
    ``"cuda"`` inside a process group (made current), else ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and (
            is_initialized() or torchrun_env()):
        if not torch.cuda.is_available():
            return dev  # resolve_device raises with its own message
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def multihost_init(cfg=None, device="cuda", init_method: str | None = None,
                   rank: int | None = None, world_size: int | None = None,
                   timeout_s: float | None = None) -> bool:
    """Start the process group when a launcher's environment is there,
    ``parallel.multihost`` is set, or ``rank``/``world_size`` are given
    (tests: with a ``file://`` ``init_method``). ``timeout_s`` bounds every
    collective (a rank that waits longer raises). Returns whether a group
    exists. Init failures propagate."""
    if is_initialized():
        return True
    want = bool(cfg is not None
                and cfg.get("parallel", {}).get("multihost", False))
    want = want or torchrun_env() or rank is not None
    if (not want and rank is None
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} without a rendezvous "
            f"({', '.join(k for k in _TORCHRUN_ENV if k not in os.environ)} "
            "missing): a rank of a multi-process job never trains alone")
    if not want:
        return False
    backend, why = choose_backend(device)
    dev = rank_device(device)
    print(f"[multihost_init] backend {backend} ({why}); device {dev}")
    kw = {}
    if rank is not None:
        kw = {"rank": int(rank), "world_size": int(world_size)}
    if timeout_s is not None:
        from datetime import timedelta

        kw["timeout"] = timedelta(seconds=float(timeout_s))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)
    return True


def is_chief() -> bool:
    """Rank 0 of the process group, or the one process without a group."""
    return not is_initialized() or dist.get_rank() == 0


def make_mesh(data_axis: int = -1, model_axis: int = 1, device=None,
              group=None) -> Mesh:
    """The ``(data, model)`` mesh over the process group's ranks (any world
    size, one included), with JAX ``make_mesh``'s checks: ``model_axis``
    divides the world size; ``data_axis`` is -1 or ``world //
    model_axis``. Every rank must call it (the groups are collective)."""
    if not is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "multihost_init first")
    world = dist.get_world_size(group)
    if model_axis < 1 or world % model_axis != 0:
        raise ValueError(
            f"model_axis={model_axis} does not divide device count {world}")
    if data_axis != -1 and data_axis < 1:
        raise ValueError(f"data_axis must be -1 or >= 1, got {data_axis}")
    data = world // model_axis
    if data_axis not in (-1, data):
        over = "" if model_axis == 1 else f" over model_axis {model_axis}"
        raise ValueError(
            f"parallel.data_axis={data_axis} does not match the world size "
            f"{world}{over}: set -1 or {data} (processes cannot carve a "
            "sub-mesh out of the group)")
    backend = str(dist.get_backend(group))
    dev = rank_device("cuda" if device is None else device)
    rank = dist.get_rank(group)
    if model_axis == 1:
        return Mesh(group, rank, world, dev, backend)
    if group is not None:
        raise ValueError("a tensor-parallel mesh spans the default group")
    # every rank creates every group, in the same order, or new_group hangs
    data_group = model_group = None
    for m in range(model_axis):
        g = dist.new_group(list(range(m, world, model_axis)))
        if rank % model_axis == m:
            data_group = g
    for d in range(data):
        g = dist.new_group(list(range(d * model_axis,
                                      (d + 1) * model_axis)))
        if rank // model_axis == d:
            model_group = g
    return Mesh(group, rank, world, dev, backend, model=model_axis,
                data_group=data_group, model_group=model_group)


def make_mesh_from_cfg(cfg, device=None) -> Mesh | None:
    """The mesh ``cfg.parallel`` asks for, or None with one process (as JAX
    with one device: a single-card run)."""
    par = cfg.get("parallel", {}) or {}
    if not is_initialized() or dist.get_world_size() == 1:
        return None
    return make_mesh(int(par.get("data_axis", -1)),
                     int(par.get("model_axis", 1)), device=device)
