"""Scene registry: which scenes exist and where their artifacts live (port
of ``nerf_replication_tpu/fleet/registry.py``).

A fleet deployment names its scenes in one of two ways:

* a **manifest** — one JSON file mapping scene ids to their checkpoint
  directory, occupancy-pyramid path, and near/far/bbox metadata
  (format: docs/fleet.md, unchanged); or
* a **directory scan** — every subdirectory of a root that holds a port
  checkpoint (``latest.pt`` or ``<epoch>.pt``: ``train/checkpoint.py``'s
  layout, ``has_checkpoint``) becomes a scene named after the
  subdirectory, picking up ``occupancy_grid.npz`` beside it when present.

The registry is pure host-side metadata — no torch, no I/O beyond the
manifest/scan. Loading a scene's actual tensors is the
:class:`~.residency.ResidencyManager`'s job, through a loader such as
:func:`checkpoint_loader`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from .errors import SceneLoadError, UnknownSceneError

MANIFEST_VERSION = 1

# the same baked-grid artifact name the single-scene surfaces use
# (renderer/occupancy.default_grid_path)
GRID_BASENAME = "occupancy_grid.npz"


@dataclass(frozen=True)
class SceneRecord:
    """One scene's artifact locations + render metadata.

    ``checkpoint`` is a port checkpoint directory in the trainer's
    layout (train/checkpoint.py: ``latest.pt`` + ``<epoch>.pt``); ``grid``
    is an occupancy-pyramid ``.npz`` ("" = no grid — only admissible on a
    volume-path engine). ``near``/``far``/``bbox`` default to the
    engine's baked values when None; a scene declaring DIFFERENT bounds
    is rejected at load (SceneCompatError) because the warmed routes
    bake near/far as constants.
    """

    scene_id: str
    checkpoint: str = ""
    grid: str = ""
    near: float | None = None
    far: float | None = None
    bbox: tuple | None = None
    epoch: int = -1
    meta: dict = field(default_factory=dict)


class SceneRegistry:
    """scene_id -> SceneRecord, with manifest / directory-scan discovery."""

    def __init__(self, records=()):
        self._records: dict[str, SceneRecord] = {}
        for record in records:
            self.register(record)

    def register(self, record: SceneRecord) -> SceneRecord:
        self._records[record.scene_id] = record
        return record

    def get(self, scene_id: str) -> SceneRecord:
        record = self._records.get(scene_id)
        if record is None:
            known = ", ".join(sorted(self._records)) or "<none>"
            raise UnknownSceneError(
                scene_id, f"unknown scene {scene_id!r} (known: {known})"
            )
        return record

    def __contains__(self, scene_id: str) -> bool:
        return scene_id in self._records

    def __len__(self) -> int:
        return len(self._records)

    def ids(self) -> list[str]:
        return sorted(self._records)

    # -- discovery ------------------------------------------------------------

    @classmethod
    def from_manifest(cls, path: str) -> "SceneRegistry":
        """Load a scene manifest (JSON; format in docs/fleet.md).

        Relative artifact paths resolve against the manifest's own
        directory, so a manifest travels with its scene store."""
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        if not isinstance(data, dict) or "scenes" not in data:
            raise ValueError(f"manifest {path}: expected an object with "
                             "a 'scenes' list")
        version = int(data.get("version", MANIFEST_VERSION))
        if version > MANIFEST_VERSION:
            raise ValueError(f"manifest {path}: version {version} is newer "
                             f"than supported ({MANIFEST_VERSION})")
        base = os.path.dirname(os.path.abspath(path))

        def _resolve(p: str) -> str:
            if not p or os.path.isabs(p):
                return p
            return os.path.join(base, p)

        registry = cls()
        for entry in data["scenes"]:
            if "scene_id" not in entry:
                raise ValueError(f"manifest {path}: scene entry missing "
                                 f"'scene_id': {entry!r}")
            bbox = entry.get("bbox")
            registry.register(SceneRecord(
                scene_id=str(entry["scene_id"]),
                checkpoint=_resolve(str(entry.get("checkpoint", ""))),
                grid=_resolve(str(entry.get("grid", ""))),
                near=None if entry.get("near") is None else float(entry["near"]),
                far=None if entry.get("far") is None else float(entry["far"]),
                bbox=None if bbox is None else tuple(map(tuple, bbox)),
                epoch=int(entry.get("epoch", -1)),
                meta=dict(entry.get("meta", {})),
            ))
        return registry

    @classmethod
    def scan(cls, root: str) -> "SceneRegistry":
        """Discover scenes by directory layout: every subdirectory of
        ``root`` holding a port checkpoint becomes a scene."""
        registry = cls()
        if not os.path.isdir(root):
            return registry
        for name in sorted(os.listdir(root)):
            scene_dir = os.path.join(root, name)
            if not _has_checkpoint(scene_dir):
                continue
            grid = os.path.join(scene_dir, GRID_BASENAME)
            registry.register(SceneRecord(
                scene_id=name,
                checkpoint=scene_dir,
                grid=grid if os.path.exists(grid) else "",
            ))
        return registry

    def to_manifest(self, path: str) -> None:
        """Write the registry back out as a manifest (atomic)."""
        scenes = []
        for sid in self.ids():
            r = self._records[sid]
            entry: dict = {"scene_id": r.scene_id}
            if r.checkpoint:
                entry["checkpoint"] = r.checkpoint
            if r.grid:
                entry["grid"] = r.grid
            if r.near is not None:
                entry["near"] = r.near
            if r.far is not None:
                entry["far"] = r.far
            if r.bbox is not None:
                entry["bbox"] = [list(row) for row in r.bbox]
            if r.epoch != -1:
                entry["epoch"] = r.epoch
            if r.meta:
                entry["meta"] = r.meta
            scenes.append(entry)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"version": MANIFEST_VERSION, "scenes": scenes}, fh,
                      indent=2)
        os.replace(tmp, path)


def _has_checkpoint(model_dir: str) -> bool:
    """The port trainer's checkpoint layout: ``latest.pt`` or
    ``<epoch>.pt`` (``train/checkpoint.has_checkpoint``)."""
    from ..train.checkpoint import has_checkpoint

    return os.path.isdir(model_dir) and has_checkpoint(model_dir)


def checkpoint_loader(template: dict, *, default_near: float,
                      default_far: float):
    """The production scene loader: port checkpoint + occupancy pyramid.

    ``template`` (the engine network's state dict) names the tensors every
    fleet scene must carry — the same architecture, the contract that lets
    one set of warmed routes serve all of them (the engine's compat check
    holds the shapes). Returns host-side data (CPU tensors: the network's
    state dict, the fine grid level as bool, the bbox as float32); the
    ResidencyManager owns device placement, byte accounting, checksums,
    and fault injection."""
    import numpy as np
    import torch

    from ..renderer.occupancy import load_occupancy_pyramid
    from ..train.checkpoint import read_network
    from .errors import SceneCompatError
    from .residency import SceneData

    names = set(template)

    def load(record: SceneRecord) -> SceneData:
        if not _has_checkpoint(record.checkpoint):
            raise SceneLoadError(
                record.scene_id,
                f"scene {record.scene_id!r}: no checkpoint under "
                f"{record.checkpoint!r}",
            )
        params, _epoch = read_network(record.checkpoint, epoch=record.epoch)
        if set(params) != names:
            raise SceneCompatError(
                record.scene_id,
                f"scene {record.scene_id!r}: state dict names differ from "
                "the engine's network")
        grid = bbox = None
        if record.grid:
            # versioned pyramid artifact (checksum-verified inside); the
            # routes consume the fine level, same as engine_from_cfg
            levels, bbox = load_occupancy_pyramid(record.grid)
            grid = torch.from_numpy(np.ascontiguousarray(levels[0], bool))
            bbox = torch.from_numpy(np.asarray(bbox, np.float32))
        if record.bbox is not None:
            bbox = torch.from_numpy(np.asarray(record.bbox, np.float32))
        return SceneData(
            scene_id=record.scene_id,
            params=params,
            grid=grid,
            bbox=bbox,
            near=default_near if record.near is None else float(record.near),
            far=default_far if record.far is None else float(record.far),
        )

    return load
