"""Sharded, paged scene catalog: the registry past one directory listing.
(port of ``nerf_replication_tpu/fleet/store.py``, host-side: no torch).

A :class:`~.registry.SceneRegistry` parses its whole manifest up front —
fine for tens of scenes, wrong for a production catalog of thousands
(the north star: millions of users across many scenes). The
:class:`SceneStore` splits the catalog into **manifest shards** under one
root::

    store/
      index.json        # {"version": 1, "shards": [{"path": ..., "scenes": [...]}]}
      shard-0000.json   # a plain scene manifest (registry.from_manifest format)
      shard-0001.json

Only ``index.json`` (scene_id -> shard) is read eagerly; a shard's
records **page in lazily** on the first ``get`` that lands in it, and at
most ``max_loaded_shards`` stay parsed (LRU) — the resident metadata
footprint is bounded no matter how wide the catalog grows. Each shard
file IS a valid single-file manifest, so every existing manifest tool
keeps working on a shard.

Promotion is atomic end-to-end: :func:`write_sharded` (the
``to_manifest`` analogue) writes every shard through a temp-file
``os.replace`` and writes ``index.json`` **last** — a torn promotion
leaves the previous index naming the previous shards, never a
half-catalog. :meth:`SceneStore.register` (the hot-update path,
fleet/publish.py) rewrites only the owning shard, again atomically.

The store quacks like a registry (``get`` / ``in`` / ``len`` / ``ids``),
so the :class:`~.residency.ResidencyManager` takes either without
knowing which.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from dataclasses import replace

from .errors import UnknownSceneError
from .registry import SceneRecord, SceneRegistry

INDEX_BASENAME = "index.json"
STORE_VERSION = 1


def _shard_name(i: int) -> str:
    return f"shard-{i:04d}.json"


def _abs_paths(record: SceneRecord) -> SceneRecord:
    kw = {}
    if record.checkpoint and not os.path.isabs(record.checkpoint):
        kw["checkpoint"] = os.path.abspath(record.checkpoint)
    if record.grid and not os.path.isabs(record.grid):
        kw["grid"] = os.path.abspath(record.grid)
    return replace(record, **kw) if kw else record


def write_sharded(registry: SceneRegistry, root: str,
                  shard_size: int = 64) -> str:
    """Promote a registry (scan or manifest) into a sharded store.

    Scenes are split into shards of ``shard_size`` in sorted id order;
    every shard is written atomically, and the index last — the
    only-visible states are "old catalog" and "new catalog". Returns the
    index path."""
    if shard_size < 1:
        raise ValueError(f"shard_size must be >= 1, got {shard_size}")
    os.makedirs(root, exist_ok=True)
    ids = registry.ids()
    shards = []
    for i in range(0, max(len(ids), 1), shard_size):
        chunk = ids[i:i + shard_size]
        if not chunk and i > 0:
            break
        shard = _shard_name(len(shards))
        # each shard is a plain manifest: reuse the registry's atomic
        # writer so the format can never fork. Artifact paths are
        # absolutized — the source registry resolved them against ITS
        # anchor (scan root / manifest dir), not against the store.
        SceneRegistry(
            _abs_paths(registry.get(sid)) for sid in chunk
        ).to_manifest(os.path.join(root, shard))
        shards.append({"path": shard, "scenes": chunk})
    index = {"version": STORE_VERSION, "shards": shards}
    path = os.path.join(root, INDEX_BASENAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(index, fh, indent=2)
    os.replace(tmp, path)
    return path


class SceneStore:
    """Lazy, LRU-paged view over a sharded scene catalog."""

    def __init__(self, root: str, *, max_loaded_shards: int = 8):
        self.root = str(root)
        self.max_loaded_shards = int(max_loaded_shards)
        self._lock = threading.Lock()
        self._loaded: OrderedDict[str, dict[str, SceneRecord]] = OrderedDict()
        self._shard_of: dict[str, str] = {}
        self._overrides: dict[str, SceneRecord] = {}
        self.page_ins = 0          # shard files parsed (incl. re-pages)
        self.shard_evictions = 0   # parsed shards dropped to the LRU cap
        self._load_index()

    def _load_index(self) -> None:
        path = os.path.join(self.root, INDEX_BASENAME)
        with open(path, encoding="utf-8") as fh:
            index = json.load(fh)
        version = int(index.get("version", STORE_VERSION))
        if version > STORE_VERSION:
            raise ValueError(f"store index {path}: version {version} is "
                             f"newer than supported ({STORE_VERSION})")
        self._shard_of = {}
        for shard in index.get("shards", []):
            for sid in shard.get("scenes", []):
                self._shard_of[str(sid)] = str(shard["path"])

    # -- registry protocol ----------------------------------------------------

    def get(self, scene_id: str) -> SceneRecord:
        with self._lock:
            record = self._overrides.get(scene_id)
            if record is not None:
                return record
            shard = self._shard_of.get(scene_id)
            if shard is None:
                known = len(self._shard_of)
                raise UnknownSceneError(
                    scene_id,
                    f"unknown scene {scene_id!r} ({known} scenes in "
                    f"store {self.root})",
                )
            # graftlint: ok(blocking-under-lock: single-flight page-in — the lock intentionally serializes shard parses so concurrent readers of one shard never duplicate the I/O)
            records = self._page_in(shard)
            record = records.get(scene_id)
            if record is None:
                # index/shard drift (a hand-edited shard): loud, not a KeyError
                raise UnknownSceneError(
                    scene_id,
                    f"scene {scene_id!r} is indexed to {shard} but the "
                    "shard does not carry it (torn store edit?)",
                )
            return record

    def _page_in(self, shard: str) -> dict[str, SceneRecord]:
        """Parse ``shard`` on first touch; LRU-bound the parsed set.
        Caller holds the lock (shard parse is host-side JSON, cheap
        relative to any scene load it precedes)."""
        records = self._loaded.get(shard)
        if records is not None:
            self._loaded.move_to_end(shard)
            return records
        sub = SceneRegistry.from_manifest(os.path.join(self.root, shard))
        records = {sid: sub.get(sid) for sid in sub.ids()}
        self._loaded[shard] = records
        self.page_ins += 1
        while len(self._loaded) > self.max_loaded_shards:
            self._loaded.popitem(last=False)
            self.shard_evictions += 1
        return records

    def __contains__(self, scene_id: str) -> bool:
        with self._lock:
            return scene_id in self._shard_of or scene_id in self._overrides

    def __len__(self) -> int:
        with self._lock:
            extra = sum(1 for sid in self._overrides
                        if sid not in self._shard_of)
            return len(self._shard_of) + extra

    def ids(self) -> list[str]:
        with self._lock:
            return sorted(set(self._shard_of) | set(self._overrides))

    # -- hot update (fleet/publish.py) ----------------------------------------

    def register(self, record: SceneRecord) -> SceneRecord:
        """Install/replace one scene's record, write-through to its shard.

        An existing scene rewrites its owning shard atomically; a new
        scene lands in the last shard (or a fresh one) and the index is
        rewritten last, same as promotion."""
        sid = record.scene_id
        with self._lock:
            shard = self._shard_of.get(sid)
            if shard is not None:
                # graftlint: ok(blocking-under-lock: write-through shard rewrite must be atomic w.r.t. concurrent gets; hot publishes are rare)
                records = dict(self._page_in(shard))
                records[sid] = record
                SceneRegistry(records.values()).to_manifest(
                    os.path.join(self.root, shard))
                self._loaded[shard] = records
                self._overrides.pop(sid, None)
                return record
            # new scene: keep it queryable immediately; the sharded file
            # set is extended by re-promoting (write_sharded) — an
            # override never shadows an indexed record
            self._overrides[sid] = record
            return record

    def to_registry(self) -> SceneRegistry:
        """Materialize every record (pages in ALL shards) — the
        re-promotion input for :func:`write_sharded`."""
        registry = SceneRegistry()
        for sid in self.ids():
            registry.register(self.get(sid))
        return registry

    def stats(self) -> dict:
        with self._lock:
            return {
                "scenes": len(self._shard_of),
                "shards": len(set(self._shard_of.values())),
                "loaded_shards": len(self._loaded),
                "max_loaded_shards": self.max_loaded_shards,
                "page_ins": self.page_ins,
                "shard_evictions": self.shard_evictions,
                "overrides": len(self._overrides),
            }
