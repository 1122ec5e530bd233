"""Pose->image LRU cache for repeated-view traffic (the port's copy of
``nerf_replication_tpu/serve/cache.py``).

Interactive viewers and embeddings of the same scene hammer a small set of
camera poses (the VDB-traversal paper's observation: real inspection
traffic is bursty around landmark views). A rendered NeRF view is a pure
function of (pose, intrinsics, scene), so repeated-view requests can skip
the march entirely. Keys quantize the camera-to-world matrix to
``decimals`` decimal places — close-enough poses (sub-voxel jitter from a
client's float serialization) collapse onto one entry, while genuinely new
views never alias at sane decimals.

Values are whatever the engine rendered (uint8 images + the tier they were
served at), so a cache hit faithfully replays the recorded tier rather
than masquerading as full quality.
"""

from __future__ import annotations

from collections import OrderedDict
from threading import Lock

import numpy as np


class PoseCache:
    """Thread-safe LRU keyed on quantized (c2w, H, W, focal).

    ``capacity <= 0`` disables caching (get always misses, put is a no-op)
    so call sites never branch on configuration.
    """

    def __init__(self, capacity: int = 64, decimals: int = 3):
        self.capacity = int(capacity)
        self.decimals = int(decimals)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._entries: OrderedDict = OrderedDict()
        self._lock = Lock()

    def key(self, c2w, H: int, W: int, focal: float) -> bytes:
        """Quantized lookup key: pose rounded to ``decimals``, intrinsics
        appended (two resolutions of one pose are distinct views)."""
        pose = np.round(
            np.asarray(c2w, np.float64)[:3, :4], self.decimals
        )
        # +0.0 normalizes -0.0 so a pose that rounds to zero from either
        # side produces one key
        head = (pose + 0.0).astype(np.float32).tobytes()
        meta = np.asarray(
            [float(H), float(W), round(float(focal), self.decimals)],
            np.float32,
        ).tobytes()
        return head + meta

    def get(self, key: bytes):
        """Cached value or None; a hit refreshes recency."""
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: bytes, value) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every entry (the counters stay)."""
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": (self.hits / total) if total else 0.0,
        }
