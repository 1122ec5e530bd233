"""Fleet error taxonomy (port of ``nerf_replication_tpu/fleet/errors.py``)
— import-free so serve/ and fleet/ can share it without a cycle.

Every error is scene-scoped by design: a torn checkpoint or an
over-budget residency set must fail THAT scene's requests (503 at the
HTTP edge) while every other resident scene keeps serving. None of these
count as dispatch failures, so they never push the circuit breaker
toward open.
"""

from __future__ import annotations


class SceneError(RuntimeError):
    """Base for all scene-scoped serving failures."""

    def __init__(self, scene_id: str, message: str):
        super().__init__(message)
        self.scene_id = scene_id


class UnknownSceneError(SceneError):
    """The requested scene_id is not in the registry (HTTP 404)."""


class SceneLoadError(SceneError):
    """The scene's artifacts could not be materialized — missing
    checkpoint, exhausted I/O retries, or a torn/corrupt checkpoint
    caught by the tree checksum (HTTP 503 for this scene only)."""


class SceneCompatError(SceneLoadError):
    """The scene loaded but cannot ride the engine's warmed routes
    (state-dict / grid-shape / near-far mismatch) — admitting it would
    force a per-scene capture or route build, which the fleet forbids."""


class ResidencyOverloadError(SceneError):
    """The byte budget cannot admit the scene because every resident
    scene is pinned by an in-flight batch (HTTP 503 + Retry-After)."""


class ScenePublishError(SceneError):
    """A hot-update could not swap (drain timeout, concurrent publish).
    The OLD version is still serving — a failed publish never degrades
    the scene (HTTP 503 for the publish call only)."""
