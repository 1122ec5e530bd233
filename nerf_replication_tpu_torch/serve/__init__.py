"""Batched render serving on the card (port of ``nerf_replication_tpu/serve``):
a checkpoint-resident :class:`RenderEngine` with warm shape buckets, a
deadline-coalescing :class:`MicroBatcher`, the :class:`DegradationPolicy`
tier ladder and the :class:`PoseCache`. HTTP entry:
``python -m nerf_replication_tpu_torch.serve``.
"""

from .batcher import MicroBatcher, ServeFuture, ServeTimeoutError
from .cache import PoseCache
from .engine import RenderEngine, ServeOptions, engine_from_cfg
from .policy import FAMILIES, TIER_IMPL, TIER_NAMES, DegradationPolicy

__all__ = [
    "FAMILIES",
    "TIER_IMPL",
    "TIER_NAMES",
    "DegradationPolicy",
    "MicroBatcher",
    "PoseCache",
    "RenderEngine",
    "ServeFuture",
    "ServeOptions",
    "ServeTimeoutError",
    "engine_from_cfg",
]
