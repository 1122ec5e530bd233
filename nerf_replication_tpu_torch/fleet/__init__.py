"""fleet/: the multi-scene control plane — catalog, residency, QoS (port of
``nerf_replication_tpu/fleet/``; one module of the JAX package per module
here, at the same path).

One trained scene per :class:`~..serve.RenderEngine` was the last
single-tenant assumption in the serving stack. This package removes it, in
two layers (docs/fleet.md):

* **Serving data plane** — a :class:`SceneRegistry` (manifest or
  directory scan) or sharded :class:`SceneStore` (manifest shards, lazy
  page-in) names every scene's artifacts; a :class:`ResidencyManager`
  keeps an LRU of device-resident scenes under a byte budget with pinned
  leases and async prefetch — all rendered through the engine's ONE
  warmed bucket x tier family of routes, whose slot tensors a batch fills
  with its scene's weights: zero per-scene captures or route builds.
* **Control plane** — :class:`TieredResidencyManager` adds the host-RAM
  staging tier (eviction demotes, re-promotion is a device copy);
  :class:`QosController` meters tenants (token-bucket admission,
  fair-share weights, per-tenant breakers); :class:`ScenePublisher`
  hot-swaps a scene to a new checkpoint version under live traffic.

``fleet_from_cfg`` is the wiring surface: it reads the ``fleet:`` config
block, builds the catalog + residency ladder, and attaches them to an
engine.
"""

from __future__ import annotations

from .errors import (
    ResidencyOverloadError,
    SceneCompatError,
    SceneError,
    SceneLoadError,
    ScenePublishError,
    UnknownSceneError,
)
from .ladder import TieredResidencyManager
from .publish import ScenePublisher
from .qos import QosController, TenantPolicy, TenantQuotaError
from .registry import SceneRecord, SceneRegistry, checkpoint_loader
from .residency import ResidencyManager, SceneData
from .store import SceneStore, write_sharded

__all__ = [
    "QosController",
    "ResidencyManager",
    "ResidencyOverloadError",
    "SceneCompatError",
    "SceneData",
    "SceneError",
    "SceneLoadError",
    "ScenePublishError",
    "ScenePublisher",
    "SceneRecord",
    "SceneRegistry",
    "SceneStore",
    "TenantPolicy",
    "TenantQuotaError",
    "TieredResidencyManager",
    "UnknownSceneError",
    "checkpoint_loader",
    "fleet_from_cfg",
    "write_sharded",
]


def fleet_from_cfg(cfg, engine):
    """Build + attach the fleet for ``engine`` from the ``fleet:`` block.

    Returns the residency manager, or None when no discovery knob
    (``manifest`` / ``scan_dir`` / ``store_dir``) is set — single-scene
    serving, the API-compatible default. ``staging_mb > 0`` selects the
    tiered ladder (HBM eviction demotes to host RAM) over the classic
    drop-on-evict manager. The byte budgets come from
    ``fleet.hbm_budget_mb`` / ``fleet.staging_mb`` and are enforced
    against the real tensor bytes at load time."""
    from ..resil import retry_params

    f = cfg.get("fleet", {})
    manifest = str(f.get("manifest", ""))
    scan_dir = str(f.get("scan_dir", ""))
    store_dir = str(f.get("store_dir", ""))
    if not manifest and not scan_dir and not store_dir:
        return None
    if store_dir:
        registry = SceneStore(store_dir)
    elif manifest:
        registry = SceneRegistry.from_manifest(manifest)
    else:
        registry = SceneRegistry.scan(scan_dir)
    loader = checkpoint_loader(
        engine.network.state_dict(), default_near=engine.near,
        default_far=engine.far,
    )
    common = dict(
        budget_bytes=int(float(f.get("hbm_budget_mb", 256.0)) * (1 << 20)),
        prefetch=bool(f.get("prefetch", True)),
        verify_checksums=bool(f.get("verify_checksums", True)),
        cache_entries=engine.options.cache_entries,
        pose_decimals=engine.options.pose_decimals,
        retry_kw=retry_params(cfg),
    )
    staging_mb = float(f.get("staging_mb", 0.0))
    if staging_mb > 0:
        residency = TieredResidencyManager(
            registry, loader,
            staging_budget_bytes=int(staging_mb * (1 << 20)),
            staging_ttl_s=float(f.get("staging_ttl_s", 0.0)),
            resident_ttl_s=float(f.get("resident_ttl_s", 0.0)),
            **common,
        )
    else:
        residency = ResidencyManager(registry, loader, **common)
    engine.attach_fleet(
        residency, default_scene=str(f.get("default_scene", "default"))
    )
    return residency
