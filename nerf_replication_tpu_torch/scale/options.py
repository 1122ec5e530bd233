"""The ``scale:`` config block, parsed once (port of
``nerf_replication_tpu/scale/options.py``; config/config.py declares the
defaults; docs/scaleout.md is the operator reference).

``scale.mesh`` / ``scale.mesh_shape`` are parsed here and turned into a
serving mesh by :func:`.mesh_dispatch.mesh_from_scale_cfg`."""

from __future__ import annotations

from dataclasses import dataclass, field


class MeshShapeError(ValueError):
    """``scale.mesh_shape`` is malformed or doesn't factor over devices.

    Defined here (not in a dispatch layer) so config parsing can raise it
    without importing one."""


def parse_mesh_shape(raw) -> "tuple[int, int] | None":
    """Parse a ``scale.mesh_shape: [D, M]`` value.

    ``None``/missing means "let ``scale.mesh`` decide" (the pre-2-D
    behaviour: all devices on data, model=1). ``D`` may be ``-1`` for
    "all remaining devices after carving M-wide model groups". Every
    malformed value raises :class:`MeshShapeError` naming the offence —
    a sharded-serving misconfiguration must never quietly fall back to
    replication."""
    if raw is None:
        return None
    if isinstance(raw, str):
        parts = [p for p in raw.replace(",", " ").split() if p]
    elif isinstance(raw, (list, tuple)):
        parts = list(raw)
    else:
        raise MeshShapeError(
            f"scale.mesh_shape must be a [D, M] pair, got {type(raw).__name__} {raw!r}"
        )
    if len(parts) != 2:
        raise MeshShapeError(
            f"scale.mesh_shape must have exactly 2 entries [data, model], got {raw!r}"
        )
    try:
        d, m = (int(p) for p in parts)
    except (TypeError, ValueError):
        raise MeshShapeError(
            f"scale.mesh_shape entries must be integers, got {raw!r}"
        ) from None
    if m < 1:
        raise MeshShapeError(
            f"scale.mesh_shape model size must be >= 1, got {m} (from {raw!r})"
        )
    if d != -1 and d < 1:
        raise MeshShapeError(
            f"scale.mesh_shape data size must be -1 (all remaining) or >= 1, "
            f"got {d} (from {raw!r})"
        )
    return (d, m)


@dataclass(frozen=True)
class PlacementOptions:
    """The ``scale.placement:`` sub-block: the planner's policy knobs.

    ``enabled: false`` keeps the router's passive affinity/least-loaded
    dispatch bitwise unchanged (tier-1 asserts the parity). Heat is the
    capacity ledger's windowed requests/s per scene: a scene at/above
    ``hot_rps`` is hot and gets ``hot_width`` replicas, plus one more per
    ``width_rps`` of additional heat, capped at ``max_width``. Byte
    budgets of 0 defer to each replica's own ladder budgets."""

    enabled: bool = False
    hot_width: int = 2
    max_width: int = 4
    hot_rps: float = 0.5
    width_rps: float = 2.0
    hbm_budget_bytes: int = 0
    staging_budget_bytes: int = 0
    replan_every_s: float = 10.0
    max_moves_per_step: int = 4

    @classmethod
    def from_cfg_block(cls, p) -> "PlacementOptions":
        return cls(
            enabled=bool(p.get("enabled", False)),
            hot_width=max(1, int(p.get("hot_width", 2))),
            max_width=max(1, int(p.get("max_width", 4))),
            hot_rps=float(p.get("hot_rps", 0.5)),
            width_rps=max(1e-9, float(p.get("width_rps", 2.0))),
            hbm_budget_bytes=int(p.get("hbm_budget_bytes", 0)),
            staging_budget_bytes=int(p.get("staging_budget_bytes", 0)),
            replan_every_s=float(p.get("replan_every_s", 10.0)),
            max_moves_per_step=max(1, int(p.get("max_moves_per_step", 4))),
        )


@dataclass(frozen=True)
class ScaleOptions:
    """Supervisor policy + replica-runtime knobs.

    The out/in thresholds are deliberately ASYMMETRIC (hysteresis): a
    replica is added when attainment sags below ``out_below`` (or the
    tenant deny rate climbs past ``deny_above``) for ``out_windows``
    consecutive evaluations, but removed only after ``in_windows``
    consecutive evaluations at or above the STRICTER ``in_above`` — so
    attainment hovering between the two thresholds changes nothing, and
    the fleet cannot flap. Cooldowns additionally space actions out so
    one bad window after a spawn can't immediately trigger another.
    """

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    # SLO signal (obs/metrics.slo_view attainment in [0, 1], or the
    # bench's windowed equivalent) + fleet/qos deny rate
    out_below: float = 0.90      # attainment below this asks for a replica
    in_above: float = 0.98       # attainment at/above this allows retire
    deny_above: float = 0.05     # tenant deny rate above this asks for one
    out_windows: int = 2         # consecutive bad windows before scale-out
    in_windows: int = 5          # consecutive good windows before scale-in
    cooldown_out_s: float = 30.0
    cooldown_in_s: float = 120.0
    # replica lifecycle
    heartbeat_interval_s: float = 2.0
    heartbeat_timeout_s: float = 10.0
    drain_timeout_s: float = 60.0
    # mesh-sharded dispatch (scale/mesh_dispatch.py: each bucket's ray
    # chunks over the mesh's data axis). "auto" asks for it when >1 device
    # is visible; "force" even on one device; "off" serves without a mesh.
    mesh: str = "off"
    # 2-D mesh shape [data, model] for model-parallel serving (None keeps
    # all devices on data; model > 1 shards each scene at rest).
    mesh_shape: "tuple[int, int] | None" = None
    # scene placement planner (scale/placement.py)
    placement: PlacementOptions = field(default_factory=PlacementOptions)

    @classmethod
    def from_cfg(cls, cfg) -> "ScaleOptions":
        s = cfg.get("scale", {})
        return cls(
            enabled=bool(s.get("enabled", False)),
            min_replicas=max(1, int(s.get("min_replicas", 1))),
            max_replicas=max(1, int(s.get("max_replicas", 4))),
            out_below=float(s.get("out_below", 0.90)),
            in_above=float(s.get("in_above", 0.98)),
            deny_above=float(s.get("deny_above", 0.05)),
            out_windows=max(1, int(s.get("out_windows", 2))),
            in_windows=max(1, int(s.get("in_windows", 5))),
            cooldown_out_s=float(s.get("cooldown_out_s", 30.0)),
            cooldown_in_s=float(s.get("cooldown_in_s", 120.0)),
            heartbeat_interval_s=float(s.get("heartbeat_interval_s", 2.0)),
            heartbeat_timeout_s=float(s.get("heartbeat_timeout_s", 10.0)),
            drain_timeout_s=float(s.get("drain_timeout_s", 60.0)),
            mesh=str(s.get("mesh", "off")),
            mesh_shape=parse_mesh_shape(s.get("mesh_shape", None)),
            placement=PlacementOptions.from_cfg_block(
                s.get("placement", {})),
        )



# defined beside the dispatcher; kept importable from here
from .mesh_dispatch import MeshDispatchError  # noqa: E402,F401
