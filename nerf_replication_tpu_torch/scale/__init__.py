"""Horizontal scale-out for the serving stack (port of
``nerf_replication_tpu/scale``; docs/scaleout.md is the JAX package's
operator reference, and its replica, router, supervisor, fleet-metrics,
placement and launcher sections hold for the port).

* **Replica runtime** (:mod:`.replica` + :mod:`.router`) — replicas
  behind the port's HTTP server (``python -m nerf_replication_tpu_torch.
  serve``) that warm-start from the shared kernel-library store
  (``compile/artifacts.py``: a fresh replica runs no ``nvcc`` and reports
  ``warm_source == "disk"``), registered via heartbeat with a front-door
  :class:`Router` doing least-loaded dispatch with scene-affinity and
  drain-before-retire.
* **Supervisor** (:mod:`.supervisor`) — a closed loop that spawns and
  retires replicas against SLO attainment and per-tenant deny rate,
  with hysteresis, cooldowns, and min/max bounds from the ``scale:``
  config block. With an evidence source attached (the fleet metrics
  aggregator), every decision row links to the attainment series, queue
  depths, and exemplar trace ids it acted on.
* **Fleet metrics** (:mod:`.fleet_metrics`) — per-replica ``/metrics``
  scrapes merged into one Prometheus body with a ``replica`` label
  (``GET /fleet/metrics``), plus the fleet SLO view the supervisor
  reads — one signal for the loop and the operator both.
* **Placement** (:mod:`.placement`) — the scene placement planner:
  versioned plans (hot scenes replicated by measured heat, cold scenes
  bin-packed under byte budgets) the router consults before its
  passive affinity and the supervisor executes as ordered
  prefetch/demote/publish moves.
* **Launcher** (:mod:`.launcher`) — real serve child processes behind
  the ProcessReplica surface: port allocation, spawn against the shared
  kernel-library store, ready-wait (ready means warmed: the child's
  server answers only after its warm-up and captures), drain-before-
  retire, kill + 1:1 replace.

* **Mesh dispatch** (:mod:`.mesh_dispatch`) — serving on one process's
  ``(data, model)`` device mesh (``scale.mesh`` / ``scale.mesh_shape``):
  a bucket's whole chunks split over the data axis, one lane of slots,
  routes, graphs and stream a data index, and scenes sharded at rest over
  the model axis and gathered into the slots at a switch.
"""

from .fleet_metrics import (
    FleetMetricsAggregator,
    make_fleet_server,
    merge_scrapes,
)
from .launcher import LaunchError, ProcessLauncher, allocate_port
from .mesh_dispatch import (
    MeshDispatchError,
    ServeMesh,
    mesh_from_scale_cfg,
    model_size,
    validate_mesh_buckets,
)
from .options import (
    MeshShapeError,
    PlacementOptions,
    ScaleOptions,
    parse_mesh_shape,
)
from .placement import (
    PlacementExecutor,
    PlacementMove,
    PlacementPlan,
    PlacementPlanner,
    merge_heat,
)
from .replica import (
    InProcessReplica,
    ProcessReplica,
    ReplicaState,
    ReplicaUnavailableError,
)
from .router import NoCapableReplicaError, NoReplicaAvailableError, Router
from .supervisor import Supervisor

__all__ = [
    "FleetMetricsAggregator",
    "InProcessReplica",
    "LaunchError",
    "MeshDispatchError",
    "MeshShapeError",
    "NoCapableReplicaError",
    "NoReplicaAvailableError",
    "PlacementExecutor",
    "PlacementMove",
    "PlacementOptions",
    "PlacementPlan",
    "PlacementPlanner",
    "ProcessLauncher",
    "ProcessReplica",
    "ReplicaState",
    "ReplicaUnavailableError",
    "Router",
    "ScaleOptions",
    "ServeMesh",
    "Supervisor",
    "allocate_port",
    "make_fleet_server",
    "merge_heat",
    "merge_scrapes",
    "mesh_from_scale_cfg",
    "model_size",
    "parse_mesh_shape",
    "validate_mesh_buckets",
]
