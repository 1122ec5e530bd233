"""resil/: fault injection, retry, checksums, circuit breaking, the flight
recorder, and training preemption/rollback — failure as a first-class,
injectable, telemetry-visible input (port of ``nerf_replication_tpu/resil``).

Import surface is deliberately flat: call sites touch one module, and
nothing here imports torch — every primitive is host-side, so no fault
point can sit inside a captured CUDA graph.
"""

from .breaker import BreakerOpenError, CircuitBreaker
from .checksum import (
    SIDECAR_SUFFIX,
    file_sha256,
    tree_sha256,
    verify_checksum,
    verify_tree_checksum,
    write_checksum,
    write_tree_checksum,
)
from .faults import (
    FAULT_KINDS,
    FAULT_POINTS,
    FaultPlan,
    FaultSpec,
    SimulatedKill,
    active,
    fault_point,
    injecting,
    install,
    report,
    truncate_file,
    uninstall,
)
from .flight import (
    FlightRecorder,
    dump_flight,
    get_flight_recorder,
    install_flight_recorder,
    note_flight,
    uninstall_flight_recorder,
    validate_flight_dump,
)
from .guard import DivergenceError, PreemptionGuard, check_finite
from .retry import RETRY_ATTEMPTS, retry_params, with_retry

__all__ = [
    "BreakerOpenError",
    "CircuitBreaker",
    "DivergenceError",
    "FlightRecorder",
    "FAULT_KINDS",
    "FAULT_POINTS",
    "FaultPlan",
    "FaultSpec",
    "PreemptionGuard",
    "RETRY_ATTEMPTS",
    "SIDECAR_SUFFIX",
    "SimulatedKill",
    "active",
    "check_finite",
    "dump_flight",
    "fault_point",
    "file_sha256",
    "get_flight_recorder",
    "injecting",
    "install",
    "install_flight_recorder",
    "note_flight",
    "report",
    "retry_params",
    "uninstall_flight_recorder",
    "validate_flight_dump",
    "tree_sha256",
    "truncate_file",
    "uninstall",
    "verify_checksum",
    "verify_tree_checksum",
    "with_retry",
    "write_checksum",
    "write_tree_checksum",
]
