"""Warm-up and compile contract of the port (``nerf_replication_tpu/
compile``): CUDA graphs captured up front, and the kernel libraries on disk.

* :mod:`.registry` — every train step, NGP step and serving route registers
  a capturable function; :meth:`AOTRegistry.compile_all` warms each up and
  captures one CUDA graph per entry before the hot loop, which then only
  replays (zero captures in the steady state).
* :mod:`.artifacts` — the ``nvcc``-built kernel libraries, keyed by
  sources, flags, toolchain and card, so that a second process builds
  nothing (``warm_source() == "disk"``).
"""

from .artifacts import (
    artifact_census,
    artifact_key,
    artifact_path,
    default_artifact_dir,
)
from .registry import AOTRegistry, CapturedFn, registry_from_cfg

__all__ = [
    "AOTRegistry",
    "CapturedFn",
    "artifact_census",
    "artifact_key",
    "artifact_path",
    "default_artifact_dir",
    "registry_from_cfg",
]
