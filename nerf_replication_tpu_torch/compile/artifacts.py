"""The disk half of the warm start (port of
``nerf_replication_tpu/compile/artifacts.py``).

What persists across processes in the port is the ``nvcc``-built kernel
library (``ops/kernels.py``), one ``lib<name>_<hash>.so`` per CUDA source
under ``<repo>/build/torch_kernels``. A CUDA graph cannot be serialized:
every process captures its own (``registry.py``). A library is keyed by
everything that could make a stale build load:

* the source's name and the bytes of the source and every header,
* ``ops.kernels.NVCC_FLAGS``,
* the torch and CUDA versions, and the card's compute capability (an
  upgrade or another card must miss, never load the old library),
* an optional extra tag.

So a second process whose sources, flags, toolchain and card are the
first's finds every library on disk and runs no ``nvcc``: the zero-build
restart that ``warm_source() == "disk"`` reports.
"""

from __future__ import annotations

import hashlib
import os


def default_artifact_dir() -> str:
    """``<repo>/build/torch_kernels``, where the kernel libraries land."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo_root, "build", "torch_kernels")


def toolchain_tag() -> str:
    """torch and CUDA versions and the card's compute capability (``none``
    without a card)."""
    import torch

    cap = "none"
    if torch.cuda.is_available():
        cap = "sm_%d%d" % torch.cuda.get_device_capability()
    return f"torch {torch.__version__} cuda {torch.version.cuda} {cap}"


def artifact_key(name: str, sources, extra: str = "", *,
                 flags=None, toolchain: str | None = None) -> str:
    """``<name>_<16 hex digits>``: the key of one kernel library, a hash of
    the files ``sources`` (paths, read in order), ``flags`` (default
    ``ops.kernels.NVCC_FLAGS``), ``toolchain`` (default
    :func:`toolchain_tag`) and ``extra``."""
    if flags is None:
        from ..ops.kernels import NVCC_FLAGS as flags
    if toolchain is None:
        toolchain = toolchain_tag()
    h = hashlib.sha256(
        "\x1f".join([name, " ".join(flags), toolchain, extra]).encode())
    for path in sources:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return f"{name}_{h.hexdigest()[:16]}"


def artifact_path(cache_dir: str, key: str) -> str:
    """The library file of ``key`` under ``cache_dir``."""
    return os.path.join(cache_dir, f"lib{key}.so")


def artifact_census(cache_dir: str | None = None) -> dict:
    """What a fresh process would warm from: ``{dir, n_artifacts, bytes}``
    of the kernel libraries under ``cache_dir`` (default
    :func:`default_artifact_dir`), the JAX package's keys."""
    cache_dir = cache_dir or default_artifact_dir()
    if not os.path.isdir(cache_dir):
        return {"dir": cache_dir, "n_artifacts": 0, "bytes": 0}
    names = [n for n in sorted(os.listdir(cache_dir))
             if n.startswith("lib") and n.endswith(".so")]
    total = sum(os.path.getsize(os.path.join(cache_dir, n)) for n in names)
    return {"dir": cache_dir, "n_artifacts": len(names), "bytes": total}
