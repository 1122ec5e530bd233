"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), loaded
through ``ctypes``. Libraries land in ``compile.artifacts.
default_artifact_dir()`` (``<repo>/build/torch_kernels/``) under the key of
``compile.artifacts.artifact_key`` (sources, flags, torch and CUDA versions,
the card's compute capability), so an edited source or another toolchain
never loads a stale build. :func:`build_all` starts one ``nvcc`` per source
at once; :func:`load` builds on first use; ``builds`` counts the ``nvcc``
runs this process started (0 in a process that found every library on
disk). Nothing here runs at import time.

Each library carries a checksum sidecar (``resil/checksum.py``) written
after it lands; a library whose bytes no longer match (a torn write) is
reported as a ``fault`` row and rebuilt, never loaded. The fault points
``artifact.save`` and ``artifact.load`` sit on those two paths, and every
build and load is a ``compile`` row (``compiles``, phase ``build`` or
``load``) with its wall time.

No ``--use_fast_math``: the kernels use IEEE ``sinf``/``cosf``/``expf`` and
division. The voxel-id arithmetic further spells out every rounding with
``__fmul_rn``/``__fadd_rn`` so that it is never contracted into an FMA.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

from ..compile.artifacts import artifact_key, artifact_path, default_artifact_dir
from ..obs.hooks import CompileTracker
from ..resil import (
    fault_point,
    report,
    verify_checksum,
    with_retry,
    write_checksum,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = default_artifact_dir()

SOURCES = {
    "fused_dda": "fused_dda.cu",
    "fused_march_full": "fused_march_full.cu",
    "fused_mlp": "fused_mlp.cu",
    "fused_mlp_bwd": "fused_mlp_bwd.cu",
    "hash_encode": "hash_encode.cu",
}
HEADERS = ("common.cuh", "dda.cuh", "mlp_rows.cuh",
           "mlp_chain_sm90.cuh", "wgmma.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
ARGTYPES = {
    "fused_dda": {
        # rays, n, grid, coarse, bbox, statics*, t_sel, valid, flat_sel,
        # n_occ, n_blk, dist, stream
        "nrt_fused_dda": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "fused_march_full": {
        # rays, n, grid, coarse, bbox, statics*, desc*, w_mat, w_bias,
        # bf16, w_heads, rgb, depth, acc, alive, n_occ, n_blk, stream
        "nrt_fused_march_full": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                 _P, _P, _P, _P, _P, _P, _P],
    },
    "fused_mlp": {
        # x, v, valid (null: K1), m, desc*, w_mat, w_bias, bf16, w_heads,
        # raw8, stream
        "nrt_fused_mlp_fwd": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P],
    },
    "fused_mlp_bwd": {
        # desc*, out (long long[4]: scratch floats per tile, K2b tiles,
        # gradient floats, most tiles a chunk)
        "nrt_fused_mlp_bwd_layout": [_P, _P],
        # K2a: x, v, valid (null: K2), draw, m, desc*, w_mat, w_bias, bf16,
        # w_heads, w_dx, scratch, live, dx, dv, stream
        "nrt_fused_mlp_bwd_rows": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P,
                                   _P, _P, _P, _P, _P, _P],
        # K2b: m, desc*, scratch, live, splits, partials, stream
        "nrt_fused_mlp_bwd_dw": [_I, _P, _P, _P, _I, _P, _P],
        # desc*, partials, n_part, grad, stream
        "nrt_fused_mlp_bwd_reduce": [_P, _P, _I, _P, _P],
    },
    "hash_encode": {
        # x, n, D, table, C, desc*, out, stream
        "nrt_hash_encode_fwd": [_P, _LL, _I, _P, _I, _P, _P, _P],
        # x, n, D, table, C, desc*, g, dtable, dx (null: none), stream
        "nrt_hash_encode_bwd": [_P, _LL, _I, _P, _I, _P, _P, _P, _P, _P],
    },
}


class MlpDescC(ctypes.Structure):
    """``struct MlpDesc`` of ``csrc/common.cuh`` (passed by pointer)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "D", "W", "skip", "c_in_pad", "c_views_pad", "n_freq_xyz",
        "n_freq_dir")]


def _ptr(t) -> ctypes.c_void_p:
    """A tensor's device address (``None`` passes a null pointer)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    """The current stream of ``device`` (the tensors' device, not a global:
    autograd runs a backward on its own thread)."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.nrt_error_string(err).decode()
        raise RuntimeError(f"{what} kernel failed to launch: {msg} ({err})")


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}
builds = 0  # nvcc runs started by this process
compiles = CompileTracker()  # this process's kernel builds and loads


def nvcc_path() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from csrc/ on the machine with the card"
    )


def _lib_path(name: str) -> str:
    key = artifact_key(name, [os.path.join(CSRC, f)
                              for f in (SOURCES[name],) + HEADERS])
    return artifact_path(BUILD_DIR, key)


def _on_disk(out: str) -> bool:
    """Whether a whole library ``out`` is on disk: a torn one (its
    checksum no longer matches) is reported and removed, to be rebuilt."""
    if not os.path.exists(out):
        return False
    with_retry(lambda: fault_point("artifact.load", path=out),
               point="artifact.load")
    if verify_checksum(out) is False:
        report("artifact.load", "checksum", path=out,
               detail="torn kernel library: rebuilt")
        os.remove(out)
        return False
    return True


def _start(name: str):
    global builds
    out = _lib_path(name)
    if _on_disk(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    builds += 1
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, SOURCES[name])]
    # graftlint: ok(blocking-under-lock: the build lock is deliberate — one build per source at a time)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _persist(tmp: str, out: str) -> None:
    fault_point("artifact.save", path=out)
    os.replace(tmp, out)
    write_checksum(out)


def _finish(name: str, out: str, tmp: str | None, proc, t0: float) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    with_retry(lambda: _persist(tmp, out), point="artifact.save")
    compiles.note_compile(f"kernel_{name}", time.perf_counter() - t0,
                          phase="build")


def build_all() -> dict[str, str]:
    """Compile every kernel source concurrently; returns the nvcc logs
    (``-Xptxas -v``: registers, shared memory, spills)."""
    with _lock:
        t0 = time.perf_counter()
        # graftlint: ok(blocking-under-lock: the build lock is deliberate — one build per source at a time)
        started = {name: _start(name) for name in SOURCES}
        try:
            for name, (out, tmp, proc) in started.items():
                # graftlint: ok(blocking-under-lock: the build lock is deliberate — one build per source at a time)
                _finish(name, out, tmp, proc, t0)
        finally:
            for out, tmp, proc in started.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return dict(build_logs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        # graftlint: ok(blocking-under-lock: the build lock is deliberate — one build per source at a time)
        out, tmp, proc = _start(name)
        # graftlint: ok(blocking-under-lock: the build lock is deliberate — one build per source at a time)
        _finish(name, out, tmp, proc, t0)
        t0 = time.perf_counter()
        lib = ctypes.CDLL(out)
        for fn, argtypes in ARGTYPES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.nrt_error_string.argtypes = [ctypes.c_int]
        lib.nrt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        # graftlint: ok(blocking-under-lock: the load's compile row, once per source)
        compiles.note_compile(f"kernel_{name}", time.perf_counter() - t0,
                              phase="load")
        return lib
