"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), loaded
through ``ctypes``. Libraries land in ``<repo>/build/torch_kernels/`` under a
name that carries a hash of the sources and flags, so an edited source never
loads a stale build. :func:`build_all` starts one ``nvcc`` per source at
once; :func:`load` builds on first use. Nothing here runs at import time.

No ``--use_fast_math``: the kernels use IEEE ``sinf``/``cosf``/``expf`` and
division. The voxel-id arithmetic further spells out every rounding with
``__fmul_rn``/``__fadd_rn`` so that it is never contracted into an FMA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

SOURCES = {
    "fused_dda": "fused_dda.cu",
    "fused_march_full": "fused_march_full.cu",
    "fused_mlp": "fused_mlp.cu",
    "hash_encode": "hash_encode.cu",
}
HEADERS = ("common.cuh", "dda.cuh", "mlp_tile.cuh")
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
        # rays, n, grid, coarse, bbox, statics*, desc*, w_stream, bf16,
        # w_heads, rgb, depth, acc, alive, n_occ, n_blk, stream
        "nrt_fused_march_full": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P,
                                 _P, _P, _P, _P, _P, _P],
    },
    "fused_mlp": {
        # x, v, valid (null: K1), m, desc*, w_stream, bf16, w_heads, raw8,
        # stream
        "nrt_fused_mlp_fwd": [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P],
        # x, v, valid (null: K2), draw, m, desc*, w_stream, bf16, w_heads,
        # w_transposed, acts, partials, n_ctas, dx, dv, grad, stream
        "nrt_fused_mlp_bwd": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                              _P, _I, _P, _P, _P, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (SOURCES[name],) + HEADERS:
        with open(os.path.join(CSRC, fname), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: str, tmp: str | None, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, str]:
    """Compile every kernel source concurrently; returns the nvcc logs
    (``-Xptxas -v``: registers, shared memory, spills)."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        try:
            for name, (out, tmp, proc) in started.items():
                _finish(name, out, tmp, proc)
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
        out, tmp, proc = _start(name)
        _finish(name, out, tmp, proc)
        lib = ctypes.CDLL(out)
        for fn, argtypes in ARGTYPES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.nrt_error_string.argtypes = [ctypes.c_int]
        lib.nrt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib
