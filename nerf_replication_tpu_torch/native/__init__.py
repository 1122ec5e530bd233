"""The native (C++) ray-bank builder, bound by ctypes (port of
``nerf_replication_tpu/native/__init__.py``).

``raybank.cpp`` builds the training bank on the host: pinhole rays of every
pixel (``datasets/rays.get_rays_np``) and the RGBA frames composited onto
white, one thread per group of frames. The library is compiled with ``g++``
at first use into ``<repo>/build/native/`` (git-ignored), keyed by the
source's hash and the interpreter, so a changed source is never loaded
stale. A host without a compiler takes the numpy builder, as the JAX
package does: this is host data code, not a device kernel, and both paths
give the same banks (``tests/test_torch_real.py`` holds them bitwise).
:func:`native_available` says which path this process takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "raybank.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "native")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_FAILED = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    tag = f"cpy{sys.version_info.major}{sys.version_info.minor}-" \
          f"{platform.machine()}"
    return os.path.join(BUILD_DIR, f"libraybank_{tag}_{digest}.so")


def _compile(out: str) -> bool:
    """g++ the source into ``out`` (atomically); False without g++ or on
    a failed build."""
    if shutil.which("g++") is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL | None:
    """The compiled library, built on first use; None without a compiler."""
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        out = _lib_path()
        if not os.path.exists(out) and not _compile(out):
            _FAILED = True
            return None
        lib = ctypes.CDLL(out)
        lib.build_ray_bank.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # poses
            ctypes.POINTER(ctypes.c_uint8),   # images
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n,H,W,C
            ctypes.c_float,                   # focal
            ctypes.c_int,                     # n_threads
            ctypes.POINTER(ctypes.c_float),   # rays_out
            ctypes.POINTER(ctypes.c_float),   # rgbs_out
        ]
        lib.build_ray_bank.restype = None
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return get_lib() is not None


def build_ray_bank(poses: np.ndarray, images: np.ndarray, focal: float,
                   n_threads: int | None = None):
    """(rays [n·H·W, 6] float32, rgbs [n·H·W, 3] float32) from poses [n,
    4, 4] and uint8 frames [n, H, W, 3|4]: the C++ builder when it is
    available, the numpy one otherwise."""
    n, H, W, C = images.shape
    if C not in (3, 4):
        raise ValueError(
            f"build_ray_bank needs RGB or RGBA frames, got {C} channels"
        )
    lib = get_lib()
    if lib is None:
        return _build_ray_bank_numpy(poses, images, focal)
    poses_c = np.ascontiguousarray(poses, np.float32)
    images_c = np.ascontiguousarray(images, np.uint8)
    rays = np.empty((n * H * W, 6), np.float32)
    rgbs = np.empty((n * H * W, 3), np.float32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    lib.build_ray_bank(
        poses_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        images_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, H, W, C, float(focal), int(n_threads),
        rays.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rgbs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return rays, rgbs


def _build_ray_bank_numpy(poses, images, focal):
    from ..datasets.rays import get_rays_np

    n, H, W, C = images.shape
    rays_list, rgb_list = [], []
    for f in range(n):
        rays_o, rays_d = get_rays_np(H, W, focal, poses[f])
        rays_list.append(
            np.concatenate([rays_o, rays_d], -1).reshape(-1, 6)
        )
        img = images[f].astype(np.float32) / 255.0
        if C == 4:
            img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
        rgb_list.append(img[..., :3].reshape(-1, 3).astype(np.float32))
    return (
        np.concatenate(rays_list, 0).astype(np.float32),
        np.concatenate(rgb_list, 0),
    )
