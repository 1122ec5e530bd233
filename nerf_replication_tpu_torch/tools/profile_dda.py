"""Where K4's time goes: the phase-timing build of the fused DDA + gather.

    python -m nerf_replication_tpu_torch.tools.profile_dda

Needs the card and ``nvcc``. Compiles ``csrc/fused_dda.cu`` with
``-DNRT_DDA_TIMING`` (no serving build carries it) into
``build/torch_kernels/profile/``, runs it on chip_smoke.py's serving inputs
(16,384 rays of one lego-style view, a 128³ ball grid, S = 800, r = 8, K_c
= 25, K = 192) and prints one JSON line: the SM clock cycles of each phase
summed over the rays (lane 0 of each ray's warp) and their shares; the
positions phase A and phase C evaluated (counted on the card); the timing
build's time (CUDA events, one launch); and its outputs held bitwise
against the plain version. A last line gives the serving build's device
time (torch.profiler), the counts of :mod:`.dda_emulate` on the same inputs
(positions, store sectors: counted on the CPU, not measured) and the card's
name and power limit. The timing build adds clock reads and atomics, so its
time runs above the serving build's; a phase's share times the serving
build's time estimates its time.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

PHASES = ("setup", "blocks", "cands", "slots")  # kDdaSetup.. of fused_dda.cu
N_COUNTERS = 7  # kDdaCounters


def build() -> ctypes.CDLL:
    """K4's timing build."""
    from ..ops import kernels

    out_dir = os.path.join(kernels.BUILD_DIR, "profile")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libk4_timing.so")
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-DNRT_DDA_TIMING",
           "-o", out, os.path.join(kernels.CSRC, "fused_dda.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(out)
    lib.nrt_fused_dda.argtypes = kernels.ARGTYPES["fused_dda"]["nrt_fused_dda"]
    lib.nrt_fused_dda.restype = ctypes.c_int
    lib.nrt_dda_counters.argtypes = [ctypes.c_void_p]
    lib.nrt_dda_counters.restype = ctypes.c_int
    lib.nrt_error_string.argtypes = [ctypes.c_int]
    lib.nrt_error_string.restype = ctypes.c_char_p
    return lib


def serving_inputs(torch, dev):
    """(st, rays, grid, coarse, bbox) of the serving slice (chip_smoke.py
    phase 2)."""
    from ..config import make_cfg
    from ..ops import fused_march as fm
    from ..renderer.accelerated import MarchOptions
    from .slice_inputs import SLICE_OPTS, ball_grid, view_rays

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = make_cfg(os.path.join(repo, "configs", "nerf", "lego.yaml"),
                   SLICE_OPTS)
    opts = MarchOptions.eval_from_cfg(cfg)
    bbox = torch.tensor(cfg.train_dataset.scene_bbox, dtype=torch.float32,
                        device=dev)
    rays = torch.from_numpy(view_rays(30.0, 128)).to(dev)
    return fm._prepare(rays, 2.0, 6.0, torch.from_numpy(ball_grid()).to(dev),
                       bbox, opts)


def phase_split(torch, inputs) -> dict:
    """One timed launch of K4's timing build on ``inputs``: cycles by phase,
    shares, positions, rays, event ms; raises if its outputs are not bitwise
    the plain version's."""
    from ..ops import fused_march as fm

    st, rays, grid, coarse, bbox = inputs
    lib = build()
    n, k, dev = rays.shape[0], st.k_sel, rays.device
    outs = [torch.empty((n, k), dtype=torch.float32, device=dev),
            torch.empty((n, k), dtype=torch.bool, device=dev),
            torch.empty((n, k), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev)]
    stc = fm._statics_c(st)
    counters = (ctypes.c_ulonglong * N_COUNTERS)()

    def launch():
        err = lib.nrt_fused_dda(
            fm._ptr(rays), n, fm._ptr(grid), fm._ptr(coarse), fm._ptr(bbox),
            ctypes.byref(stc), *[fm._ptr(t) for t in outs], fm._stream(dev))
        if err:
            raise RuntimeError(lib.nrt_error_string(err).decode())

    def read():
        if lib.nrt_dda_counters(counters):
            raise RuntimeError("reading the phase counters failed")
        return list(counters)

    launch()
    torch.cuda.synchronize()
    read()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    c = read()
    ref = fm.dda_block_plain(st, rays, grid, coarse, bbox)
    for name, a, b in zip(("t_sel", "valid", "flat_sel", "n_occ", "n_blk",
                           "dist"), outs, ref):
        if not torch.equal(a, b):
            raise RuntimeError(f"K4 timing build: {name} differs from the "
                               f"plain version")
    cycles = dict(zip(PHASES, c[:4]))
    total = sum(cycles.values())
    return {"timing_build_ms": start.elapsed_time(end),
            "cycles": cycles,
            "share": {p: v / total for p, v in cycles.items()},
            "positions_blocks": c[4], "positions_cands": c[5],
            "rays": c[6], "mean_ray_cycles": total / max(c[6], 1)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_dda: no CUDA device visible", file=sys.stderr)
        return 2
    from ..ops import fused_march as fm
    from ..utils.platform import resolve_device
    from .dda_emulate import emulate_k4
    from .profile_fused_mlp import device_ms

    dev = resolve_device("cuda")
    inputs = serving_inputs(torch, dev)
    print(json.dumps(phase_split(torch, inputs)), flush=True)
    last = {}
    with torch.inference_mode():
        ms = device_ms(torch, lambda: fm.dda_block(*inputs), 20,
                       key=lambda name: "k4" if "dda" in name else "other")
    last["serving_build_device_ms"] = ms.get("k4", 0.0)
    _, last["cpu_counts"] = emulate_k4(
        *[x.cpu() if isinstance(x, torch.Tensor) else x for x in inputs])
    last["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(last))
    return 0


if __name__ == "__main__":
    sys.exit(main())
