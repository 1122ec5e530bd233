"""Where K5's time goes: a phase-timing build of the fused march kernel.

    python -m nerf_replication_tpu_torch.tools.profile_fused_march

Needs the card and ``nvcc``. Compiles ``csrc/fused_march_full.cu`` with
``-DNRT_PHASE_TIMING`` (the serving build carries none of it) into
``build/torch_kernels/profile/``, runs it on chip_smoke.py's inputs (lego
width, 128³ ball grid, 16384 rays of one view, seed 0) for the f32 and bf16
families, and prints one JSON line per family: SM cycles summed over CTAs
per phase (DDA, schedule, encode, MLP, composite, finalize) and their
shares, MLP rounds and rows per round (tile fill), CTAs with samples, the
longest CTA against the mean, and the kernel time (CUDA events). The
timing build adds a barrier after the encode phase and clock reads on
thread 0, so its kernel time runs a little above the serving build's.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

PHASES = ("dda", "schedule", "encode", "mlp", "composite", "finalize")
N_COUNTERS = 11  # the kernel's kPhaseCount


def _build() -> ctypes.CDLL:
    from ..ops import kernels

    out_dir = os.path.join(kernels.BUILD_DIR, "profile")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libfused_march_full_timing.so")
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-DNRT_PHASE_TIMING",
           "-o", out, os.path.join(kernels.CSRC, "fused_march_full.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(out)
    fn = lib.nrt_fused_march_full
    fn.argtypes = kernels.ARGTYPES["fused_march_full"]["nrt_fused_march_full"]
    fn.restype = ctypes.c_int
    lib.nrt_phase_read.argtypes = [ctypes.c_void_p]
    lib.nrt_phase_read.restype = ctypes.c_int
    lib.nrt_error_string.argtypes = [ctypes.c_int]
    lib.nrt_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_fused_march: no CUDA device visible", file=sys.stderr)
        return 2
    from ..config import make_cfg
    from ..models import make_network
    from ..models.nerf.network import init_params
    from ..ops import fused_march as fm
    from ..ops.fused_mlp import fused_spec_for
    from ..renderer.accelerated import MarchOptions
    from ..utils.platform import resolve_device
    from .slice_inputs import SLICE_OPTS, ball_grid, view_rays

    dev = resolve_device("cuda")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = make_cfg(os.path.join(repo, "configs", "nerf", "lego.yaml"),
                   SLICE_OPTS)
    opts = MarchOptions.eval_from_cfg(cfg)
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    bbox = torch.tensor(cfg.train_dataset.scene_bbox, dtype=torch.float32,
                        device=dev)
    rays = torch.from_numpy(view_rays(30.0, 128)).to(dev)
    st, rays, grid_flat, coarse_flat, bbox = fm._prepare(
        rays, 2.0, 6.0, torch.from_numpy(ball_grid()).to(dev), bbox, opts)
    k_tile = fm.compositing_tile(opts, opts.chunk_size)
    lib = _build()
    n = rays.shape[0]
    counters = (ctypes.c_ulonglong * N_COUNTERS)()
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        spec = fused_spec_for(net if dtype == torch.float32
                              else net.clone(dtype))
        weights = fm.FusedWeights(spec, net.fine)
        desc = fm.MlpDescC(spec.D, spec.W,
                           -1 if spec.skip is None else spec.skip,
                           spec.c_in_pad,
                           spec.c_views_pad,
                           fm._encoder_bands(net.xyz_encoder, spec.c_in_pad),
                           fm._encoder_bands(net.dir_encoder,
                                             spec.c_views_pad))
        stc = fm._statics_c(st, k_tile)
        outs = [torch.empty((n, 3), device=dev)] + [
            torch.empty((n,), device=dev) for _ in range(2)] + [
            torch.empty((n,), dtype=torch.bool, device=dev)] + [
            torch.empty((n,), dtype=torch.int32, device=dev)
            for _ in range(2)]

        def launch():
            err = lib.nrt_fused_march_full(
                fm._ptr(rays), n, fm._ptr(grid_flat), fm._ptr(coarse_flat),
                fm._ptr(bbox), ctypes.byref(stc), ctypes.byref(desc),
                fm._ptr(weights.stream), int(dtype == torch.bfloat16),
                fm._ptr(weights.heads), *[fm._ptr(t) for t in outs],
                fm._stream(dev))
            if err:
                raise RuntimeError(lib.nrt_error_string(err).decode())

        launch()
        torch.cuda.synchronize()
        if lib.nrt_phase_read(counters):
            raise RuntimeError("reading the phase counters failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        if lib.nrt_phase_read(counters):
            raise RuntimeError("reading the phase counters failed")
        c = list(counters)
        cycles = dict(zip(PHASES, c[:6]))
        total = sum(cycles.values())
        n_ctas = c[10]
        print(json.dumps({
            "family": label,
            "device": torch.cuda.get_device_name(0),
            "kernel_ms": start.elapsed_time(end),
            "cta_cycles": cycles,
            "share": {k: v / total for k, v in cycles.items()},
            "rounds": c[6], "rows": c[7],
            "rows_per_round": c[7] / max(c[6], 1),
            "ctas": n_ctas, "ctas_with_samples": c[8],
            "max_cta_cycles": c[9], "mean_cta_cycles": total / n_ctas,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
