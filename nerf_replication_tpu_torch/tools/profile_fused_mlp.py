"""Where K2's time goes: the fused-MLP backward split by kernel, beside K1.

    python -m nerf_replication_tpu_torch.tools.profile_fused_mlp \
        [--iters 5] [--out PATH] [--cases k2_f32,k2_bf16,k3b_f32,k3b_bf16]

Needs the card and ``nvcc``. Inputs are those of chip_smoke.py's K1/K2
phase: lego width (D=8, W=256, skip 4), seeded random weights with
non-zero biases, encoded random points and directions, a random cotangent
in the live columns; M = 65,573 rows for K2 and the packed stream of one
4096-ray chunk for K3b (786,432 rows, the first 5% valid). For the f32 and
bf16 families it prints one JSON line per shape:

K2 (or K3b) as ``ops.fused_mlp.mlp_backward`` runs it, dx and dv asked
for: device ms per call of K2a (``fused_mlp_bwd_rows_kernel``: the
recompute, the dX chain and the scratch writes), K2b
(``fused_mlp_bwd_dw_kernel``: the dW/db products and the scratch reads),
the reduce, and the rest (packing the weights, zeroing dx/dv), from
``torch.profiler``; the whole call (CUDA events); K1 on the same rows (the
recompute alone); the bound of each kernel (bytes each read or written
once against 3.35 TB/s, operations against their type's peak).

``--out PATH`` also writes the lines (each with the nvidia-smi name/power
line) to a JSONL file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# published H100 SXM peaks (NVIDIA data sheet: dense, no sparsity)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
K2_M = 65536 + 37
PACKED_M = 4096 * 192
PACKED_VALID = 0.05
SEED = 0
CATEGORIES = (("fused_mlp_bwd_rows", "k2a"), ("fused_mlp_bwd_dw", "k2b"),
              ("fused_mlp_reduce", "reduce"), ("fused_mlp_fwd", "k1"))


def _category(name: str) -> str:
    return next((c for key, c in CATEGORIES if key in name), "other")


def device_ms(torch, fn, iters: int, key=_category) -> dict:
    """Device ms per call of ``fn`` by ``key`` of each kernel's name
    (default its category; torch.profiler), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            c = key(e.name)
            out[c] = out.get(c, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return out


def call_ms(torch, fn, iters: int) -> float:
    """Milliseconds per call of ``fn`` between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lego_case(torch, np, dtype, m: int, seed: int, dev):
    """(spec, x, v, draw, flat) of chip_smoke.py's K1/K2 phase at lego
    width: rows padded to the 512 multiple, the cotangent zero past ``m``
    and in the dead columns. Absolute imports: tools/time_trees.py calls
    it with another checkout's package first on ``sys.path``."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    net = make_network(make_cfg(os.path.join(repo, "configs", "nerf",
                                             "lego.yaml"), []))
    init_params(net, torch.Generator().manual_seed(SEED + 2))
    gen = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        for p in net.fine.parameters():
            if p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    spec = fmlp.fused_spec_for(net.clone(dtype))
    flat = [t.detach().to(dev) for t in spec.flatten_params(net.fine)]
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (m, 3)).astype(np.float32))
    d = rng.normal(0, 1, (m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    m_pad = fmlp._rup(m, 512)
    x = torch.zeros((m_pad, spec.c_in_pad))
    x[:m] = fmlp._pad_cols(net.xyz_encoder(pts), spec.c_in_pad)
    v = torch.zeros((m_pad, spec.c_views_pad))
    v[:m] = fmlp._pad_cols(net.dir_encoder(torch.from_numpy(d)),
                           spec.c_views_pad)
    draw = torch.zeros((m_pad, 8))
    draw[:m, :4] = torch.from_numpy(
        rng.normal(0, 1, (m, 4)).astype(np.float32))
    return spec, x.to(dev), v.to(dev), draw.to(dev), flat


def mlp_flops_per_sample(spec) -> int:
    """Multiply-adds x 2 of the padded fused MLP forward (heads 8 wide);
    the dX chain and the weight gradients are products of the same sizes."""
    W, W2, cin, cvp = spec.W, spec.W2, spec.c_in_pad, spec.c_views_pad
    macs = cin * W + (spec.D - 1) * W * W + cin * W + W * 8 + W * W \
        + (W + cvp) * W2 + W2 * 8
    return 2 * macs


def k2_bounds(spec, m: int, live_rows: int, n_part: int, n_grad: int,
              tile_floats: int, live_tiles: int) -> dict:
    """Bound ms of K2a, K2b and the reduce at ``m`` rows of which
    ``live_rows`` are in live tiles: the recompute at the compute type's
    peak, each float32 backward product as three TF32 products at the TF32
    peak; the scratch written once and read once."""
    fwd = live_rows * mlp_flops_per_sample(spec)
    peak = PEAK_BF16 if str(spec.compute_dtype) == "torch.bfloat16" \
        else PEAK_F32
    row_bytes = 4 * (spec.c_in_pad + spec.c_views_pad + 8)
    scratch = 4 * tile_floats * live_tiles
    k2a_bytes = m * (row_bytes + 4) + m * 4 * (spec.c_in_pad
                                               + spec.c_views_pad) + scratch
    b = {
        "k2a": max(k2a_bytes / PEAK_BYTES, fwd / peak + 3 * fwd / PEAK_TF32),
        "k2b": max(scratch / PEAK_BYTES, 3 * fwd / PEAK_TF32),
        "reduce": (n_part + 1) * 4 * n_grad / PEAK_BYTES,
    }
    return {k: v * 1e3 for k, v in b.items()}


def case_inputs(torch, np, case: str, dev):
    """(spec, x, v, draw, flat, m, valid) of one case: ``<kind>_<family>``
    with kind ``k2`` / ``k1`` (K2_M rows) or ``k3b`` / ``k3a`` (the packed
    stream, its first 5% valid) and family ``f32`` or ``bf16``."""
    kind, family = case.split("_")
    dtype = torch.float32 if family == "f32" else torch.bfloat16
    packed = kind in ("k3b", "k3a")
    m = PACKED_M if packed else K2_M
    spec, x, v, draw, flat = lego_case(torch, np, dtype, m, SEED + m, dev)
    valid = None
    if packed:
        bits = np.zeros(x.shape[0], np.float32)
        bits[:int(m * PACKED_VALID)] = 1.0
        valid = torch.from_numpy(bits).to(dev)
    return spec, x, v, draw, flat, m, valid


def profile_case(torch, np, case: str, iters: int, dev):
    from ..ops import fused_mlp as fmlp
    from ..ops.kernels import load

    spec, x, v, draw, flat, m, valid = case_inputs(torch, np, case, dev)
    tile_floats, jobs, n_grad, max_tiles = fmlp._bwd_layout(
        load("fused_mlp_bwd"), fmlp._desc(spec))
    n_valid = m if valid is None else int(valid[:m].sum())
    live_tiles = -(-n_valid // 64)  # the valid rows lead the packed stream
    chunks = fmlp.chunk_tiles(m, 64 * max_tiles)
    n_part = sum(fmlp._splits(dev, t, jobs) for t in chunks)
    row = {"config": case,
           "dtype": str(spec.compute_dtype).replace("torch.", ""),
           "m": m, "valid_rows": n_valid, "live_tiles": live_tiles,
           "chunks": len(chunks), "partials": n_part, "k2b_jobs": jobs,
           "bounds_ms": k2_bounds(spec, m, live_tiles * 64, n_part, n_grad,
                                  tile_floats, live_tiles)}

    def call():
        return fmlp.mlp_backward(spec, x, v, draw, flat, m, valid=valid)

    with torch.no_grad():
        row["kernel_ms"] = device_ms(torch, call, iters)
        row["call_ms"] = call_ms(torch, call, iters)
        row["k1_ms"] = device_ms(torch, lambda: fmlp.mlp_forward(
            spec, x, v, flat, m, valid=valid), iters).get("k1", 0.0)
    return row


def main(argv=None) -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--out", default="")
    parser.add_argument("--cases", default="k2_f32,k2_bf16,k3b_f32,k3b_bf16")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fused_mlp: no CUDA device", file=sys.stderr)
        return 2
    from ..ops import kernels
    from ..utils.platform import resolve_device

    dev = resolve_device("cuda")
    kernels.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    rows = []
    for case in args.cases.split(","):
        row = profile_case(torch, np, case, args.iters, dev)
        row["device"] = torch.cuda.get_device_name(0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps({**row, "smi": smi}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
