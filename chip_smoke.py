#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (nerf_replication_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (PATH or $CUDA_HOME/bin) and this checkout; it
imports nothing of JAX. Phases, each fatal on failure:

1. the card's name and power limit; build every CUDA kernel from ``csrc/``
   (one nvcc per source, started together);
2. kernels vs their plain PyTorch versions at the serving slice's shapes
   (lego width D=8 W=256, a 128³ ball grid filling ~5% of the volume,
   16384 rays of one lego-style view, step 0.005 → S=800, r=8, K_c=25,
   K=192): K4 exact; K5 f32 and bf16 within the stated tolerances, and an
   opaque variant that exercises early ray termination. Times each kernel,
   its plain version and its bound;
3. serving: writes camera metadata, a seeded port checkpoint and the grid
   to a temporary directory, boots ``engine_from_cfg`` on lego.yaml with
   ``march_coarse_block 8, march_fused full`` on the card (warming buckets x
   families), answers ``render_view``/``render_request`` calls at 200x200
   over every tier, a few concurrent ``MicroBatcher.submit``s, and one
   request through a second engine with ``march_fused gather`` (K4). Launch
   counts are reset right before this phase and read right after.

4. K1/K2 (the fused MLP, ``csrc/fused_mlp.cu``) against their plain
   versions at lego width in both families, at M = 65,536 + 37 rows and at a
   small ragged M: raw, dx, dv and every weight gradient, each held to its
   stated tolerance; kernel, plain and bound times;
5. training (the slice-2 main path): a 200x200 procedural scene (20 train,
   2 test views) generated into a temporary directory, then ``fit`` on
   lego.yaml with ``network.nerf.fused_trunk true network.nerf.fused_tile
   512``: f32 across the precrop boundary with one validation image and one
   checkpoint (K1/K2 launch counts reset right before and read right after),
   the promoted bf16 configuration (N_rays 4096) and ``fused_trunk false``;
   median step ms and rays/s of each, a finite and falling f32 loss;
6. serving the trained checkpoint: an occupancy grid baked from the trained
   coarse net, ``engine_from_cfg`` on it, one 200x200 ``full``-tier view
   through K5 (PSNR against the test image, mean acc).

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_RAYS = 16384
# published H100 SXM peaks (NVIDIA data sheet: dense, no sparsity)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
# tolerances of kernel vs plain on the card
# K5 maps: the kernel and cuBLAS sum the 256-long products in different
# orders (float32: ~1e-7 relative per layer); bf16 operands can round to the
# neighbouring bf16 value when an f32 activation differs by an ulp. Depth
# scales the weight error by t <= 6.
TOL_F32 = {"rgb": 1e-5, "acc": 1e-5, "depth": 1e-4}
TOL_BF16 = {"rgb": 1e-3, "acc": 1e-3, "depth": 1e-2}
# K1/K2 vs plain. Per row the two compute the same float32 chain in another
# summation order, so an activation within an ulp of zero can take the other
# side of its relu in one of them; that row's backward then differs by a
# whole term (f32: ~1e-6 of the 134 M activations at M = 65k; bf16 far more,
# since an activation that differs by an ulp rounds to another bf16 value).
# So: raw (continuous in the flips) elementwise — f32 absolute, bf16
# relative to max|raw|; dx/dv by the share of rows with an element off by
# more than `el` x max|value|; every dW/db tensor by its relative Frobenius
# error. The persistent grid's accumulation is held exactly apart from
# that: K2 over all rows against K2 over chunks of one tile per CTA (dx/dv
# bitwise — a row's arithmetic does not depend on its CTA — and dW/db within
# CHUNK_REL, the order of the float32 sums).
TOL_MLP = {"f32": {"raw": 1e-5, "el": 1e-4, "rows": 1e-3, "fro": 5e-3},
           "bf16": {"raw_rel": 5e-3, "el": 5e-3, "rows": 5e-2, "fro": 5e-2}}
CHUNK_REL = 1e-5
MLP_M = (333, 65536 + 37)
TRAIN_HW = 200
DEVICE = "cuda"  # the card; only a CPU rehearsal of the phases changes it


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
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


def mlp_flops_per_sample(spec) -> int:
    """Multiply-adds x 2 of the padded fused MLP (heads 8 wide)."""
    W, W2, cin, cvp = spec.W, spec.W2, spec.c_in_pad, spec.c_views_pad
    macs = cin * W + (spec.D - 1) * W * W + cin * W + W * 8 + W * W \
        + (W + cvp) * W2 + W2 * 8
    return 2 * macs


def phase_kernels(torch, np, dev):
    """Phase 2: every kernel against its plain version at slice shapes."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.ops.fused_mlp import fused_spec_for
    from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        SLICE_OPTS,
        ball_grid,
        view_rays,
    )

    cfg = make_cfg(os.path.join(REPO, "configs", "nerf", "lego.yaml"),
                   SLICE_OPTS)
    opts = MarchOptions.eval_from_cfg(cfg)
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(SEED))
    net = net.to(dev).eval()
    grid_np = ball_grid()
    bbox = torch.tensor(cfg.train_dataset.scene_bbox, dtype=torch.float32,
                        device=dev)
    rays = torch.from_numpy(view_rays(30.0, 128)).to(dev)
    require(rays.shape[0] == N_RAYS, "ray count")
    st, rays, grid_flat, coarse_flat, bbox = fm._prepare(
        rays, 2.0, 6.0, torch.from_numpy(grid_np).to(dev), bbox, opts)
    print(f"statics: S={st.n_steps} S_c={st.s_c} K_c={st.k_c} "
          f"C={st.c_total} K={st.k_sel} compact={st.compact}; grid "
          f"occupancy {grid_np.mean():.4f}")
    require((st.n_steps, st.s_c, st.k_c, st.k_sel) == (800, 100, 25, 192),
            "lego statics")
    rows = []
    n = rays.shape[0]

    # K4: exact on every output
    with torch.inference_mode():
        ker = fm.dda_block(st, rays, grid_flat, coarse_flat, bbox)
        ref = fm.dda_block_plain(st, rays, grid_flat, coarse_flat, bbox)
        torch.cuda.synchronize()
        names = ("t_sel", "valid", "flat_sel", "n_occ", "n_blk", "dist")
        for name, a, b in zip(names, ker, ref):
            require(torch.equal(a, b),
                    f"K4 {name} differs from the plain version "
                    f"({int((a != b).sum())} elements)")
        k4_ms = time_ms(torch, lambda: fm.dda_block(
            st, rays, grid_flat, coarse_flat, bbox), 20)
        k4_plain_ms = time_ms(torch, lambda: fm.dda_block_plain(
            st, rays, grid_flat, coarse_flat, bbox), 3)
    n_real = int((ref[5] > 0).sum())
    k4_bytes = rays.numel() * 4 + grid_flat.numel() + coarse_flat.numel() \
        + 24 + n * st.k_sel * (4 + 1 + 4) + n * 12
    # per position of a real ray: the fma and, per axis, mul/add/clip/
    # sub/div/mul/floor (8 ops); coarse positions S, candidates C
    k4_ops = n_real * (st.n_steps + st.c_total) * (2 + 3 * 8)
    k4_bound = max(k4_bytes / PEAK_BYTES, k4_ops / PEAK_F32) * 1e3
    print(f"K4 fused_dda_gather: exact on {names}; kernel {k4_ms:.4f} ms, "
          f"plain {k4_plain_ms:.4f} ms, bound {k4_bound:.5f} ms; "
          f"n_occ total {int(ref[3].sum())}, rays with samples "
          f"{int((ref[3] > 0).sum())}/{n}")
    rows.append({
        "name": "fused_dda_gather (K4)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_dda.cu",
        "replaces": "nerf_replication_tpu/ops/fused_march.py:241",
        "max_abs_err": 0.0, "ms": k4_ms, "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound,
        "bound_by": "bytes" if k4_bytes / PEAK_BYTES >= k4_ops / PEAK_F32
        else "operations",
        "library_ms": None,
    })

    # K5: f32 family, bf16 family, opaque (ERT) variant
    kt = fm.compositing_tile(opts, opts.chunk_size)
    enc_x, enc_d = net.xyz_encoder, net.dir_encoder
    k5 = {}
    for label, dtype, alpha_bias in (("f32", torch.float32, None),
                                     ("bf16", torch.bfloat16, None),
                                     ("f32-opaque", torch.float32, 20.0)):
        net_d = net if dtype == torch.float32 else net.clone(dtype)
        spec = fused_spec_for(net_d)
        if alpha_bias is not None:
            with torch.no_grad():
                net.fine.alpha_linear.bias.fill_(alpha_bias)
        weights = fm.FusedWeights(spec, net.fine)
        if alpha_bias is not None:
            with torch.no_grad():
                net.fine.alpha_linear.bias.zero_()
        with torch.inference_mode():
            ker = fm.march_full_block(st, weights, enc_x, enc_d, kt, rays,
                                      grid_flat, coarse_flat, bbox)
            ref = fm.march_full_plain(st, spec, enc_x, enc_d, kt, rays,
                                      grid_flat, coarse_flat, bbox,
                                      weights.flat, return_needed=True)
            torch.cuda.synchronize()
            needed = ref[-1]
            errs = {
                "rgb": float((ker[0] - ref[0]).abs().max()),
                "depth": float((ker[1] - ref[1]).abs().max()),
                "acc": float((ker[2] - ref[2]).abs().max()),
            }
            require(torch.isfinite(ker[0]).all() and torch.isfinite(
                ker[1]).all() and torch.isfinite(ker[2]).all(),
                f"K5 {label} outputs not finite")
            require(torch.equal(ker[4], ref[4]) and torch.equal(ker[5], ref[5]),
                    f"K5 {label} n_occ/n_blk differ from the plain version")
            alive_diff = int((ker[3] != ref[3]).sum())
            tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
            for k, v in errs.items():
                require(v <= tol[k], f"K5 {label} {k} error {v} > {tol[k]}")
            require(alive_diff <= max(1, n // 1000),
                    f"K5 {label} still_alive differs on {alive_diff} rays")
            ms = time_ms(torch, lambda: fm.march_full_block(
                st, weights, enc_x, enc_d, kt, rays, grid_flat, coarse_flat,
                bbox), 5)
            plain_ms = time_ms(torch, lambda: fm.march_full_plain(
                st, spec, enc_x, enc_d, kt, rays, grid_flat, coarse_flat,
                bbox, weights.flat), 2)
        flops = needed * mlp_flops_per_sample(spec)
        wbytes = weights.stream.numel() * weights.stream.element_size() \
            + weights.heads.numel() * 4
        k5_bytes = rays.numel() * 4 + grid_flat.numel() + coarse_flat.numel() \
            + 24 + wbytes + n * (12 + 4 + 4 + 1 + 4 + 4)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        bound = max(k5_bytes / PEAK_BYTES, flops / peak) * 1e3
        k5[label] = dict(errs=errs, ms=ms, plain_ms=plain_ms, bound=bound,
                         needed=needed, alive_diff=alive_diff,
                         by="bytes" if k5_bytes / PEAK_BYTES >= flops / peak
                         else "operations",
                         acc_mean=float(ker[2].mean()))
        print(f"K5 fused_march_full [{label}]: max |err| rgb "
              f"{errs['rgb']:.3e} depth {errs['depth']:.3e} acc "
              f"{errs['acc']:.3e} (tol {tol}); still_alive differs on "
              f"{alive_diff} rays; samples needed {needed} "
              f"({flops / 1e9:.2f} GFLOP); mean acc {k5[label]['acc_mean']:.4f}; "
              f"kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms")
    f32 = k5["f32"]
    rows.append({
        "name": "fused_march_full (K5)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_march_full.cu",
        "replaces": "nerf_replication_tpu/ops/fused_march.py:514",
        "max_abs_err": max(f32["errs"].values()), "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound"],
        "bound_by": f32["by"], "library_ms": None,
    })
    return rows, k5


def phase_serve(torch, np, dev, tmp):
    """Phase 3: the port's serving path on the card."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets.rays import (
        focal_from_fov,
        get_rays_np,
        pose_spherical,
    )
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.ops.fused_march import (
        LAUNCHES,
        reset_launch_counts,
    )
    from nerf_replication_tpu_torch.renderer.occupancy import (
        save_occupancy_grid,
    )
    from nerf_replication_tpu_torch.serve import MicroBatcher, engine_from_cfg
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        LEGO_CAMERA_ANGLE_X,
        SLICE_OPTS,
        ball_grid,
    )
    from nerf_replication_tpu_torch.train.checkpoint import save_network

    data_root = os.path.join(tmp, "data")
    os.makedirs(os.path.join(data_root, "lego"))
    with open(os.path.join(data_root, "lego", "transforms_test.json"),
              "w") as f:
        json.dump({"camera_angle_x": LEGO_CAMERA_ANGLE_X, "frames": []}, f)
    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    opts = SLICE_OPTS + ["test_dataset.data_root", data_root,
                         "trained_model_dir",
                         os.path.join(tmp, "trained_model")]
    cfg = make_cfg(lego, opts, default_task="run")
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(SEED + 1))
    save_network(cfg.trained_model_dir, net)
    os.chdir(tmp)  # default_grid_path is relative: logs/lego/...
    save_occupancy_grid(os.path.join("logs", "lego", "occupancy_grid.npz"),
                        ball_grid(),
                        cfg.train_dataset.scene_bbox, 1.0)

    reset_launch_counts()
    t0 = time.perf_counter()
    engine = engine_from_cfg(cfg, cfg_file=lego, device="cuda")
    print(f"engine up in {time.perf_counter() - t0:.2f} s on {engine.device}"
          f" (route {engine.march_options.march_fused}, buckets "
          f"{list(engine.buckets)}, {engine.warmup_dispatches} warm-up "
          f"dispatches)")
    require(LAUNCHES["fused_march_full"] >= engine.warmup_dispatches,
            "warm-up did not launch K5")
    H = W = 200
    focal = focal_from_fov(W, LEGO_CAMERA_ANGLE_X)

    def check_out(out, label):
        rgb = np.asarray(out["rgb_map_f"])
        require(rgb.shape == (H * W, 3), f"{label}: rgb shape {rgb.shape}")
        for k in ("rgb_map_f", "depth_map_f", "acc_map_f"):
            require(np.isfinite(out[k]).all(), f"{label}: {k} not finite")
        require(rgb.min() >= -1e-5 and rgb.max() <= 1 + 1e-5,
                f"{label}: rgb outside [0, 1]")
        acc = np.asarray(out["acc_map_f"])
        require(acc.min() >= -1e-5 and acc.max() <= 1 + 1e-5,
                f"{label}: acc outside [0, 1]")

    lat = {}
    for i, tier in enumerate(("full", "bf16", "reduced_k", "coarse",
                              "half_res")):
        for j in range(2):
            theta = 20.0 * i + 90.0 * j
            before = LAUNCHES["fused_march_full"]
            captured = {}

            def via(rays, near, far, tier=tier, captured=captured):
                captured["out"] = engine.render_request(rays, near, far,
                                                        tier=tier)
                return captured["out"]

            torch.cuda.synchronize()
            t1 = time.perf_counter()
            image, info = engine.render_view(
                pose_spherical(theta, -30.0, 4.0), H, W, focal, tier=tier,
                via=via)
            ms = (time.perf_counter() - t1) * 1e3
            lat.setdefault(tier, []).append(ms)
            require(image.shape == (H, W, 3) and image.dtype == np.uint8,
                    f"{tier}: image {image.shape} {image.dtype}")
            require(not info["cache_hit"], f"{tier}: unexpected cache hit")
            check_out(captured["out"], tier)
            require(LAUNCHES["fused_march_full"] > before,
                    f"{tier}: request did not launch K5")
    print("render_view 200x200 latency ms by tier: " + json.dumps(
        {k: [round(v, 3) for v in vs] for k, vs in lat.items()}))

    # concurrent submits through the micro-batcher
    batcher = MicroBatcher(engine)
    try:
        before = LAUNCHES["fused_march_full"]
        results, errors = [None] * 8, []

        def client(k):
            try:
                o, d = get_rays_np(64, 64, focal * 64 / W,
                                   pose_spherical(45.0 * k, -30.0, 4.0))
                rays = np.concatenate([o, d], -1).reshape(-1, 6)
                results[k] = batcher.submit(rays, engine.near,
                                            engine.far).result(120.0)
            except Exception as err:  # surfaced below, the phase fails
                errors.append(repr(err))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180.0)
        wall = (time.perf_counter() - t1) * 1e3
        require(not errors, f"batcher errors: {errors}")
        require(all(not t.is_alive() for t in threads), "batcher hung")
        for r in results:
            require(r is not None and np.isfinite(r["rgb_map_f"]).all(),
                    "batcher result missing or not finite")
        bs = batcher.stats()
        require(LAUNCHES["fused_march_full"] > before,
                "batched requests did not launch K5")
        print(f"micro-batcher: 8 concurrent 64x64 requests in {wall:.1f} ms,"
              f" {bs['n_batches']} batches, tiers "
              f"{sorted({r['tier'] for r in results})}")
    finally:
        batcher.close()
    print("engine stats march: " + json.dumps(engine.stats()["march"]))

    # one request through the gather route (K4 + the plain network)
    cfg_g = make_cfg(lego, opts[:2] + ["task_arg.march_fused", "gather"]
                     + opts[4:], default_task="run")
    engine_g = engine_from_cfg(cfg_g, cfg_file=lego, device="cuda")
    before = LAUNCHES["fused_dda_gather"]
    o, d = get_rays_np(H, W, focal, pose_spherical(10.0, -30.0, 4.0))
    rays = np.concatenate([o, d], -1).reshape(-1, 6)
    t1 = time.perf_counter()
    out = engine_g.render_request(rays, engine_g.near, engine_g.far)
    print(f"gather route: one 200x200 request in "
          f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
    check_out(out, "gather")
    require(LAUNCHES["fused_dda_gather"] > before,
            "gather request did not launch K4")
    counts = dict(LAUNCHES)
    print(f"launches on the serving path: {json.dumps(counts)}")
    return counts


def _mlp_inputs(torch, np, spec, net, m, seed, dev):
    """Encoded rows of random points/directions in the lego bbox, padded to
    the 512-row multiple as fused_mlp_raw does, and a cotangent that is zero
    past the real rows and columns (as the train step's is)."""
    from nerf_replication_tpu_torch.ops.fused_mlp import _pad_cols, _rup

    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (m, 3)).astype(np.float32))
    d = rng.normal(0, 1, (m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    m_pad = _rup(m, 512)
    x = torch.zeros((m_pad, spec.c_in_pad))
    x[:m] = _pad_cols(net.xyz_encoder(pts), spec.c_in_pad)
    v = torch.zeros((m_pad, spec.c_views_pad))
    v[:m] = _pad_cols(net.dir_encoder(torch.from_numpy(d)), spec.c_views_pad)
    draw = torch.zeros((m_pad, 8))
    draw[:m, :4] = torch.from_numpy(rng.normal(0, 1, (m, 4)).astype(np.float32))
    return x.to(dev), v.to(dev), draw.to(dev)


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _rows_off(a, b, tol) -> float:
    """Share of rows with an element off by more than tol·max|b|."""
    off = ((a - b).abs() > tol * float(b.abs().max())).any(-1)
    return float(off.float().mean())


def _fro(a, b) -> float:
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def phase_mlp_kernels(torch, np, dev):
    """Phase 4: K1 and K2 against their plain versions at lego width."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    cfg = make_cfg(os.path.join(REPO, "configs", "nerf", "lego.yaml"), [])
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(SEED + 2))
    gen = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():  # non-zero biases, as a trained net has
        for p in net.fine.parameters():
            if p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    net = net.to(dev)
    out = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        spec = fmlp.fused_spec_for(net.clone(dtype))
        flat = [t.detach() for t in spec.flatten_params(net.fine)]
        tol = TOL_MLP[label]
        for m in MLP_M:
            x, v, draw = _mlp_inputs(torch, np, spec, net, m, SEED + m, dev)
            with torch.no_grad():
                raw = fmlp.mlp_forward(spec, x, v, flat, m)
                dx, dv, grads = fmlp.mlp_backward(spec, x, v, draw, flat, m)
                ref = fmlp.forward_tile(spec, x[:m], v[:m], flat)
                rdx, rdv, rgrads = fmlp.backward_tile(spec, x[:m], v[:m],
                                                      draw[:m], flat)
            torch.cuda.synchronize()
            for name, t in (("raw", raw), ("dx", dx), ("dv", dv), *(
                    (f"grad{i}", g) for i, g in enumerate(grads))):
                require(bool(torch.isfinite(t).all()),
                        f"K1/K2 {label} M={m}: {name} not finite")
            require(float(raw[m:].abs().max()) == 0.0,
                    f"K1 {label}: rows past M are not zero")
            errs = {
                "raw": float((raw[:m] - ref).abs().max()),
                "raw_rel": _rel(raw[:m], ref),
                "dx_rows": _rows_off(dx[:m], rdx, tol["el"]),
                "dv_rows": _rows_off(dv[:m], rdv, tol["el"]),
                "dx_fro": _fro(dx[:m], rdx), "dv_fro": _fro(dv[:m], rdv),
                "dW_fro": max(_fro(g, r) for g, r in zip(grads, rgrads)),
                "dW_max_rel": max(_rel(g, r) for g, r in zip(grads, rgrads)),
                "dW_abs": max(float((g - r).abs().max())
                              for g, r in zip(grads, rgrads)),
            }
            print(f"K1/K2 [{label}] M={m}: " + json.dumps(
                {k: float(f"{v:.4g}") for k, v in errs.items()}))
            if label == "f32":
                require(errs["raw"] <= tol["raw"],
                        f"K1 f32 M={m} raw error {errs['raw']} > {tol['raw']}")
            else:
                require(errs["raw_rel"] <= tol["raw_rel"],
                        f"K1 bf16 M={m} raw error {errs['raw_rel']} > "
                        f"{tol['raw_rel']}")
            for k in ("dx_rows", "dv_rows"):
                require(errs[k] <= tol["rows"], f"K2 {label} M={m}: {k} "
                        f"{errs[k]} > {tol['rows']}")
            require(errs["dW_fro"] <= tol["fro"], f"K2 {label} M={m}: dW "
                    f"Frobenius error {errs['dW_fro']} > {tol['fro']}")
        # the persistent grid against one tile per CTA, at the big M
        chunk = fmlp._backward_ctas(dev, 10**9) * 64
        with torch.no_grad():
            parts = [fmlp.mlp_backward(spec, x[i:i + chunk], v[i:i + chunk],
                                       draw[i:i + chunk], flat,
                                       min(chunk, m - i))
                     for i in range(0, m, chunk)]
        cdx = torch.cat([p[0][:min(chunk, m - i)] for i, p in
                         zip(range(0, m, chunk), parts)])
        cdv = torch.cat([p[1][:min(chunk, m - i)] for i, p in
                         zip(range(0, m, chunk), parts)])
        require(torch.equal(cdx, dx[:m]) and torch.equal(cdv, dv[:m]),
                f"K2 {label}: dx/dv depend on the grid")
        csum = [sum(p[2][j] for p in parts) for j in range(len(grads))]
        chunk_err = max(_rel(g, c) for g, c in zip(grads, csum))
        require(chunk_err <= CHUNK_REL, f"K2 {label}: persistent-grid dW "
                f"differs from the chunked sum by {chunk_err} > {CHUNK_REL}")
        print(f"K2 [{label}] persistent grid ({-(-m // 64)} tiles on "
              f"{fmlp._backward_ctas(dev, m)} CTAs) vs {len(parts)} chunks of "
              f"one tile per CTA: dx/dv bitwise equal, dW/db max relative "
              f"{chunk_err:.3e} (tol {CHUNK_REL})")
        # times at the big M
        m = MLP_M[-1]
        with torch.no_grad():
            ms_f = time_ms(torch, lambda: fmlp.mlp_forward(spec, x, v, flat,
                                                           m), 10)
            ms_b = time_ms(torch, lambda: fmlp.mlp_backward(
                spec, x, v, draw, flat, m), 5)
            pl_f = time_ms(torch, lambda: fmlp.forward_tile(
                spec, x[:m], v[:m], flat), 5)
            pl_b = time_ms(torch, lambda: fmlp.backward_tile(
                spec, x[:m], v[:m], draw[:m], flat), 3)
        fwd = m * mlp_flops_per_sample(spec)
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        wbytes = sum(t.numel() * t.element_size() for t in flat)
        n_grad = sum(t.numel() for t in flat)
        k1_bytes = m * (spec.c_in_pad + spec.c_views_pad + 8) * 4 + wbytes
        k1_ops_s = fwd / peak
        # K2: the recompute in the compute type, both backward products f32
        k2_bytes = m * (spec.c_in_pad + spec.c_views_pad + 8) * 4 \
            + m * (spec.c_in_pad + spec.c_views_pad) * 4 + wbytes \
            + n_grad * 4 * 2
        k2_ops_s = fwd / peak + 2 * fwd / PEAK_F32
        b1 = max(k1_bytes / PEAK_BYTES, k1_ops_s) * 1e3
        b2 = max(k2_bytes / PEAK_BYTES, k2_ops_s) * 1e3
        out[label] = dict(
            errs=errs, k1_ms=ms_f, k2_ms=ms_b, k1_plain=pl_f, k2_plain=pl_b,
            k1_bound=b1, k2_bound=b2,
            k1_by="bytes" if k1_bytes / PEAK_BYTES >= k1_ops_s
            else "operations",
            k2_by="bytes" if k2_bytes / PEAK_BYTES >= k2_ops_s
            else "operations")
        print(f"K1 fused_mlp_fwd [{label}] M={m}: kernel {ms_f:.3f} ms "
              f"({fwd / ms_f / 1e9:.2f} TFLOP/s), plain {pl_f:.3f} ms, bound "
              f"{b1:.4f} ms; K2 fused_mlp_bwd (+ reduce): kernel {ms_b:.3f} "
              f"ms ({3 * fwd / ms_b / 1e9:.2f} TFLOP/s), plain {pl_b:.3f} ms,"
              f" bound {b2:.4f} ms")
    f32 = out["f32"]
    rows = [{
        "name": "fused_mlp_fwd (K1)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "nerf_replication_tpu/ops/fused_mlp.py:339",
        "max_abs_err": f32["errs"]["raw"], "ms": f32["k1_ms"],
        "plain_ms": f32["k1_plain"], "bound_ms": f32["k1_bound"],
        "bound_by": f32["k1_by"], "library_ms": None,
    }, {
        "name": "fused_mlp_bwd (K2)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "nerf_replication_tpu/ops/fused_mlp.py:348",
        "max_abs_err": f32["errs"]["dW_abs"], "ms": f32["k2_ms"],
        "plain_ms": f32["k2_plain"], "bound_ms": f32["k2_bound"],
        "bound_by": f32["k2_by"], "library_ms": None,
    }]
    return rows, out


def _train_opts(data, out, exp):
    hw = str(TRAIN_HW)
    return [
        "scene", "procedural", "exp_name", exp,
        "train_dataset.data_root", data, "test_dataset.data_root", data,
        "train_dataset.H", hw, "train_dataset.W", hw,
        "test_dataset.H", hw, "test_dataset.W", hw,
        "test_dataset.cams", "[0, 1, 1]",  # one validation image
        "network.nerf.fused_trunk", "true", "network.nerf.fused_tile", "512",
        "trained_model_dir", os.path.join(out, "trained"),
        "trained_config_dir", os.path.join(out, "config"),
        "record_dir", os.path.join(out, "record"),
        "result_dir", os.path.join(out, "result"),
        "log_interval", "1",
    ]


def _fit_run(torch, np, lego, opts, label):
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.train.trainer import fit

    cfg = make_cfg(lego, opts)
    rows = []
    logs = []
    t0 = time.perf_counter()
    state = fit(cfg, device=DEVICE, emit=rows.append, log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [r["stats"]["loss"] for r in rows]
    require(len(rows) == state.step, f"{label}: {len(rows)} rows for "
            f"{state.step} steps")
    require(all(np.isfinite(losses)), f"{label}: non-finite loss")
    times = [r["step_time_s"] for r in rows[3:]]
    med = float(np.median(times)) * 1e3
    n_rays = int(cfg.task_arg.N_rays)
    res = {"steps": state.step, "median_step_ms": med,
           "rays_per_s": n_rays / med * 1e3, "losses": losses,
           "wall_s": wall, "logs": logs, "state": state, "cfg": cfg}
    print(f"train [{label}]: {state.step} steps in {wall:.1f} s; median "
          f"step {med:.2f} ms = {res['rays_per_s']:.0f} rays/s (N_rays "
          f"{n_rays}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; psnr "
          f"{rows[-1]['stats']['psnr']:.2f}")
    return res


def phase_train(torch, np, tmp):
    """Phase 5: the slice-2 main path, fit on a procedural scene."""
    from nerf_replication_tpu_torch.datasets.procedural import generate_scene
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    generate_scene(data, "procedural", H=TRAIN_HW, W=TRAIN_HW, n_train=20,
                   n_test=2)
    print(f"procedural scene {TRAIN_HW}x{TRAIN_HW}, 20 train + 2 test views, "
          f"in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "out")

    # the main path: f32 fused, across the precrop boundary, with one
    # validation image and one checkpoint
    fmlp.reset_launch_counts()
    fm.reset_launch_counts()
    f32 = _fit_run(torch, np, lego, _train_opts(data, out, "f32") + [
        "task_arg.precrop_iters", "20", "ep_iter", "50", "train.epoch", "2",
        "eval_ep", "2", "save_ep", "2", "save_latest_ep", "2"], "f32 fused")
    counts = dict(fmlp.LAUNCHES)
    print(f"launches on the training path: {json.dumps(counts)}")
    for k in ("fused_mlp_fwd", "fused_mlp_bwd"):
        require(counts[k] > 0, f"the f32 training run never launched {k}")
    losses = f32["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    require(last < first, f"f32 loss did not fall: first 10 mean {first}, "
            f"last 10 mean {last}")
    val = [line for line in f32["logs"] if line.startswith("val epoch")]
    require(val, "no validation line")
    print(f"f32 loss mean of first 10 steps {first:.4f}, last 10 "
          f"{last:.4f}; {val[-1]}")
    ckpt = os.path.join(f32["cfg"].trained_model_dir, "latest.pt")
    require(os.path.exists(ckpt), "no checkpoint written")
    summary = os.path.join(f32["cfg"].result_dir, "summary.json")
    require(os.path.exists(summary), "no summary.json")

    # the promoted configuration (BENCH_DEFAULTS.json): bf16, 4096 rays
    before = dict(fmlp.LAUNCHES)
    bf16 = _fit_run(torch, np, lego, _train_opts(data, out, "bf16") + [
        "precision.compute_dtype", "bfloat16", "task_arg.N_rays", "4096",
        "task_arg.precrop_iters", "0", "ep_iter", "20", "train.epoch", "1",
        "eval_ep", "100", "save_ep", "100", "save_latest_ep", "100"],
        "bf16 fused")
    require(fmlp.LAUNCHES["fused_mlp_bwd"] > before["fused_mlp_bwd"],
            "the bf16 run never launched K2")
    # the plain Network through autograd: the comparison point
    before = dict(fmlp.LAUNCHES)
    plain = _fit_run(torch, np, lego, _train_opts(data, out, "plain") + [
        "network.nerf.fused_trunk", "false",
        "task_arg.precrop_iters", "0", "ep_iter", "20", "train.epoch", "1",
        "eval_ep", "100", "save_ep", "100", "save_latest_ep", "100"],
        "f32 plain network")
    require(fmlp.LAUNCHES == before, "the unfused run launched K1/K2")
    print("train step ms / rays/s: " + json.dumps({
        k: [round(r["median_step_ms"], 3), round(r["rays_per_s"], 1)]
        for k, r in (("f32_fused", f32), ("bf16_fused", bf16),
                     ("f32_plain", plain))}))
    return counts, f32, data


def phase_serve_trained(torch, np, tmp, f32, data):
    """Phase 6: the trained checkpoint served through K5."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.ops.fused_march import (
        LAUNCHES,
        reset_launch_counts,
    )
    from nerf_replication_tpu_torch.renderer.occupancy import (
        bake_occupancy_grid,
        save_occupancy_grid,
    )
    from nerf_replication_tpu_torch.serve import engine_from_cfg
    from nerf_replication_tpu_torch.tools.slice_inputs import SLICE_OPTS
    from nerf_replication_tpu_torch.utils.image import psnr, read_png

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    opts = _train_opts(data, os.path.join(tmp, "out"), "f32") + SLICE_OPTS
    cfg = make_cfg(lego, opts, default_task="run")
    require(cfg.trained_model_dir == f32["cfg"].trained_model_dir,
            "serving looks for the checkpoint elsewhere")
    t0 = time.perf_counter()
    grid = bake_occupancy_grid(f32["state"].network, cfg, device=DEVICE)
    print(f"grid baked from the trained coarse net in "
          f"{time.perf_counter() - t0:.1f} s: occupancy {grid.mean():.4f}")
    os.chdir(tmp)
    save_occupancy_grid(os.path.join("logs", "lego", "occupancy_grid.npz"),
                        grid, cfg.train_dataset.scene_bbox,
                        float(cfg.task_arg.occupancy_grid_threshold))
    reset_launch_counts()
    engine = engine_from_cfg(cfg, cfg_file=lego, device=DEVICE)
    with open(os.path.join(data, "procedural", "transforms_test.json")) as f:
        frame = json.load(f)["frames"][0]
    c2w = np.asarray(frame["transform_matrix"], np.float32)
    cam = engine.default_camera
    captured = {}

    def via(rays, near, far):
        captured["out"] = engine.render_request(rays, near, far, tier="full")
        return captured["out"]

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    image, _ = engine.render_view(c2w, cam["H"], cam["W"], cam["focal"],
                                  tier="full", via=via)
    ms = (time.perf_counter() - t1) * 1e3
    require(LAUNCHES["fused_march_full"] > 0,
            "the trained view did not launch K5")
    acc = float(np.asarray(captured["out"]["acc_map_f"]).mean())
    require(np.isfinite(acc), "trained view acc not finite")
    gt = read_png(os.path.join(data, "procedural",
                               frame["file_path"] + ".png")).astype(np.float32) / 255.0
    gt = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
    view_psnr = psnr(image.astype(np.float32) / 255.0, gt)
    print(f"trained checkpoint served through K5: one {cam['H']}x{cam['W']} "
          f"full-tier view in {ms:.1f} ms, mean acc {acc:.4f} (random "
          f"weights: 0.0078), PSNR vs the test image {view_psnr:.2f} dB; "
          f"K5 launches {LAUNCHES['fused_march_full']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "nerf_replication_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from nerf_replication_tpu_torch.ops import kernels
    from nerf_replication_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cuda")
    smi = smi_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"built {sorted(kernels.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    rows, _ = phase_kernels(torch, np, dev)
    mlp_rows, _ = phase_mlp_kernels(torch, np, dev)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        try:
            counts = phase_serve(torch, np, dev, tmp)
        finally:
            os.chdir(cwd)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        try:
            train_counts, f32, data = phase_train(torch, np, tmp)
            phase_serve_trained(torch, np, tmp, f32, data)
        finally:
            os.chdir(cwd)
    counts.update(train_counts)
    keys = {"K4": "fused_dda_gather", "K5": "fused_march_full",
            "K1": "fused_mlp_fwd", "K2": "fused_mlp_bwd"}
    rows = mlp_rows + rows
    for row in rows:
        key = next(v for k, v in keys.items() if f"({k})" in row["name"])
        row["launches"] = counts[key]
        require(row["launches"] > 0, f"{row['name']} never launched")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
