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
   its plain version and its bound (K4: its device time from torch.profiler
   beside the time between CUDA events, and its phase split from the
   phase-timing build of ``tools/profile_dda.py``, itself held bitwise to
   the plain version, with phase A's positions equal to the CPU count of
   ``tools/dda_emulate.py``);
3. serving: writes camera metadata, a seeded port checkpoint and the grid
   to a temporary directory, boots ``engine_from_cfg`` on lego.yaml with
   ``march_coarse_block 8, march_fused full`` on the card (warming buckets x
   families), answers ``render_view``/``render_request`` calls at 200x200
   over every tier, a few concurrent ``MicroBatcher.submit``s, and one
   request through a second engine with ``march_fused gather`` (K4). Launch
   counts are reset right before this phase and read right after.
4. K1/K2 (the fused MLP: K1 ``csrc/fused_mlp.cu``, K2 = K2a + K2b + the
   reduce, ``csrc/fused_mlp_bwd.cu``) against their plain versions at lego
   width in both families, at M = 65,536 + 37 rows and at a small ragged M:
   raw, dx, dv and every weight gradient, each held to its stated
   tolerance; K2 in its default row chunks and splits against a forced
   small chunk with one split, and against a second call; kernel, plain and
   bound times, and K2's split by kernel (K2a, K2b, reduce) with bounds;
5. training (the slice-2 main path): a 200x200 procedural scene (20 train,
   2 test views) generated into a temporary directory, then ``fit`` on
   lego.yaml with ``network.nerf.fused_trunk true network.nerf.fused_tile
   512``: f32 across the precrop boundary with one validation image and one
   checkpoint (K1/K2 launch counts reset right before and read right after),
   the promoted bf16 configuration (N_rays 4096) and ``fused_trunk false``;
   median step ms and rays/s of each, a finite and falling f32 loss; the
   f32 fit's last validation (the view captured before its epoch loop,
   replayed after the weights moved) equal to an eager ``Trainer.val`` of
   the final state;
6. serving the trained checkpoint: an occupancy grid baked from the trained
   coarse net, ``engine_from_cfg`` on it, one 200x200 ``full``-tier view
   through K5 (PSNR against the test image, mean acc);
7. eval (the slice-3 main path): ``run.run_evaluate`` of the trained f32
   checkpoint through the baked grid on both 200x200 test views, three
   routes — lego.yaml's per-ray march with ``fused_trunk`` (K1),
   ``march_coarse_block 8`` and ``march_clip_bbox true`` (the packed march,
   K3a) — each with its launch counts reset right before and read right
   after; PSNR/SSIM, mean net_time and overflow_frac per route; view 0 of
   every route rendered again through the plain Network (cuBLAS), maps
   within 1e-4 (K1 at the per-ray route's 786,432 rows, K3a on both packed
   routes);
8. a gradient through the packed march (the route the NGP trainer takes,
   slice 4): one loss.backward over 4096 training rays with the fused
   apply (K3a forward, K3b backward; counts reset right before and read
   right after), parameter gradients against the plain Network's;
9. the serving engine's slice-3 routes: one 200x200 request through
   ``march_fused off`` (the packed march) and one through the grid-less
   chunked volume route.

10. K6/K6b (the hash encoder, ``csrc/hash_encode.cu``) against their plain
   versions at lego_hash's full geometry (16 levels x 2 features, a
   5,738,832-row table) on four point sets: ``ray``, the NGP warm step's
   131,072 ray-ordered points (1024 rays x 128 samples,
   ``slice_inputs.ngp_points``: the main path's order, whose times the
   kernels line reports); ``uniform``, 131,072 uniform points; ``uniform16k``,
   16,384 (the grid refresh's count); ``cell``, 16,384 points inside one
   level-0 cell (contention): K6 within 1e-6 of max|out| (printed as bitwise
   or not), K6b's dtable within 1e-5 (relative Frobenius) of a float64
   reference and dx within 1e-5 of max|dx|; kernel, plain and bound times,
   and, as a diagnostic only, ``index_add_`` over the same (row, w·g) pairs;
11. NGP training (the slice-4 main path) on the 200x200 scene, each run's
   hash-kernel launch counts reset right before and read right after:
   (a) lego_hash, ``ngp_training``, f32, the per-ray march, 1024 rays, 30
   warm + 70 march steps (the grid decaying fast enough to carve in 100
   steps), the loss falling, validation on both test views;
   (b) the packed march in bf16 at 4096 rays; (c) lego_hash_packed.yaml
   with the packed march (the cell-packed encoder: plain PyTorch, no K6);
   (d) lego_hash through the ordinary coarse+fine trainer, 100 steps;
12. the proposal-sampling path at ``lego_proposal.yaml``'s full
   width (fine W=256 D=8, proposal D=2 W=64, 96 proposal / 64 fine
   samples, ``fused_trunk true fused_tile 512``) on the 200x200 scene,
   its K1/K2/K3a launches reset right before each run and read right
   after: (a) f32 at 1024 rays, 100 steps, the loss falling, loss_prop
   finite, validation on both test views; (b) bf16 at 4096 rays; (c) K1/K2
   at the fine pass's 65,536 rows (1024 rays x 64 resampled points of the
   trained net) against their plain versions (the phase-4 gates; K1 f32
   relative to max|raw|, see TOL_TRAINED_RAW_REL), and K1's and the plain
   version's distance from float64 there and on the lego-trained net of
   phase 5; (d) a grid baked from the trained fine branch, view 0 through
   ``march_rays_proposal_packed`` with K3a and with the plain Network,
   maps within 1e-4; (e) ``engine_from_cfg`` on the checkpoint answering
   one 200x200 request at tiers ``full`` (K5) and ``proposal`` (K3a); one
   line with the phase's launches, step ms, rays/s, view ms and the card;
13. CUDA graphs (``compile.aot``, ``compile/registry.py``; phases 5, 11
   and 12 already trained graphed, each fit's registry line checked: every
   entry captured, none in errors, launch counts read as before since a
   replay adds its captured launches): (a) lego f32 and bf16 and the
   proposal f32 step, 8 steps each from one seeded state eager, eager
   again and graphed: parameters, Adam's moments and stats bitwise, no
   capture after warm-up; (b) NGP f32 per-ray and bf16 packed, warm and
   march, the same within 1e-5 relative Frobenius (K6b's float32
   atomics), and the step's draws replayed bitwise eager ones; (c) the
   engine's ``full`` (K5), ``march_fused off``, grid-less and ``proposal``
   (K3a) routes on one 200x200 request, eager and replayed: maps bitwise,
   captures constant over 5 more requests, request ms and peak memory of
   each; (d) a second process boots an engine with no nvcc run
   (``builds == 0``, ``warm_source == "disk"``); (e) eager against graphed
   step ms, rays/s, idle share and kernels a step
   (``tools/profile_train_step.py``) for NGP f32 warm / march, NGP bf16
   packed march, proposal f32, lego f32 and lego bf16; one line with all
   of it and the card.
14. serving the hash checkpoints of phase 11: run (d) (lego_hash, the
   coarse+fine trainer) with a grid baked from its coarse branch, run (a)
   (NGP f32) with its checkpoint's live grid; ``engine_from_cfg`` on each
   answers one 200x200 request on the staged per-ray route (``march_fused
   off``), the staged packed route (``march_coarse_block 8``) and
   ``gather`` (K4), eagerly and from the captured ``full`` family: maps
   bitwise, captures constant after warm-up, K6 launched on every route
   and K4 on ``gather`` (counts reset right before the graphed request and
   read right after), the maps within 1e-4 of the same request through
   K6's plain version; request ms on the host clock, eager and graphed;
15. the eval renders as CUDA graphs: phase 7's three routes
   (``Renderer.aot_register_eval`` of the march: K1 per-ray, K3a packed
   hier and clip) and ``Trainer.val``'s chunked render (K1) of the trained
   f32 checkpoint, both test views eager then graphed (view 0 bitwise, or
   within two eager renders' difference; no capture after the first view;
   net_time per view and peak MB of each); the chunked render's K1 at
   its own shapes (8192-ray chunks x 64 and x 192 samples) against the
   plain Network: raw on every row, the coarse maps and the fine maps on
   the same rows (``_chunked_vs_plain``); and the NGP val of phase 11's
   run (a) (``NGPTrainer.aot_register_render``: one capture, both views
   and the evaluator's val replayed, bitwise eager). K1/K3a/K6 counts
   reset right before the graphed views and read right after. Since this
   phase, phase 7's ``run_evaluate`` and every fit's validation replay
   their captured view too (their registry lines are checked).

16. the ops layers (``obs/``, ``resil/``), their K1/K2/K5/K6/K6b launch
   counts reset right before and read right after (the eager reference
   steps of (c) and (e) left out): (a) lego f32 graphed through ``python -m
   nerf_replication_tpu_torch.train`` (2 epochs of 30 steps): every row of
   its ``telemetry.jsonl`` valid, a ``memory`` row per epoch with the
   card's allocator numbers, ``step`` rows with the dispatch/block split,
   no ``compile`` row after the first step, its step ms beside phase 13's
   graphed lego f32 step; (b) ``train.profile`` over steps [20, 25): the
   Chrome trace's K1 / K2a / K2b kernel events are 5 x the launches a step;
   (c) a ``nan_loss`` fault in epoch 1: one rollback with its ``fault``
   rows, no capture after it, a finite final loss, and the first graphed
   step after the restore bitwise an eager step from the restored
   checkpoint; (d) SIGTERM from a row tap at step 15 of the train CLI:
   ``latest.pt`` and its checksum sidecar flushed, exit 0, and the resumed
   run's final weights bitwise (a)'s; (e) NGP f32 per-ray (K6/K6b) with
   one ``nan_loss`` rollback: the step after the restore (grid EMA, weights,
   the phase sidecar's phase) within 1e-5 relative Frobenius of an eager
   step from the restored checkpoint; (f) a lego engine (``full``, K5)
   behind the batcher with tracing, metrics and the flight recorder:
   ``serve.dispatch`` io_errors open the breaker (a flight dump), which
   sheds, goes half open and closes, with no capture in the engine; the
   spans under their requests; the HTTP entry's ``/metrics`` (Prometheus
   text) and ``/healthz`` (its ``slo`` block); (g) ``run --type evaluate``
   writes ``run_meta`` and ``eval`` rows. One line with all of it.

17. the model zoo (phase 17), its K1/K2/K5/K6/K6b launch counts reset
   right before each run and read right after (the kernel-vs-plain checks
   left out): (a) ``configs/light_stage/dynamic.yaml`` at its width (W 64,
   D 3, ``cuda_hashgrid_latent`` 16 x 2 levels, 2^19 rows, finest 1024,
   1024 rays, 64 + 128 samples) through ``python -m
   nerf_replication_tpu_torch.train`` (a driver around its ``main`` that
   writes the subprocess's K6/K6b counts) on a procedural PNG capture of 4
   cameras x 8 frames at 256 x 256, 100 graphed steps: the loss falling,
   max|latent_t| > 1e-4, both test views finite through the captured
   chunked ``Trainer.val``, no capture after warm-up, its step ms;
   (b) the tri-plane (on the 200 x 200 scene) and ``cuda_hashgrid_4d``,
   ``_coef``, ``dnerf``, ``cuda_motion2d``, ``cuda_dnerf_ngp_tensorf`` (on
   a 2 x 4 capture at 128 x 128) at dynamic.yaml's hash geometry, 20 graphed
   steps each, finite losses; one eager step's K6/K6b calls recorded and
   held to the plain versions on their own inputs (phase 10's gates: D = 2
   and 4, dx wherever an encoder asks for it), with kernel ms and bytes
   bounds; (c) img_fit at ``lego_view0.yaml``'s width (W 128, D 4, freq
   10, 8,192 pixels) on the 200 x 200 scene, ``test_dataset.input_ratio
   0.5``, 200 steps: validation PSNR above flat gray's, ``metrics.json``
   and ``vis/res.png``; (d) the scene as one ``transforms.json``:
   ``capture.yaml`` with the fused trunk (K1/K2) and the native ray bank,
   ``capture_ndc.yaml``, 20 steps each; (e) ``run --type mesh`` of phase
   5's checkpoint at resolution 128 (level: the grid bake's σ cut), faces
   > 0, its seconds and peak memory; (f) the same checkpoint's 360° video
   through its baked grid on the ``full`` route (K5), 24 frames: the AVI
   bitwise the engine's renders of the same poses, no capture after
   warm-up, its fps.

18. data-parallel training and sequence-parallel eval (``parallel/``),
   each part in ``python -m torch.distributed.run`` subprocesses running
   this script's ``--dp-worker`` mode (this process never holds a process
   group; NCCL refuses two ranks on one card, so more than one rank shares
   the card over gloo): (a) NCCL at world size 1: ``build_dp_step``'s
   captured segments around the all-reduce against the single-card
   ``Trainer.step``, lego f32, 3 steps from one seeded state on one bank:
   parameters, Adam's moments and stats bitwise, one all-reduce a step, no
   capture after warm-up; (b) lego f32 (fused trunk, 1024 global rays, 512
   a rank) on 2 ranks through ``train.__main__.main`` for 100 graphed
   steps, each rank's K1/K2 launch counts reset right before and read right
   after: one DP step first held bitwise to its one-process emulation
   (both ranks' draws, ``(g0 + g1) / 2``, clip + Adam), the loss falling,
   both ranks' parameters and moments bitwise equal at the end, step ms and
   all-reduce ms per rank, the flat buffer's bytes; (c) lego_hash NGP f32
   per-ray the same way (K6/K6b; one step within 1e-5 relative Frobenius
   of its emulation: K6b's atomics; the grid EMA's MAX-merge leaves the
   ranks' grids bitwise equal); (d) ``run --type evaluate`` with
   ``eval.sharded`` on 2 ranks on (b)'s checkpoint, through the chunked
   render and through a grid the chief bakes from it (each rank's slice
   captured; K1): maps within 1e-6 of max|map| of this process's
   one-process render of the same views (measured bitwise, printed) and
   the same PSNR (rtol 1e-4). One line with all of it and the card.

Then the port bench (``python -m nerf_replication_tpu_torch.bench``, bf16,
4096 rays, ``scan_steps 32``, the median of three timed windows) runs once
as a subprocess; its JSON line is printed before the kernels line.

Phase 4 also holds K3a/K3b (the masked MLP) against their plain versions and
against K1/K2 under three masks, and times K3a/K3b at the packed stream's
shape (786,432 rows, 5% valid, sorted valid-first; K3b split by kernel)
beside K1/K2 on the same rows and on the compacted valid rows; K1 on those
786,432 rows is held against its plain version too.

K1, K3a and K5 run the Hopper forward chain (``csrc/mlp_chain_sm90.cuh``:
wgmma products, bf16 or 3xTF32, weights through a TMA ring); phases 2 and
4 print each family's TFLOP/s, and their rows of the kernels line carry two
bounds: ``bound_ms`` counts a float32 product as three TF32 products at the
TF32 peak (the chain's arithmetic, K2's convention), ``bound_ms_cuda_cores``
one product at the CUDA cores' float32 peak (the earlier chain's).

Prints a ``{"kernels": [...]}`` line (with launches by path: K1, K2 and
K3a on the proposal path, K1 and K3a on the graphed eval, K6 on the graphed
NGP val and on hash serving, K4 on hash serving's ``gather`` route, K1, K2,
K5, K6 and K6b on the ops phase and on the model zoo, K1, K2, K6 and K6b on
the ``parallel`` path of phase 18, summed over its ranks; K6 and K6b also
carry their ms and bound at D = 2 and 4), the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# the published H100 peaks and the fused MLP's operations per row (one
# definition, shared with the K2 profiler); outside a checkout this import
# fails and the script ends before any result
from nerf_replication_tpu_torch.tools.profile_fused_mlp import (  # noqa: E402
    PEAK_BF16,
    PEAK_BYTES,
    PEAK_F32,
    PEAK_TF32,
    mlp_flops_per_sample,
)

SEED = 0
N_RAYS = 16384
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
# error. K2's row chunks and splits are held exactly apart from that: K2 in
# its default chunks and splits against chunks of K2_CHUNK rows with one
# split each (dx/dv bitwise — a row's arithmetic does not depend on its
# chunk — and dW/db within CHUNK_REL, the order of the float32 sums).
TOL_MLP = {"f32": {"raw": 1e-5, "el": 1e-4, "rows": 1e-3, "fro": 5e-3},
           "bf16": {"raw_rel": 5e-3, "el": 5e-3, "rows": 5e-2, "fro": 5e-2}}
CHUNK_REL = 1e-5
# K1 f32 on a TRAINED network's rows (phase 12's fine pass), relative to
# max|raw|: the absolute raw gate above was set at an untrained network's
# magnitudes (max|raw| ~0.7). Trained, raw reaches ~30, and no float32
# summation order meets 1e-5 absolute (the plain version itself is 1.2e-5
# from float64 there). K1's chain, its split rounded to nearest and its
# tensor-core partial sums added into IEEE float32 sums, lands within
# TOL_K1_F64_REL of max|raw| from float64 there and on a lego-trained net
# (the truncating split and the tensor cores' own sums put it at 1.4-1.8e-5;
# phase 12 prints both distances, tools/chain_accuracy.py).
TOL_TRAINED_RAW_REL = 3e-6
TOL_K1_F64_REL = 3e-6
K2_CHUNK = 8192  # the forced small chunk of K2's chunking check
MLP_M = (333, 65536 + 37)
# the packed stream of one 4096-ray chunk at packed_cap 192, and the valid
# share of a carved lego grid
PACKED_M = 4096 * 192
PACKED_VALID = 0.05
MASKS = ("sorted", "random", "all_invalid")
# each eval route's view through K1 or K3a vs the plain Network (cuBLAS f32)
TOL_EVAL_MAPS = 1e-4
TRAIN_HW = 200
DEVICE = "cuda"  # the card; only a CPU rehearsal of the phases changes it
# K6/K6b's point sets: the NGP warm step's ray-ordered points (1024 rays x
# 128 samples), uniform points at that count and at the grid refresh's
# (64³ / 16 cells), and 16,384 points inside one level-0 cell
HASH_SETS = (("ray", 1024 * 128), ("uniform", 1024 * 128),
             ("uniform16k", 64**3 // 16), ("cell", 64**3 // 16))
# K6 vs plain: every float operation of the kernel is the plain version's
# (measured bitwise); the bound leaves room for the FMA of pos, which the
# plain version emulates in float64
TOL_K6 = 1e-6  # of max|out|
TOL_K6B_FRO = 1e-5  # dtable vs float64: float32 atomics reorder the sums
TOL_K6B_DX = 1e-5  # of max|dx|: the same closed form in another order


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


def kernel_ms(torch, fn, iters: int, names) -> float:
    """Device time per call of ``fn`` in the kernels whose names contain
    one of ``names`` (torch.profiler): the kernels' own time, without the
    wrapper's host work, which back-to-back CUDA-event timing includes once
    a kernel is shorter than it."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(n in e.name for n in names))
    return us / 1e3 / iters


def chain_ops_seconds(fwd: float, bf16: bool) -> tuple[float, float]:
    """The forward chain's operations (K1, K3a, K5) at the least time their
    types allow: bf16 products at the bf16 peak; a float32 product as three
    TF32 products at the TF32 peak (the chain's 3xTF32, K2's convention).
    Second: the earlier bound of one float32 product at the CUDA cores' f32
    peak (the bf16 bound is the same in both)."""
    if bf16:
        return fwd / PEAK_BF16, fwd / PEAK_BF16
    return 3 * fwd / PEAK_TF32, fwd / PEAK_F32


def k2_ops_seconds(fwd: float, peak: float) -> float:
    """The operations of K2 (K3b) at the least time their types allow: the
    recompute at the compute type's peak, and the two float32 backward
    products of the forward's size (the dX chain, the weight gradients),
    each run as three TF32 products, at the TF32 peak."""
    return fwd / peak + 2 * 3 * fwd / PEAK_TF32


def k2_split(torch, fmlp, spec, x, v, draw, flat, m, valid, label):
    """Device ms per call of K2a, K2b, the reduce and the rest of one
    mlp_backward (torch.profiler), each printed beside its bound."""
    from nerf_replication_tpu_torch.tools.profile_fused_mlp import (
        device_ms,
        k2_bounds,
    )

    from nerf_replication_tpu_torch.ops.kernels import load

    lib = load("fused_mlp_bwd")
    tile_floats, jobs, n_grad, max_tiles = fmlp._bwd_layout(
        lib, fmlp._desc(spec))
    live_rows = m if valid is None else int(valid[:m].sum())
    tiles = fmlp.chunk_tiles(m, 64 * max_tiles)
    n_part = sum(fmlp._splits(x.device, t, jobs) for t in tiles)
    live_tiles = -(-live_rows // 64) if valid is not None else sum(tiles)
    bounds = k2_bounds(spec, m, live_tiles * 64, n_part, n_grad, tile_floats,
                       live_tiles)
    with torch.no_grad():
        ms = device_ms(torch, lambda: fmlp.mlp_backward(
            spec, x, v, draw, flat, m, valid=valid), 5)
    name = "K2" if valid is None else "K3b"
    print(f"{name} split [{label}] M={m} ({live_tiles} live tiles, {len(tiles)}"
          f" chunk(s), {n_part} partials): K2a fused_mlp_bwd_rows "
          f"{ms.get('k2a', 0.0):.4f} ms (bound {bounds['k2a']:.4f}), K2b "
          f"fused_mlp_bwd_dw {ms.get('k2b', 0.0):.4f} ms (bound "
          f"{bounds['k2b']:.4f}), reduce {ms.get('reduce', 0.0):.4f} ms (bound "
          f"{bounds['reduce']:.4f}), other {ms.get('other', 0.0):.4f} ms "
          f"(packing the weights, zeroing dx/dv)")
    return {"ms": ms, "bounds": bounds}


def phase_kernels(torch, np, dev):
    """Phase 2: every kernel against its plain version at slice shapes."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.ops.fused_mlp import fused_spec_for
    from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions
    from nerf_replication_tpu_torch.tools.dda_emulate import emulate_k4
    from nerf_replication_tpu_torch.tools.profile_dda import phase_split
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
        k4_event_ms = time_ms(torch, lambda: fm.dda_block(
            st, rays, grid_flat, coarse_flat, bbox), 20)
        k4_ms = kernel_ms(torch, lambda: fm.dda_block(
            st, rays, grid_flat, coarse_flat, bbox), 20, ("fused_dda",))
        k4_plain_ms = time_ms(torch, lambda: fm.dda_block_plain(
            st, rays, grid_flat, coarse_flat, bbox), 3)
    # where K4's time goes: its phase-timing build (bitwise the plain
    # version too), and the work these inputs need, counted on the CPU
    split = phase_split(torch, (st, rays, grid_flat, coarse_flat, bbox))
    _, counts = emulate_k4(st, rays.cpu(), grid_flat.cpu(),
                           coarse_flat.cpu(), bbox.cpu())
    require(split["positions_blocks"] == counts["positions"],
            "K4 phase A's positions on the card differ from the CPU count")
    k4_bytes = rays.numel() * 4 + grid_flat.numel() + coarse_flat.numel() \
        + 24 + n * st.k_sel * (4 + 1 + 4) + n * 12
    # per position evaluated (phase A's, with the shortcut, and the kept
    # blocks' candidates): the fma and, per axis, mul/add/clip/sub/div/mul/
    # floor (8 ops)
    k4_ops = (counts["positions"] + counts["candidates"]) * (2 + 3 * 8)
    k4_bound = max(k4_bytes / PEAK_BYTES, k4_ops / PEAK_F32) * 1e3
    print(f"K4 fused_dda_gather: exact on {names}; kernel {k4_ms:.4f} ms "
          f"device (torch.profiler), {k4_event_ms:.4f} ms between events; "
          f"plain {k4_plain_ms:.4f} ms, bound {k4_bound:.5f} ms; n_occ total "
          f"{int(ref[3].sum())}, rays with samples {int((ref[3] > 0).sum())}"
          f"/{n}")
    print("K4 phase split (timing build, shares of lane 0's cycles): "
          + json.dumps({k: round(v, 4) for k, v in split["share"].items()})
          + f"; positions A {split['positions_blocks']}, C "
          f"{split['positions_cands']}; store sectors {counts['sectors']} "
          f"(outputs {counts['sectors_min']}; CPU count)")
    rows.append({
        "name": "fused_dda_gather (K4)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_dda.cu",
        "replaces": "nerf_replication_tpu/ops/fused_march.py:241",
        "max_abs_err": 0.0, "ms": k4_ms, "event_ms": k4_event_ms,
        "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
        "bound_by": "bytes" if k4_bytes / PEAK_BYTES >= k4_ops / PEAK_F32
        else "operations",
        "library_ms": None, "phase_share": split["share"],
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
        wbytes = sum(t.numel() * t.element_size() for t in weights.flat)
        k5_bytes = rays.numel() * 4 + grid_flat.numel() + coarse_flat.numel() \
            + 24 + wbytes + n * (12 + 4 + 4 + 1 + 4 + 4)
        ops_s, core_s = chain_ops_seconds(flops, dtype == torch.bfloat16)
        bound = max(k5_bytes / PEAK_BYTES, ops_s) * 1e3
        k5[label] = dict(errs=errs, ms=ms, plain_ms=plain_ms, bound=bound,
                         bound_cuda_cores=max(k5_bytes / PEAK_BYTES,
                                              core_s) * 1e3,
                         needed=needed, alive_diff=alive_diff,
                         by="bytes" if k5_bytes / PEAK_BYTES >= ops_s
                         else "operations",
                         acc_mean=float(ker[2].mean()))
        print(f"K5 fused_march_full [{label}]: max |err| rgb "
              f"{errs['rgb']:.3e} depth {errs['depth']:.3e} acc "
              f"{errs['acc']:.3e} (tol {tol}); still_alive differs on "
              f"{alive_diff} rays; samples needed {needed} "
              f"({flops / 1e9:.2f} GFLOP); mean acc {k5[label]['acc_mean']:.4f}; "
              f"kernel {ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms (one float32 product "
              f"at the CUDA cores' peak: {k5[label]['bound_cuda_cores']:.4f} "
              f"ms)")
    f32 = k5["f32"]
    rows.append({
        "name": "fused_march_full (K5), Hopper chain mlp_chain_sm90.cuh "
                "(wgmma 3xTF32 / bf16, TMA weight ring)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_march_full.cu",
        "replaces": "nerf_replication_tpu/ops/fused_march.py:514",
        "max_abs_err": max(f32["errs"].values()), "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound"],
        "bound_ms_cuda_cores": f32["bound_cuda_cores"],
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


def _mask(torch, np, kind, m, n, seed, dev):
    """[n] float32 0/1 over the first m rows: a sorted valid prefix (the
    packed stream's layout), random 60%, or all invalid."""
    valid = np.zeros(n, np.float32)
    if kind == "sorted":
        valid[:int(m * PACKED_VALID)] = 1.0
    elif kind == "random":
        valid[:m] = np.random.default_rng(seed).random(m) < 0.6
    return torch.from_numpy(valid).to(dev)


def _k3_checks(torch, np, fmlp, spec, flat, x, v, draw, m, label, dev):
    """K3a/K3b under the three masks at one M: against the plain versions
    (the K1/K2 tolerances), against K1/K2 (K3a bitwise on valid rows,
    exact zeros elsewhere; K3b dx/dv bitwise K2 under draw x valid, dW/db
    within CHUNK_REL), and exactly zero gradients when all rows skip."""
    tol = TOL_MLP[label]
    worst = {"raw": 0.0, "dW_abs": 0.0}
    for kind in MASKS:
        valid = _mask(torch, np, kind, m, x.shape[0], SEED + 7, dev)
        with torch.no_grad():
            raw_m = fmlp.mlp_forward(spec, x, v, flat, m, valid=valid)
            dx_m, dv_m, g_m = fmlp.mlp_backward(spec, x, v, draw, flat, m,
                                                valid=valid)
            raw = fmlp.mlp_forward(spec, x, v, flat, m)
            dmask = draw * valid[:, None]
            dx, dv, g = fmlp.mlp_backward(spec, x, v, dmask, flat, m)
        torch.cuda.synchronize()
        ok = valid > 0
        require(not bool(raw_m[~ok].any()),
                f"K3a {label} {kind}: invalid rows are not exactly 0")
        require(torch.equal(raw_m[ok], raw[ok]),
                f"K3a {label} {kind}: valid rows differ from K1")
        require(torch.equal(dx_m, dx) and torch.equal(dv_m, dv),
                f"K3b {label} {kind}: dx/dv differ from K2 under draw*valid")
        k2_rel = max(_rel(a, b) for a, b in zip(g_m, g))
        require(k2_rel <= CHUNK_REL, f"K3b {label} {kind}: dW/db differ "
                f"from K2 under draw*valid by {k2_rel} > {CHUNK_REL}")
        if kind == "all_invalid":
            require(not bool(dx_m.any()) and not bool(dv_m.any()) and not
                    any(bool(t.any()) for t in g_m),
                    f"K3b {label}: all-invalid gradients are not zero")
            print(f"K3a/K3b [{label}] all_invalid: raw, dx, dv and every "
                  f"gradient exactly 0")
            continue
        with torch.no_grad():
            ref = fmlp.forward_tile(spec, x[:m], v[:m], flat) * \
                valid[:m, None]
            rdx, rdv, rg = fmlp.backward_tile(spec, x[:m], v[:m],
                                              dmask[:m], flat)
        errs = {
            "raw": float((raw_m[:m] - ref).abs().max()),
            "raw_rel": _rel(raw_m[:m], ref),
            "dx_rows": _rows_off(dx_m[:m], rdx, tol["el"]),
            "dv_rows": _rows_off(dv_m[:m], rdv, tol["el"]),
            "dW_fro": max(_fro(a, b) for a, b in zip(g_m, rg)),
            "dW_abs": max(float((a - b).abs().max())
                          for a, b in zip(g_m, rg)),
            "vs_K2_dW_rel": k2_rel,
        }
        print(f"K3a/K3b [{label}] M={m} {kind} ({int(ok.sum())} valid): "
              + json.dumps({k: float(f"{e:.4g}") for k, e in errs.items()}))
        if label == "f32":
            require(errs["raw"] <= tol["raw"], f"K3a f32 {kind}: raw error "
                    f"{errs['raw']} > {tol['raw']}")
        else:
            require(errs["raw_rel"] <= tol["raw_rel"], f"K3a bf16 {kind}: "
                    f"raw error {errs['raw_rel']} > {tol['raw_rel']}")
        for k in ("dx_rows", "dv_rows"):
            require(errs[k] <= tol["rows"], f"K3b {label} {kind}: {k} "
                    f"{errs[k]} > {tol['rows']}")
        require(errs["dW_fro"] <= tol["fro"], f"K3b {label} {kind}: dW "
                f"Frobenius error {errs['dW_fro']} > {tol['fro']}")
        worst = {k: max(worst[k], errs[k]) for k in worst}
    return worst


def _k3_times(torch, np, fmlp, spec, net, flat, label, dev):
    """K3a/K3b at the packed stream's shape (PACKED_M rows, the first 5%
    valid) beside K1/K2 on the same rows and on the compacted valid rows,
    the plain masked versions, and the bounds."""
    m = PACKED_M
    n_valid = int(m * PACKED_VALID)
    x, v, draw = _mlp_inputs(torch, np, spec, net, m, SEED + 9, dev)
    valid = _mask(torch, np, "sorted", m, m, SEED, dev)
    tiles = -(-m // 64)
    skipped = 1.0 - (-(-n_valid // 64)) / tiles
    with torch.no_grad():
        k3a = time_ms(torch, lambda: fmlp.mlp_forward(spec, x, v, flat, m,
                                                      valid=valid), 10)
        k1_all = time_ms(torch, lambda: fmlp.mlp_forward(spec, x, v, flat,
                                                         m), 3)
        k1_val = time_ms(torch, lambda: fmlp.mlp_forward(
            spec, x[:n_valid], v[:n_valid], flat, n_valid), 10)
        k3b = time_ms(torch, lambda: fmlp.mlp_backward(
            spec, x, v, draw, flat, m, valid=valid), 5)
        k2_val = time_ms(torch, lambda: fmlp.mlp_backward(
            spec, x[:n_valid], v[:n_valid], draw[:n_valid], flat, n_valid), 5)
        pl_f = time_ms(torch, lambda: fmlp.forward_tile(
            spec, x, v, flat) * valid[:, None], 2)
        dmask = draw * valid[:, None]
        pl_b = time_ms(torch, lambda: fmlp.backward_tile(
            spec, x, v, dmask, flat), 1)
        # K1 held at the per-ray eval route's rows (4096 rays x 192 slots)
        raw = fmlp.mlp_forward(spec, x, v, flat, m)[:m]
        ref = fmlp.forward_tile(spec, x, v, flat)
    tol = TOL_MLP[label]
    k1_err = float((raw - ref).abs().max()) if label == "f32" \
        else _rel(raw, ref)
    k1_tol = tol["raw"] if label == "f32" else tol["raw_rel"]
    require(k1_err <= k1_tol, f"K1 {label} M={m}: raw error {k1_err} > "
            f"{k1_tol}")
    print(f"K1 fused_mlp_fwd [{label}] M={m} (the per-ray eval route's rows) "
          f"vs plain: {'max abs' if label == 'f32' else 'max rel'} error "
          f"{k1_err:.3e} (tol {k1_tol})")
    fwd = n_valid * mlp_flops_per_sample(spec)
    peak = PEAK_BF16 if spec.compute_dtype == torch.bfloat16 else PEAK_F32
    wbytes = sum(t.numel() * t.element_size() for t in flat)
    n_grad = sum(t.numel() for t in flat)
    row_in = (spec.c_in_pad + spec.c_views_pad + 1) * 4
    a_bytes = m * (row_in + 8 * 4) + wbytes
    a_ops, a_core = chain_ops_seconds(fwd, spec.compute_dtype ==
                                      torch.bfloat16)
    b_bytes = m * (row_in + 8 * 4) + m * (spec.c_in_pad + spec.c_views_pad) \
        * 4 + wbytes + n_grad * 4 * 2
    b_ops = k2_ops_seconds(fwd, peak)
    split = k2_split(torch, fmlp, spec, x, v, draw, flat, m, valid, label)
    res = dict(
        k3a_ms=k3a, k3b_ms=k3b, k1_all_ms=k1_all, k1_valid_ms=k1_val,
        k2_valid_ms=k2_val, k3a_plain=pl_f, k3b_plain=pl_b, k1_err=k1_err,
        k3a_bound=max(a_bytes / PEAK_BYTES, a_ops) * 1e3,
        k3a_bound_cuda_cores=max(a_bytes / PEAK_BYTES, a_core) * 1e3,
        k3b_bound=max(b_bytes / PEAK_BYTES, b_ops) * 1e3,
        k3a_by="bytes" if a_bytes / PEAK_BYTES >= a_ops else "operations",
        k3b_by="bytes" if b_bytes / PEAK_BYTES >= b_ops else "operations",
        skipped_tiles=skipped, k3b_split=split)
    print(f"K3a fused_mlp_fwd_masked [{label}] at the packed shape (M={m}, "
          f"{n_valid} valid, sorted; {skipped:.4f} of {tiles} tiles skip): "
          f"kernel {k3a:.4f} ms, bound {res['k3a_bound']:.4f} ms "
          f"({res['k3a_by']}), plain {pl_f:.3f} ms; K1 on all {m} rows "
          f"{k1_all:.3f} ms, K1 on the {n_valid} compacted valid rows "
          f"{k1_val:.4f} ms")
    print(f"K3b fused_mlp_bwd_masked [{label}] at the packed shape: kernel "
          f"{k3b:.4f} ms, bound {res['k3b_bound']:.4f} ms ({res['k3b_by']}),"
          f" plain {pl_b:.3f} ms; K2 on the compacted valid rows "
          f"{k2_val:.4f} ms")
    return res


def _k1k2_check(torch, fmlp, spec, x, v, draw, flat, m, label,
                trained=False):
    """K1 and K2 on padded rows ``x``/``v`` with cotangent ``draw`` against
    their plain versions, held to TOL_MLP (K1 f32 on a ``trained``
    network's rows to TOL_TRAINED_RAW_REL of max|raw|); ``(errs, dx, dv,
    grads)``."""
    tol = dict(TOL_MLP["bf16" if spec.compute_dtype == torch.bfloat16
                       else "f32"])
    if trained and "raw" in tol:
        tol["raw_rel"] = TOL_TRAINED_RAW_REL
        del tol["raw"]
    with torch.no_grad():
        raw = fmlp.mlp_forward(spec, x, v, flat, m)
        dx, dv, grads = fmlp.mlp_backward(spec, x, v, draw, flat, m)
        ref = fmlp.forward_tile(spec, x[:m], v[:m], flat)
        rdx, rdv, rgrads = fmlp.backward_tile(spec, x[:m], v[:m], draw[:m],
                                              flat)
    torch.cuda.synchronize()
    for name, t in (("raw", raw), ("dx", dx), ("dv", dv), *(
            (f"grad{i}", g) for i, g in enumerate(grads))):
        require(bool(torch.isfinite(t).all()),
                f"K1/K2 {label} M={m}: {name} not finite")
    require(raw.shape[0] == m or float(raw[m:].abs().max()) == 0.0,
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
    if "raw" in tol:
        require(errs["raw"] <= tol["raw"],
                f"K1 {label} M={m} raw error {errs['raw']} > {tol['raw']}")
    else:
        require(errs["raw_rel"] <= tol["raw_rel"],
                f"K1 {label} M={m} raw error {errs['raw_rel']} > "
                f"{tol['raw_rel']}")
    for k in ("dx_rows", "dv_rows"):
        require(errs[k] <= tol["rows"], f"K2 {label} M={m}: {k} "
                f"{errs[k]} > {tol['rows']}")
    require(errs["dW_fro"] <= tol["fro"], f"K2 {label} M={m}: dW "
            f"Frobenius error {errs['dW_fro']} > {tol['fro']}")
    return errs, dx, dv, grads


def phase_mlp_kernels(torch, np, dev):
    """Phase 4: K1/K2 and K3a/K3b against their plain versions at lego
    width."""
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
        for m in MLP_M:
            x, v, draw = _mlp_inputs(torch, np, spec, net, m, SEED + m, dev)
            errs, dx, dv, grads = _k1k2_check(torch, fmlp, spec, x, v, draw,
                                              flat, m, label)
        # K2's row chunks and splits against a forced small chunk with one
        # split, and a second call, at the big M
        with torch.no_grad():
            cdx, cdv, cg = fmlp.mlp_backward(spec, x, v, draw, flat, m,
                                             chunk_rows=K2_CHUNK, splits=1)
            _, _, g2 = fmlp.mlp_backward(spec, x, v, draw, flat, m)
        require(torch.equal(cdx, dx) and torch.equal(cdv, dv),
                f"K2 {label}: dx/dv depend on the chunking")
        require(all(torch.equal(a, b) for a, b in zip(grads, g2)),
                f"K2 {label}: two calls give different dW/db")
        chunk_err = max(_rel(c, g) for c, g in zip(cg, grads))
        require(chunk_err <= CHUNK_REL, f"K2 {label}: dW/db over chunks of "
                f"{K2_CHUNK} rows, one split each, differ by {chunk_err} > "
                f"{CHUNK_REL}")
        print(f"K2 [{label}] M={m}: default chunks and splits vs "
              f"{-(-m // K2_CHUNK)} chunks of {K2_CHUNK} rows with one split"
              f": dx/dv bitwise equal, dW/db max relative {chunk_err:.3e} "
              f"(tol {CHUNK_REL}); two calls bitwise equal")
        k3_errs = _k3_checks(torch, np, fmlp, spec, flat, x, v, draw, m,
                             label, dev)
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
        k1_ops_s, k1_core_s = chain_ops_seconds(
            fwd, dtype == torch.bfloat16)
        k2_bytes = m * (spec.c_in_pad + spec.c_views_pad + 8) * 4 \
            + m * (spec.c_in_pad + spec.c_views_pad) * 4 + wbytes \
            + n_grad * 4 * 2
        k2_ops_s = k2_ops_seconds(fwd, peak)
        split = k2_split(torch, fmlp, spec, x, v, draw, flat, m, None, label)
        b1 = max(k1_bytes / PEAK_BYTES, k1_ops_s) * 1e3
        b1_core = max(k1_bytes / PEAK_BYTES, k1_core_s) * 1e3
        b2 = max(k2_bytes / PEAK_BYTES, k2_ops_s) * 1e3
        out[label] = dict(
            errs=errs, k1_ms=ms_f, k2_ms=ms_b, k1_plain=pl_f, k2_plain=pl_b,
            k1_bound=b1, k1_bound_cuda_cores=b1_core, k2_bound=b2,
            k3_errs=k3_errs, k2_split=split,
            k3=_k3_times(torch, np, fmlp, spec, net, flat, label, dev),
            k1_by="bytes" if k1_bytes / PEAK_BYTES >= k1_ops_s
            else "operations",
            k2_by="bytes" if k2_bytes / PEAK_BYTES >= k2_ops_s
            else "operations")
        print(f"K1 fused_mlp_fwd [{label}] M={m}: kernel {ms_f:.3f} ms "
              f"({fwd / ms_f / 1e9:.2f} TFLOP/s), plain {pl_f:.3f} ms, bound "
              f"{b1:.4f} ms (one float32 product at the CUDA cores' peak: "
              f"{b1_core:.4f} ms); K2 fused_mlp_bwd (+ reduce): kernel {ms_b:.3f} "
              f"ms ({3 * fwd / ms_b / 1e9:.2f} TFLOP/s), plain {pl_b:.3f} ms,"
              f" bound {b2:.4f} ms")
    f32 = out["f32"]
    rows = [{
        "name": "fused_mlp_fwd (K1), Hopper chain mlp_chain_sm90.cuh (wgmma "
                "3xTF32 / bf16, TMA weight ring)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "nerf_replication_tpu/ops/fused_mlp.py:339",
        "max_abs_err": max(f32["errs"]["raw"], f32["k3"]["k1_err"]),
        "ms": f32["k1_ms"],
        "plain_ms": f32["k1_plain"], "bound_ms": f32["k1_bound"],
        "bound_ms_cuda_cores": f32["k1_bound_cuda_cores"],
        "bound_by": f32["k1_by"], "library_ms": None,
    }, {
        "name": "fused_mlp_bwd (K2): K2a fused_mlp_bwd_rows + K2b "
                "fused_mlp_bwd_dw + reduce", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "nerf_replication_tpu/ops/fused_mlp.py:348",
        "max_abs_err": f32["errs"]["dW_abs"], "ms": f32["k2_ms"],
        "plain_ms": f32["k2_plain"], "bound_ms": f32["k2_bound"],
        "bound_by": f32["k2_by"], "library_ms": None,
    }, {
        "name": "fused_mlp_fwd_masked (K3a), Hopper chain "
                "mlp_chain_sm90.cuh (K1's body under MASKED)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "nerf_replication_tpu/ops/fused_mlp.py:370",
        "max_abs_err": f32["k3_errs"]["raw"], "ms": f32["k3"]["k3a_ms"],
        "plain_ms": f32["k3"]["k3a_plain"], "bound_ms": f32["k3"]["k3a_bound"],
        "bound_ms_cuda_cores": f32["k3"]["k3a_bound_cuda_cores"],
        "bound_by": f32["k3"]["k3a_by"], "library_ms": None,
    }, {
        "name": "fused_mlp_bwd_masked (K3b): K2a + K2b under MASKED + "
                "reduce", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "nerf_replication_tpu/ops/fused_mlp.py:397",
        "max_abs_err": f32["k3_errs"]["dW_abs"], "ms": f32["k3"]["k3b_ms"],
        "plain_ms": f32["k3"]["k3b_plain"], "bound_ms": f32["k3"]["k3b_bound"],
        "bound_by": f32["k3"]["k3b_by"], "library_ms": None,
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


def _compile_status(logs, label):
    """The registry line a fit logs under ``compile.aot`` (the CUDA graphs
    of its steps): every entry captured, none in errors."""
    lines = [line for line in logs if line.startswith("compile: ")]
    require(lines, f"{label}: no compile line (compile.aot installs the "
            "CUDA-graph registry on the card)")
    st = json.loads(lines[-1][len("compile: "):])
    require(not st["errors"] and st["captures"] == st["entries"] > 0,
            f"{label}: captures failed: {st}")
    return st


class _Rows:
    """The telemetry rows emitted inside the block, read through a row tap
    (``obs.add_row_tap``); ``of(kind)`` filters them."""

    def __enter__(self):
        from nerf_replication_tpu_torch.obs import add_row_tap

        self.rows = []
        add_row_tap(self.rows.append)
        return self

    def __exit__(self, *exc):
        from nerf_replication_tpu_torch.obs import remove_row_tap

        remove_row_tap(self.rows.append)

    def of(self, kind):
        return [r for r in self.rows if r["kind"] == kind]


def _step_times(rows):
    """Host wall time per step between consecutive ``step`` rows (each row
    follows the stats read that synchronises with the card; log_interval
    1), the first row's step dropped."""
    return [(b["t"] - a["t"]) / b["k"] for a, b in zip(rows, rows[1:])]


def _fit_run(torch, np, lego, opts, label):
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.train.trainer import fit

    cfg = make_cfg(lego, opts)
    logs = []
    t0 = time.perf_counter()
    with _Rows() as tapped:
        state = fit(cfg, device=DEVICE, log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = tapped.of("step")
    losses = [r["stats"]["loss"] for r in rows]
    require(len(rows) == state.step, f"{label}: {len(rows)} rows for "
            f"{state.step} steps")
    require(all(np.isfinite(losses)), f"{label}: non-finite loss")
    times = _step_times(rows)[2:]
    med = float(np.median(times)) * 1e3
    n_rays = int(cfg.task_arg.N_rays)
    st = _compile_status(logs, label)
    res = {"steps": state.step, "median_step_ms": med,
           "rays_per_s": n_rays / med * 1e3, "losses": losses,
           "wall_s": wall, "logs": logs, "state": state, "cfg": cfg,
           "rows": rows, "compile": st}
    print(f"train [{label}]: {state.step} steps in {wall:.1f} s; median "
          f"step {med:.2f} ms = {res['rays_per_s']:.0f} rays/s (N_rays "
          f"{n_rays}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; psnr "
          f"{rows[-1]['stats']['psnr']:.2f}; graphs {json.dumps(st)}")
    return res


def _eager_val(run, summary):
    """``Trainer.val`` of a fit's final state with no registry (every view
    eager), as ``fit`` builds its trainer; the evaluator's summary.json."""
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.evaluators import make_evaluator
    from nerf_replication_tpu_torch.registry import load_attr
    from nerf_replication_tpu_torch.train.trainer import Trainer

    cfg, network = run["cfg"], run["state"].network
    loss = load_attr(cfg.loss_module, "make_loss", "NetworkWrapper")(
        cfg, network)
    trainer = Trainer(cfg, network, loss, make_evaluator(cfg))
    require(trainer.aot is None, "a fresh Trainer holds a registry")
    trainer.val(run["state"], -1, make_dataset(cfg, "test"),
                log=lambda _s: None)
    with open(summary) as f:
        return json.load(f)


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
    for k in ("fused_mlp_fwd", "fused_mlp_bwd", "fused_mlp_bwd_rows",
              "fused_mlp_bwd_dw", "fused_mlp_bwd_reduce"):
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
    # the fit captured its validation view before the epoch loop and
    # replayed it after the last step: it must score the final weights
    with open(summary) as f:
        replayed = json.load(f)
    eager = _eager_val(f32, summary)
    require(eager == replayed, f"the fit's replayed validation {replayed} "
            f"differs from an eager Trainer.val of its final state {eager}")
    print(f"f32 fit's replayed validation equals an eager Trainer.val of "
          f"its final state: per-view PSNR {eager['per_image_psnr']}")

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


EVAL_ROUTES = (
    ("per_ray", []),
    ("packed_hier", ["task_arg.march_coarse_block", "8"]),
    ("packed_clip", ["task_arg.march_clip_bbox", "true"]),
)


def _eval_opts(data, tmp, extra=()):
    """The trained f32 run's opts, both test views, no march_fused."""
    return _train_opts(data, os.path.join(tmp, "out"), "f32") + [
        "test_dataset.cams", "[0, -1, 1]", *extra]


def phase_eval(torch, np, tmp, data):
    """Phase 7: run_evaluate of the trained checkpoint through the grid on
    every eval route (cwd: tmp, where phase 6 saved logs/lego/)."""
    from types import SimpleNamespace

    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.renderer.volume import make_renderer
    from nerf_replication_tpu_torch.run import run_evaluate
    from nerf_replication_tpu_torch.utils.setup import load_trained_network

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    args = SimpleNamespace(cfg_file=lego, device=DEVICE)
    results, counts = {}, {}
    for route, extra in EVAL_ROUTES:
        cfg = make_cfg(lego, _eval_opts(data, tmp, extra))
        fmlp.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_evaluate(cfg, args)
        wall = time.perf_counter() - t0
        counts[route] = dict(fmlp.LAUNCHES)
        require(res["used_grid"], f"eval {route}: the grid did not load")
        st = res["compile"]
        require(st is not None and not st["errors"]
                and st["captures"] == st["entries"] == 1,
                f"eval {route}: the view's march was not captured: {st}")
        require(res["n_images"] == 2, f"eval {route}: {res['n_images']} views")
        require(np.isfinite(res["psnr"]) and np.isfinite(res["ssim"]),
                f"eval {route}: PSNR/SSIM not finite (maps not finite)")
        if route == "per_ray":
            require(counts[route]["fused_mlp_fwd"] > 0,
                    "the per-ray route never launched K1")
        else:
            require(counts[route]["fused_mlp_fwd_masked"] > 0,
                    f"eval {route} never launched K3a")
            require(res["march"] and "overflow_frac" in res["march"],
                    f"eval {route}: no overflow_frac reported")
        results[route] = res
        print(f"eval [{route}] 2 views {TRAIN_HW}x{TRAIN_HW}: PSNR {res['psnr']:.3f} dB, "
              f"SSIM {res['ssim']:.4f}, mean net_time "
              f"{res['mean_net_time_s'] * 1e3:.2f} ms (second view), run "
              f"{wall:.1f} s, truncated {res['n_truncated']}, march "
              f"{json.dumps(res['march'])}, launches {json.dumps(counts[route])}")

    # view 0 of every route again through the plain Network (cuBLAS f32):
    # the per-ray route holds K1 at its [4096 x 192] rows, the packed ones K3a
    from nerf_replication_tpu_torch.datasets import make_dataset

    cfg = make_cfg(lego, _eval_opts(data, tmp))
    net, _ = load_trained_network(cfg, DEVICE, verbose=False)
    batch = make_dataset(cfg, "test").image_batch(0)
    rb = {"rays": torch.from_numpy(batch["rays"]).to(DEVICE),
          "near": float(batch["near"]), "far": float(batch["far"])}
    for route, extra in EVAL_ROUTES:
        maps = []
        for trunk in ([], ["network.nerf.fused_trunk", "false"]):
            r = make_renderer(make_cfg(lego, _eval_opts(data, tmp,
                                                         extra + trunk)), net)
            require(r.load_occupancy_grid(os.path.join(
                "logs", "lego", "occupancy_grid.npz")), "grid did not load")
            with torch.no_grad():
                maps.append(r.render_accelerated(rb))
        err = max(float((maps[0][k] - maps[1][k]).abs().max())
                  for k in ("rgb_map_f", "acc_map_f", "depth_map_f"))
        kernel = "K1" if route == "per_ray" else "K3a"
        require(err <= TOL_EVAL_MAPS, f"{route} view 0 through {kernel} vs "
                f"the plain Network differs by {err} > {TOL_EVAL_MAPS}")
        print(f"{route} view 0: {kernel} vs plain Network (cuBLAS f32) max "
              f"|map diff| {err:.3e} (tol {TOL_EVAL_MAPS})")
    k3a = sum(c["fused_mlp_fwd_masked"] for c in counts.values())
    return results, counts, k3a


def phase_packed_grad(torch, np, tmp, data):
    """Phase 8: one gradient through the packed march with the fused apply
    (K3a forward, K3b backward) against the plain Network's."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.ops.fused_mlp import make_fused_apply
    from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions
    from nerf_replication_tpu_torch.renderer.packed_march import (
        march_rays_packed,
    )
    from nerf_replication_tpu_torch.renderer.occupancy import (
        load_occupancy_pyramid,
    )
    from nerf_replication_tpu_torch.utils.setup import load_trained_network

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    cfg = make_cfg(lego, _eval_opts(data, tmp, EVAL_ROUTES[1][1]))
    net, _ = load_trained_network(cfg, DEVICE, verbose=False)
    levels, bbox = load_occupancy_pyramid(os.path.join(
        "logs", "lego", "occupancy_grid.npz"))
    grid = torch.from_numpy(levels[0]).to(DEVICE)
    bbox = torch.from_numpy(bbox).to(DEVICE)
    rays, rgbs = make_dataset(cfg, "train").ray_bank()
    pick = np.random.default_rng(SEED).choice(rays.shape[0], 4096,
                                              replace=False)
    rays = torch.from_numpy(rays[pick]).to(DEVICE)
    rgbs = torch.from_numpy(rgbs[pick]).to(DEVICE)
    opts = MarchOptions.eval_from_cfg(cfg)
    fused = make_fused_apply(net, cfg)

    def plain(pts, vd, model):
        return net(pts, vd, model=model)

    grads = []
    fmlp.reset_launch_counts()
    for apply_fn in (fused, plain):
        net.zero_grad()
        out = march_rays_packed(apply_fn, rays, 2.0, 6.0, grid, bbox, opts,
                                cap_avg=opts.max_samples)
        loss = torch.mean((out["rgb_map_f"] - rgbs) ** 2)
        loss.backward()
        grads.append({n: p.grad.detach().clone()
                      for n, p in net.fine.named_parameters()})
        if apply_fn is fused:
            counts = dict(fmlp.LAUNCHES)
    for k in ("fused_mlp_bwd_masked", "fused_mlp_bwd_rows",
              "fused_mlp_bwd_dw"):
        require(counts[k] > 0, f"the packed-march gradient never launched {k}")
    for g in grads[0].values():
        require(bool(torch.isfinite(g).all()), "K3b gradient not finite")
    fro = max(_fro(grads[0][n], grads[1][n]) for n in grads[0])
    require(fro <= TOL_MLP["f32"]["fro"], f"packed-march gradient through "
            f"K3b vs the plain Network: relative Frobenius {fro} > "
            f"{TOL_MLP['f32']['fro']}")
    print(f"packed-march gradient (4096 train rays, stream "
          f"{4096 * opts.max_samples} rows, {int(out['march_samples_out'])} "
          f"occupied): K3b vs plain Network max relative Frobenius "
          f"{fro:.3e}; launches {json.dumps(counts)}")
    return counts


def phase_engine_routes(torch, np, tmp, data):
    """Phase 9: one 200x200 request through the engine's staged packed
    route and one through its grid-less chunked route."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.serve import engine_from_cfg

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    with open(os.path.join(data, "procedural", "transforms_test.json")) as f:
        c2w = np.asarray(json.load(f)["frames"][0]["transform_matrix"],
                         np.float32)
    for route, extra in (
            ("packed (march_fused off)", ["task_arg.march_coarse_block", "8"]),
            ("grid-less chunked", ["task_arg.accelerated_renderer", "false"])):
        cfg = make_cfg(lego, _eval_opts(data, tmp, extra + [
            "serve.warmup", "false"]), default_task="run")
        engine = engine_from_cfg(cfg, cfg_file=lego, device=DEVICE)
        require(engine.use_grid == ("packed" in route),
                f"{route}: use_grid {engine.use_grid}")
        cam = engine.default_camera
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image, _ = engine.render_view(c2w, cam["H"], cam["W"], cam["focal"])
        ms = (time.perf_counter() - t0) * 1e3
        require(image.shape == (cam["H"], cam["W"], 3), f"{route}: image")
        st = engine.stats()
        print(f"engine {route}: one {cam['H']}x{cam['W']} request in "
              f"{ms:.1f} ms (first on its route), mean pixel "
              f"{float(image.mean()):.2f}, march {json.dumps(st['march'])}")


def _hash_points(torch, kind, n, d, scale0, gen, dev):
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        cell_points,
        ngp_points,
    )

    if kind == "ray":
        x = torch.from_numpy(ngp_points(SEED))
    elif kind == "cell":
        x = torch.from_numpy(cell_points(n, scale0, d, SEED))
    else:
        return torch.rand((n, d), generator=gen, device=dev)
    require(x.shape == (n, d), f"point set {kind}: {tuple(x.shape)}")
    return x.to(dev)


def _index_add_ms(torch, he, x, g, table, geo):
    """Diagnostic: ``dtable.index_add_`` over the (row, w·g) pairs of K6b
    on ``x``, precomputed (PyTorch's own scatter on the same traffic)."""
    from nerf_replication_tpu_torch.models.encoding.hashgrid import (
        _corner_index,
        corner_weight,
        geometry_levels,
        level_terms,
    )

    c = table.shape[1]
    rows, vals = [], []
    for lvl, (off, size, scale, res, hashed) in enumerate(
            geometry_levels(geo)):
        pos_grid, frac = level_terms(x, scale)
        for bits in range(1 << x.shape[1]):
            rows.append(_corner_index(he._corners(pos_grid, bits), res, size,
                                      hashed) + off)
            vals.append(corner_weight(frac, bits)[:, None]
                        * g[:, lvl * c:(lvl + 1) * c])
    rows, vals = torch.cat(rows), torch.cat(vals)
    dt = torch.zeros_like(table)
    # every kernel of the call: index_add_ alone
    ms = kernel_ms(torch, lambda: dt.index_add_(0, rows, vals), 20, ("",))
    return ms, rows.numel()


def phase_hash_kernels(torch, np, dev):
    """Phase 10: K6/K6b against their plain versions at lego_hash's full
    geometry, on the NGP warm step's ray-ordered points, uniform points,
    and a contention set."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models.encoding import get_encoder
    from nerf_replication_tpu_torch.ops import hash_encode as he

    cfg = make_cfg(os.path.join(REPO, "configs", "nerf", "lego_hash.yaml"))
    enc, out_dim = get_encoder(cfg.network.xyz_encoder)
    geo = enc.geometry
    n_levels, c, d = enc.num_levels, enc.level_dim, enc.input_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    table = torch.rand((enc.n_entries, c), generator=gen, device=dev) * 2 - 1
    print(f"lego_hash table {tuple(table.shape)} ({table.numel() * 4 / 1e6:.1f}"
          f" MB), {sum(geo[3])} of {n_levels} levels hashed")
    res = {}
    for kind, n in HASH_SETS:
        x = _hash_points(torch, kind, n, d, geo[1][0], gen, dev)
        g = torch.randn((n, out_dim), generator=gen, device=dev)
        with torch.no_grad():
            out = he.hash_encode_fwd(x, table, geo)
            ref = he.forward_plain(x, table, geo)
            dt, dx = he.hash_encode_bwd(x, g, table, geo, want_dx=True)
            ref_dt, _ = he.backward_plain(x, g, table, geo, want_dx=False,
                                          accum=torch.float64)
            _, ref_dx = he.backward_plain(x, g, table, geo)
        torch.cuda.synchronize()
        errs = {
            "fwd_abs": float((out - ref).abs().max()),
            "fwd_rel": _rel(out, ref),
            "dtable_fro": _fro(dt.double(), ref_dt),
            "dtable_abs": float((dt.double() - ref_dt).abs().max()),
            "dx_rel": _rel(dx, ref_dx),
        }
        bitwise = bool(torch.equal(out, ref))
        label = f"{kind} N={n}"
        require(bool(torch.isfinite(out).all()) and bool(
            torch.isfinite(dt).all()), f"K6/K6b {label}: not finite")
        require(errs["fwd_rel"] <= TOL_K6, f"K6 {label}: error "
                f"{errs['fwd_rel']} > {TOL_K6} of max|out|")
        require(errs["dtable_fro"] <= TOL_K6B_FRO, f"K6b {label}: dtable "
                f"relative Frobenius error {errs['dtable_fro']} > "
                f"{TOL_K6B_FRO}")
        require(errs["dx_rel"] <= TOL_K6B_DX, f"K6b {label}: dx error "
                f"{errs['dx_rel']} > {TOL_K6B_DX} of max|dx|")
        with torch.no_grad():
            # the main path's calls: the forward, and the backward without
            # dx; the kernels' device time, and each wrapper's whole call
            # (host work, and K6b's zeroing of dtable, included)
            fwd = lambda: he.hash_encode_fwd(x, table, geo)  # noqa: E731
            bwd = lambda: he.hash_encode_bwd(x, g, table, geo)  # noqa: E731
            k6 = kernel_ms(torch, fwd, 20, ("hash_fwd",))
            k6b = kernel_ms(torch, bwd, 20, ("hash_bwd",))
            k6_call, k6b_call = time_ms(torch, fwd, 20), time_ms(torch, bwd,
                                                                 20)
            k6_plain = time_ms(torch, lambda: he.forward_plain(x, table, geo),
                               3)
            k6b_plain = time_ms(torch, lambda: he.backward_plain(
                x, g, table, geo, want_dx=False), 3)
            rows = he.touched_rows(x, geo)
            scatter_ms, pairs = _index_add_ms(torch, he, x, g, table, geo)
        corners = 1 << d
        # per (point, level): pos (fma, floor, sub) per dim; per corner the
        # D weight products and C multiply-adds (forward) or products and
        # atomic adds (backward). Bytes: x and out or g once, and the rows
        # this set touches, read (K6) or read and written (K6b's adds; the
        # wrapper's zeroing of dtable is a separate memset, outside `ms`)
        k6_bytes = x.numel() * 4 + out.numel() * 4 + rows * c * 4
        k6_ops = n * n_levels * (3 * d + corners * (d + 2 * c))
        k6b_bytes = x.numel() * 4 + g.numel() * 4 + 2 * rows * c * 4
        k6b_ops = n * n_levels * (3 * d + corners * (d + 2 * c))
        res[kind] = dict(
            errs=errs, k6_ms=k6, k6b_ms=k6b, k6_plain=k6_plain,
            k6b_plain=k6b_plain, rows=rows, bitwise=bitwise,
            k6_bound=max(k6_bytes / PEAK_BYTES, k6_ops / PEAK_F32) * 1e3,
            k6b_bound=max(k6b_bytes / PEAK_BYTES, k6b_ops / PEAK_F32) * 1e3,
            k6_by="bytes" if k6_bytes / PEAK_BYTES >= k6_ops / PEAK_F32
            else "operations",
            k6b_by="bytes" if k6b_bytes / PEAK_BYTES >= k6b_ops / PEAK_F32
            else "operations")
        r = res[kind]
        print(f"K6/K6b [{label}]: " + json.dumps(
            {k: float(f"{v:.4g}") for k, v in errs.items()})
            + f"; K6 {'bitwise' if bitwise else 'NOT bitwise'} its plain "
            f"version; {rows} table rows touched; K6 kernel {k6:.4f} ms, "
            f"call {k6_call:.4f} ms (bound {r['k6_bound']:.4f} ms, "
            f"{r['k6_by']}; plain {k6_plain:.3f} ms); K6b kernel {k6b:.4f} "
            f"ms, call {k6b_call:.4f} ms incl. zeroing dtable (bound "
            f"{r['k6b_bound']:.4f} ms, {r['k6b_by']}; plain {k6b_plain:.3f} "
            f"ms); diagnostic: index_add_ of the same {pairs} (row, w·g) "
            f"pairs {scatter_ms:.4f} ms")
    ray, uni = res["ray"], res["uniform"]
    return [{
        "name": "hash_encode_fwd (K6)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/hash_encode.cu",
        "replaces": "nerf_replication_tpu/models/encoding/pallas_hash.py:102",
        "max_abs_err": max(v["errs"]["fwd_abs"] for v in res.values()),
        "ms": ray["k6_ms"], "plain_ms": ray["k6_plain"],
        "bound_ms": ray["k6_bound"], "bound_by": ray["k6_by"],
        "library_ms": None, "ms_uniform": uni["k6_ms"],
        "bound_ms_uniform": uni["k6_bound"],
    }, {
        "name": "hash_encode_bwd (K6b)", "route": "cuda",
        "source": "nerf_replication_tpu_torch/csrc/hash_encode.cu",
        "replaces": "nerf_replication_tpu/models/encoding/pallas_hash.py:102",
        "max_abs_err": max(v["errs"]["dtable_abs"] for v in res.values()),
        "ms": ray["k6b_ms"], "plain_ms": ray["k6b_plain"],
        "bound_ms": ray["k6b_bound"], "bound_by": ray["k6b_by"],
        "library_ms": None, "ms_uniform": uni["k6b_ms"],
        "bound_ms_uniform": uni["k6b_bound"],
    }], res


def _hash_opts(data, out, exp, extra=()):
    """The training opts with the hash encoder's MLP (no fused trunk: it
    refuses a learnable encoder) and both test views."""
    return _train_opts(data, out, exp) + [
        "network.nerf.fused_trunk", "false", "test_dataset.cams",
        "[0, -1, 1]", "task_arg.precrop_iters", "0", *extra]


def _ngp_run(torch, np, cfg_name, opts, label):
    """One NGP fit: median step ms and rays/s by phase, the last stats."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.ops import hash_encode as he
    from nerf_replication_tpu_torch.train.trainer import fit

    cfg = make_cfg(os.path.join(REPO, "configs", "nerf", cfg_name), opts)
    logs = []
    he.reset_launch_counts()
    t0 = time.perf_counter()
    with _Rows() as tapped:
        state = fit(cfg, device=DEVICE, log=logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = tapped.of("step")
    counts = dict(he.LAUNCHES)
    losses = [r["stats"]["loss"] for r in rows]
    require(len(rows) == state.step, f"{label}: {len(rows)} rows for "
            f"{state.step} steps")
    require(all(np.isfinite(losses)), f"{label}: non-finite loss")
    n_rays = int(cfg.task_arg.N_rays)
    by_phase = {}
    for phase in ("warm", "march", "step"):
        # NGP rows carry the phase; the ordinary trainer's are plain steps
        times = [dt for r, dt in zip(rows[1:], _step_times(rows)) if
                 {True: "warm", False: "march"}.get(r["stats"].get("warm"))
                 == phase or (phase == "step" and "warm" not in r["stats"])]
        if len(times) > 3:
            med = float(np.median(times[3:])) * 1e3
            by_phase[phase] = {"steps": len(times), "median_step_ms": med,
                               "rays_per_s": n_rays / med * 1e3}
    last = rows[-1]["stats"]
    st = _compile_status(logs, label)
    print(f"ngp [{label}]: {state.step} steps in {wall:.1f} s; "
          f"{json.dumps(by_phase)}; loss {losses[0]:.4f} -> {losses[-1]:.4f};"
          f" last stats " + json.dumps({k: round(v, 4) for k, v in
                                       last.items()})
          + f"; launches {json.dumps(counts)}; graphs {json.dumps(st)}")
    return dict(state=state, rows=rows, logs=logs, counts=counts,
                losses=losses, by_phase=by_phase, cfg=cfg, compile=st,
                opts=opts, cfg_name=cfg_name)


def phase_ngp(torch, np, tmp, data):
    """Phase 11: NGP training (a)-(c) and lego_hash's ordinary trainer (d)
    on the procedural scene of phase 5."""
    out = os.path.join(tmp, "out_hash")
    # (a) the main path: f32, per-ray march, 30 warm + 70 march steps. The
    # grid EMA decays 0.1 per 16-step window (0.95 by default) so that it
    # carves within 100 steps, not thousands
    a = _ngp_run(torch, np, "lego_hash.yaml", _hash_opts(data, out, "ngp_a", [
        "task_arg.ngp_training", "true", "task_arg.ngp_warmup_steps", "30",
        "task_arg.ngp_warmup_max", "30", "task_arg.ngp_grid_decay", "0.1",
        "ep_iter", "50", "train.epoch", "2", "eval_ep", "2", "save_ep", "2",
        "save_latest_ep", "2"]), "a: lego_hash f32 per-ray")
    warm = [r["stats"]["warm"] for r in a["rows"]]
    require(warm == [True] * 30 + [False] * 70, "(a) did not run 30 warm "
            "then 70 march steps")
    first, last = float(np.mean(a["losses"][:10])), float(
        np.mean(a["losses"][-10:]))
    require(last < first, f"(a) loss did not fall: first 10 mean {first}, "
            f"last 10 mean {last}")
    val = [line for line in a["logs"] if line.startswith("ngp val")]
    require(val, "(a) no validation line")
    blob = torch.load(os.path.join(a["cfg"].trained_model_dir, "latest.pt"),
                      weights_only=True)
    require(tuple(blob["grid_ema"].shape) == (64, 64, 64),
            "(a) checkpoint without grid_ema")
    occ = [round(r["stats"]["occupancy"], 4) for r in a["rows"][::10]]
    trunc = [round(r["stats"]["truncated_frac"], 4)
             for r in a["rows"][30::10]]
    print(f"(a) loss mean of first 10 steps {first:.4f}, last 10 {last:.4f};"
          f" occupancy every 10 steps {occ}; truncated_frac in the march "
          f"phase {trunc}; {val[-1]} (both test views)")
    for k in ("hash_encode_fwd", "hash_encode_bwd"):
        require(a["counts"][k] > 0, f"(a) never launched {k}")
    # (b) the packed march in bf16 at 4096 rays
    b = _ngp_run(torch, np, "lego_hash.yaml", _hash_opts(data, out, "ngp_b", [
        "task_arg.ngp_training", "true", "task_arg.ngp_packed_march",
        "true", "precision.compute_dtype", "bfloat16", "task_arg.N_rays",
        "4096", "task_arg.ngp_warmup_steps", "10", "task_arg.ngp_warmup_max",
        "10", "ep_iter", "20", "train.epoch", "1", "eval_ep", "100",
        "save_ep", "100", "save_latest_ep", "100"]),
        "b: lego_hash bf16 packed march")
    over = [round(r["stats"]["overflow_frac"], 4) for r in b["rows"]
            if "overflow_frac" in r["stats"]]
    require(over, "(b) no overflow_frac: the packed march did not run")
    print(f"(b) overflow_frac per march step {over}")
    # (c) the cell-packed encoder (plain PyTorch) with the packed march
    c = _ngp_run(torch, np, "lego_hash_packed.yaml", _hash_opts(
        data, out, "ngp_c", [
            "task_arg.ngp_training", "true", "task_arg.ngp_packed_march",
            "true", "task_arg.ngp_warmup_steps", "10",
            "task_arg.ngp_warmup_max", "10", "ep_iter", "20", "train.epoch",
            "1", "eval_ep", "100", "save_ep", "100", "save_latest_ep",
            "100"]), "c: lego_hash_packed packed march")
    require(sum(c["counts"].values()) == 0,
            "(c) the cell-packed encoder launched K6/K6b")
    # (d) lego_hash through the ordinary coarse+fine trainer; 100 steps and
    # a checkpoint, so that phase 14 serves a coarse branch that carves
    dd = _ngp_run(torch, np, "lego_hash.yaml", _hash_opts(data, out, "hash_d", [
        "ep_iter", "100", "train.epoch", "1", "eval_ep", "100", "save_ep",
        "100", "save_latest_ep", "1"]), "d: lego_hash coarse+fine")
    for k in ("hash_encode_fwd", "hash_encode_bwd"):
        require(b["counts"][k] > 0 and dd["counts"][k] > 0,
                f"(b)/(d) never launched {k}")
    # (a)'s fit captured its eval render beside the steps (one entry, its
    # validation replayed it on both views)
    require(any(line.startswith("ngp val") for line in a["logs"])
            and a["compile"]["entries"] == 3,
            f"(a) registry {a['compile']}: not warm + march + the render")
    counts = {k: a["counts"][k] + b["counts"][k] + dd["counts"][k]
              for k in a["counts"]}
    return counts, {"ngp_a": a, "hash_d": dd}


def _prop_opts(data, out, exp, extra=()):
    """The training opts on lego_proposal.yaml: no precrop, both test
    views."""
    return _train_opts(data, out, exp) + [
        "task_arg.precrop_iters", "0", "test_dataset.cams", "[0, -1, 1]",
        *extra]


def _count_launches(fmlp, fm, counts, fn):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after, adding them into ``counts``; returns what ``fn`` returns."""
    fmlp.reset_launch_counts()
    fm.reset_launch_counts()
    res = fn()
    for k, v in {**fmlp.LAUNCHES, **fm.LAUNCHES}.items():
        counts[k] = counts.get(k, 0) + v
    return res


def _fine_pass_rows(torch, np, net, cfg, step):
    """The encoded rows of the proposal training step's fine pass: 1024
    rays of the training bank (seeded) through the proposal resampler at
    ``step``; ``(x_enc [M, c_in], d_enc [M, c_views])`` with M = 1024 x
    n_fine."""
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.renderer.sampling import (
        proposal_render_rays,
    )
    from nerf_replication_tpu_torch.renderer.volume import RenderOptions

    rays, _ = make_dataset(cfg, "train").ray_bank()
    pick = np.random.default_rng(SEED).integers(0, rays.shape[0],
                                                int(cfg.task_arg.N_rays))
    rays = torch.from_numpy(rays[pick]).to(DEVICE)
    seen = {}

    def apply_fn(pts, vd, model):
        if model == "fine":
            seen["pts"], seen["vd"] = pts, vd
        return net(pts, vd, model=model)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with torch.no_grad():
        proposal_render_rays(apply_fn, rays, float(cfg.task_arg.near),
                             float(cfg.task_arg.far), gen,
                             RenderOptions.from_cfg(cfg, train=True),
                             step=step)
        pts, vd = seen["pts"], seen["vd"]
        x_enc = net.xyz_encoder(pts).reshape(-1, net.input_ch)
        d_enc = net.dir_encoder(vd[:, None, :].expand(pts.shape)).reshape(
            -1, net.input_ch_views)
    return x_enc, d_enc


def phase_proposal(torch, np, tmp, data, lego_net):
    """Phase 12. the proposal-sampling path at lego_proposal.yaml's
    full width on the procedural scene of phase 5 (cwd: tmp). ``lego_net``
    is phase 5's trained lego network (K1's accuracy on trained weights)."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.renderer.occupancy import (
        bake_occupancy_grid,
        save_occupancy_grid,
    )
    from nerf_replication_tpu_torch.renderer.volume import make_renderer
    from nerf_replication_tpu_torch.serve import engine_from_cfg
    from nerf_replication_tpu_torch.tools.chain_accuracy import (
        backward_errors,
        forward_errors,
    )
    from nerf_replication_tpu_torch.tools.slice_inputs import SLICE_OPTS

    prop = os.path.join(REPO, "configs", "nerf", "lego_proposal.yaml")
    out = os.path.join(tmp, "out_prop")
    counts: dict = {}
    # (a) the main path: f32 fused at 1024 rays, 100 steps, one validation
    # of both test views and a checkpoint
    f32 = _count_launches(fmlp, fm, counts, lambda: _fit_run(
        torch, np, prop, _prop_opts(data, out, "prop_f32", [
            "ep_iter", "50", "train.epoch", "2", "eval_ep", "2", "save_ep",
            "2", "save_latest_ep", "2"]), "proposal f32 fused"))
    for k in ("fused_mlp_fwd", "fused_mlp_bwd", "fused_mlp_bwd_rows",
              "fused_mlp_bwd_dw", "fused_mlp_bwd_reduce"):
        require(counts[k] > 0, f"the proposal f32 run never launched {k}")
    cfg = f32["cfg"]
    s = cfg.sampling
    require((s.mode, int(s.n_proposal), int(s.n_fine), int(s.net.D),
             int(s.net.W), int(cfg.network.nerf.W), int(cfg.network.nerf.D))
            == ("proposal", 96, 64, 2, 64, 256, 8),
            "the proposal phase does not run lego_proposal.yaml's widths")
    losses = f32["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    require(last < first, f"proposal f32 loss did not fall: first 10 mean "
            f"{first}, last 10 mean {last}")
    prop_losses = [r["stats"]["loss_prop"] for r in f32["rows"]]
    require(all(np.isfinite(prop_losses)), "loss_prop not finite")
    val = [line for line in f32["logs"] if line.startswith("val epoch")]
    require(val, "proposal: no validation line")
    print(f"proposal f32 loss mean of first 10 steps {first:.4f}, last 10 "
          f"{last:.4f}; loss_prop {prop_losses[0]:.3e} -> "
          f"{prop_losses[-1]:.3e}; {val[-1]}")
    # (b) bf16 at 4096 rays
    bf16 = _count_launches(fmlp, fm, counts, lambda: _fit_run(
        torch, np, prop, _prop_opts(data, out, "prop_bf16", [
            "precision.compute_dtype", "bfloat16", "task_arg.N_rays", "4096",
            "ep_iter", "20", "train.epoch", "1", "eval_ep", "100", "save_ep",
            "100", "save_latest_ep", "100"]), "proposal bf16 fused"))

    # (c) K1/K2 at the fine pass's rows (1024 rays x 64 resampled points)
    # against their plain versions, f32 and bf16 (not counted)
    net = f32["state"].network
    x_enc, d_enc = _fine_pass_rows(torch, np, net, cfg, f32["steps"])
    for label, dtype in (("f32 fine pass", torch.float32),
                         ("bf16 fine pass", torch.bfloat16)):
        spec = fmlp.fused_spec_for(net.clone(dtype))
        m, _, x, v = fmlp._padded_inputs(spec, x_enc, d_enc, 512)
        require(m == 1024 * 64, f"fine pass rows {m}")
        flat = [t.detach() for t in spec.flatten_params(net.fine)]
        draw = torch.zeros((x.shape[0], 8), device=DEVICE)
        draw[:m, :4] = torch.randn((m, 4), device=DEVICE, generator=torch.
                                   Generator(device=DEVICE).manual_seed(SEED))
        _k1k2_check(torch, fmlp, spec, x, v, draw, flat, m, label,
                    trained=True)
        if dtype == torch.float32:
            # K1 and the plain version against float64, here and on the
            # lego-trained network's uniform rows (phase 4's inputs)
            acc = {"proposal fine pass": forward_errors(spec, x, v, flat, m)}
            bwd = {"proposal fine pass": backward_errors(spec, x, v, draw,
                                                         flat, m)}
            lspec = fmlp.fused_spec_for(lego_net)
            lx, lv, ldraw = _mlp_inputs(torch, np, lspec, lego_net, m, SEED,
                                        DEVICE)
            lflat = [t.detach() for t in lspec.flatten_params(lego_net.fine)]
            acc["lego-trained, uniform rows"] = forward_errors(
                lspec, lx, lv, lflat, m)
            bwd["lego-trained, uniform rows"] = backward_errors(
                lspec, lx, lv, ldraw, lflat, m)
            print("K1 f32 vs float64 (max|err| / max|raw|): " + json.dumps(
                {k: {kk: float(f"{vv:.4g}") for kk, vv in a.items()}
                 for k, a in acc.items()}))
            for k, a in acc.items():
                require(a["k1_rel_f64"] <= TOL_K1_F64_REL,
                        f"K1 f32 [{k}] {a['k1_rel_f64']} of max|raw| from "
                        f"float64 > {TOL_K1_F64_REL}")
            print("K2 f32 vs float64 (dx: max|err| / max|dx|; dW: the worst "
                  "tensor's relative Frobenius error): " + json.dumps(
                      {k: {kk: float(f"{vv:.4g}") for kk, vv in a.items()}
                       for k, a in bwd.items()}))

    # (d) a grid baked from the trained FINE branch (a proposal checkpoint
    # never trains its coarse branch, which the bake reads), view 0 through
    # march_rays_proposal_packed: K3a vs the plain Network
    with torch.no_grad():
        grid = bake_occupancy_grid(
            lambda p, d, model: net(p, d, model="fine"), cfg, device=DEVICE)
    grid_path = os.path.join("logs", "lego_proposal", "occupancy_grid.npz")
    save_occupancy_grid(grid_path, grid, cfg.train_dataset.scene_bbox,
                        float(cfg.task_arg.occupancy_grid_threshold))
    batch = make_dataset(cfg, "test").image_batch(0)
    rb = {"rays": torch.from_numpy(batch["rays"]).to(DEVICE),
          "near": float(batch["near"]), "far": float(batch["far"])}
    maps, view_ms, stats = [], [], None
    for trunk in ("true", "false"):
        r = make_renderer(make_cfg(prop, _prop_opts(data, out, "prop_f32", [
            "network.nerf.fused_trunk", trunk])), net)
        require(r.load_occupancy_grid(grid_path), "grid did not load")

        def view():
            with torch.no_grad():
                res = r.render_accelerated(rb)
            torch.cuda.synchronize()
            return res

        view()  # first call: packs the weights
        t0 = time.perf_counter()
        if trunk == "true":
            maps.append(_count_launches(fmlp, fm, counts, view))
            stats = r.last_march_stats
        else:
            before = dict(fmlp.LAUNCHES)
            maps.append(view())
            require(fmlp.LAUNCHES == before, "the plain eval launched K3a")
        view_ms.append((time.perf_counter() - t0) * 1e3)
    require(counts.get("fused_mlp_fwd_masked", 0) > 0,
            "the packed proposal eval never launched K3a")
    err = max(float((maps[0][k] - maps[1][k]).abs().max())
              for k in ("rgb_map_f", "acc_map_f", "depth_map_f"))
    require(err <= TOL_EVAL_MAPS, f"packed proposal view 0 through K3a vs "
            f"the plain Network differs by {err} > {TOL_EVAL_MAPS}")
    n_rows = rb["rays"].shape[0] * 64
    valid = float(stats["march_samples_out"].sum()) / n_rows
    print(f"packed proposal view 0 ({TRAIN_HW}x{TRAIN_HW}): grid occupancy "
          f"{grid.mean():.4f}, stream {n_rows} rows {valid:.1%} valid; K3a "
          f"{view_ms[0]:.1f} ms vs plain Network {view_ms[1]:.1f} ms; max "
          f"|map diff| {err:.3e} (tol {TOL_EVAL_MAPS})")

    # (e) the serving engine on the checkpoint: tiers full (K5, the fine
    # branch) and proposal (the packed proposal march, K3a)
    ecfg = make_cfg(prop, _prop_opts(data, out, "prop_f32", SLICE_OPTS),
                    default_task="run")
    engine = _count_launches(fmlp, fm, counts, lambda: engine_from_cfg(
        ecfg, cfg_file=prop, device=DEVICE))
    require(engine.has_proposal and engine.use_grid,
            "the engine did not load the proposal branch and the grid")
    tier_ms = {}
    for tier, key in (("full", "fused_march_full"),
                      ("proposal", "fused_mlp_fwd_masked")):
        before = counts.get(key, 0)

        def request():
            res = engine.render_request(batch["rays"], rb["near"], rb["far"],
                                        tier=tier)
            torch.cuda.synchronize()
            return res

        t0 = time.perf_counter()
        res = _count_launches(fmlp, fm, counts, request)
        tier_ms[tier] = (time.perf_counter() - t0) * 1e3
        require(res["tier"] == tier, f"engine answered {res['tier']}")
        require(counts.get(key, 0) > before,
                f"the engine's {tier} tier never launched {key}")
        for k in ("rgb_map_f", "acc_map_f", "depth_map_f"):
            require(np.isfinite(res[k]).all()
                    and res[k].shape[0] == rb["rays"].shape[0],
                    f"engine {tier} tier: {k} not finite or misshapen")
    card = smi_line()
    print("proposal phase: " + json.dumps({
        "launches": {"K1": counts["fused_mlp_fwd"],
                     "K2": counts["fused_mlp_bwd"],
                     "K3a": counts["fused_mlp_fwd_masked"]},
        "f32_step_ms": round(f32["median_step_ms"], 3),
        "f32_rays_per_s": round(f32["rays_per_s"], 1),
        "bf16_step_ms": round(bf16["median_step_ms"], 3),
        "bf16_rays_per_s": round(bf16["rays_per_s"], 1),
        "packed_view_ms_k3a": round(view_ms[0], 2),
        "packed_view_ms_plain": round(view_ms[1], 2),
        "engine_request_ms": {k: round(v, 2) for k, v in tier_ms.items()},
        "card": card}))
    return counts


GRAPH_STEPS = 8
# NGP under graphs: K6b sums the table gradient with float32 atomics (and
# the proposal step's interlevel loss backpropagates through torch.gather,
# whose backward adds with atomics), so two runs of one step, eager or
# replayed, differ in the last bits; the parameters (and the NGP grid EMA)
# are held in relative Frobenius norm
TOL_NGP_GRAPH_FRO = 1e-5


def _fro_rel(a, b) -> float:
    num = sum(float((x.double() - y.double()).pow(2).sum())
              for x, y in zip(a, b))
    den = sum(float(x.double().pow(2).sum()) for x in a)
    return (num / max(den, 1e-300)) ** 0.5


def _state_tensors(state):
    """The parameters, then every optimizer state tensor (Adam's moments
    and step counts), in order."""
    params = list(state.network.parameters())
    moments = [v for p in params
               for _, v in sorted(state.optimizer.state[p].items())
               if hasattr(v, "shape")]
    return params, moments


def _max_abs(a, b) -> float:
    return max((float((x.double() - y.double()).abs().max()) for x, y in
                zip(a, b) if x.numel()), default=0.0)


def _copy_state(torch, src, dst):
    """``dst``'s parameters, optimizer state and grid EMA set to
    ``src``'s, in place (where its captured step reads them)."""
    with torch.no_grad():
        for p, q in zip(dst.network.parameters(), src.network.parameters()):
            p.copy_(q)
            for k, v in dst.optimizer.state[p].items():
                v.copy_(src.optimizer.state[q][k])
        if hasattr(src, "grid_ema"):
            dst.grid_ema.copy_(src.grid_ema)


def _step_pairs(torch, make, step, n_steps, label, bitwise):
    """Three trainers from ``make()`` (identical seeded init): eager, eager
    again, graphed. ``step(trainer, state)`` runs one step and returns its
    stats. After each step the second eager run and the graphed run are
    compared with the first: bitwise (``bitwise``), else in relative
    Frobenius norm with every step taken from the first run's state (so
    that one step's atomics are compared, not eight steps' compounded
    through Adam); the graphed registry's captures must not grow."""
    from nerf_replication_tpu_torch.compile import AOTRegistry

    (e1, s1, bank), (e2, s2, _), (g, sg, _) = make(), make(), make()
    g.aot = AOTRegistry(device=torch.device(DEVICE))
    g.aot_register_steps(sg, bank)
    st = g.aot.status()
    require(not st["errors"] and st["captures"] == st["entries"] > 0,
            f"{label}: captures failed: {st}")
    captures = g.aot.captures
    worst = {"eager_eager": 0.0, "eager_graphed": 0.0}
    for i in range(n_steps):
        if not bitwise and i:
            _copy_state(torch, s1, s2)
            _copy_state(torch, s1, sg)
        stats = [step(e1, s1), step(e2, s2), step(g, sg)]
        torch.cuda.synchronize()
        ref = _state_tensors(s1)
        for key, other, ost in (("eager_eager", s2, stats[1]),
                                ("eager_graphed", sg, stats[2])):
            got = _state_tensors(other)
            keys = sorted(stats[0])
            require(sorted(ost) == keys, f"{label}: stats keys differ")
            sa = [stats[0][k].float() for k in keys]
            sb = [ost[k].float() for k in keys]
            if bitwise:
                d = max(_max_abs(ref[0], got[0]), _max_abs(ref[1], got[1]),
                        _max_abs(sa, sb))
            else:
                grids = ([s1.grid_ema], [other.grid_ema]) if hasattr(
                    s1, "grid_ema") else ([], [])
                d = max(_fro_rel(ref[0], got[0]), _fro_rel(*grids))
            worst[key] = max(worst[key], d)
    require(g.aot.captures == captures, f"{label}: captures grew "
            f"{captures} -> {g.aot.captures} after warm-up")
    if bitwise:
        require(worst["eager_graphed"] == 0.0, f"{label}: graphed steps "
                f"differ from eager ones by {worst['eager_graphed']} "
                f"(eager vs eager {worst['eager_eager']})")
    else:
        require(worst["eager_graphed"] <= TOL_NGP_GRAPH_FRO,
                f"{label}: graphed steps {worst['eager_graphed']} "
                f"(relative Frobenius) from eager ones > {TOL_NGP_GRAPH_FRO}"
                f" (eager vs eager {worst['eager_eager']})")
    print(f"graphs [{label}]: {n_steps} steps eager, eager again and "
          f"graphed from one seeded state: worst "
          + ("max |diff| of parameters, Adam state and stats " if bitwise
             else "relative Frobenius of parameters (and grid EMA), each "
             "step from the first run's state ")
          + json.dumps(worst) + f"; {json.dumps(st)}")
    return worst


def _ngp_draws_bitwise(torch, trainer, bank):
    """The NGP step's draws (ray batch, warm depths, refresh cells,
    jitter) replayed from a generator registered with a graph and reseeded
    per step, against a fresh generator of the same (seed, step)."""
    from nerf_replication_tpu_torch.compile import AOTRegistry
    from nerf_replication_tpu_torch.datasets.sampling import (
        reseed,
        sample_rays,
        step_generator,
    )
    from nerf_replication_tpu_torch.renderer.volume import stratified_z_vals

    t = trainer

    def draws(gen):
        rays, rgbs = sample_rays(gen, bank[0], bank[1], t.n_rays)
        z = stratified_z_vals(gen, t.near, t.far, t.n_rays, t.warm_samples,
                              1.0, device=bank[0].device)
        idx = torch.randint(0, t.grid_res**3, (t.cells_per_step,),
                            generator=gen, device=bank[0].device)
        u = torch.rand((t.cells_per_step, 3), generator=gen,
                       device=bank[0].device)
        return rays, rgbs, z, idx, u

    gen = torch.Generator(device=DEVICE)
    reg = AOTRegistry(device=torch.device(DEVICE))
    reg.register("draws", lambda: draws(gen), generators=(gen,))
    reg.compile_all()
    fn = reg.take("draws")
    require(fn is not None, f"draw capture failed: {reg.status()}")
    for step in (0, 1, 17, 1):
        reseed(gen, t.seed, step)
        got = [x.clone() for x in fn()]
        want = draws(step_generator(t.seed, step, DEVICE))
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"replayed draws of step {step} differ from eager ones")


def _engine_pair(torch, np, cfg_path, opts, tier, rays, near, far, label):
    """One request through an engine without graphs and one replaying its
    captured route: bitwise maps, request ms of each, captures constant
    over 5 more requests; the pool's peak memory."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.serve import engine_from_cfg

    res = {}
    for aot in ("false", "true"):
        cfg = make_cfg(cfg_path, opts + ["compile.aot", aot, "serve.buckets",
                                         "[16384]", "serve.warmup", aot],
                       default_task="run")
        torch.cuda.reset_peak_memory_stats()
        engine = engine_from_cfg(cfg, cfg_file=cfg_path, device=DEVICE)
        engine.render_request(rays, near, far, tier=tier)  # first use
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.render_request(rays, near, far, tier=tier)
        ms = (time.perf_counter() - t0) * 1e3
        st = engine.stats()
        res[aot] = {"out": out, "ms": ms, "stats": st,
                    "peak_mb": torch.cuda.max_memory_allocated() / 2**20}
        if aot == "true":
            require(st["captures"] > 0 and not st["compile"]["errors"],
                    f"engine {label}: captures {st['captures']}, "
                    f"{st['compile']}")
            family = {"full": "full", "proposal": "proposal"}[tier]
            require(f"serve/{family}/b16384" in st["captured_routes"],
                    f"engine {label}: the {tier} route was not captured")
            for _ in range(5):
                engine.render_request(rays, near, far, tier=tier)
            require(engine.stats()["captures"] == st["captures"],
                    f"engine {label}: captures grew after warm-up")
    a, b = res["false"]["out"], res["true"]["out"]
    keys = [k for k in a if k != "tier"]
    require(keys and all(np.array_equal(a[k], b[k]) for k in keys),
            f"engine {label}: replayed maps differ from eager ones: " +
            json.dumps({k: float(np.abs(np.asarray(a[k], np.float64)
                                        - np.asarray(b[k])).max())
                        for k in keys}))
    row = {"eager_ms": round(res["false"]["ms"], 2),
           "graphed_ms": round(res["true"]["ms"], 2),
           "peak_mb_eager": round(res["false"]["peak_mb"], 1),
           "peak_mb_graphed": round(res["true"]["peak_mb"], 1),
           "captures": res["true"]["stats"]["captures"]}
    print(f"graphs engine [{label}]: one {rays.shape[0]}-ray request, maps "
          f"bitwise eager; " + json.dumps(row))
    return row


def _warm_restart(torch, tmp, cfg_path, opts):
    """A second process boots an engine on the same checkout: it must run
    no nvcc (every kernel library on disk) and report warm_source disk."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from nerf_replication_tpu_torch.config import make_cfg\n"
        "from nerf_replication_tpu_torch.ops import kernels\n"
        "from nerf_replication_tpu_torch.serve import engine_from_cfg\n"
        "cfg = make_cfg(sys.argv[1], json.loads(sys.argv[2]), "
        "default_task='run')\n"
        "e = engine_from_cfg(cfg, cfg_file=sys.argv[1], device='cuda')\n"
        "s = e.stats()\n"
        "print(json.dumps({'builds': kernels.builds, 'warm_source': "
        "s['warm_source'], 'captures': s['captures'], 'compile': "
        "s['compile']}))\n")
    res = subprocess.run([sys.executable, "-c", code, cfg_path,
                          json.dumps(opts)], capture_output=True, text=True,
                         timeout=300, cwd=tmp)
    require(res.returncode == 0, f"warm restart failed: {res.stderr[-2000:]}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    require(rec["builds"] == 0 and rec["warm_source"] == "disk"
            and rec["captures"] > 0 and not rec["compile"]["errors"],
            f"warm restart: {rec}")
    print(f"graphs warm restart: a second process's engine {json.dumps(rec)}")
    return rec


GRAPH_PROFILES = ("ngp_f32_warm", "ngp_f32_march", "ngp_bf16_packed_march",
                  "proposal_f32_fused", "f32_fused", "bf16_fused")


def phase_graphs(torch, np, tmp, data):
    """Phase 13: the compile registry as CUDA graphs (cwd: tmp, where
    phases 6 and 12 saved their grids)."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.registry import load_attr
    from nerf_replication_tpu_torch.tools.profile_train_step import (
        profile_config,
    )
    from nerf_replication_tpu_torch.tools.slice_inputs import SLICE_OPTS
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer
    from nerf_replication_tpu_torch.train.trainer import (
        Trainer,
        make_train_state,
    )

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    prop = os.path.join(REPO, "configs", "nerf", "lego_proposal.yaml")
    hashy = os.path.join(REPO, "configs", "nerf", "lego_hash.yaml")
    out = os.path.join(tmp, "out_graphs")
    banks = {}

    def bank_of(cfg):
        key = cfg.train_dataset.data_root
        if key not in banks:
            banks[key] = tuple(torch.from_numpy(a).to(DEVICE) for a in
                               make_dataset(cfg, "train").ray_bank())
        return banks[key]

    # (a) lego f32 / bf16 and the proposal f32 step: bitwise
    for label, path, extra in (
            ("lego f32", lego, []),
            ("lego bf16", lego, ["precision.compute_dtype", "bfloat16",
                                 "task_arg.N_rays", "4096"]),
            ("proposal f32", prop, [])):
        cfg = make_cfg(path, _train_opts(data, out, "g") + [
            "task_arg.precrop_iters", "0", *extra])

        def make(cfg=cfg):
            net = make_network(cfg)
            tr = Trainer(cfg, net, load_attr(cfg.loss_module, "make_loss")(
                cfg, net))
            return tr, make_train_state(cfg, net, DEVICE), bank_of(cfg)

        def step(tr, st):
            bank = bank_of(tr.cfg)
            return tr.step(st, bank[0], bank[1])[1]

        # the proposal step's interlevel loss gathers the proposal's
        # cumulative weights: torch.gather's backward adds with atomics, so
        # its steps agree only in norm, eager against eager too
        _step_pairs(torch, make, step, GRAPH_STEPS, label,
                    bitwise=not label.startswith("proposal"))

    # (b) NGP: f32 per-ray warm + march, bf16 packed march
    for label, extra in (
            ("ngp f32 per-ray", []),
            ("ngp bf16 packed", ["precision.compute_dtype", "bfloat16",
                                 "task_arg.N_rays", "4096",
                                 "task_arg.ngp_packed_march", "true"])):
        cfg = make_cfg(hashy, _hash_opts(data, out, "g_ngp", [
            "task_arg.ngp_training", "true", *extra]))

        def make(cfg=cfg):
            tr = NGPTrainer(cfg, make_network(cfg))
            return tr, tr.make_state(DEVICE), bank_of(cfg)

        for warm in (True, False):
            def step(tr, st, warm=warm):
                bank = bank_of(tr.cfg)
                return tr._one_step(st, bank[0], bank[1], warm)

            _step_pairs(torch, make, step, GRAPH_STEPS,
                        f"{label} {'warm' if warm else 'march'}",
                        bitwise=False)
        if not extra:
            tr = NGPTrainer(cfg, make_network(cfg))
            _ngp_draws_bitwise(torch, tr, bank_of(cfg))
            print("graphs: the NGP step's draws replayed bitwise eager ones "
                  "(steps 0, 1, 17, 1)")

    # (c) the engine's captured routes against their eager runs
    batch = make_dataset(make_cfg(lego, _eval_opts(data, tmp)),
                         "test").image_batch(0)
    rays, near, far = batch["rays"].reshape(-1, 6), float(batch["near"]), \
        float(batch["far"])
    serving = {}
    for label, path, opts, tier in (
            ("full (K5)", lego, _eval_opts(data, tmp, SLICE_OPTS), "full"),
            ("march_fused off", lego, _eval_opts(data, tmp, [
                "task_arg.march_coarse_block", "8"]), "full"),
            ("grid-less", lego, _eval_opts(data, tmp, [
                "task_arg.accelerated_renderer", "false"]), "full"),
            ("proposal (K3a)", prop, _prop_opts(
                data, os.path.join(tmp, "out_prop"), "prop_f32",
                SLICE_OPTS), "proposal")):
        serving[label] = _engine_pair(torch, np, path, opts, tier, rays,
                                      near, far, label)

    # (d) a second process: no nvcc, warm_source disk
    restart = _warm_restart(torch, tmp, lego, _eval_opts(data, tmp,
                                                         SLICE_OPTS))

    # (e) eager against graphed steps: ms, rays/s, idle, kernels a step
    profiles = {}
    for label in GRAPH_PROFILES:
        for graphed in (False, True):
            row = profile_config(torch, label, data, tmp, graphed, 8, 3)
            profiles.setdefault(label, {})[row["mode"]] = {
                "step_ms": round(row["step_ms_unprofiled"], 3),
                "rays_per_s": round(row["n_rays"] / row["step_ms_unprofiled"]
                                    * 1e3, 1),
                "idle": round(row["idle_share_unprofiled"], 4),
                "kernels_per_step": round(row["kernels_per_step"], 1),
                "peak_mb": round(row["max_memory_allocated_mb"], 1)}
    print("graphs phase: " + json.dumps({
        "steps": profiles, "engine": serving, "warm_restart": restart,
        "card": smi_line()}))
    return profiles, serving


HASH_ROUTES = (
    ("staged per-ray", ["task_arg.march_fused", "off",
                        "task_arg.march_coarse_block", "0"]),
    ("staged packed", ["task_arg.march_fused", "off",
                       "task_arg.march_coarse_block", "8"]),
    ("gather", ["task_arg.march_fused", "gather",
                "task_arg.march_coarse_block", "8"]),
)
# a hash route's maps through K6 vs through K6's plain version on the card
# (K6 measured bitwise its plain version: phase 10)
TOL_HASH_MAPS = 1e-4


def _request_ms(torch, engine, rays, near, far):
    """One request's host-clock ms (the card idle before it; the maps are
    on the host when it returns) and its maps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.render_request(rays, near, far)
    return (time.perf_counter() - t0) * 1e3, out


def _serve_hash_route(torch, np, run, route, extra, rays, near, far):
    """One checkpoint on one route: an eager engine (``compile.aot false``)
    and a graphed one (the ``full`` family captured, as a server's warm-up
    does; ``gather`` stays eager), one 200x200 request each after a first,
    maps equal; the eager engine again with K6's plain version."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.ops import hash_encode as he
    from nerf_replication_tpu_torch.serve import engine_from_cfg

    cfg_path = os.path.join(REPO, "configs", "nerf", run["cfg_name"])
    res = {}
    for aot in ("false", "true"):
        cfg = make_cfg(cfg_path, run["opts"] + extra + [
            "compile.aot", aot, "serve.buckets", "[16384]", "serve.warmup",
            "false"], default_task="run")
        engine = engine_from_cfg(cfg, cfg_file=cfg_path, device=DEVICE)
        require(engine.use_grid, f"hash {route}: the grid did not load")
        trained = run["state"].network.state_dict()
        require(all(torch.equal(v, trained[k]) for k, v in
                    engine.network.state_dict().items()),
                f"hash {route}: the engine did not load the trained weights")
        engine.warm_up(("full",))
        engine.render_request(rays, near, far)  # first use
        if aot == "true":
            he.reset_launch_counts()
            fm.reset_launch_counts()
        ms, out = _request_ms(torch, engine, rays, near, far)
        st = engine.stats()
        res[aot] = {"ms": ms, "out": out, "engine": engine}
        if aot == "true":
            counts = {"K6": he.LAUNCHES["hash_encode_fwd"],
                      "K4": fm.LAUNCHES["fused_dda_gather"]}
            require(counts["K6"] > 0, f"hash {route}: K6 never launched")
            if route == "gather":
                require(counts["K4"] > 0, "hash gather: K4 never launched")
            else:
                require("serve/full/b16384" in st["captured_routes"]
                        and not st["compile"]["errors"],
                        f"hash {route}: not captured: {st['compile']}")
                captures = st["captures"]
                for _ in range(3):
                    engine.render_request(rays, near, far)
                require(engine.stats()["captures"] == captures,
                        f"hash {route}: captures grew after warm-up")
    a, b = res["false"]["out"], res["true"]["out"]
    keys = ("rgb_map_f", "depth_map_f", "acc_map_f")
    require(all(np.array_equal(a[k], b[k]) for k in keys),
            f"hash {route}: graphed maps differ from eager ones")
    kernel = he.hash_encode_fwd
    he.hash_encode_fwd = he.forward_plain
    try:
        plain = res["false"]["engine"].render_request(rays, near, far)
    finally:
        he.hash_encode_fwd = kernel
    err = max(float(np.abs(a[k] - plain[k]).max()) for k in keys)
    require(err <= TOL_HASH_MAPS, f"hash {route}: maps through K6 vs its "
            f"plain version differ by {err} > {TOL_HASH_MAPS}")
    return {"eager_ms": round(res["false"]["ms"], 2),
            "graphed_ms": round(res["true"]["ms"], 2),
            "vs_plain_k6": err, "mean_acc": float(np.mean(a["acc_map_f"])),
            "launches": counts}


def phase_serve_hash(torch, np, tmp, runs):
    """Phase 14: the hash checkpoints of phase 11 served. Run (d) (lego_hash
    through the coarse+fine trainer) with a grid baked from its trained
    coarse branch, as phase 6 bakes; run (a) (NGP f32) with its own live
    grid, ``grid_ema > threshold`` from the checkpoint, written with
    ``save_occupancy_grid`` (a smoke-side choice, like phase 12's
    fine-branch bake: an NGP run trains no coarse branch to bake). Each
    boots ``engine_from_cfg`` (its own working directory, for its grid
    file) and answers one 200x200 request per route."""
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.renderer.occupancy import (
        bake_occupancy_grid,
        default_grid_path,
        save_occupancy_grid,
    )
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer

    rows, counts = {}, {"K6": 0, "K4": 0}
    for label, run in (("hash_d", runs["hash_d"]), ("ngp_a", runs["ngp_a"])):
        cfg = run["cfg"]
        if label == "hash_d":
            threshold = float(cfg.task_arg.occupancy_grid_threshold)
            grid = bake_occupancy_grid(run["state"].network, cfg,
                                       device=DEVICE)
        else:
            threshold = NGPTrainer(cfg, run["state"].network).threshold
            blob = torch.load(os.path.join(cfg.trained_model_dir,
                                           "latest.pt"), weights_only=True)
            grid = (blob["grid_ema"] > threshold).cpu().numpy()
        require(0.0 < grid.mean() < 1.0, f"hash {label}: grid occupancy "
                f"{grid.mean()}: nothing to march through")
        work = os.path.join(tmp, f"serve_{label}")
        os.makedirs(work, exist_ok=True)
        os.chdir(work)
        save_occupancy_grid(default_grid_path(run["cfg_name"]), grid,
                            cfg.train_dataset.scene_bbox, threshold)
        batch = make_dataset(cfg, "test").image_batch(0)
        for route, extra in HASH_ROUTES:
            row = _serve_hash_route(torch, np, run, route, extra,
                                    batch["rays"], float(batch["near"]),
                                    float(batch["far"]))
            for k in counts:
                counts[k] += row["launches"][k]
            rows[f"{label} {route}"] = {"grid_occupancy": float(grid.mean()),
                                        **row}
        os.chdir(tmp)
    print("serving hash checkpoints, one 200x200 request (3 buckets of "
          "16384 rays; host clock; graphed maps bitwise eager): "
          + json.dumps({"routes": rows, "card": smi_line()}))
    return counts


def _view_ms(torch, render, rays):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render(rays)
    out = {k: v.clone() for k, v in out.items()}
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _graphed_views(torch, np, label, make, register, views):
    """Two views eager (view 0 twice: the eager-vs-eager difference), then
    registered, captured and replayed: view 0 graphed equals eager (bitwise
    or within that difference), no capture after the first view; net_time
    per view and peak MB of each, and view 0's graphed maps."""
    from nerf_replication_tpu_torch.compile import AOTRegistry

    row = {}
    outs = {}
    for mode in ("eager", "graphed"):
        render = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reg = None
        if mode == "graphed":
            reg = AOTRegistry(device=torch.device(DEVICE))
            register(render, reg)
            require(reg.captures == 1 and not reg.summary()["errors"],
                    f"graphed eval {label}: {reg.status()}")
        times = []
        for i, rays in enumerate(views):
            ms, out = _view_ms(torch, render, rays)
            times.append(round(ms, 2))
            if i == 0:
                outs[mode] = out
        if mode == "eager":
            _, again = _view_ms(torch, render, views[0])
        else:
            require(reg.captures == 1, f"graphed eval {label}: captures "
                    f"grew to {reg.captures} after the first view")
        row[mode] = {"net_time_ms": times, "peak_mb": round(
            torch.cuda.max_memory_allocated() / 2**20, 1)}
    diff = {k: float((outs["eager"][k].double() - again[k].double())
                     .abs().max()) for k in outs["eager"]}
    gdiff = {k: float((outs["eager"][k].double() - outs["graphed"][k]
                       .double()).abs().max()) for k in outs["eager"]}
    require(all(gdiff[k] <= diff[k] for k in gdiff),
            f"graphed eval {label}: graphed vs eager {gdiff} beyond eager "
            f"vs eager {diff}")
    row["bitwise"] = all(v == 0.0 for v in gdiff.values())
    row["eager_vs_eager"] = max(diff.values())
    return row, outs["graphed"]


def _chunked_vs_plain(torch, make_cfg, lego, opts, net, rays, near, far,
                      graphed):
    """The chunked render's K1 held against the plain Network (cuBLAS f32)
    at the route's own shapes: view 0 in chunks of 8192 rays, 64 coarse and
    192 fine samples a ray. The fine samples are drawn from the coarse
    weights (an inverse CDF), so a whole plain render moves them too; the
    fine pass is held where both networks see the same rows: K1's coarse
    pass, then the plain fine pass. K1's raw within TOL_TRAINED_RAW_REL of
    max|raw| of the plain version on every row it is given, the coarse maps
    and the same-rows fine maps within TOL_EVAL_MAPS; the K1 render equals
    the graphed view 0 bitwise. The whole-render fine difference and how
    far the fine samples moved are printed."""
    from nerf_replication_tpu_torch.renderer.volume import (
        make_renderer,
        map_chunks,
        render_rays,
    )

    fused = make_renderer(make_cfg(lego, opts), net)
    plain_r = make_renderer(make_cfg(lego, opts + [
        "network.nerf.fused_trunk", "false"]), net)
    k1, plain = fused._apply_fn(), plain_r._apply_fn()
    raw = {"coarse": [0.0, 0.0], "fine": [0.0, 0.0]}  # max|diff|, max|raw|
    fine_pts = {"k1": [], "plain": []}

    def k1_held(pts, viewdirs, model):
        out = k1(pts, viewdirs, model)
        ref = plain(pts, viewdirs, model)
        raw[model][0] = max(raw[model][0], float((out - ref).abs().max()))
        raw[model][1] = max(raw[model][1], float(ref.abs().max()))
        if model == "fine":
            fine_pts["k1"].append(pts)
        return out

    def plain_seen(pts, viewdirs, model):
        if model == "fine":
            fine_pts["plain"].append(pts)
        return plain(pts, viewdirs, model)

    def k1_coarse(pts, viewdirs, model):
        return (k1 if model == "coarse" else plain)(pts, viewdirs, model)

    options = fused.eval_options
    maps = {}
    for name, apply_fn in (("k1", k1_held), ("plain", plain_seen),
                           ("k1_coarse", k1_coarse)):
        with torch.no_grad():
            maps[name] = map_chunks(
                lambda rc, f=apply_fn: render_rays(f, rc, near, far, None,
                                                   options),
                rays, options.chunk_size)
    require(all(torch.equal(maps["k1"][k], graphed[k]) for k in graphed),
            "the chunked render through K1 differs from its graphed view 0")

    def diff(a, b, branch):
        return max(float((maps[a][k + branch] - maps[b][k + branch])
                         .abs().max()) for k in ("rgb_map", "acc_map",
                                                 "depth_map"))

    res = {"raw_rel": {m: e[0] / e[1] for m, e in raw.items()},
           "coarse_maps": diff("k1", "plain", "_c"),
           "fine_maps_same_rows": diff("k1", "k1_coarse", "_f"),
           "fine_maps_whole_render": diff("k1", "plain", "_f"),
           "fine_samples_moved": max(
               float((a - b).abs().max())
               for a, b in zip(fine_pts["k1"], fine_pts["plain"]))}
    for m, rel in res["raw_rel"].items():
        require(rel <= TOL_TRAINED_RAW_REL, f"chunked view 0: K1's {m} raw "
                f"vs the plain Network {rel} of max|raw| > "
                f"{TOL_TRAINED_RAW_REL}")
    for k in ("coarse_maps", "fine_maps_same_rows"):
        require(res[k] <= TOL_EVAL_MAPS, f"chunked view 0 through K1 vs the "
                f"plain Network: {k} differ by {res[k]} > {TOL_EVAL_MAPS}")
    print("chunked (Trainer.val) view 0, K1 vs plain Network (cuBLAS f32), "
          f"tol raw {TOL_TRAINED_RAW_REL} of max|raw|, maps "
          f"{TOL_EVAL_MAPS}: " + json.dumps(res))


def phase_eval_graphs(torch, np, tmp, data, ngp_run):
    """Phase 15: the eval renders as CUDA graphs (cwd: tmp, where phase 6
    saved logs/lego/). Phase 7's three routes (``Renderer.aot_register_eval``
    of the march) and ``Trainer.val``'s chunked render of the trained f32
    checkpoint, on both 200x200 test views; the NGP val of phase 11's run
    (a) (``NGPTrainer.aot_register_render``). K1/K3a launch counts reset
    right before the graphed views and read right after."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.evaluators import make_evaluator
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.ops import hash_encode as he
    from nerf_replication_tpu_torch.renderer.volume import make_renderer
    from nerf_replication_tpu_torch.utils.setup import load_trained_network
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    cfg0 = make_cfg(lego, _eval_opts(data, tmp))
    net, _ = load_trained_network(cfg0, DEVICE, verbose=False)
    test_ds = make_dataset(cfg0, "test")
    batches = [test_ds.image_batch(i) for i in range(len(test_ds))]
    views = [torch.from_numpy(b["rays"]).to(DEVICE) for b in batches]
    near, far = float(batches[0]["near"]), float(batches[0]["far"])
    n_rays = views[0].shape[0]
    rows, counts = {}, {}
    for route, extra in EVAL_ROUTES + (("chunked (Trainer.val)", None),):
        cfg = make_cfg(lego, _eval_opts(data, tmp, extra or []))
        grid = extra is not None

        def make(cfg=cfg, grid=grid):
            r = make_renderer(cfg, net)
            if grid:
                require(r.load_occupancy_grid(os.path.join(
                    "logs", "lego", "occupancy_grid.npz")), "grid")

            def render(rays):
                with torch.no_grad():
                    return r.render_accelerated({"rays": rays, "near": near,
                                                 "far": far})
            render.renderer = r
            return render

        def register(render, reg, grid=grid):
            r = render.renderer
            r.aot_register_eval(reg, n_rays, near, far, chunked=not grid)
            reg.compile_all()
            require(r.aot_install(reg) == 1, "eval entry not installed")
            fmlp.reset_launch_counts()

        rows[route], graphed = _graphed_views(torch, np, route, make,
                                              register, views)
        counts[route] = dict(fmlp.LAUNCHES)
    _chunked_vs_plain(torch, make_cfg, lego, _eval_opts(data, tmp), net,
                      views[0], near, far, graphed)
    for route, c in counts.items():
        key = "fused_mlp_fwd_masked" if "packed" in route else "fused_mlp_fwd"
        require(c[key] > 0, f"graphed eval {route} never launched {key}")

    # the NGP val of run (a): its entry captured once, both views replayed
    cfg = ngp_run["cfg"]
    state = ngp_run["state"]
    ngp = {}
    for mode in ("eager", "graphed"):
        trainer = NGPTrainer(cfg, state.network)
        if mode == "graphed":
            from nerf_replication_tpu_torch.compile import AOTRegistry

            trainer.aot = AOTRegistry(device=torch.device(DEVICE))
            trainer.aot_register_render(state, n_rays)
            require(trainer.aot.captures == 1 and not
                    trainer.aot.summary()["errors"],
                    f"ngp val: {trainer.aot.status()}")
            he.reset_launch_counts()
        times, maps = [], None
        for rays in views:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = trainer.render_image(state, {"rays": rays})
            out = {k: v.clone() for k, v in out.items()}
            torch.cuda.synchronize()
            times.append(round((time.perf_counter() - t0) * 1e3, 2))
            if maps is None:
                maps = out
        result = trainer.val(state, make_dataset(cfg, "test"),
                             make_evaluator(cfg), log=lambda _s: None)
        ngp[mode] = {"net_time_ms": times, "maps": maps, "val": result}
        if mode == "graphed":
            (name,) = trainer.aot.names()
            require(trainer.aot.captures == 1
                    and trainer.aot.take(name).replays == 2 * len(views),
                    f"ngp val: captures {trainer.aot.captures}, replays "
                    f"{trainer.aot.take(name).replays}")
            counts["ngp val"] = {"hash_encode_fwd":
                                 he.LAUNCHES["hash_encode_fwd"]}
    a, b = ngp["eager"]["maps"], ngp["graphed"]["maps"]
    require(all(torch.equal(a[k], b[k]) for k in a),
            "ngp val: graphed maps differ from eager ones")
    require(ngp["eager"]["val"] == ngp["graphed"]["val"],
            f"ngp val: {ngp['eager']['val']} vs {ngp['graphed']['val']}")
    rows["ngp val (run a)"] = {m: {"net_time_ms": ngp[m]["net_time_ms"]}
                               for m in ngp}
    rows["ngp val (run a)"]["bitwise"] = True
    print("graphed eval, both 200x200 test views (host clock, synced; peak "
          "= max_memory_allocated over the mode): " + json.dumps(
              {"routes": rows, "card": smi_line()}))
    return {"K1": sum(c["fused_mlp_fwd"] for r, c in counts.items()
                      if r != "ngp val"),
            "K3a": sum(c["fused_mlp_fwd_masked"] for r, c in counts.items()
                       if r != "ngp val"),
            "K6": counts["ngp val"]["hash_encode_fwd"]}


# the SIGTERM run of phase 16 (d): the train CLI, with a row tap that sends
# the process SIGTERM as the step-OPS_SIGTERM_STEP row goes out
_SIGTERM_DRIVER = """
import os, signal, sys
sys.path.insert(0, {repo!r})
from nerf_replication_tpu_torch.obs import add_row_tap


def tap(row):
    if row["kind"] == "step" and row["step"] == {step}:
        os.kill(os.getpid(), signal.SIGTERM)


add_row_tap(tap)
from nerf_replication_tpu_torch.train.__main__ import main
sys.exit(main(sys.argv[1:]))
"""
OPS_SIGTERM_STEP = 15
# K1 / K2a / K2b kernel symbols in the profiler's trace (csrc/fused_mlp.cu,
# csrc/fused_mlp_bwd.cu) and the launch counters they match
TRACE_KERNELS = {"fused_mlp_fwd_kernel": "fused_mlp_fwd",
                 "fused_mlp_bwd_rows_kernel": "fused_mlp_bwd_rows",
                 "fused_mlp_bwd_dw_kernel": "fused_mlp_bwd_dw"}


def _telemetry(cfg):
    from nerf_replication_tpu_torch.obs import validate_row

    path = os.path.join(str(cfg.record_dir), "telemetry.jsonl")
    require(os.path.exists(path), f"no telemetry at {path}")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        errs = validate_row(r)
        require(not errs, f"telemetry row {r['kind']} invalid: {errs}")
    return rows


def _net_tensors(torch, net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _bitwise(torch, a, b, label):
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    require(not bad, f"{label}: differ bitwise in {bad[:4]}")


class _Snapshots:
    """A row tap for a rollback: on the ``rollback`` fault row, keeps a copy
    of ``latest.pt`` (the checkpoint about to be restored) and, on the next
    ``step`` row, the live network's tensors (and ``grid()``'s) after the
    first step taken from the restored state."""

    def __init__(self, torch, model_dir, keep_dir, net, grid=None):
        self.torch, self.model_dir, self.keep_dir = torch, model_dir, keep_dir
        self.net, self.grid = net, grid
        self.after, self.after_step, self.rolled = None, None, 0

    def __call__(self, row):
        import shutil

        if row["kind"] == "fault" and row["fault"] == "rollback":
            self.rolled += 1
            os.makedirs(self.keep_dir, exist_ok=True)
            for f in os.listdir(self.model_dir):
                if f.startswith("latest"):
                    shutil.copy(os.path.join(self.model_dir, f),
                                self.keep_dir)
        elif (row["kind"] == "step" and self.rolled
              and self.after is None):
            self.after = _net_tensors(self.torch, self.net)
            if self.grid is not None:
                self.after["grid_ema"] = self.grid().detach().clone()
            self.after_step = row["step"]


def phase_ops(torch, np, tmp, data, graphed_step_ms):
    """Phase 16: the ops layers (obs/, resil/) on the lego fit (K1/K2), the
    NGP fit (K6/K6b), serving (K5) and the eval CLI (cwd: tmp)."""
    from nerf_replication_tpu_torch import resil
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.obs import add_row_tap, remove_row_tap
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.ops import hash_encode as he
    from nerf_replication_tpu_torch.train.trainer import fit

    t_phase = time.perf_counter()
    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    out = os.path.join(tmp, "out_ops")
    steps_ep = 30

    def lego_opts(exp, extra=()):
        return _train_opts(data, out, exp) + [
            "task_arg.precrop_iters", "0", "ep_iter", str(steps_ep),
            "train.epoch", "2", "eval_ep", "100", "save_ep", "1",
            "save_latest_ep", "1", *extra]

    report = {"card": smi_line()}
    env = dict(os.environ, PYTHONPATH=REPO)

    # (a) lego f32 graphed through the train CLI, telemetry on
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "nerf_replication_tpu_torch.train",
         "--cfg_file", lego, "--device", DEVICE, *lego_opts("ops_a")],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    require(res.returncode == 0, f"ops (a): the train CLI failed "
            f"(rc {res.returncode}): {res.stderr[-2000:]}")
    cfg_a = make_cfg(lego, lego_opts("ops_a"))
    rows = _telemetry(cfg_a)
    kinds = [r["kind"] for r in rows]
    steps = [r for r in rows if r["kind"] == "step"]
    require(len(steps) == 2 * steps_ep, f"ops (a): {len(steps)} step rows")
    require(all(r["dispatch_s"] >= 0 and r["block_s"] >= 0 for r in steps),
            "ops (a): a step row lacks its dispatch/block split")
    first = kinds.index("step")
    late = [r["name"] for r in rows[first:] if r["kind"] == "compile"]
    require(not late, f"ops (a): compile rows after the first step: {late}")
    early = [r for r in rows[:first] if r["kind"] == "compile"]
    mem = [r for r in rows if r["kind"] == "memory"]
    require(len(mem) == 2, f"ops (a): memory rows {mem}")
    meta = rows[0]
    require(meta["kind"] == "run_meta", f"ops (a): first row {meta}")
    on_card = DEVICE == "cuda"  # else a CPU rehearsal of the phase
    if on_card:
        require(any(r.get("phase") == "capture" for r in early),
                "ops (a): no capture row before the first step")
        require(all(r["devices"] and r["devices"][0]["bytes_in_use"] > 0
                    and r["devices"][0]["peak_bytes_in_use"] > 0
                    and r["devices"][0]["bytes_limit"] > 0 for r in mem),
                f"ops (a): memory rows {mem}")
        require(meta["platform"] == "gpu" and meta["device_kind"]
                == torch.cuda.get_device_name(0), f"ops (a): run_meta {meta}")
    step_ms = float(np.median(_step_times(steps)[2:])) * 1e3
    report["a"] = {"rows": len(rows), "kinds": sorted(set(kinds)),
                   "compile_rows": len(early),
                   "step_ms_telemetry_on": round(step_ms, 3),
                   "step_ms_graphed_phase13": graphed_step_ms,
                   "memory_row": mem[-1]["devices"],
                   "wall_s": round(time.perf_counter() - t0, 1)}
    print(f"ops (a): lego f32 through the train CLI, {len(rows)} rows, all "
          f"valid, no compile row after the first step; step "
          f"{step_ms:.3f} ms with telemetry on against phase 13's graphed "
          f"{graphed_step_ms} ms")

    fmlp.reset_launch_counts()
    fm.reset_launch_counts()
    he.reset_launch_counts()
    # (b) the profiler window over steps [20, 25) of one epoch
    t0 = time.perf_counter()
    cfg_b = make_cfg(lego, lego_opts("ops_b", [
        "train.epoch", "1", "train.profile.start_step", "20",
        "train.profile.num_steps", "5"]))
    # the launches a step: the counters' change between the step-10 and
    # step-20 rows (the capture's warm-up step launched before step 1)
    marks = {}

    def mark(row):
        if row["kind"] == "step" and row["step"] in (10, 20):
            marks[row["step"]] = dict(fmlp.LAUNCHES)

    add_row_tap(mark)
    try:
        fit(cfg_b, device=DEVICE, log=lambda _s: None)
    finally:
        remove_row_tap(mark)
    per_step = {k: (marks[20][k] - marks[10][k]) / 10
                for k in TRACE_KERNELS.values()}
    trace = os.path.join(str(cfg_b.record_dir), "profile", "trace.json")
    require(os.path.exists(trace), f"ops (b): no trace at {trace}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    counts = {sym: sum(1 for e in kern if sym in e["name"])
              for sym in TRACE_KERNELS}
    want = {sym: 5 * per_step[key] for sym, key in TRACE_KERNELS.items()}
    require(counts == want and (all(v > 0 for v in want.values())
                                or not on_card),
            f"ops (b): kernel events in the window {counts}, want 5 x the "
            f"launches a step {want}")
    # the host's annotations (the card's copies are gpu_user_annotation)
    dispatches = sum(1 for e in events
                     if e.get("name") == "train/step_dispatch"
                     and e.get("cat") == "user_annotation")
    require(dispatches == 5, f"ops (b): {dispatches} step dispatches traced")
    report["b"] = {"kernel_events": counts, "launches_per_step": per_step,
                   "kernel_events_total": len(kern),
                   "wall_s": round(time.perf_counter() - t0, 1)}
    print(f"ops (b): the window traced {counts} kernel events = 5 x "
          f"{per_step} launches a step, in 5 graphed steps")

    # (c) a nan_loss rollback in epoch 1: one rollback, no capture after
    # it, and the first graphed step after the restore equal to an eager
    # step from the restored checkpoint
    t0 = time.perf_counter()
    cfg_c = make_cfg(lego, lego_opts("ops_c"))
    net_c = make_network(cfg_c)
    snap = _Snapshots(torch, cfg_c.trained_model_dir,
                      os.path.join(out, "ops_c_restored"), net_c)
    plan = resil.FaultPlan().add("train.loss", "nan_loss",
                                 after=steps_ep + 5)
    add_row_tap(snap)
    try:
        with resil.injecting(plan):
            state_c = fit(cfg_c, network=net_c, device=DEVICE,
                          log=lambda _s: None)
    finally:
        remove_row_tap(snap)
    rows_c = _telemetry(cfg_c)
    faults = [(r["fault"], r["injected"]) for r in rows_c
              if r["kind"] == "fault"]
    require(faults == [("nan_loss", True), ("rollback", False)],
            f"ops (c): fault rows {faults}")
    roll = next(i for i, r in enumerate(rows_c) if r.get("fault") ==
                "rollback")
    late = [r["name"] for r in rows_c[roll:] if r["kind"] == "compile"]
    require(not late, f"ops (c): captures after the rollback: {late}")
    last = [r for r in rows_c if r["kind"] == "step"][-1]
    require(state_c.step == 2 * steps_ep and np.isfinite(
        last["stats"]["loss"]), f"ops (c): step {state_c.step}, last loss "
        f"{last['stats']['loss']}")
    eager = _uncounted(_eager_lego_step, torch, cfg_c, snap.keep_dir)
    require(snap.after_step == steps_ep + 1, f"ops (c): first step after "
            f"the rollback is {snap.after_step}")
    _bitwise(torch, snap.after, eager, "ops (c): the graphed step after the "
             "restore against an eager step from the restored checkpoint")
    report["c"] = {"faults": faults, "final_loss": last["stats"]["loss"],
                   "wall_s": round(time.perf_counter() - t0, 1)}
    print("ops (c): one rollback, no capture after it, the graphed step "
          "after the restore bitwise an eager step from the checkpoint; "
          f"final loss {last['stats']['loss']:.5f}")

    # (d) SIGTERM mid-epoch 0 (the train CLI), then a resume in-process:
    # the final weights equal run (a)'s (the same config, uninterrupted)
    t0 = time.perf_counter()
    opts_d = lego_opts("ops_d")
    res = subprocess.run(
        [sys.executable, "-c", _SIGTERM_DRIVER.format(
            repo=REPO, step=OPS_SIGTERM_STEP),
         "--cfg_file", lego, "--device", DEVICE, *opts_d],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    require(res.returncode == 0, f"ops (d): the SIGTERM run exited "
            f"{res.returncode}: {res.stderr[-2000:]}")
    cfg_d = make_cfg(lego, opts_d)
    latest = os.path.join(cfg_d.trained_model_dir, "latest.pt")
    require(resil.verify_checksum(latest) is True,
            "ops (d): latest.pt or its sidecar was not flushed")
    blob = torch.load(latest, weights_only=True)
    require((blob["step"], blob["epoch_it"]) == (OPS_SIGTERM_STEP,
                                                 OPS_SIGTERM_STEP),
            f"ops (d): flushed step {blob['step']} epoch_it "
            f"{blob['epoch_it']}")
    state_d = fit(cfg_d, device=DEVICE, log=lambda _s: None)
    require(state_d.step == 2 * steps_ep, f"ops (d): resumed to step "
            f"{state_d.step}")
    whole = torch.load(os.path.join(cfg_a.trained_model_dir, "latest.pt"),
                       weights_only=True)["network"]
    _bitwise(torch, {k: v.cpu() for k, v in
                     _net_tensors(torch, state_d.network).items()}, whole,
             "ops (d): resumed against uninterrupted final weights")
    report["d"] = {"flushed_step": blob["step"],
                   "wall_s": round(time.perf_counter() - t0, 1)}
    print(f"ops (d): SIGTERM at step {OPS_SIGTERM_STEP} flushed latest.pt "
          "+ sidecar and exited 0; the resumed run's weights equal the "
          "uninterrupted run's bitwise")
    counts_k12 = dict(fmlp.LAUNCHES)

    # (e) NGP f32 per-ray (K6/K6b), telemetry and one nan_loss rollback
    t0 = time.perf_counter()
    hashy = os.path.join(REPO, "configs", "nerf", "lego_hash.yaml")
    cfg_e = make_cfg(hashy, _hash_opts(data, out, "ops_e", [
        "task_arg.ngp_training", "true", "task_arg.ngp_warmup_steps", "20",
        "task_arg.ngp_warmup_max", "20", "task_arg.ngp_grid_decay", "0.1",
        "ep_iter", "25", "train.epoch", "2", "eval_ep", "100",
        "save_ep", "1", "save_latest_ep", "1"]))
    net_e = make_network(cfg_e)
    holder = {}
    snap_e = _Snapshots(torch, cfg_e.trained_model_dir,
                        os.path.join(out, "ops_e_restored"), net_e,
                        grid=lambda: holder["grid"])
    plan = resil.FaultPlan().add("train.loss", "nan_loss", after=30)
    from nerf_replication_tpu_torch.train import ngp as ngp_mod

    make_state = ngp_mod.NGPTrainer.make_state

    def keep(self, device):  # the live grid, for the snapshot tap
        st = make_state(self, device)
        holder["grid"] = st.grid_ema
        return st

    ngp_mod.NGPTrainer.make_state = keep
    add_row_tap(snap_e)
    try:
        with resil.injecting(plan):
            state_e = fit(cfg_e, network=net_e, device=DEVICE,
                          log=lambda _s: None)
    finally:
        remove_row_tap(snap_e)
        ngp_mod.NGPTrainer.make_state = make_state
    rows_e = _telemetry(cfg_e)
    faults = [r["fault"] for r in rows_e if r["kind"] == "fault"]
    require(faults == ["nan_loss", "rollback"], f"ops (e): faults {faults}")
    require(state_e.step == 50, f"ops (e): step {state_e.step}")
    eager = _uncounted(_eager_ngp_step, torch, cfg_e, snap_e.keep_dir)
    errs = {k: _fro_rel([snap_e.after[k]], [eager[k]]) for k in eager}
    worst = max(errs.values())
    require(worst <= 1e-5, f"ops (e): the step after the restore is "
            f"{worst} (relative Frobenius) from an eager step from the "
            f"restored checkpoint: {errs}")
    report["e"] = {"faults": faults, "max_rel_fro": worst,
                   "grid_ema_rel_fro": errs["grid_ema"],
                   "wall_s": round(time.perf_counter() - t0, 1)}
    print(f"ops (e): NGP rollback; grid_ema and the weights after the "
          f"first step from the restore within {worst:.3g} of an eager "
          "step from the restored checkpoint (and its phase sidecar)")
    counts_k6 = dict(he.LAUNCHES)

    # (f) serving through K5 with tracing, metrics and the breaker cycle
    report["f"] = _ops_serving(torch, np, tmp, data, out)
    counts_k5 = dict(fm.LAUNCHES)

    # (g) the eval CLI writes run_meta and eval rows
    t0 = time.perf_counter()
    from nerf_replication_tpu_torch.run import main as run_main

    opts_g = _eval_opts(data, tmp) + [
        "test_dataset.cams", "[0, 1, 1]",
        "record_dir", os.path.join(out, "ops_g_record")]
    require(run_main(["--type", "evaluate", "--cfg_file", lego,
                      "--device", DEVICE, *opts_g]) == 0,
            "ops (g): run --type evaluate failed")
    rows_g = _telemetry(make_cfg(lego, opts_g))
    require([r["kind"] for r in rows_g] == ["run_meta", "eval"]
            and rows_g[0]["component"] == "evaluate"
            and np.isfinite(rows_g[1]["metrics"]["psnr"]),
            f"ops (g): rows {rows_g}")
    report["g"] = {"psnr": rows_g[1]["metrics"]["psnr"],
                   "fps": rows_g[1]["fps"],
                   "wall_s": round(time.perf_counter() - t0, 1)}
    ops = {"K1": counts_k12["fused_mlp_fwd"],
           "K2": counts_k12["fused_mlp_bwd"],
           "K5": counts_k5["fused_march_full"],
           "K6": counts_k6["hash_encode_fwd"],
           "K6b": counts_k6["hash_encode_bwd"]}
    report["launches"] = ops
    report["wall_s"] = round(time.perf_counter() - t_phase, 1)
    print("ops phase: " + json.dumps(report))
    return ops


def _uncounted(fn, *args):
    """``fn(*args)`` with the kernels' launch counters left as they were:
    the eager reference steps of phase 16 are checks, not its main path."""
    from nerf_replication_tpu_torch.ops import fused_march, fused_mlp
    from nerf_replication_tpu_torch.ops import hash_encode

    saved = [(m.LAUNCHES, dict(m.LAUNCHES))
             for m in (fused_march, fused_mlp, hash_encode)]
    try:
        return fn(*args)
    finally:
        for counters, before in saved:
            counters.clear()
            counters.update(before)


def _eager_lego_step(torch, cfg, ckpt_dir):
    """One eager step (no registry) of a fresh lego trainer from the
    checkpoint in ``ckpt_dir``: the network's tensors after it."""
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.registry import load_attr
    from nerf_replication_tpu_torch.train.checkpoint import load_model
    from nerf_replication_tpu_torch.train.trainer import (
        Trainer,
        make_train_state,
    )

    net = make_network(cfg)
    tr = Trainer(cfg, net, load_attr(cfg.loss_module, "make_loss")(cfg, net))
    state, _, _ = load_model(ckpt_dir, make_train_state(cfg, net, DEVICE))
    bank = tuple(torch.from_numpy(a).to(DEVICE)
                 for a in make_dataset(cfg, "train").ray_bank())
    tr.step(state, bank[0], bank[1])
    return _net_tensors(torch, net)


def _eager_ngp_step(torch, cfg, ckpt_dir):
    """One eager NGP burst of one step from the checkpoint (and phase
    sidecar) in ``ckpt_dir``: the network's tensors and the grid after."""
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train.checkpoint import (
        load_model,
        load_phase_state,
    )
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer

    net = make_network(cfg)
    tr = NGPTrainer(cfg, net)
    state, _, _ = load_model(ckpt_dir, tr.make_state(DEVICE))
    require(tr.restore_phase(load_phase_state(ckpt_dir),
                             expect_step=state.step),
            "ops (e): the checkpoint's phase sidecar did not restore")
    bank = tuple(torch.from_numpy(a).to(DEVICE)
                 for a in make_dataset(cfg, "train").ray_bank())
    tr.multi_step(state, bank[0], bank[1], 1)
    return {**_net_tensors(torch, net),
            "grid_ema": state.grid_ema.detach().clone()}


def _ops_serving(torch, np, tmp, data, out):
    """Phase 16 (f): a lego engine (``full``, K5) behind the batcher with
    tracing, metrics and the flight recorder; ``serve.dispatch`` faults
    open the breaker, which sheds, goes half open and closes, with no
    capture in the engine; spans descend from their requests; the HTTP
    entry's /metrics and /healthz."""
    import threading
    import urllib.request

    from nerf_replication_tpu_torch import resil
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.obs import (
        configure_tracing,
        init_run,
        reset_metrics,
    )
    from nerf_replication_tpu_torch.serve import (
        TIER_NAMES,
        MicroBatcher,
        engine_from_cfg,
    )
    from nerf_replication_tpu_torch.serve.__main__ import make_server
    from nerf_replication_tpu_torch.tools.slice_inputs import SLICE_OPTS

    t0 = time.perf_counter()
    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    cfg = make_cfg(lego, _eval_opts(data, tmp, SLICE_OPTS) + [
        "serve.buckets", "[16384]", "serve.max_batch_rays", "16384",
        "record_dir", os.path.join(out, "ops_f_record")],
        default_task="run")
    flight_dir = os.path.join(out, "ops_f_flight")
    # the HTTP entry's set-up: telemetry, metrics, tracing, flight recorder
    emitter = init_run(cfg, component="serve")
    reset_metrics()
    trs = configure_tracing(enabled=True)
    resil.install_flight_recorder(resil.FlightRecorder(flight_dir))
    engine = engine_from_cfg(cfg, cfg_file=lego, device=DEVICE)
    captures = engine.stats()["captures"]
    require(captures > 0 or DEVICE != "cuda",
            "ops (f): the engine captured nothing")
    batch = make_dataset(cfg, "test").image_batch(0)
    rays = batch["rays"].reshape(-1, 6)[:16384]
    near, far = float(batch["near"]), float(batch["far"])
    clock = {"t": 0.0}
    breaker = resil.CircuitBreaker(threshold=2, cooldown_s=1.0,
                                   clock=lambda: clock["t"])
    batcher = MicroBatcher(engine, start=False, breaker=breaker)
    seen = []

    def request(root_name="serve.request"):
        with trs.span(root_name) as root:
            try:
                fut = batcher.submit(rays, near, far)
            except resil.BreakerOpenError:
                return "shed", root
        batcher.pump()
        try:
            return fut.result(60.0)["tier"], root
        except OSError:
            return "error", root

    try:
        plan = resil.FaultPlan().add("serve.dispatch", "io_error", after=1,
                                     times=2)
        with resil.injecting(plan):
            for i in range(5):
                if i == 4:
                    clock["t"] += 1.5  # past the cooldown
                status, root = request()
                seen.append((status, breaker.state))
        # two failures open the breaker; the probe after the cooldown runs
        # two tiers down the ladder (the pre-open pressure) and closes it
        require([s for s, _ in seen] == ["full", "error", "error", "shed",
                                         TIER_NAMES[2]]
                 and [b for _, b in seen] == ["closed", "closed", "open",
                                              "open", "closed"],
                 f"ops (f): {seen}")
        require(os.path.exists(os.path.join(
            flight_dir, "flight_breaker_open.json")),
            "ops (f): no flight dump when the breaker opened")
        require(engine.stats()["captures"] == captures,
                "ops (f): the engine captured during the breaker cycle")
        server = make_server(engine, batcher, port=0, slo_target_ms=100.0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                text = r.read().decode()
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
    finally:
        batcher.close(drain=False)
        resil.uninstall_flight_recorder()
        configure_tracing(enabled=False)
        emitter.close()
    rows = _telemetry(cfg)
    spans = [r for r in rows if r["kind"] == "span"]
    by_id = {s["span_id"]: s for s in spans}
    mine = [s for s in spans if s["trace_id"] == root.context.trace_id]
    names = {s["name"] for s in mine}
    require({"serve.request", "serve.queue", "serve.batch", "serve.dispatch",
             "serve.device", "serve.scatter"} <= names,
            f"ops (f): spans {names}")
    for s in mine:
        p = s
        while p.get("parent_id"):
            p = by_id[p["parent_id"]]
        require(p["span_id"] == root.context.span_id,
                f"ops (f): span {s['name']} not under its request")
    breaker_rows = [r["state"] for r in rows if r["kind"] == "breaker"]
    require(breaker_rows == ["open", "half_open", "closed"],
            f"ops (f): breaker rows {breaker_rows}")
    samples = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
    require(samples and all(len(ln.rsplit(" ", 1)) == 2 and float(
        ln.rsplit(" ", 1)[1]) == float(ln.rsplit(" ", 1)[1]) for ln in samples),
        "ops (f): /metrics is not Prometheus text")
    served = sum(float(ln.rsplit(" ", 1)[1]) for ln in samples
                 if ln.startswith('serve_requests_total{status="ok"'))
    require(served == 2, f"ops (f): /metrics counts {served} served "
            "requests, not 2")
    require("slo" in health and health["slo"]["requests"] >= 2,
            f"ops (f): /healthz {health}")
    ok_ms = [s["dur_s"] * 1e3 for s in mine if s["name"] == "serve.batch"]
    row = {"statuses": seen, "captures": captures, "rows": len(rows),
           "batch_ms": round(ok_ms[0], 3) if ok_ms else None,
           "metrics_lines": len(samples), "slo": health["slo"],
           "wall_s": round(time.perf_counter() - t0, 1)}
    print(f"ops (f): breaker cycle {seen} with {captures} captures and none "
          "added; flight dump written; spans under their requests; "
          "/metrics and /healthz served")
    return row


# -- phase 17: the model zoo ---------------------------------------------------

# (a)'s light-stage capture (cameras, frames, H = W) and steps; (b)'s smaller
# capture for the other time-conditioned encoders, and its steps
ZOO_CAPTURE = (4, 8, 256)
ZOO_STEPS = 100
ZOO_SMALL_CAPTURE = (2, 4, 128)
ZOO_ENC_STEPS = 20
ZOO_ENCODERS = ("triplane", "cuda_hashgrid_4d", "cuda_hashgrid_coef",
                "dnerf", "cuda_motion2d", "cuda_dnerf_ngp_tensorf")
# the hash geometry of configs/light_stage/dynamic.yaml, given to every (b)
# encoder (the tri-plane's planes too)
ZOO_HASH = ["num_levels", "16", "level_dim", "2", "base_resolution", "16",
            "log2_hashmap_size", "19", "desired_resolution", "1024"]
# opts appended to every fit of the phase: empty on the card (the stated
# widths); a CPU rehearsal of the phase shrinks the fits through it
ZOO_OPTS: list = []
IMG_FIT_STEPS = 200
REAL_STEPS = 20
MESH_RES = 128
VIDEO_FRAMES = 24
_ZOO_DRIVER = """
import json, sys
sys.path.insert(0, {repo!r})
from nerf_replication_tpu_torch.ops import hash_encode as he
from nerf_replication_tpu_torch.train.__main__ import main
rc = main(sys.argv[1:])
with open({out!r}, "w") as f:
    json.dump(dict(he.LAUNCHES), f)
sys.exit(rc)
"""


def _zoo_paths(out, exp):
    return ["exp_name", exp,
            "trained_model_dir", os.path.join(out, "trained"),
            "trained_config_dir", os.path.join(out, "config"),
            "record_dir", os.path.join(out, "record"),
            "result_dir", os.path.join(out, "result"), "log_interval", "1"]


def _zoo_fit(torch, np, cfg_path, opts, label):
    """An in-process fit of ``opts`` (graphed on the card): its step rows'
    losses (finite), median step ms and registry line."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.train.trainer import fit

    cfg = make_cfg(cfg_path, list(opts) + ZOO_OPTS)
    logs = []
    with _Rows() as tapped:
        state = fit(cfg, device=DEVICE, log=logs.append)
    rows = tapped.of("step")
    losses = [r["stats"]["loss"] for r in rows]
    require(len(rows) == state.step > 0 and all(np.isfinite(losses)),
            f"zoo {label}: {len(rows)} step rows, losses {losses[-3:]}")
    st = _compile_status(logs, label) if DEVICE == "cuda" else None
    med = float(np.median(_step_times(rows)[2:])) * 1e3
    return {"cfg": cfg, "state": state, "losses": losses, "step_ms": med,
            "logs": logs, "compile": st}


def _record_hash_calls(torch, fn):
    """``fn()`` with every K6 / K6b wrapper call's inputs recorded (the
    kernels still run); the calls as dicts."""
    from nerf_replication_tpu_torch.ops import hash_encode as he

    calls = []
    fwd, bwd = he.hash_encode_fwd, he.hash_encode_bwd

    def rec_fwd(x, table, geometry):
        calls.append({"x": x.detach().clone(), "table": table.detach().clone(),
                      "geo": geometry, "kind": "fwd"})
        return fwd(x, table, geometry)

    def rec_bwd(x, g, table, geometry, want_dx=False):
        calls.append({"x": x.detach().clone(), "g": g.detach().clone(),
                      "table": table.detach().clone(), "geo": geometry,
                      "kind": "bwd", "want_dx": want_dx})
        return bwd(x, g, table, geometry, want_dx)

    he.hash_encode_fwd, he.hash_encode_bwd = rec_fwd, rec_bwd
    try:
        fn()
    finally:
        he.hash_encode_fwd, he.hash_encode_bwd = fwd, bwd
    return calls


def _one_step_calls(torch, np, run):
    """One eager loss + backward of a fit's final network on 1024 rays of
    its bank, with the K6/K6b calls recorded (uncounted: a check)."""
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.train.loss import NeRFLoss

    cfg, net = run["cfg"], run["state"].network
    rays, rgbs = make_dataset(cfg, "train").ray_bank()
    idx = np.random.default_rng(SEED).integers(0, len(rays), 1024)
    batch = {"rays": torch.from_numpy(rays[idx]).to(DEVICE),
             "rgbs": torch.from_numpy(rgbs[idx]).to(DEVICE),
             "near": float(cfg.task_arg.near), "far": float(cfg.task_arg.far)}
    loss = NeRFLoss(cfg, net)

    def step():
        net.zero_grad()
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        _, value, _ = loss(batch, gen=gen, train=True)
        value.backward()

    return _uncounted(_record_hash_calls, torch, step)


def _bare_ms(torch, he, call, iters: int = 20) -> float:
    """Device ms of one K6 or K6b launch on a recorded call's inputs:
    CUDA events around back-to-back library calls into buffers made once
    (K6b adds into one zeroed dtable), so neither the wrapper's output
    allocation nor its memset of dtable is timed. (Traced by
    torch.profiler after phase 16's profiler window, K6b lost kernel
    events: 0.031 ms on the calls these time at 0.103.)"""
    import ctypes

    from nerf_replication_tpu_torch.ops import kernels

    x, table, geo = call["x"].contiguous(), call["table"].contiguous(), \
        call["geo"]
    lib = kernels.load("hash_encode")
    desc = ctypes.byref(he._desc(geo))
    n, d, c = x.shape[0], x.shape[1], table.shape[1]
    stream = kernels._stream(x.device)
    if call["kind"] == "fwd":
        out = torch.empty((n, len(geo[1]) * c), device=x.device)

        def launch():
            return lib.nrt_hash_encode_fwd(kernels._ptr(x), n, d,
                                           kernels._ptr(table), c, desc,
                                           kernels._ptr(out), stream)
    else:
        g = call["g"].contiguous()
        dt = torch.zeros_like(table)
        dx = torch.empty_like(x) if call["want_dx"] else None

        def launch():
            return lib.nrt_hash_encode_bwd(
                kernels._ptr(x), n, d, kernels._ptr(table), c, desc,
                kernels._ptr(g), kernels._ptr(dt), kernels._ptr(dx), stream)

    require(launch() == 0, "a bare hash-kernel launch failed")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _hash_call_check(torch, he, call, label):
    """K6 (forward call) or K6b (backward call, dx when it was asked for)
    against the plain versions on the call's own inputs, phase 10's gates;
    the kernel's ms and bound."""
    x, table, geo = call["x"], call["table"], call["geo"]
    n, d = x.shape
    c = table.shape[1]
    n_levels = len(geo[1])
    rows = he.touched_rows(x, geo)
    ops = n * n_levels * (3 * d + (1 << d) * (d + 2 * c))
    with torch.no_grad():
        if call["kind"] == "fwd":
            out = he.hash_encode_fwd(x, table, geo)
            ref = he.forward_plain(x, table, geo)
            err = {"fwd_rel": _rel(out, ref),
                   "fwd_abs": float((out - ref).abs().max())}
            require(err["fwd_rel"] <= TOL_K6, f"K6 {label}: {err}")
            ms = _bare_ms(torch, he, call)
            nbytes = x.numel() * 4 + out.numel() * 4 + rows * c * 4
        else:
            g, want_dx = call["g"], call["want_dx"]
            dt, dx = he.hash_encode_bwd(x, g, table, geo, want_dx=want_dx)
            ref_dt, _ = he.backward_plain(x, g, table, geo, want_dx=False,
                                          accum=torch.float64)
            err = {"dtable_fro": _fro(dt.double(), ref_dt),
                   "dtable_abs": float((dt.double() - ref_dt).abs().max())}
            require(err["dtable_fro"] <= TOL_K6B_FRO, f"K6b {label}: {err}")
            if want_dx:
                _, ref_dx = he.backward_plain(x, g, table, geo)
                err["dx_rel"] = _rel(dx, ref_dx)
                require(err["dx_rel"] <= TOL_K6B_DX, f"K6b dx {label}: {err}")
            ms = _bare_ms(torch, he, call)
            nbytes = (x.numel() * 4 + g.numel() * 4 + 2 * rows * c * 4
                      + (x.numel() * 4 if want_dx else 0))
    bound = max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3
    by = "bytes" if nbytes / PEAK_BYTES >= ops / PEAK_F32 else "operations"
    return {"label": label, "n": n, "d": d, "rows": rows, "errs": err,
            "ms": ms, "bound_ms": bound, "bound_by": by,
            "want_dx": call.get("want_dx", False)}


def phase_zoo(torch, np, tmp, data):
    """Phase 17: the model zoo (cwd: tmp, where phase 6 saved lego's grid):
    (a) light-stage dynamic.yaml through the train CLI, (b) the other
    encoders with K6/K6b held to their plain versions at D = 2 and 4 (and
    dx), (c) img_fit, (d) the real captures, (e) the mesh and (f) the
    video of phase 5's checkpoint."""
    from nerf_replication_tpu_torch import native
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.datasets.img_fit import Dataset as ImgDs
    from nerf_replication_tpu_torch.datasets.procedural import (
        generate_light_stage_capture,
        write_real_capture,
    )
    from nerf_replication_tpu_torch.ops import fused_march as fm
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.ops import hash_encode as he
    from nerf_replication_tpu_torch.utils.setup import load_trained_network

    t_phase = time.perf_counter()
    on_card = DEVICE == "cuda"  # else a CPU rehearsal of the phase
    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    dyn = os.path.join(REPO, "configs", "light_stage", "dynamic.yaml")
    out = os.path.join(tmp, "out_zoo")
    report = {"card": smi_line()}
    zoo = {"K1": 0, "K2": 0, "K5": 0, "K6": 0, "K6b": 0}

    # (a) dynamic.yaml at its width through the train CLI
    cams, frames, hw = ZOO_CAPTURE
    cap = os.path.join(tmp, "zoo_capture")
    t0 = time.perf_counter()
    generate_light_stage_capture(cap, n_cams=cams, n_frames=frames, H=hw,
                                 W=hw)
    gen_s = time.perf_counter() - t0
    half = ZOO_STEPS // 2
    opts_a = ["train_dataset.data_root", cap, "test_dataset.data_root", cap,
              "network.xyz_encoder.num_frames", str(frames),
              "test_dataset.frames", f"[0, -1, {frames // 2}]",
              "ep_iter", str(half), "train.epoch", "2", "eval_ep", "2",
              "save_ep", "2", "save_latest_ep", "2",
              *_zoo_paths(out, "zoo_a"), *ZOO_OPTS]
    counts_file = os.path.join(tmp, "zoo_a_launches.json")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c",
         _ZOO_DRIVER.format(repo=REPO, out=counts_file),
         "--cfg_file", dyn, "--device", DEVICE, *opts_a],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    require(res.returncode == 0, f"zoo (a): the train CLI failed (rc "
            f"{res.returncode}): {res.stderr[-2000:]}")
    wall_a = time.perf_counter() - t0
    cfg_a = make_cfg(dyn, opts_a)
    rows = _telemetry(cfg_a)
    steps = [r for r in rows if r["kind"] == "step"]
    require(len(steps) == ZOO_STEPS, f"zoo (a): {len(steps)} step rows")
    losses = [r["stats"]["loss"] for r in steps]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    require(all(np.isfinite(losses)) and last < first, f"zoo (a): loss "
            f"first 10 mean {first}, last 10 mean {last}")
    kinds = [r["kind"] for r in rows]
    late = [r["name"] for r in rows[kinds.index("step"):]
            if r["kind"] == "compile"]
    require(not late, f"zoo (a): captures after warm-up: {late}")
    st_a = None
    if on_card:
        st_a = _compile_status(res.stdout.splitlines(), "zoo (a)")
        require(st_a["entries"] == 2, f"zoo (a): the step and the "
                f"validation view should be captured: {st_a}")
    with open(os.path.join(cfg_a.result_dir, "summary.json")) as f:
        val = json.load(f)
    require(val["per_image_psnr"] and all(
        np.isfinite(val["per_image_psnr"])), f"zoo (a): validation {val}")
    net_a, _ = load_trained_network(cfg_a, DEVICE, verbose=False)
    latent = float(net_a.xyz_encoder.latent_t.detach().abs().max())
    require(latent > 1e-4, f"zoo (a): max|latent_t| {latent} stayed in its "
            "init range")
    with open(counts_file) as f:
        launches_a = json.load(f)
    require(not on_card or (launches_a["hash_encode_fwd"] > 0
                            and launches_a["hash_encode_bwd"] > 0),
            f"zoo (a): hash launches {launches_a}")
    zoo["K6"] += launches_a["hash_encode_fwd"]
    zoo["K6b"] += launches_a["hash_encode_bwd"]
    step_a = float(np.median(_step_times(steps)[2:])) * 1e3
    report["a"] = {"capture": f"{cams} cams x {frames} frames at {hw}x{hw}",
                   "generate_s": round(gen_s, 1), "wall_s": round(wall_a, 1),
                   "step_ms": round(step_a, 3), "loss_first10": first,
                   "loss_last10": last, "max_abs_latent": latent,
                   "val_psnr": val["psnr"], "launches": launches_a,
                   "compile": st_a}
    print(f"zoo (a): dynamic.yaml through the train CLI, {ZOO_STEPS} "
          f"graphed steps, step {step_a:.3f} ms, loss {first:.4f} -> "
          f"{last:.4f}, max|latent_t| {latent:.3g}, val PSNR "
          f"{val['psnr']:.2f} over {len(val['per_image_psnr'])} views, "
          f"K6/K6b launches {launches_a}")

    # (b) every other encoder at its full geometry, 20 graphed steps each
    scams, sframes, shw = ZOO_SMALL_CAPTURE
    small = os.path.join(tmp, "zoo_capture_small")
    generate_light_stage_capture(small, n_cams=scams, n_frames=sframes,
                                 H=shw, W=shw)
    steps_b = ["ep_iter", str(ZOO_ENC_STEPS), "train.epoch", "1",
               "eval_ep", "100", "save_ep", "100", "save_latest_ep", "100"]
    checks, report["b"] = [], {}
    for enc in ZOO_ENCODERS:
        keys = [f"network.xyz_encoder.{k}" if i % 2 == 0 else k
                for i, k in enumerate(ZOO_HASH)]
        if enc == "triplane":  # a static encoder: 6-column rays
            cfg_path = lego
            opts = _train_opts(data, out, f"zoo_{enc}") + [
                "network.nerf.fused_trunk", "false",
                "network.nerf.W", "64", "network.nerf.D", "3",
                "network.nerf.skips", "[1]", "task_arg.precrop_iters", "0",
                "network.xyz_encoder.type", enc, *keys,
                "network.xyz_encoder.bbox",
                "[[-1.5,-1.5,-1.5],[1.5,1.5,1.5]]", *steps_b]
        else:
            cfg_path = dyn
            opts = ["train_dataset.data_root", small,
                    "test_dataset.data_root", small,
                    "network.xyz_encoder.type", enc,
                    "network.xyz_encoder.num_frames", str(sframes),
                    *steps_b, *_zoo_paths(out, f"zoo_{enc}")]
        he.reset_launch_counts()
        run = _zoo_fit(torch, np, cfg_path, opts, f"zoo (b) {enc}")
        zoo["K6"] += he.LAUNCHES["hash_encode_fwd"]
        zoo["K6b"] += he.LAUNCHES["hash_encode_bwd"]
        require(he.LAUNCHES["hash_encode_fwd"] > 0 or not on_card,
                f"zoo (b) {enc}: K6 never launched")
        calls = _one_step_calls(torch, np, run)
        seen = set()
        for call in calls:
            d = call["x"].shape[1]
            key = (call["kind"], d, call.get("want_dx", False))
            if key in seen or (d == 3 and not key[2]):
                continue  # phase 10 holds D = 3 without dx
            seen.add(key)
            if on_card:
                checks.append(_uncounted(
                    _hash_call_check, torch, he, call,
                    f"{enc} {call['kind']} D={d}"
                    + (" dx" if key[2] else "")))
        report["b"][enc] = {"step_ms": round(run["step_ms"], 3),
                            "loss": [run["losses"][0], run["losses"][-1]],
                            "hash_calls": sorted(seen)}
        print(f"zoo (b) {enc}: {ZOO_ENC_STEPS} steps at {run['step_ms']:.3f}"
              f" ms, loss {run['losses'][0]:.4f} -> {run['losses'][-1]:.4f};"
              f" hash calls {sorted(seen)}")
    by_kind = {}
    for c in checks:
        print(f"zoo (b) K6/K6b vs plain [{c['label']}, N={c['n']}]: "
              + json.dumps({k: float(f"{v:.4g}") for k, v in
                            c["errs"].items()})
              + f"; {c['rows']} rows touched; kernel {c['ms']:.4f} ms, "
              f"bound {c['bound_ms']:.4f} ms ({c['bound_by']})")
        by_kind.setdefault((c["label"].split()[1], c["d"]), c)
    if on_card:
        for kind, d in (("fwd", 2), ("fwd", 4), ("bwd", 2), ("bwd", 4)):
            require((kind, d) in by_kind, f"zoo (b): no {kind} call at "
                    f"D={d} checked")
        require(any(c["want_dx"] for c in checks),
                "zoo (b): no dx was checked")
    report["b_kernels"] = [{k: c[k] for k in ("label", "n", "rows", "ms",
                                              "bound_ms", "bound_by")}
                           for c in checks]

    # (c) img_fit at lego_view0.yaml's width on the procedural scene
    img_cfg = os.path.join(REPO, "configs", "img_fit", "lego_view0.yaml")
    ep = IMG_FIT_STEPS // 2
    opts_c = ["scene", "procedural", "train_dataset.data_root", data,
              "test_dataset.data_root", data,
              "test_dataset.input_ratio", "0.5", "ep_iter", str(ep),
              "train.epoch", "2", "eval_ep", "2", "save_ep", "100",
              "save_latest_ep", "100", *_zoo_paths(out, "zoo_img_fit")]
    run_c = _zoo_fit(torch, np, img_cfg, opts_c, "zoo (c) img_fit")
    val_c = [line for line in run_c["logs"] if line.startswith("val epoch")]
    require(val_c, "zoo (c): no validation")
    psnr_c = float(val_c[-1].split("psnr:")[1].split()[0])
    gt = ImgDs(data, "procedural", split="test", input_ratio=0.5).img
    flat = float(-10 * np.log10(np.mean((gt - 0.5) ** 2)))
    require(psnr_c > flat, f"zoo (c): PSNR {psnr_c} <= flat gray {flat}")
    rdir = run_c["cfg"].result_dir
    for name in ("metrics.json", os.path.join("vis", "res.png")):
        require(os.path.exists(os.path.join(rdir, name)),
                f"zoo (c): no {name}")
    report["c"] = {"step_ms": round(run_c["step_ms"], 3), "psnr": psnr_c,
                   "flat_gray_psnr": flat, "compile": run_c["compile"]}
    print(f"zoo (c): img_fit {IMG_FIT_STEPS} steps at "
          f"{run_c['step_ms']:.3f} ms, val PSNR {psnr_c:.2f} (flat gray "
          f"{flat:.2f}) at input_ratio 0.5")

    # (d) the procedural scene as one real capture: capture.yaml with the
    # fused trunk (K1/K2) and capture_ndc.yaml
    write_real_capture(os.path.join(data, "procedural"))
    base_d = ["scene", "procedural", "train_dataset.data_root", data,
              "test_dataset.data_root", data, "ep_iter", str(REAL_STEPS),
              "train.epoch", "1", "eval_ep", "100", "save_ep", "100",
              "save_latest_ep", "100"]
    real_cfg = os.path.join(REPO, "configs", "real", "capture.yaml")
    opts_d = base_d + ["network.nerf.fused_trunk", "true",
                       "network.nerf.fused_tile", "512",
                       *_zoo_paths(out, "zoo_real")]
    bank = make_dataset(make_cfg(real_cfg, opts_d + ZOO_OPTS), "train")
    require(bank.bank_builder == "native" and native.native_available(),
            f"zoo (d): the real capture's bank took {bank.bank_builder}")
    fmlp.reset_launch_counts()
    run_d = _zoo_fit(torch, np, real_cfg, opts_d, "zoo (d) capture")
    k1k2 = dict(fmlp.LAUNCHES)
    require(not on_card or (k1k2["fused_mlp_fwd"] > 0
                            and k1k2["fused_mlp_bwd"] > 0),
            f"zoo (d): K1/K2 launches {k1k2}")
    zoo["K1"] += k1k2["fused_mlp_fwd"]
    zoo["K2"] += k1k2["fused_mlp_bwd"]
    ndc_cfg = os.path.join(REPO, "configs", "real", "capture_ndc.yaml")
    run_ndc = _zoo_fit(torch, np, ndc_cfg,
                       base_d + _zoo_paths(out, "zoo_real_ndc"),
                       "zoo (d) capture_ndc")
    report["d"] = {"capture_step_ms": round(run_d["step_ms"], 3),
                   "ndc_step_ms": round(run_ndc["step_ms"], 3),
                   "bank_builder": bank.bank_builder, "k1k2": k1k2}
    print(f"zoo (d): capture.yaml (fused trunk, native bank) "
          f"{REAL_STEPS} steps at {run_d['step_ms']:.3f} ms, loss "
          f"{run_d['losses'][0]:.4f} -> {run_d['losses'][-1]:.4f}, K1/K2 "
          f"{k1k2['fused_mlp_fwd']}/{k1k2['fused_mlp_bwd']}; capture_ndc "
          f"{run_ndc['step_ms']:.3f} ms, loss {run_ndc['losses'][0]:.4f} -> "
          f"{run_ndc['losses'][-1]:.4f}")

    # (e) the mesh of phase 5's checkpoint (level: the grid bake's σ cut)
    from nerf_replication_tpu_torch import run as run_cli
    from nerf_replication_tpu_torch.utils.mesh import read_ply

    level = str(make_cfg(lego).task_arg.occupancy_grid_threshold)
    opts_e = _train_opts(data, os.path.join(tmp, "out"), "f32") + [
        "resolution", str(MESH_RES), "level", level,
        "result_dir", os.path.join(out, "mesh")]
    base = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    run_cli.main(["--type", "mesh", "--cfg_file", lego, "--device", DEVICE,
                  *opts_e])
    mesh_s = time.perf_counter() - t0
    # the sweep's own peak: above what earlier phases left allocated
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20 if on_card \
        else None
    verts, faces = read_ply(os.path.join(make_cfg(lego, opts_e).result_dir,
                                         "mesh.ply"))
    require(len(faces) > 0 and np.isfinite(verts).all(),
            f"zoo (e): {len(faces)} faces")
    report["e"] = {"resolution": MESH_RES, "level": float(level),
                   "seconds": round(mesh_s, 2), "faces": len(faces),
                   "vertices": len(verts), "peak_mb_above_base": peak,
                   "base_mb": base / 2**20}
    print(f"zoo (e): run --type mesh at resolution {MESH_RES}, level "
          f"{level}: {len(faces)} faces, {len(verts)} vertices in "
          f"{mesh_s:.2f} s, peak device memory {peak} MB above the "
          f"{base / 2**20:.1f} MB allocated before it")

    # (f) the 360° video of the same checkpoint through its baked grid (K5)
    from nerf_replication_tpu_torch.render_video import (
        render_360_video,
        spiral_poses,
        video_engine,
    )
    from nerf_replication_tpu_torch.tools.slice_inputs import SLICE_OPTS
    from nerf_replication_tpu_torch.utils.video import read_avi

    opts_f = _train_opts(data, os.path.join(tmp, "out"), "f32") + \
        SLICE_OPTS + ["task_arg.video_frames", str(VIDEO_FRAMES),
                      "result_dir", os.path.join(out, "video"),
                      "record_dir", os.path.join(out, "video_record")]
    cfg_f = make_cfg(lego, opts_f)
    engine, cam = video_engine(cfg_f, lego, device=DEVICE)
    require(engine.use_grid, "zoo (f): the baked grid did not load")
    captures = engine.stats()["captures"]
    fm.reset_launch_counts()
    with _Rows() as tapped:
        path = render_360_video(cfg_f, device=DEVICE, engine=(engine, cam))
    zoo["K5"] += fm.LAUNCHES["fused_march_full"]
    require(not on_card or fm.LAUNCHES["fused_march_full"] > 0,
            "zoo (f): the video never launched K5")
    require(engine.stats()["captures"] == captures,
            "zoo (f): a capture after warm-up")
    (row,) = tapped.of("eval")
    video, fps = read_avi(path)
    require(len(video) == VIDEO_FRAMES, f"zoo (f): {len(video)} frames")
    engine.cache.clear()

    def replay():
        return [engine.render_view(c2w, int(cam.H), int(cam.W),
                                   float(cam.focal))[0]
                for c2w in spiral_poses(VIDEO_FRAMES)]

    for i, (a, b) in enumerate(zip(video, _uncounted(replay))):
        require(np.array_equal(a, b), f"zoo (f): frame {i} differs from "
                "the engine's render of its pose")
    report["f"] = {"frames": len(video), "fps": row["fps"],
                   "route": engine.stats()["route"],
                   "k5_launches": fm.LAUNCHES["fused_march_full"]}
    print(f"zoo (f): {len(video)}-frame spiral through the full route at "
          f"{row['fps']:.2f} fps, the AVI bitwise the engine's renders, no "
          "capture after warm-up")

    for k, v in zoo.items():
        require(v > 0 or not on_card, f"zoo: {k} never launched")
    report["launches"] = zoo
    report["seconds"] = round(time.perf_counter() - t_phase, 1)
    print("zoo: " + json.dumps(report, default=str))
    print(f"phase 17 (the model zoo) took {report['seconds']} s")
    return zoo, by_kind


# -- phase 18: data-parallel training and sequence-parallel eval ------------

DP_WORLD = 2  # ranks sharing the card over gloo in (b)-(d)
DP_OPTS = ["ep_iter", "50", "train.epoch", "2", "eval_ep", "100",
           "save_ep", "2", "save_latest_ep", "2"]
# the NGP run: phase 11 (a)'s schedule (30 warm + 70 march steps)
DP_NGP_OPTS = ["task_arg.ngp_training", "true", "task_arg.ngp_warmup_steps",
               "30", "task_arg.ngp_warmup_max", "30",
               "task_arg.ngp_grid_decay", "0.1"]
TOL_DP_NGP_FRO = 1e-5  # K6b's float32 atomics (phase 13's rule)
TOL_SEQ_MAPS = 1e-6  # of max|map|: measured bitwise
DP_EXTRA: list = []  # appended to every phase-18 config (a CPU rehearsal)


def _dp_launch(torch, n_proc, spec, tmp, timeout):
    """``chip_smoke.py --dp-worker`` under torchrun with ``n_proc`` ranks on
    this card (each rank writes its JSON result); the ranks' results."""
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], f"spec_{spec['job']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n_proc), os.path.abspath(__file__),
           "--dp-worker", path]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, cwd=tmp)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-6000:])
        print(res.stderr[-6000:], file=sys.stderr)
    require(res.returncode == 0, f"parallel {spec['job']}: torchrun exited "
            f"{res.returncode}")
    for line in res.stdout.splitlines():
        if line.startswith("[multihost_init]") or line.startswith("dp "):
            print("  " + line)
    out = []
    for r in range(n_proc):
        with open(os.path.join(spec["out"],
                               f"dp_{spec['job']}_rank{r}.json")) as f:
            out.append(json.load(f))
    print(f"parallel {spec['job']}: {n_proc} rank(s) in {wall:.1f} s")
    return out, wall


def _dp_digest(torch, tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _dp_state_tensors(state):
    """Parameters, Adam's moments (and an NGP grid) in a fixed order."""
    out = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in list(out):
        st = state.optimizer.state.get(p, {})
        out += [st[k] for k in sorted(st) if hasattr(st[k], "shape")]
    grid = getattr(state, "grid_ema", None)
    return out + ([grid] if grid is not None else [])


def _rank_of(rank, size):
    """Rank ``rank`` of a ``size``-rank mesh without a group, for the
    one-process emulations (``shard_bank`` and the pool read only the rank
    and the size)."""
    from nerf_replication_tpu_torch.parallel.mesh import Mesh

    return Mesh(None, rank, size, DEVICE, "gloo")


def _lego_parts(torch, cfg, mesh):
    """A seeded lego trainer's pieces: (network, loss, trainer, state)."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.registry import load_attr
    from nerf_replication_tpu_torch.train.trainer import (
        Trainer,
        make_train_state,
    )

    net = make_network(cfg)
    loss = load_attr(cfg.loss_module, "make_loss", "NetworkWrapper")(cfg, net)
    trainer = Trainer(cfg, net, loss, None, mesh=mesh)
    return net, loss, trainer, make_train_state(cfg, net, DEVICE)


def _dp_nccl1(torch, np, spec):
    """(a): ``build_dp_step`` over a one-rank NCCL mesh against the
    single-card ``Trainer.step``, lego f32, 3 graphed steps each from one
    seeded state on the same bank: bitwise, one all-reduce a step, no
    capture after warm-up."""
    from nerf_replication_tpu_torch.compile import AOTRegistry
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.parallel import collectives
    from nerf_replication_tpu_torch.parallel.mesh import make_mesh

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    cfg = make_cfg(lego, _train_opts(spec["data"], spec["out"], "nccl1")
                   + ["task_arg.precrop_iters", "0"] + spec["extra"])
    mesh = make_mesh(device=DEVICE)
    bank = tuple(torch.from_numpy(a).to(DEVICE)
                 for a in make_dataset(cfg, "train").ray_bank())
    runs = {}
    for label, m in (("single", None), ("dp", mesh)):
        _, _, trainer, state = _lego_parts(torch, cfg, m)
        trainer.aot = AOTRegistry(torch.device(DEVICE),
                                  enabled=DEVICE == "cuda")
        trainer.aot_register_steps(state, bank)
        st = trainer.aot.status()
        require(DEVICE != "cuda" or (not st["errors"]
                                     and st["captures"] == st["entries"] > 0),
                f"parallel (a) {label}: captures {st}")
        captures = trainer.aot.captures
        collectives.reset_counts()
        stats = []
        for _ in range(3):
            state, st = trainer.step(state, bank[0], bank[1])
            stats.append({k: float(v) for k, v in st.items()})
        require(trainer.aot.captures == captures,
                f"parallel (a) {label}: captured after warm-up")
        runs[label] = (state, stats, dict(collectives.COUNTS),
                       trainer.aot.status())
    (s1, st1, c1, _), (s2, st2, c2, reg) = runs["single"], runs["dp"]
    bad = [i for i, (a, b) in enumerate(zip(_dp_state_tensors(s1),
                                            _dp_state_tensors(s2)))
           if not torch.equal(a, b)]
    require(not bad and st1 == st2, f"parallel (a): the NCCL world-1 step "
            f"differs from the single-card step (tensors {bad[:4]})")
    require(c2["all_reduce"] == 3 and c1["all_reduce"] == 0,
            f"parallel (a): all-reduces {c2} (dp) / {c1} (single)")
    return {"bitwise": True, "all_reduces": c2["all_reduce"],
            "registry": {k: reg[k] for k in ("entries", "captures")},
            "loss": [s["loss"] for s in st2]}


def _kept_state():
    """Wrap ``trainer.fit`` to keep the state it returns."""
    from nerf_replication_tpu_torch.train import trainer as tr

    orig = tr.fit
    kept = {}

    def fit(*a, **k):
        kept["state"] = orig(*a, **k)
        return kept["state"]

    tr.fit = fit
    return kept, lambda: setattr(tr, "fit", orig)


def _cli_fit(torch, np, cfg_file, opts, label, step_cls, step_name):
    """The train CLI (``train.__main__.main``) on this rank, its kernel
    launch counts reset right before and read right after: the final state,
    step ms, losses, launches and the all-reduce ms of its DP steps."""
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.ops import hash_encode as he
    from nerf_replication_tpu_torch.parallel import collectives
    from nerf_replication_tpu_torch.parallel import step as pstep
    from nerf_replication_tpu_torch.train.__main__ import main as train_main

    # each step's loss and the host clock after it (reading the loss waits
    # for the card)
    losses, stamps = [], []
    orig = getattr(step_cls, step_name)

    def record(self, *a, **k):
        out = orig(self, *a, **k)
        st = out[1] if isinstance(out, tuple) else out
        losses.append(float(st["loss"]))
        stamps.append(time.perf_counter())
        return out

    setattr(step_cls, step_name, record)
    kept, restore_fit = _kept_state()
    pstep.TIME_REDUCE, pstep.REDUCE_MS[:] = True, []
    fmlp.reset_launch_counts()
    he.reset_launch_counts()
    collectives.reset_counts()
    logs = io.StringIO()
    try:
        with contextlib.redirect_stdout(logs):
            rc = train_main(["--cfg_file", cfg_file, "--device", DEVICE,
                             *opts])
    finally:
        setattr(step_cls, step_name, orig)
        restore_fit()
        pstep.TIME_REDUCE = False
    launches = {"K1": fmlp.LAUNCHES["fused_mlp_fwd"],
                "K2": fmlp.LAUNCHES["fused_mlp_bwd"],
                "K6": he.LAUNCHES["hash_encode_fwd"],
                "K6b": he.LAUNCHES["hash_encode_bwd"]}
    require(rc == 0, f"parallel {label}: the train CLI returned {rc}")
    graphs = (_compile_status(logs.getvalue().splitlines(), label)
              if DEVICE == "cuda" else None)
    state = kept["state"]
    dt = np.diff(np.asarray(stamps)) * 1e3
    return {"state": state, "losses": losses,
            "step_ms": float(np.median(dt[3:])),
            "reduce_ms": float(np.median(pstep.REDUCE_MS[3:]))
            if DEVICE == "cuda" else None,
            "launches": launches, "collectives": dict(collectives.COUNTS),
            "collective_bytes": dict(collectives.BYTES),
            "digest": _dp_digest(torch, _dp_state_tensors(state)),
            "steps": int(state.step), "graphs": graphs}


def _dp_lego(torch, np, spec):
    """(b) on this rank: one DP step against its one-process emulation
    (rank 0: both ranks' draws, ``(g0 + g1) / 2``, Adam; bitwise), then the
    train CLI for 100 steps."""
    import torch.distributed as dist

    from nerf_replication_tpu_torch.compile import registry_from_cfg
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.datasets.sampling import step_generator
    from nerf_replication_tpu_torch.parallel.mesh import make_mesh
    from nerf_replication_tpu_torch.train.optim import (
        optimizer_step,
        set_lr,
    )
    from nerf_replication_tpu_torch.train.step_core import sampled_grad_step
    from nerf_replication_tpu_torch.train.trainer import Trainer, shard_inputs

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    opts = _train_opts(spec["data"], os.path.join(spec["out"], "lego"),
                       "dp_lego") + DP_OPTS + spec["extra"]
    cfg = make_cfg(lego, opts)
    mesh = make_mesh(device=DEVICE)
    train_ds = make_dataset(cfg, "train")
    _, _, trainer, state = _lego_parts(torch, cfg, mesh)
    bank, pool = shard_inputs(cfg, train_ds, mesh, DEVICE, True)
    trainer.aot = registry_from_cfg(cfg, DEVICE)
    trainer.aot_register_steps(state, bank, pool=pool)
    state, _ = trainer.step(state, bank[0], bank[1], index_pool=pool)
    flat_bytes = trainer._dp.flat.nbytes
    one = {"flat_bytes": flat_bytes}
    if mesh.rank == 0:
        def emulate():
            net, loss, _, st = _lego_parts(torch, cfg, None)
            params = [p for p in net.parameters()]
            grads = []
            for r in range(mesh.size):
                b, pl = shard_inputs(cfg, train_ds,
                                     _rank_of(r, mesh.size),
                                     DEVICE, True)
                gen = step_generator(int(cfg.seed), 0, DEVICE, r)
                sampled_grad_step(loss, params, b[0], b[1],
                                  trainer._dp.n_local, trainer.near,
                                  trainer.far, gen, index_pool=pl)
                grads.append([None if p.grad is None else p.grad.clone()
                              for p in params])
            for p, g0, g1 in zip(params, *grads):
                p.grad = None if g0 is None else (g0 + g1) / 2
            set_lr(st.optimizer, st.schedule, 0)
            optimizer_step(st.optimizer)
            return st

        emu = _uncounted(emulate)
        bad = [i for i, (a, b) in enumerate(zip(_dp_state_tensors(state),
                                                _dp_state_tensors(emu)))
               if not torch.equal(a, b)]
        require(not bad, f"parallel (b): the DP step differs from its "
                f"emulation in tensors {bad[:6]}")
        one["emulation_bitwise"] = True
    dist.barrier()
    del trainer, state
    run = _cli_fit(torch, np, lego, opts, "(b) lego", Trainer, "step")
    first, last = np.mean(run["losses"][:10]), np.mean(run["losses"][-10:])
    require(run["steps"] == 100 and last < first,
            f"parallel (b): {run['steps']} steps, loss {first} -> {last}")
    run.pop("state")
    return {**run, **one, "loss_first10": float(first),
            "loss_last10": float(last)}


def _dp_ngp(torch, np, spec):
    """(c) on this rank: one NGP DP step (warm) against its one-process
    emulation (rank 0; within TOL_DP_NGP_FRO: K6b's atomics), then the
    train CLI for 100 steps."""
    import torch.distributed as dist

    from nerf_replication_tpu_torch.compile import registry_from_cfg
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.datasets.sampling import step_generator
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.parallel.mesh import make_mesh
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer
    from nerf_replication_tpu_torch.train.optim import (
        optimizer_step,
        set_lr,
    )
    from nerf_replication_tpu_torch.train.trainer import shard_inputs

    cfg_file = os.path.join(REPO, "configs", "nerf", "lego_hash.yaml")
    opts = _hash_opts(spec["data"], os.path.join(spec["out"], "ngp"),
                      "dp_ngp", DP_NGP_OPTS) + DP_OPTS + spec["extra"]
    cfg = make_cfg(cfg_file, opts)
    mesh = make_mesh(device=DEVICE)
    train_ds = make_dataset(cfg, "train")
    trainer = NGPTrainer(cfg, make_network(cfg), mesh=mesh)
    state = trainer.make_state(DEVICE)
    bank, _ = shard_inputs(cfg, train_ds, mesh, DEVICE, False)
    trainer.aot = registry_from_cfg(cfg, DEVICE)
    trainer.aot_register_steps(state, bank)
    trainer.multi_step(state, bank[0], bank[1], 1)
    one = {"flat_bytes": trainer._flats[True].nbytes}
    if mesh.rank == 0:
        def emulate():
            emu = NGPTrainer(cfg, make_network(cfg))
            emu.n_local = trainer.n_local
            st = emu.make_state(DEVICE)
            params = list(st.network.parameters())
            grads, outs, gens = [], [], []
            for r in range(mesh.size):
                b, _ = shard_inputs(cfg, train_ds,
                                    _rank_of(r, mesh.size),
                                    DEVICE, False)
                emu._gen = step_generator(int(cfg.seed), 0, DEVICE, r)
                _, out = emu._grad_part(st, b[0], b[1], True,
                                        lambda i: None)
                grads.append([None if p.grad is None else p.grad.clone()
                              for p in params])
                outs.append({k: v.detach().clone() for k, v in out.items()})
                gens.append(emu._gen)
            for p, g0, g1 in zip(params, *grads):
                p.grad = None if g0 is None else (g0 + g1) / 2
            set_lr(st.optimizer, st.schedule, 0)
            optimizer_step(st.optimizer)
            base = st.grid_ema.clone()
            cands = []
            for r in range(mesh.size):
                st.grid_ema.copy_(base)
                emu._gen = gens[r]
                emu._grid_part(st, outs[r])
                cands.append(st.grid_ema.clone())
            st.grid_ema.copy_(torch.maximum(*cands))
            return st

        emu = _uncounted(emulate)
        worst = max(_fro_rel([a], [b]) for a, b in
                    zip(_dp_state_tensors(state), _dp_state_tensors(emu)))
        require(worst <= TOL_DP_NGP_FRO, f"parallel (c): the NGP DP step is "
                f"{worst:.3g} (relative Frobenius) from its emulation")
        one["emulation_fro"] = worst
    dist.barrier()
    del trainer, state
    run = _cli_fit(torch, np, cfg_file, opts, "(c) NGP", NGPTrainer,
                   "_one_step")
    first, last = np.mean(run["losses"][:10]), np.mean(run["losses"][-10:])
    require(run["steps"] == 100 and last < first,
            f"parallel (c): {run['steps']} steps, loss {first} -> {last}")
    run["grid_digest"] = _dp_digest(torch, [run["state"].grid_ema])
    run.pop("state")
    return {**run, **one, "loss_first10": float(first),
            "loss_last10": float(last)}


def _gate_maps(fn):
    """``fn()`` with every render of the render gate recorded (per-ray maps
    as numpy, in call order)."""
    from nerf_replication_tpu_torch.renderer import gate

    orig = gate.full_image_render_fn
    maps = []

    def factory(*a, **k):
        render = orig(*a, **k)

        def wrapped(batch):
            out = render(batch)
            maps.append({k: v.detach().cpu().numpy() for k, v in out.items()
                         if v.dim()})
            return out

        for attr in ("mesh", "surface"):
            setattr(wrapped, attr, getattr(render, attr, None))
        return wrapped

    gate.full_image_render_fn = factory
    try:
        return fn(), maps
    finally:
        gate.full_image_render_fn = orig


def _dp_eval_cfg(spec, grid: bool, sharded: bool):
    from nerf_replication_tpu_torch.config import make_cfg

    lego = os.path.join(REPO, "configs", "nerf", "lego.yaml")
    opts = _train_opts(spec["data"], os.path.join(spec["out"], "lego"),
                       "dp_lego") + DP_OPTS + spec["extra"] + [
        "test_dataset.cams", "[0, -1, 1]", "eval.sharded",
        str(sharded).lower(), "task_arg.accelerated_renderer",
        str(grid).lower(),
        "result_dir", os.path.join(spec["out"], "eval",
                                   f"{'grid' if grid else 'nogrid'}_"
                                   f"{'sharded' if sharded else 'one'}")]
    return lego, make_cfg(lego, opts)


def _run_eval(torch, spec, grid, sharded):
    """``run --type evaluate`` of (b)'s checkpoint (cwd: the grid's
    ``logs/lego/``): its result, the gate's maps and K1 launches."""
    from types import SimpleNamespace

    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.run import run_evaluate

    lego, cfg = _dp_eval_cfg(spec, grid, sharded)
    fmlp.reset_launch_counts()
    res, maps = _gate_maps(lambda: run_evaluate(
        cfg, SimpleNamespace(cfg_file=lego, device=DEVICE)))
    return res, maps, fmlp.LAUNCHES["fused_mlp_fwd"]


def _dp_eval(torch, np, spec):
    """(d) on this rank: ``run --type evaluate`` with ``eval.sharded`` on
    (b)'s checkpoint through the chunked render and through a grid the
    chief bakes from it; rank 0 keeps the gathered maps."""
    import torch.distributed as dist

    from nerf_replication_tpu_torch.parallel.mesh import is_chief
    from nerf_replication_tpu_torch.renderer.occupancy import (
        bake_occupancy_grid,
        save_occupancy_grid,
    )
    from nerf_replication_tpu_torch.utils.setup import load_trained_network

    if is_chief():
        _, cfg = _dp_eval_cfg(spec, True, True)
        net, _ = load_trained_network(cfg, DEVICE, verbose=False)
        grid = _uncounted(bake_occupancy_grid, net, cfg, DEVICE)
        save_occupancy_grid(os.path.join("logs", "lego",
                                         "occupancy_grid.npz"),
                            grid, cfg.train_dataset.scene_bbox,
                            float(cfg.task_arg.occupancy_grid_threshold))
    dist.barrier()
    out = {}
    for grid in (False, True):
        res, maps, k1 = _run_eval(torch, spec, grid, True)
        label = "grid" if grid else "nogrid"
        st = res["compile"]
        require(DEVICE != "cuda" or (
            st is not None and not st["errors"]
            and st["captures"] == st["entries"] == 1),
            f"parallel (d) {label}: the rank's slice was not captured: {st}")
        require(res["used_grid"] == grid, f"parallel (d) {label}: used_grid "
                f"{res['used_grid']}")
        out[label] = {"psnr": res.get("psnr"), "k1": k1,
                      "net_time_s": res["mean_net_time_s"]}
        if is_chief():
            np.savez(os.path.join(spec["out"], f"maps_{label}.npz"),
                     **{f"{i}_{k}": v for i, m in enumerate(maps)
                        for k, v in m.items()})
    return out


def _dp_worker(spec_path):
    """A rank of phase 18 under torchrun (``--dp-worker <spec.json>``): its
    results in ``dp_<job>_rank<r>.json`` beside the spec."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nerf_replication_tpu_torch.parallel.mesh import multihost_init
    from nerf_replication_tpu_torch.utils.platform import resolve_device

    global DEVICE, TRAIN_HW
    with open(spec_path) as f:
        spec = json.load(f)
    DEVICE, TRAIN_HW = spec["device"], spec["hw"]
    multihost_init(None, DEVICE)  # makes this rank's card current
    resolve_device(DEVICE)
    rank = dist.get_rank()
    res = {"rank": rank, "world": dist.get_world_size(),
           "backend": str(dist.get_backend())}
    try:
        if spec["job"] == "nccl1":
            res["a"] = _dp_nccl1(torch, np, spec)
        else:
            for part, fn in (("b", _dp_lego), ("c", _dp_ngp)):
                res[part] = fn(torch, np, spec)
                print(f"dp rank {rank} ({part}): " + json.dumps(
                    {k: v for k, v in res[part].items() if k != "losses"}))
            res["d"] = _dp_eval(torch, np, spec)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(spec["out"],
                           f"dp_{spec['job']}_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _one_process_eval(torch, np, spec):
    """(d)'s reference: the same views rendered in this process (no process
    group: the gate's one-card routes)."""
    ref = {}
    for grid in (False, True):
        res, maps, _ = _uncounted(_run_eval, torch, spec, grid, False)
        ref["grid" if grid else "nogrid"] = (res, maps)
    return ref


def phase_parallel(torch, np, tmp, data):
    """Phase 18: data-parallel training (lego K1/K2, NGP K6/K6b) and
    sequence-parallel eval (K1) on torch.distributed, each run in torchrun
    subprocesses (this process never holds a process group); cwd: tmp."""
    t0 = time.perf_counter()
    work = os.path.join(tmp, "dp")
    os.makedirs(work, exist_ok=True)
    spec = {"data": data, "out": work, "device": DEVICE, "extra": DP_EXTRA,
            "hw": TRAIN_HW}
    report = {}
    if DEVICE == "cuda":
        a, a_wall = _dp_launch(torch, 1, {**spec, "job": "nccl1"}, work, 300)
        require(a[0]["backend"] == "nccl", f"parallel (a): backend "
                f"{a[0]['backend']}")
        report["a"] = {**a[0]["a"], "wall_s": round(a_wall, 1)}
    ranks, wall = _dp_launch(torch, DP_WORLD, {**spec, "job": "gloo2"},
                             work, 900)
    require(all(r["backend"] == "gloo" for r in ranks),
            "parallel: two ranks on one card did not choose gloo")
    for part, label in (("b", "lego"), ("c", "NGP")):
        digests = {r[part]["digest"] for r in ranks}
        require(len(digests) == 1, f"parallel ({part}): the ranks' {label} "
                f"states differ after {ranks[0][part]['steps']} steps")
        for r in ranks:
            for k in (("K1", "K2") if part == "b" else ("K6", "K6b")):
                require(DEVICE != "cuda" or r[part]["launches"][k] > 0,
                        f"parallel ({part}): rank {r['rank']} never "
                        f"launched {k}")
    require(len({r["c"]["grid_digest"] for r in ranks}) == 1,
            "parallel (c): the ranks' grids differ")
    require(ranks[0]["b"].get("emulation_bitwise"), "parallel (b): no "
            "emulation check")
    # (d) against the one-process render of the same views (cwd: the grid's
    # logs/lego/ under work, as the ranks had it)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        ref = _one_process_eval(torch, np, spec)
    finally:
        os.chdir(cwd)
    d = {}
    for label, (res, maps) in ref.items():
        got = np.load(os.path.join(work, f"maps_{label}.npz"))
        worst = 0.0
        for i, m in enumerate(maps):
            for k, v in m.items():
                g = got[f"{i}_{k}"]
                require(g.shape == v.shape, f"parallel (d) {label}: {k} "
                        f"shape {g.shape} vs {v.shape}")
                scale = max(float(np.abs(v).max()), 1e-30)
                worst = max(worst, float(np.abs(g - v).max()) / scale)
        psnr_sharded = ranks[0]["d"][label]["psnr"]
        require(worst <= TOL_SEQ_MAPS, f"parallel (d) {label}: maps "
                f"{worst:.3g} of max|map| from the one-process render")
        require(abs(psnr_sharded - res["psnr"]) <= 1e-4 * abs(res["psnr"]),
                f"parallel (d) {label}: psnr {psnr_sharded} vs {res['psnr']}")
        d[label] = {"maps_rel": worst, "bitwise": worst == 0.0,
                    "psnr_sharded": psnr_sharded, "psnr_one": res["psnr"],
                    "net_time_ms_sharded": [round(r["d"][label]["net_time_s"]
                                                  * 1e3, 3) for r in ranks],
                    "net_time_ms_one": round(res["mean_net_time_s"] * 1e3, 3),
                    "k1_per_rank": [r["d"][label]["k1"] for r in ranks]}
    report["d"] = d
    for part in ("b", "c"):
        report[part] = {
            "step_ms_per_rank": [round(r[part]["step_ms"], 3)
                                 for r in ranks],
            "allreduce_ms_per_rank": [r[part]["reduce_ms"] for r in ranks],
            "flat_bytes": ranks[0][part]["flat_bytes"],
            "loss_first10_last10": [ranks[0][part]["loss_first10"],
                                    ranks[0][part]["loss_last10"]],
            "launches_per_rank": [r[part]["launches"] for r in ranks],
            "collectives_rank0": ranks[0][part]["collectives"],
            "digest": ranks[0][part]["digest"]}
    report["c"]["emulation_fro"] = ranks[0]["c"]["emulation_fro"]
    report["smi"] = smi_line()
    report["wall_s"] = round(time.perf_counter() - t0, 1)
    print("parallel phase: " + json.dumps(report))
    counts = {
        "K1": sum(r["b"]["launches"]["K1"] + sum(
            r["d"][g]["k1"] for g in ("grid", "nogrid")) for r in ranks),
        "K2": sum(r["b"]["launches"]["K2"] for r in ranks),
        "K6": sum(r["c"]["launches"]["K6"] for r in ranks),
        "K6b": sum(r["c"]["launches"]["K6b"] for r in ranks)}
    return counts, report


def run_bench():
    """``python -m nerf_replication_tpu_torch.bench`` once, as a user runs
    it (no BENCH_* overrides); its one JSON line."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "nerf_replication_tpu_torch.bench"],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    require(res.returncode == 0, f"the port bench failed "
            f"(rc {res.returncode}): {res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    require(len(lines) == 1, f"the port bench printed {len(lines)} lines")
    rec = json.loads(lines[0])
    require(rec["metric"] == "train_rays_per_sec" and rec["value"] > 0
            and len(rec["windows"]) >= 3, f"bench line {lines[0]}")
    print(f"port bench in {time.perf_counter() - t0:.1f} s:")
    print(lines[0])
    return rec


def main() -> int:
    import torch

    if len(sys.argv) > 2 and sys.argv[1] == "--dp-worker":
        return _dp_worker(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
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
    hash_rows, _ = phase_hash_kernels(torch, np, dev)
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
            _, _, k3a_launches = phase_eval(torch, np, tmp, data)
            grad_counts = phase_packed_grad(torch, np, tmp, data)
            phase_engine_routes(torch, np, tmp, data)
            hash_counts, hash_runs = phase_ngp(torch, np, tmp, data)
            os.chdir(tmp)
            prop_counts = phase_proposal(torch, np, tmp, data,
                                         f32["state"].network)
            profiles, _ = phase_graphs(torch, np, tmp, data)
            serve_hash_counts = phase_serve_hash(torch, np, tmp, hash_runs)
            eval_graph_counts = phase_eval_graphs(torch, np, tmp, data,
                                                  hash_runs["ngp_a"])
            ops_counts = phase_ops(
                torch, np, tmp, data,
                profiles["f32_fused"]["graphed"]["step_ms"])
            zoo_counts, zoo_hash = phase_zoo(torch, np, tmp, data)
            par_counts, _ = phase_parallel(torch, np, tmp, data)
        finally:
            os.chdir(cwd)
    run_bench()
    counts.update(train_counts)
    counts.update(hash_counts)
    counts["fused_mlp_fwd_masked"] = k3a_launches
    counts["fused_mlp_bwd_masked"] = grad_counts["fused_mlp_bwd_masked"]
    keys = {"K4": "fused_dda_gather", "K5": "fused_march_full",
            "K1": "fused_mlp_fwd", "K2": "fused_mlp_bwd",
            "K3a": "fused_mlp_fwd_masked", "K3b": "fused_mlp_bwd_masked",
            "K6": "hash_encode_fwd", "K6b": "hash_encode_bwd"}
    rows = mlp_rows + rows + hash_rows
    # K2 and K3b run as K2a + K2b + the reduce: their launches on the same
    # main-path run stand beside the call count
    parts = {"K2": train_counts, "K3b": grad_counts}
    for row in rows:
        kernel, key = next((k, v) for k, v in keys.items()
                           if f"({k})" in row["name"])
        row["launches"] = counts[key]
        require(row["launches"] > 0, f"{row['name']} never launched")
        # later main paths, each launching the kernel: the proposal path
        # (phase 12; K1, K2, K3a), the graphed eval (phase 15; K1, K3a, and
        # K6 in the NGP val) and serving the hash checkpoints (phase 14;
        # K6, and K4 on the gather route)
        paths = {}
        if kernel in ("K1", "K2", "K3a"):
            paths["proposal"] = prop_counts[key]
        if kernel in ("K1", "K3a"):
            paths["eval_graphed"] = eval_graph_counts[kernel]
        if kernel in ("K4", "K6"):
            paths["serving_hash"] = serve_hash_counts[kernel]
        if kernel == "K6":
            paths["eval_graphed"] = eval_graph_counts["K6"]
        # the ops layers' runs (phase 16): lego fits (K1, K2), the NGP fit
        # (K6, K6b) and the traced serving engine (K5)
        if kernel in ops_counts:
            paths["ops"] = ops_counts[kernel]
        # the model zoo (phase 17): the real capture's fused trunk (K1,
        # K2), the video (K5) and the hash encoders at D = 2, 3, 4 (K6,
        # K6b), whose times at D = 2 and 4 stand beside phase 10's D = 3
        if kernel in zoo_counts:
            paths["zoo"] = zoo_counts[kernel]
        # data-parallel training and sequence-parallel eval (phase 18):
        # K1/K2 on the lego ranks (K1 also on the sharded eval), K6/K6b on
        # the NGP ranks, summed over the ranks
        if kernel in par_counts:
            paths["parallel"] = par_counts[kernel]
        if kernel in ("K6", "K6b"):
            kind = "fwd" if kernel == "K6" else "bwd"
            for d in (2, 4):
                c = zoo_hash[(kind, d)]
                row[f"ms_d{d}"] = c["ms"]
                row[f"bound_ms_d{d}"] = c["bound_ms"]
                row[f"bound_by_d{d}"] = c["bound_by"]
                row[f"n_d{d}"] = c["n"]
        if paths:
            row["launches_by_path"] = {"earlier_phases": counts[key],
                                       **paths}
            row["launches"] += sum(paths.values())
            for path, n in paths.items():
                require(n > 0, f"{row['name']} never launched on the "
                        f"{path} path")
        for k, c in parts.items():
            if f"({k})" in row["name"]:
                row["part_launches"] = {
                    "K2a": c["fused_mlp_bwd_rows"],
                    "K2b": c["fused_mlp_bwd_dw"],
                    "reduce": c["fused_mlp_bwd_reduce"]}
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
