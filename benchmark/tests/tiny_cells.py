"""The benchmark's cells cut to sizes a CPU test holds: the same code
paths and names, small widths, a 2-view 16x16 scene and short marches."""

from __future__ import annotations

import copy

from harness.spec import resolve

TINY_NERF = {"D": 3, "W": 32, "skips": [1], "N_samples": 8,
             "N_importance": 8, "N_rays": 64}
NERF_OPTS = ["network.nerf.D", "3", "network.nerf.W", "32",
             "network.nerf.skips", "[1]", "network.nerf.fused_tile", "64"]


def tiny_train(name: str, dtype: str | None = "float32"):
    """A training cell at a small size (``dtype``: the compute precision,
    None for the configuration's)."""
    cell = resolve(name)
    c = copy.deepcopy(cell.config)
    ms, opts = c["model_spec"], c["program"]["train_opts"]
    ms.update(TINY_NERF)
    opts += NERF_OPTS + ["task_arg.N_samples", "8",
                         "task_arg.N_importance", "8", "task_arg.N_rays", "64"]
    if dtype:
        ms["compute_dtype"] = dtype
        opts += ["precision.compute_dtype", dtype]
    c["scene"].update({"n_views": 2, "H": 16, "W": 16})
    cell.config = c
    cell.traffic = dict(cell.traffic, unit_steps=2, trace_seconds=0.5)
    return cell


def tiny_serve(name: str):
    """A serving cell at a small size: small buckets and views, a 16^3
    grid and a 40-position march."""
    cell = resolve(name)
    c = copy.deepcopy(cell.config)
    ms, sv = c["model_spec"], c["serve"]
    extra = ["serve.buckets", "[256, 1024]", "task_arg.march_chunk_size",
             "256", "task_arg.render_step_size", "0.1",
             "task_arg.eval_render_step_size", "0.1",
             "task_arg.max_march_samples", "16",
             "task_arg.eval_max_march_samples", "16", *NERF_OPTS]
    ms.update(TINY_NERF)
    sv.update({"grid_res": 16, "step": 0.1, "max_samples": 16})
    c["program"]["serve_opts"] = c["program"]["serve_opts"] + extra
    cell.config = c
    cell.traffic = dict(cell.traffic, side_min=8, side_max=24,
                        rate_per_s=4.0, compared_requests=4)
    return cell
