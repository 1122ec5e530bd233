"""Shared scanning of append-only sweep records (BENCH_SWEEP*.jsonl); a
copy of ``nerf_replication_tpu/utils/sweeps.py``, so the port reads the
same records by the same rule without importing the JAX package.

Sweep files are append-only (a crash must never destroy prior records), so
a point may appear many times across runs. The repo-wide recency rule: the
LAST record per (config, n_rays, dtype, remat, scan_steps, grad_accum,
opts) key wins, ordered by the record's ``ts`` (absent on pre-round-3
records ⇒ oldest), ties by file/line order (the rule of scripts/promote_bench_defaults.py and
the root bench.py's failure diagnostics).
"""

from __future__ import annotations

import json


def latest_points(paths) -> dict:
    """{(config, n_rays, dtype, remat, scan_steps, grad_accum, opts):
    record} after recency resolution.

    Malformed lines are skipped; error/null records are kept here (the
    caller decides) so a re-measured failure correctly supersedes an old
    success for its point.
    """
    latest: dict = {}
    for path in paths:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (
                rec.get("config", "lego.yaml"),
                rec.get("n_rays"),
                rec.get("dtype"),
                rec.get("remat"),
                rec.get("scan_steps", 1),
                rec.get("grad_accum", 1),
                rec.get("opts", ""),
            )
            if key not in latest or rec.get("ts", 0) >= latest[key].get("ts", 0):
                latest[key] = rec
    return latest


def best_point(paths, config: str | None = None):
    """The highest-value current (post-recency) record, or None.

    ``config`` filters to one config; None considers every config.
    """
    valid = [
        r for (cfg_name, *_), r in latest_points(paths).items()
        if isinstance(r.get("value"), (int, float))
        and (config is None or cfg_name == config)
    ]
    return max(valid, key=lambda r: r["value"], default=None)
