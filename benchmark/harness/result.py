"""The result line, the device block and the import check."""

from __future__ import annotations

import json
import math
import subprocess
import sys

# whole top-level module names a run may not load: JAX, its libraries,
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_replication_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """``name, power.limit`` of the first card (nvidia-smi), or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi unavailable: {err}"


def device_block(torch, device, n_cards: int, peak_bytes: int,
                 tracer=None) -> dict:
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    out = {"platform": platform, "kind": kind, "count": int(n_cards),
           "memory_peak_bytes": int(peak_bytes)}
    if tracer is not None:
        r = tracer.reading()
        out["busy_s"] = r["busy_s"]
        out["window_s"] = r["window_s"]
    return out


def _finite(x):
    """``x`` with every float that is not finite replaced by None (strict
    JSON has no NaN or infinity)."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def emit(result: dict) -> None:
    """The checks on standard error (last lines there), then the result as
    the last line of standard output, ``checks`` its last key."""
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False))
    sys.stdout.flush()
