"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number that
decided ``correct`` with its limit (also the last lines on standard error).
Exits non-zero with no result line when the card is missing, when the
checkout lacks a file the cell needs, or when a JAX module is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# the kernel caches live at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
# and so does Python's bytecode: where the environment turns its writing
# off (PYTHONDONTWRITEBYTECODE) and the installed packages hold none, every
# run would compile torch's modules from source again, seconds of host work
# in each set-up
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
sys.dont_write_bytecode = False
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness.result import emit, forbidden_modules  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from harness.cell import run_cell
    from harness.spec import resolve

    try:
        cell = resolve(args.workload)
    except (OSError, KeyError, ValueError) as err:
        print(f"benchmark: cannot resolve {args.workload!r}: {err}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; nothing measured",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    result = run_cell(torch, torch.device("cuda", 0), cell, args.seed,
                      args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX modules loaded in this process: {found}",
              file=sys.stderr)
        return 4
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
