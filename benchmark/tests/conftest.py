"""The benchmark's CPU tests: the harness, the yardstick and the
references at small sizes. Run from the checkout's root:

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` run the benchmark on a card and skip without one.
"""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)
