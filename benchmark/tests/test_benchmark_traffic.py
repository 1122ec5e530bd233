"""The viewer traffic: seeded, every seed the same sizes and gaps in its
own order, due times at the stated rate."""

import math

import numpy as np
import pytest

from harness.spec import load_benchmark, resolve
from harness.traffic import sample_indices, viewer_schedule

TRAFFIC = {"rate_per_s": 20.0, "side_min": 64, "side_max": 256,
           "size_block": 8}


def test_same_seed_same_schedule():
    assert viewer_schedule(TRAFFIC, 2**31 + 9, 30.0) == \
        viewer_schedule(TRAFFIC, 2**31 + 9, 30.0)


def test_other_seed_other_order_same_work():
    a = viewer_schedule(TRAFFIC, 1, 30.0)
    b = viewer_schedule(TRAFFIC, 2, 30.0)
    assert len(a) == len(b) == 600
    assert [r.side for r in a] != [r.side for r in b]
    assert [r.azimuth_deg for r in a] != [r.azimuth_deg for r in b]
    assert sorted(r.side for r in a) == sorted(r.side for r in b)
    assert a[-1].due_s == pytest.approx(b[-1].due_s, rel=0.02)


def test_due_times_follow_the_rate():
    s = viewer_schedule(TRAFFIC, 7, 60.0)
    assert len(s) == 1200
    due = np.array([r.due_s for r in s])
    assert due[0] == 0.0 and np.all(np.diff(due) > 0)
    assert np.mean(np.diff(due)) == pytest.approx(1 / 20.0, rel=0.05)
    sides = np.array([r.side for r in s])
    assert sides.min() >= 64 and sides.max() <= 256
    # log-uniform: the median side is the geometric mean of the range
    assert np.median(sides) == pytest.approx(math.sqrt(64 * 256), rel=0.02)


def test_short_gaps_cluster_and_sizes_are_stratified():
    s = viewer_schedule(TRAFFIC, 2**31 + 5, 60.0)
    gaps = np.diff([r.due_s for r in s])
    short = gaps < np.quantile(gaps, 1 / 8)
    # Poisson arrivals: some 8 consecutive gaps hold several short ones
    runs = [int(short[i:i + 8].sum()) for i in range(len(short) - 8)]
    assert max(runs) >= 3
    # each run of 8 views holds one of each eighth of the sizes
    sides = np.array([r.side for r in s])
    edges = np.quantile(sides, np.arange(1, 8) / 8)
    for i in range(0, len(sides) - 7, 8):
        strata = np.searchsorted(edges, sides[i:i + 8], side="right")
        assert len(set(strata.tolist())) >= 7


def test_sample_holds_the_largest():
    s = viewer_schedule(TRAFFIC, 3, 30.0)
    largest = max(range(len(s)), key=lambda i: s[i].side)
    pick = sample_indices(len(s), 24, 3, always=(largest,))
    assert largest in pick and 24 <= len(pick) <= 25
    assert pick == sample_indices(len(s), 24, 3, always=(largest,))


def test_serve_cells_offer_a_fixed_rate():
    for w in load_benchmark()["workloads"]:
        t = resolve(w["name"]).traffic
        if t["kind"] == "viewer_open":
            assert t["rate_per_s"] > 0
