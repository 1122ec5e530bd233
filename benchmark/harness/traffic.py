"""The general generators of the traffic mixes (``traffic/*.json``).

``viewer_open``: independent viewers asking for views at a fixed offered
rate (an open loop). Every seed gets the same set of view sizes and
inter-arrival gaps, in its own order, so seeds differ in order and not in
work: the sizes are the quantiles of a log-uniform law over ``side_min ..
side_max`` (square views), the gaps those of an exponential law at
``rate_per_s``, one of each per request, ``rate_per_s x seconds``
requests. The gaps take a uniformly random order, so the arrivals are a
Poisson process's (short gaps cluster as they fall). The sizes' order is
stratified: each run of ``size_block`` consecutive requests holds one size
from each of ``size_block`` strata of the sorted set, drawn and placed
from the seed, so no seed gathers its largest views in one stretch. Poses
lie on an orbit (``radius``, ``elevation_deg``) at an azimuth drawn
uniformly from the seed, so no two views share a pose.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Request:
    index: int
    due_s: float      # from the window's start
    side: int         # the view is side x side pixels
    azimuth_deg: float


def _rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF,
                                  sum(map(ord, tag))])


def stratified_order(n: int, block: int, rng) -> np.ndarray:
    """A permutation of ``range(n)`` (indices of a sorted set) whose every
    run of ``block`` consecutive places holds one index of each of
    ``block`` strata of the set (a last, shorter run holds the rest)."""
    block = max(1, min(block, n))
    strata = np.array_split(np.arange(n), block)
    for s in strata:
        rng.shuffle(s)
    out = []
    for j in range(max(len(s) for s in strata)):
        run = [s[j] for s in strata if j < len(s)]
        rng.shuffle(run)
        out.extend(run)
    return np.asarray(out)


def viewer_schedule(traffic: dict, seed: int, seconds: float,
                    rate_per_s: float | None = None) -> list[Request]:
    rate = float(rate_per_s if rate_per_s is not None
                 else traffic["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    lo, hi = math.log(traffic["side_min"]), math.log(traffic["side_max"])
    sides = np.rint(np.exp(lo + (hi - lo) * q)).astype(int)
    gaps = -np.log1p(-q) / rate
    rng = _rng(seed, "viewer")
    sides = sides[stratified_order(n, int(traffic["size_block"]), rng)]
    gaps = gaps[rng.permutation(n)]
    due = np.cumsum(gaps) - gaps[0]
    azimuth = rng.uniform(-180.0, 180.0, n)
    return [Request(i, float(due[i]), int(sides[i]), float(azimuth[i]))
            for i in range(n)]


def sample_indices(n: int, k: int, seed: int, always=()) -> list[int]:
    """``k`` request indices drawn from the seed, plus ``always``."""
    rng = _rng(seed, "sample")
    pick = set(rng.choice(n, size=min(k, n), replace=False).tolist())
    return sorted(pick | set(always))
