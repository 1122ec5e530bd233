"""The program's span rows, alone and on the device trace's clock.

A span row (the program's ``obs/trace.py``: ``name``, ``span_id``,
``parent_id``, ``start_s``, ``dur_s`` and attributes) is stamped on
``time.perf_counter``. A ``torch.profiler`` trace is stamped on the Unix
clock: its ``trace_start_ns()`` plus each event's relative µs.
:func:`place` moves rows onto the trace's relative µs with the offset the
program's ``wall_offset_ns`` gives; that places the trace's host
operations, but its device operations lag behind by up to a millisecond
on an H100 (PERF.md). Probes measure the lag: a span around a sleep
kernel and a synchronisation brackets it (:func:`lag_bounds`), and
:func:`shift` takes it off the device's intervals, so a span and a device
operation can be compared in time.

On its own, a served view's spans (each request's ``serve.view``, its
``serve.rays`` and ``serve.image``, its ``serve.queue`` with ``behind_s``,
its ``serve.handoff``) give the serving metrics their numbers; placed on
the trace, they split the device's idle time by what the program was
doing (:func:`idle_by_span`). Everything here is plain arithmetic on
lists, so the readers' tests build rows and intervals by hand.
"""

from __future__ import annotations

import bisect
import heapq

from .trace import _union as union

NO_REQUEST = "no request"


def named(rows, name: str) -> list:
    return [r for r in rows if r["name"] == name]


def durations(rows, name: str) -> list:
    return [r["dur_s"] for r in rows if r["name"] == name]


def view_host_s(rows) -> list:
    """Per view that rendered rays: its ``serve.rays`` plus ``serve.image``
    seconds (the host's work of the view around its render)."""
    views = {r["span_id"] for r in named(rows, "serve.view")}
    per: dict = {}
    seen = set()
    for r in rows:
        if r["name"] in ("serve.rays", "serve.image") \
                and r.get("parent_id") in views:
            per[r["parent_id"]] = per.get(r["parent_id"], 0.0) + r["dur_s"]
            if r["name"] == "serve.rays":
                seen.add(r["parent_id"])
    return [per[v] for v in per if v in seen]


def behind_s(rows) -> list:
    """``behind_s`` of every ``serve.queue`` row that carries it."""
    return [r["behind_s"] for r in named(rows, "serve.queue")
            if "behind_s" in r]


def clip(intervals, lo: float, hi: float) -> list:
    """``intervals`` cut to ``[lo, hi]``, empty pieces dropped."""
    out = []
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out.append([s, e])
    return out


def complement(busy, lo: float, hi: float) -> list:
    """The idle pieces of ``[lo, hi]``: where no interval of ``busy``
    lies."""
    idle, t = [], lo
    for s, e in union(clip(busy, lo, hi)):
        if s > t:
            idle.append([t, s])
        t = max(t, e)
    if hi > t:
        idle.append([t, hi])
    return idle


def overlap(a, b) -> float:
    """Total length where the two unions of intervals meet."""
    a, b = union(a), union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_s(parent: dict, children) -> float:
    """The parent's seconds that none of ``children`` covers."""
    lo, hi = parent["start_s"], parent["start_s"] + parent["dur_s"]
    covered = sum(e - s for s, e in union(clip(
        [(c["start_s"], c["start_s"] + c["dur_s"]) for c in children],
        lo, hi)))
    return parent["dur_s"] - covered


def view_self_s(rows) -> list:
    """Per ``serve.view``: its seconds that no child span covers."""
    kids: dict = {}
    for r in rows:
        if r.get("parent_id") is not None:
            kids.setdefault(r["parent_id"], []).append(r)
    return [self_s(v, kids.get(v["span_id"], []))
            for v in named(rows, "serve.view")]


def place(rows, offset_ns: int, trace_start_ns: int) -> list:
    """``(start_us, end_us, row)`` of each row on the trace's relative µs:
    ``(start_s * 1e9 + offset_ns - trace_start_ns) / 1e3``."""
    out = []
    for r in rows:
        s = (r["start_s"] * 1e9 + offset_ns - trace_start_ns) / 1e3
        out.append((s, s + r["dur_s"] * 1e6, r))
    return out


def lag_bounds(probe) -> tuple:
    """The bounds ``(lo, hi)`` in µs of the device clock's lag behind the
    host's that one probe allows: a span ``(s, e)`` around a kernel that
    the trace places at ``(ks, ke)``. The kernel truly starts after the
    span does (``ks - lag >= s``) and ends before it (``ke - lag <= e``),
    so ``ke - e <= lag <= ks - s``."""
    s, e, ks, ke = probe
    return ke - e, ks - s


def lag_at(probes) -> tuple:
    """``(t, lag)`` of a set of probes taken together: the midpoint of the
    narrowest bounds all of them allow, at the set's mean kernel time;
    ``lag`` None where the probes disagree (the lag moved within the
    set)."""
    bounds = [lag_bounds(p) for p in probes]
    lo = max(b[0] for b in bounds)
    hi = min(b[1] for b in bounds)
    t = sum(p[2] for p in probes) / len(probes)
    return t, ((lo + hi) / 2 if lo <= hi else None)


def lag_fit(points):
    """The lag as a function of the trace's µs: the line through the
    first and last ``(t, lag)`` (a constant for one point)."""
    (t0, a), (t1, b) = points[0], points[-1]
    if t1 == t0:
        return lambda t: a
    return lambda t: a + (b - a) * (t - t0) / (t1 - t0)


def shift(busy, lag) -> list:
    """Device intervals moved onto the host's clock: each end less the
    lag there."""
    return [(s - lag(s), e - lag(e)) for s, e in busy]


def idle_in_views_us(stretch, busy, placed) -> float:
    """µs of ``stretch`` (``(lo, hi)``) with no device operation while at
    least one ``serve.view`` was open."""
    lo, hi = stretch
    views = [(s, e) for s, e, r in placed if r["name"] == "serve.view"]
    return overlap(complement(busy, lo, hi), clip(views, lo, hi))


def idle_by_span(stretch, busy, placed) -> dict:
    """Idle µs of ``stretch`` by the shortest (innermost) program span open
    at the time, else :data:`NO_REQUEST`: a sweep over the span and idle
    edges, the shortest open span a heap's top (spans that closed are
    dropped when they reach the top)."""
    lo, hi = stretch
    spans = sorted((s, e, r["name"]) for s, e, r in placed
                   if e > lo and s < hi)
    idle = complement(busy, lo, hi)
    edges = sorted({x for s, e, _ in spans for x in (s, e)}
                   | {x for s, e in idle for x in (s, e)})
    out: dict = {}
    heap: list = []
    k = 0
    for a, b in zip(edges, edges[1:]):
        while k < len(spans) and spans[k][0] <= a:
            s, e, name = spans[k]
            heapq.heappush(heap, (e - s, e, name))
            k += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        i = bisect.bisect_right(idle, [a, float("inf")]) - 1
        if i < 0 or idle[i][1] < b:
            continue  # the device was busy over [a, b]
        label = heap[0][2] if heap else NO_REQUEST
        out[label] = out.get(label, 0.0) + (b - a)
    return out


def label_at(placed, t: float):
    """The shortest span open at ``t``, or None."""
    best = None
    for s, e, r in placed:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, r["name"])
    return None if best is None else best[2]


def label_gaps(gaps, placed) -> list:
    """``[label, seconds]`` of each idle gap ``(start_us, end_us)`` in which
    the profiler saw no host operation: the shortest program span open at
    its midpoint, else ``host idle``."""
    return [[label_at(placed, (s + e) / 2) or "host idle", (e - s) / 1e6]
            for s, e in gaps]
