"""The numbers that decide ``correct``, each against its limit.

Training cells compare the losses of the first steps, the first gradient
as the optimizer gets it and the parameters' change over the steps. The
gradient and the change are compared by the worst leaf: the gap between
the program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger. Leaves the step does not
train (a reference gradient of exactly zero) and leaves whose reference
gradient is under a thousandth of the median trained leaf's are left out
of both (they move by round-off alone under Adam); a run names each in
``where.left_out`` with its norm beside the median's.

Serving cells compare the maps of the replies with the reference's render
of the same rays: the widest gap of any pixel.
"""

from __future__ import annotations

import statistics

import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def counted_leaves(ref_grad_norms: dict) -> list[str]:
    trained = {k: v for k, v in ref_grad_norms.items() if v > 0.0}
    med = statistics.median(trained.values())
    return [k for k, v in trained.items() if v >= EXCLUDE_BELOW * med]


def left_out(ref_grad_norms: dict, leaves) -> dict:
    """The leaves not compared, each with its reference gradient's norm,
    beside the median trained leaf's (``"median"``)."""
    trained = [v for v in ref_grad_norms.values() if v > 0.0]
    out = {k: v for k, v in ref_grad_norms.items() if k not in leaves}
    return {**out, "median": statistics.median(trained)} if out else {}


def worst_leaf_gap(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    """``(gap, leaf)``: max over ``leaves`` of ``|prog - ref| / max(ref,
    median ref)`` of per-leaf norms."""
    med = statistics.median(ref[k] for k in leaves)
    worst, name = 0.0, ""
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst or not name:
            worst, name = gap, k
    return worst, name


def relative_error(prog: dict, ref: dict, leaves) -> float:
    """``|prog - ref| / |ref|`` over the ``leaves`` taken as one vector."""
    num = sum(float(torch.sum((prog[k].double() - ref[k].double()) ** 2))
              for k in leaves)
    den = sum(float(torch.sum(ref[k].double() ** 2)) for k in leaves)
    return (num / max(den, 1e-300)) ** 0.5


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: ``{"losses": [...], "grad1": {leaf: tensor},
    "delta": {leaf: tensor}}``. Returns every number read (the limited
    ones are those the configuration's limits name) and where the worst
    leaves were."""
    loss_gaps = [abs(p - r) / max(abs(r), 1e-30)
                 for p, r in zip(prog["losses"], ref["losses"])]
    g_ref, d_ref = norms(ref["grad1"]), norms(ref["delta"])
    leaves = counted_leaves(g_ref)
    grad_gap, grad_leaf = worst_leaf_gap(norms(prog["grad1"]), g_ref, leaves)
    delta_gap, delta_leaf = worst_leaf_gap(norms(prog["delta"]), d_ref,
                                           leaves)
    return {
        "numbers": {"loss_gap": max(loss_gaps), "loss1_gap": loss_gaps[0],
                    "grad_gap": grad_gap, "delta_gap": delta_gap,
                    "grad_err": relative_error(prog["grad1"], ref["grad1"],
                                               leaves),
                    "delta_err": relative_error(prog["delta"], ref["delta"],
                                                leaves)},
        "where": {"grad_gap": grad_leaf, "delta_gap": delta_leaf,
                  "leaves_compared": len(leaves), "leaves": len(g_ref),
                  "left_out": left_out(g_ref, leaves)},
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [(name, number, limit), ...])`` over the numbers
    ``limits`` names: correct when each is finite and at or under its
    limit."""
    rows = []
    ok = True
    for name, limit in limits.items():
        value, limit = numbers[name], float(limit)
        good = value == value and value <= limit  # NaN fails
        ok = ok and good
        rows.append((name, float(value), limit))
    return ok, rows
