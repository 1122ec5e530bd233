"""The benchmark's cells cut to sizes a CPU test holds: the same code
paths and names, the cell's family's small cut (small widths, few
samples, short marches) and a 2-view 16x16 scene."""

from __future__ import annotations

import copy

from harness.spec import ROOT, load_benchmark, resolve


def cells_of_kind(kind: str, root: str = ROOT) -> list[str]:
    """The names of the cells whose traffic is of ``kind``."""
    return [w["name"] for w in load_benchmark(root)["workloads"]
            if resolve(w["name"], root).traffic["kind"] == kind]


def tiny_train(name: str, dtype: str | None = "float32", root: str = ROOT):
    """A training cell at a small size (``dtype``: the compute precision,
    None for the configuration's)."""
    cell = resolve(name, root)
    c = copy.deepcopy(cell.config)
    cell.family.tiny_train(c, dtype)
    c["scene"].update({"n_views": 2, "H": 16, "W": 16})
    cell.config = c
    cell.traffic = dict(cell.traffic, unit_steps=2, trace_seconds=0.5)
    return cell


def tiny_serve(name: str, root: str = ROOT):
    """A serving cell at a small size: the family's cut, small views."""
    cell = resolve(name, root)
    c = copy.deepcopy(cell.config)
    cell.family.tiny_serve(c)
    cell.config = c
    cell.traffic = dict(cell.traffic, side_min=8, side_max=24,
                        rate_per_s=4.0, compared_requests=4)
    return cell


def plant(monkeypatch, cell, fault: str) -> None:
    """Plant the cell's family's fault ``fault`` in the program."""
    for owner, name, value in cell.family.fault_patches(fault):
        monkeypatch.setattr(owner, name, value)
