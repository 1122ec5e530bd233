"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic; the configuration's file is the one its entry
names (``benchmark/configs/<name>.json``), the traffic is
``benchmark/traffic/<name>.json``, the model's family (every model-specific
step of a run, ``families/nerf.py`` says which) is
``benchmark/families/<model_spec.model>.py`` and a per-layer metric's
reader is ``benchmark/metrics/<name>.py``. Adding a cell, a configuration,
a model, a traffic mix or a metric adds files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    chips: int
    family: object  # the loaded ``families/<model>.py``
    root: str  # where its files were found


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, root: str = ROOT) -> Cell:
    """The cell ``cell_name`` with its configuration, traffic and the
    metrics it reports; raises ``KeyError`` for an unknown cell."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r}; have {sorted(cells)}")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[w["config"]]
    with open(os.path.join(root, conf_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, cell_name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and _in_cell(m, cell_name)]
    family = load_family(config["model_spec"]["model"], root)
    return Cell(cell_name, config, traffic, e2e, per_layer,
                int(w["chips"]), family, root)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_family(model: str, root: str = ROOT):
    """The module ``benchmark/families/<model>.py``; raises
    ``FileNotFoundError`` naming the file when there is none."""
    path = os.path.join(root, "benchmark", "families", model + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"model {model!r} has no family file {path}")
    return _load(path, "bench_family_" + model.replace(".", "_"))


def metric_reader(name: str, root: str = ROOT):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    return _load(path, "bench_metric_" + name.replace(".", "_")).read
