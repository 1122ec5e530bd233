"""A model plugs into the benchmark as files of its own: a family under
``families/``, a configuration and entries appended to ``BENCHMARK.json``,
with no byte of an existing file changed. The NeRF family reads what the
harness read before families existed: the same weights, the same counts,
and nothing generic imports the NeRF reference."""

import ast
import copy
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from counts import mlp
from counts.peaks import PEAK_BF16, compute_peak
from harness import cell as cell_mod
from harness import weights
from harness.cell import run_serve, run_train
from harness.spec import load_benchmark, load_family, metric_reader, resolve
from harness.trace import DeviceTracer
from reference import nerf

from conftest import BENCH_DIR, ROOT
from tiny_cells import tiny_serve, tiny_train

CPU = torch.device("cpu")

# a family that is the NeRF family under another name, and that records
# which of its functions the harness and the readers called
TOY_FAMILY = '''
import os

from harness.spec import load_family

_root = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_nerf = load_family("nerf", _root)
CALLS = []


def _recorded(name, fn):
    def call(*args, **kwargs):
        CALLS.append(name)
        return fn(*args, **kwargs)
    return call


for _name, _value in vars(_nerf).items():
    if not _name.startswith("_"):
        globals()[_name] = (_recorded(_name, _value) if callable(_value)
                            and not isinstance(_value, type) else _value)
'''


def _lego_spec():
    with open(os.path.join(BENCH_DIR, "configs", "lego.json")) as f:
        return json.load(f)["model_spec"]


def _digests(root) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for fn in files:
            path = os.path.join(d, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def _copy_with_model(tmp_path, model: str, family_source: str | None):
    """The benchmark copied under ``tmp_path`` with a configuration of
    ``model`` (lego's numbers), its family file when given, and a
    training and a serving cell appended to ``BENCHMARK.json``, each named
    in the lists of the end-to-end metrics lego's cell reports."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench_dir = tmp_path / "benchmark"
    if family_source is not None:
        (bench_dir / "families" / f"{model}.py").write_text(family_source)
    with open(bench_dir / "configs" / "lego.json") as f:
        config = json.load(f)
    config["name"] = model
    config["model_spec"]["model"] = model
    (bench_dir / "configs" / f"{model}.json").write_text(json.dumps(config))
    bench = load_benchmark(str(tmp_path))
    lego = next(c for c in bench["configs"] if c["name"] == "lego")
    bench["configs"].append(dict(lego, name=model,
                                 file=f"benchmark/configs/{model}.json"))
    for cell, traffic in ((f"{model}.train", "train_closed"),
                          (f"{model}.serve", "viewer_open_r16")):
        bench["workloads"].append({"name": cell, "config": model,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a model added as files"})
        lego_cell = "lego" + cell[len(model):]
        for m in bench["end_to_end"]:
            if lego_cell in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return before


class _BusyTracer(DeviceTracer):
    """A CPU run records no device operations; its reading counts the
    traced stretch as busy so that a reader over busy time reads."""

    def reading(self) -> dict:
        r = super().reading()
        r["busy_s"] = r["busy_s"] or r["window_s"]
        return r


def test_a_model_joins_with_new_files_alone(tmp_path, monkeypatch):
    before = _copy_with_model(tmp_path, "toy", TOY_FAMILY)
    root = str(tmp_path)
    train = tiny_train("toy.train", root=root)
    assert train.family.__name__ == "bench_family_toy"
    assert {m["name"] for m in train.per_layer} >= {"mfu.train"}
    r = run_train(torch, CPU, train, 2**31 + 31, 0.3, True,
                  time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert isinstance(r["metrics"]["mfu.train"]["value"], float)
    calls = set(train.family.CALLS)
    assert calls >= {"check_train_cfg", "initial_weights", "build_trainer",
                     "rays_per_step", "train_reference", "step_flops",
                     "tiny_train"}

    monkeypatch.setattr(cell_mod, "DeviceTracer", _BusyTracer)
    serve = tiny_serve("toy.serve", root=root)
    r = run_serve(torch, CPU, serve, 2**31 + 32, 2.0, True,
                  time.perf_counter())
    assert r["correct"] and r["failed"] == 0
    assert r["where"]["requests_compared"] >= 4
    assert isinstance(r["metrics"]["mfu.serve"]["value"], float)
    assert set(serve.family.CALLS) >= {
        "check_serve_cfg", "initial_weights", "build_engine",
        "reference_maps", "count_samples", "sample_flops", "tiny_serve"}

    after = _digests(tmp_path)
    changed = sorted(k for k in before if after[k] != before[k])
    assert changed == ["BENCHMARK.json"]
    # BENCHMARK.json: the old entries as they were, new ones appended
    new = load_benchmark(root)
    for m in new["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [c for c in m["workloads"]
                              if not c.startswith("toy.")]
    new["configs"] = new["configs"][:-1]
    new["workloads"] = new["workloads"][:-2]
    assert new == load_benchmark()


def test_unknown_model_names_its_missing_family_file(tmp_path):
    _copy_with_model(tmp_path, "ghost", None)
    with pytest.raises(FileNotFoundError, match="families/ghost.py"):
        resolve("ghost.train", str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ghost.serve",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode == 2 and out.stdout == ""
    assert "families/ghost.py" in out.stderr


def test_lego_weights_are_the_draw_before_families():
    """The NeRF family's weights for lego are, bitwise, the draw the harness
    made before families: ``make_weights`` over the coarse and fine
    layouts (digests of that draw on the CPU)."""
    fam = load_family("nerf")
    spec = _lego_spec()
    c_pts, c_views = (nerf.encoded_width(spec["pe_xyz"]),
                      nerf.encoded_width(spec["pe_dir"]))
    layout = [item for prefix in ("coarse", "fine") for item in
              nerf.mlp_layout(prefix, spec["D"], spec["W"], spec["skips"],
                              c_pts, c_views)]
    for seed, digest in (
            (2**31 + 5, "4a908d124a50a39a50ab82765ff357be"
                        "5caeebec4882be1148f1e278c8c6bf76"),
            (4000000201, "3049a7d1bbb0724131ba501968a54155"
                         "9b43ba4a889352b39f184d4ee00db2aa")):
        w = fam.initial_weights(spec, seed, CPU)
        assert list(w) == [n for n, _ in layout]
        same = weights.make_weights(layout, seed, CPU)
        h = hashlib.sha256()
        for name, shape in layout:
            assert tuple(w[name].shape) == shape
            assert torch.equal(w[name], same[name])
            h.update(name.encode())
            h.update(w[name].numpy().tobytes())
        assert h.hexdigest() == digest


def test_lego_counts_are_the_kernel_table_expressions():
    fam = load_family("nerf")
    spec = _lego_spec()
    rows = sum(mlp.nerf_rows_per_step(spec).values())
    row = mlp.row_flops(*mlp.nerf_widths(spec))
    assert fam.step_flops(spec) == mlp.train_step_flops(rows, row) \
        == 3 * 4096 * (64 + 64 + 128) * 1_186_816
    assert fam.sample_flops(spec) == row == 1_186_816
    assert fam.rays_per_step(spec) == 4096
    # the readers' arithmetic, digit for digit
    cell = SimpleNamespace(family=fam)
    window, steps, busy, samples = 5.8371, 96, 11.4619, 123_456_789
    ctx = SimpleNamespace(cell=cell, spec=spec, steps=steps,
                          trace={"window_s": window, "busy_s": busy})
    assert metric_reader("mfu.train")(ctx) == \
        100.0 * mlp.train_step_flops(rows, row) * steps / window / PEAK_BF16
    serve = json.load(open(os.path.join(BENCH_DIR, "configs",
                                        "lego.json")))["serve"]
    ctx = SimpleNamespace(cell=cell, spec=spec, samples=samples,
                          serve=serve, trace={"busy_s": busy})
    assert metric_reader("mfu.serve")(ctx) == \
        100.0 * samples * row / busy / compute_peak(serve["compute_dtype"])


NERF_ONLY = re.compile(r"\bnerf_(widths|rows_per_step)\b|\blego_train\b"
                       r"|\bserve_march\b|\breference\.nerf\b")


def _generic_sources():
    d = os.path.join(BENCH_DIR, "harness")
    yield from (os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(".py"))
    d = os.path.join(BENCH_DIR, "metrics")
    yield from (os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.startswith("mfu.") and f.endswith(".py"))


@pytest.mark.parametrize("path", list(_generic_sources()),
                         ids=os.path.basename)
def test_generic_code_imports_no_model(path):
    with open(path) as f:
        source = f.read()
    assert not NERF_ONLY.search(source), path
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom) and node.module == "reference":
            assert not {a.name for a in node.names} & {
                "nerf", "lego_train", "serve_march"}, path


def test_a_model_only_reader_lists_its_cells():
    """A per-layer reader that counts one model's shapes is given to the
    cells it names, never to a cell a later model adds."""
    for m in load_benchmark()["per_layer"]:
        with open(os.path.join(BENCH_DIR, "metrics",
                               m["name"] + ".py")) as f:
            if NERF_ONLY.search(f.read()):
                assert m.get("workloads"), m["name"]


def test_every_cell_has_its_family_and_faults():
    for w in load_benchmark()["workloads"]:
        cell = resolve(w["name"])
        model = cell.config["model_spec"]["model"]
        assert cell.family.__name__ == f"bench_family_{model}"
        kind = cell.traffic["kind"]
        for fault in cell.family.FAULTS[kind]:
            patches = cell.family.fault_patches(fault)
            assert patches and all(hasattr(owner, name)
                                   for owner, name, _ in patches)
        cut = copy.deepcopy(cell.config)
        if kind == "train_loop":
            cell.family.tiny_train(cut, "float32")
        else:
            cell.family.tiny_serve(cut)
        assert cut["model_spec"] != cell.config["model_spec"]
