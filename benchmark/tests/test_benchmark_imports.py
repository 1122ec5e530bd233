"""No run loads JAX or the JAX package, and the references import
nothing of the program."""

import ast
import os
import subprocess
import sys

from harness.result import forbidden_modules

from conftest import BENCH_DIR, ROOT


def test_check_compares_whole_top_level_names():
    mods = {"jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1,
            "nerf_replication_tpu.models": 1,
            "nerf_replication_tpu_torch.serve": 1, "jaxtyping": 1,
            "torch": 1}
    assert forbidden_modules(mods) == ["flax.linen", "jax",
                                       "jaxlib.xla_client",
                                       "nerf_replication_tpu.models"]
    assert forbidden_modules({"nerf_replication_tpu_torch": 1}) == []


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_references_and_counts_import_no_program():
    for sub in ("reference", "counts"):
        d = os.path.join(BENCH_DIR, sub)
        for fn in os.listdir(d):
            if fn.endswith(".py"):
                for mod in _imports(os.path.join(d, fn)):
                    top = mod.split(".")[0]
                    assert top in ("torch", "math", "hashlib", "statistics",
                                   "__future__"), (fn, mod)


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{BENCH_DIR!r}, {ROOT!r}, "
        f"{os.path.join(BENCH_DIR, 'tests')!r}]\n"
        "from tiny_cells import tiny_train\n"
        "from harness.cell import run_train\n"
        "from harness.result import forbidden_modules\n"
        "r = run_train(torch, torch.device('cpu'), tiny_train('lego.train'),"
        " 5, 0.2, False, time.perf_counter())\n"
        "print(forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
