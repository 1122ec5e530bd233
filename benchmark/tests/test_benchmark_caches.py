"""A run keeps its caches at fixed paths inside its checkout, so that only
a checkout's first run builds and compiles: Python's bytecode too, also
where the environment turns its writing off and the installed packages
hold none."""

import os
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, ROOT


def _run(cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONPYCACHEPREFIX")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONDONTWRITEBYTECODE"] = "1"
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "no.such_cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def _cache(root) -> dict:
    top = os.path.join(root, "build", "pycache")
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, files in os.walk(top) for f in files}


def test_bytecode_is_cached_inside_the_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    first = _run(tmp_path)
    assert first.returncode == 2 and first.stdout == ""
    cache = _cache(tmp_path)
    # torch's modules and the harness's, wherever they are installed
    torch_dir = os.path.dirname(__import__("torch").__file__)
    torch_dirs = {torch_dir, os.path.realpath(torch_dir)}
    assert any(p.endswith(".pyc") and any(d in p for d in torch_dirs)
               for p in cache)
    assert any(p.endswith(".pyc") and "harness" in p for p in cache)
    assert not os.path.exists(tmp_path / "benchmark" / "__pycache__")
    # the second run reads what the first wrote and writes nothing
    second = _run(tmp_path)
    assert second.returncode == 2
    assert _cache(tmp_path) == cache
