"""The port's concurrency rules R10-R13 against the JAX package's, on the
fixtures of ``tests/test_analysis.py`` (lock-order, unguarded-shared,
blocking-under-lock, thread-hygiene): the same source through both engines
gives the same findings (messages compared with the package path mapped),
the three-lock cycle across two modules included, and a baselined finding
survives a line shift. Then what only the port's R12 sees: torch's
synchronizing calls under a lock.
"""

import pytest

from nerf_replication_tpu.analysis import lint_paths as jax_lint_paths
from nerf_replication_tpu.analysis import lint_source as jax_lint
from nerf_replication_tpu_torch.analysis import (
    CONCURRENCY_RULE_IDS,
    RULE_IDS,
    RULES,
    diff_baseline,
    lint_paths,
    lint_source,
    load_baseline,
    save_baseline,
)

JAX_PATH = "nerf_replication_tpu/fx_conc.py"
PORT_PATH = "nerf_replication_tpu_torch/fx_conc.py"

SELF_DEADLOCK = """
import threading

class Store:
    def __init__(self):
        self._lock = threading.Lock()

    def outer(self):
        with self._lock:
            self.inner()

    def inner(self):
        with self._lock:
            pass
"""

UNGUARDED = """
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self._t = threading.Thread(target=self._worker, daemon=True)

    def bump(self):
        with self._lock:
            self._n += 1

    def _worker(self):
        while True:
            self._n = 0
"""

GUARDS = """
import threading

class Batcher:
    def __init__(self):
        {ann}self._cond = threading.Condition()
        self._queue = []
        self._n_cut = 0
        self._t = threading.Thread(target=self._worker, daemon=True)

    def submit(self, item):
        with self._cond:
            self._queue.append(item)
            self._n_cut += 1

    def _worker(self):
        while True:
            self._n_cut = 0
"""

BLOCKING = """
import threading
import time

class Slow:
    def __init__(self):
        self._lock = threading.Lock()

    def tick(self):
        with self._lock:
            time.sleep(0.1)
"""

HYGIENE = """
import threading

class Spawner:
    def __init__(self):
        self._cond = threading.Condition()
        self._ready = False

    def go(self):
        t = threading.Thread(target=self._work)
        t.start()

    def wait_once(self):
        with self._cond:
            self._cond.wait()

    def _work(self):
        pass
"""

CASES = {
    "self_deadlock": (SELF_DEADLOCK, {"lock-order"}),
    "rlock": (SELF_DEADLOCK.replace("threading.Lock()",
                                    "threading.RLock()"), set()),
    "unguarded": (UNGUARDED, {"unguarded-shared"}),
    "unguarded_locked": (UNGUARDED.replace(
        "        while True:\n            self._n = 0",
        "        while True:\n            with self._lock:\n"
        "                self._n = 0"), set()),
    "guards_inferred": (GUARDS.format(ann=""), {"unguarded-shared"}),
    "guards_pinned": (GUARDS.format(
        ann="# graftlint: guards(_queue)\n        "), set()),
    "blocking": (BLOCKING, {"blocking-under-lock"}),
    "blocking_via_call": (BLOCKING.replace(
        "            time.sleep(0.1)",
        "            self._nap()\n\n    def _nap(self):\n"
        "        time.sleep(0.1)"), {"blocking-under-lock"}),
    "blocking_outside_and_allowlisted": (BLOCKING.replace(
        "        with self._lock:\n            time.sleep(0.1)",
        "        with self._lock:\n            pass\n        time.sleep(0.1)"
        "\n\n    def tock(self):\n        with self._lock:\n"
        "            # graftlint: ok(blocking-under-lock: test allowlist)\n"
        "            time.sleep(0.1)"), set()),
    "hygiene": (HYGIENE, {"thread-hygiene"}),
    "hygiene_clean": (HYGIENE.replace(
        "t = threading.Thread(target=self._work)",
        "t = threading.Thread(target=self._work, daemon=True)").replace(
        "            self._cond.wait()",
        "            while not self._ready:\n                self._cond.wait()"),
        set()),
}


def _mapped(findings):
    return [(f.rule, f.line, f.col,
             f.message.replace(JAX_PATH, PORT_PATH), f.snippet)
            for f in findings]


@pytest.mark.parametrize("case", sorted(CASES))
def test_concurrency_rules_equal(case):
    src, rules = CASES[case]
    a = jax_lint(src, path=JAX_PATH)
    b = lint_source(src, path=PORT_PATH)
    assert _mapped(a) == _mapped(b)
    assert {f.rule for f in b} == rules
    if case == "hygiene":
        assert [f.rule for f in b].count("thread-hygiene") >= 2


MOD_A = (
    "import threading\n"
    "from mod_b import B\n"
    "\n"
    "class A:\n"
    "    def __init__(self):\n"
    "        self._l1 = threading.Lock()\n"
    "        self._l3 = threading.Lock()\n"
    "        self._b = B()\n"
    "\n"
    "    def fwd(self):\n"
    "        with self._l1:\n"
    "            self._b.grab2()\n"
    "\n"
    "    def grab3(self):\n"
    "        with self._l3:\n"
    "            pass\n"
    "\n"
    "    def rev(self):\n"
    "        with self._l3:\n"
    "            with self._l1:\n"
    "                pass\n"
)
MOD_B = (
    "import threading\n"
    "from mod_a import A\n"
    "\n"
    "class B:\n"
    "    def __init__(self):\n"
    "        self._l2 = threading.Lock()\n"
    "        self._a = A()\n"
    "\n"
    "    def grab2(self):\n"
    "        with self._l2:\n"
    "            pass\n"
    "\n"
    "    def fwd(self):\n"
    "        with self._l2:\n"
    "            self._a.grab3()\n"
)


def test_three_lock_cycle_across_modules_equal(tmp_path):
    (tmp_path / "mod_a.py").write_text(MOD_A)
    (tmp_path / "mod_b.py").write_text(MOD_B)
    paths = [str(tmp_path / "mod_a.py"), str(tmp_path / "mod_b.py")]

    def run():
        a = jax_lint_paths(paths, repo_root=str(tmp_path),
                           rules=("lock-order",))
        b = lint_paths(paths, repo_root=str(tmp_path), rules=("lock-order",))
        assert a[1] == b[1] == []
        assert _mapped(a[0]) == _mapped(b[0])
        return [f.message for f in b[0] if "cycle" in f.message]

    msgs = run()
    assert any("A._l1" in m and "B._l2" in m and "A._l3" in m for m in msgs)
    # breaking one edge (rev() no longer nests l1 under l3) clears it
    (tmp_path / "mod_a.py").write_text(MOD_A.replace(
        "        with self._l3:\n            with self._l1:\n",
        "        with self._l3:\n            if self._l1:\n"))
    assert run() == []


def test_baseline_identity_survives_line_shift(tmp_path):
    findings = lint_source(BLOCKING, path=PORT_PATH)
    assert findings
    path = str(tmp_path / "baseline.json")
    save_baseline(path, findings)
    shifted = lint_source("# shift\n# every\n# line\n" + BLOCKING,
                          path=PORT_PATH)
    new, accepted, n_fixed = diff_baseline(shifted, load_baseline(path))
    assert new == [] and accepted and n_fixed == 0


TORCH_SYNCS = """
import threading
import torch

class Engine:
    def __init__(self):
        self._lock = threading.Lock()

    def render(self, out, ev):
        with self._lock:
            torch.cuda.synchronize()
            ev.synchronize()
            n = out.item()
            host = out.cpu()
            self._copy_back(out)
        return n, host

    def _copy_back(self, out):
        return out.cpu()

    def cold(self, out):
        return out.cpu(), out.item()
"""


def test_torch_syncs_block_under_a_lock():
    """torch.cuda.synchronize, Event/Stream.synchronize, .item() and
    .cpu() are blocking calls: directly under the lock, one call away, and
    inside the helper only ever called under it (held at entry); outside a
    lock they are not R12's business. The JAX engine sees none of them."""
    found = [f for f in lint_source(TORCH_SYNCS, path=PORT_PATH)
             if f.rule == "blocking-under-lock"]
    assert [f.line for f in found] == [11, 12, 13, 14, 15, 19]
    assert "torch.cuda.synchronize" in found[0].message
    assert "ev.synchronize" in found[1].message
    assert ".item()" in found[2].message and ".cpu()" in found[3].message
    assert "_copy_back" in found[4].message
    assert [f for f in jax_lint(TORCH_SYNCS, path=JAX_PATH)
            if f.rule == "blocking-under-lock"] == []


def test_rule_registry_matches_jax():
    from nerf_replication_tpu.analysis.core import RULE_IDS as JAX_IDS
    from nerf_replication_tpu.analysis.core import RULES as JAX_RULES

    lint_source("x = 1")  # force rule registration
    jax_lint("x = 1")
    assert RULE_IDS == JAX_IDS
    assert CONCURRENCY_RULE_IDS == (
        "lock-order", "unguarded-shared", "blocking-under-lock",
        "thread-hygiene")
    assert set(RULES) == set(JAX_RULES) == set(RULE_IDS)
    assert all(RULES[r].doc for r in RULE_IDS)
