"""The port's graftlint rules R1-R7 held against the JAX package's.

Each R1-R7 fixture of ``tests/test_analysis.py`` has a torch twin here: the
torch hazard that takes the JAX one's place, laid out so that it sits on
the same lines. JAX's engine on the JAX snippet and the port's engine on
the twin must flag the same ``(rule, line)`` set (both empty for the
negatives). "Traced" becomes "captured": a function handed to
``AOTRegistry.register(name, fn, ...)`` (the ``# captured`` lines below
stand where the JAX snippets decorate with ``@jax.jit``), or the body of
``with torch.cuda.graph(...)``. Then the torch-only parts of the rules and
the port tree's hot roots.
"""

import os

import pytest

from nerf_replication_tpu.analysis import lint_source as jax_lint
from nerf_replication_tpu_torch.analysis import lint_source as port_lint
from nerf_replication_tpu_torch.analysis.core import ModuleContext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG = "aot.register('f', f, (x0,))\n"
_LIB = "nerf_replication_tpu/render/foo.py"


def port_path(path: str) -> str:
    """A JAX fixture path at its place in the port."""
    if path.startswith("nerf_replication_tpu/"):
        return "nerf_replication_tpu_torch/" + path[len(
            "nerf_replication_tpu/"):]
    if path.startswith("scripts/"):
        return "nerf_replication_tpu_torch/tools/" + path[len("scripts/"):]
    return path


def lines(findings):
    return {(f.rule, f.line) for f in findings}


# (JAX snippet, torch twin, path) — positives, then negatives, per rule
TWINS = {
    "host-sync": ([
        ("import jax\nimport numpy as np\n@jax.jit\ndef f(x):\n"
         "    return np.asarray(x) + 1\n",
         "import torch\nimport numpy as np\n# captured\ndef f(x):\n"
         "    return np.asarray(x) + 1\n" + REG, "fixture.py"),
        ("import jax\nimport jax.numpy as jnp\n@jax.jit\ndef f(x):\n"
         "    a = x.item()\n    b = float(jnp.sum(x))\n    return a + b\n",
         "import torch\nimport numpy as np\n# captured\ndef f(x):\n"
         "    a = x.item()\n    b = float(torch.sum(x))\n    return a + b\n"
         + REG, "fixture.py"),
        ("import jax\nimport numpy as np\ndef helper(x):\n"
         "    return np.asarray(x)\n@jax.jit\ndef f(x):\n"
         "    return helper(x)\n",
         "import torch\nimport numpy as np\ndef helper(x):\n"
         "    return np.asarray(x)\n# captured\ndef f(x):\n"
         "    return helper(x)\n" + REG, "fixture.py"),
        ("import numpy as np\n# graftlint: hot\ndef per_request(fn, rays):\n"
         "    return np.asarray(fn(rays))\n",
         "import numpy as np\n# graftlint: hot\ndef per_request(fn, rays):\n"
         "    return np.asarray(fn(rays))\n", "fixture.py"),
    ], [
        ("import jax\nimport numpy as np\ndef load(path):\n"
         "    return np.asarray([1, 2])\n@jax.jit\ndef f(x):\n"
         "    n = int(x.shape[0])\n    return x * n\n",
         "import torch\nimport numpy as np\ndef load(path):\n"
         "    return np.asarray([1, 2])\n# captured\ndef f(x):\n"
         "    n = int(x.shape[0])\n    return x * n\n" + REG, "fixture.py"),
    ]),
    "retrace": ([
        ("import jax\ndef bench(xs):\n    for x in xs:\n"
         "        f = jax.jit(lambda a: a + 1)\n        f(x)\n",
         "import torch\ndef bench(xs):\n    for x in xs:\n"
         "        g = torch.cuda.CUDAGraph()\n        g.replay()\n",
         "fixture.py"),
        ("import jax\n@jax.jit\ndef f(x):\n    return x + 1\n"
         "def serve(x, n):\n    return f(x[:n])\n",
         "import torch\nf = aot.take('f')\n\n\n"
         "def serve(x, n):\n    return f(x[:n])\n", "fixture.py"),
    ], [
        ("import jax\nimport numpy as np\n@jax.jit\ndef f(x):\n"
         "    return x + 1\ndef serve(x):\n"
         "    padded = np.pad(x, ((0, 4096 - x.shape[0]), (0, 0)))\n"
         "    return f(padded)\ndef bench(xs):\n    for x in xs:\n"
         "        f(x)\n",
         "import torch\nimport numpy as np\nf = aot.take('f')\n\n\n"
         "def serve(x):\n"
         "    padded = np.pad(x, ((0, 4096 - x.shape[0]), (0, 0)))\n"
         "    return f(padded)\ndef bench(xs):\n    for x in xs:\n"
         "        f(x)\n", "fixture.py"),
    ]),
    "donate": ([
        ("import jax\n@jax.jit\ndef step(state, batch):\n"
         "    grads = batch\n    return state.apply_gradients(grads=grads)\n",
         "import torch\ndef warm(aot): aot.register('step', step, ())\n"
         "def step(params, grads):\n    for p, g in zip(params, grads):\n"
         "        p.data = p - 0.1 * g\n", "fixture.py"),
        ("import jax\n"
         "opt = jax.jit(lambda state, g: state.apply_gradients(grads=g))\n",
         "import torch\n"
         "opt = aot.register('opt', lambda params, g: (params := params - g),"
         " ())\n", "fixture.py"),
    ], [
        ("import jax\nfrom functools import partial\n"
         "@partial(jax.jit, donate_argnums=(0,))\ndef step(state, batch):\n"
         "    return state.apply_gradients(grads=batch)\n@jax.jit\n"
         "def render(params, rays):\n    return rays * 2\n",
         "import torch\ndef step(params, grads):\n"
         "    for p, g in zip(params, grads):\n"
         "        p.add_(g, alpha=-0.1)\ndef render(params, rays):\n"
         "    return rays * 2\ndef warm(aot):\n"
         "    aot.register('step', step, ())\n"
         "    aot.register('render', render, ())\n", "fixture.py"),
    ]),
    "rng": ([
        ("import jax\nkey = jax.random.PRNGKey(0)\n",
         "import torch\ngen = torch.Generator().manual_seed(0)\n",
         "nerf_replication_tpu/foo.py"),
        ("import jax\ndef f(key):\n    a = jax.random.normal(key, (3,))\n"
         "    b = jax.random.uniform(key, (3,))\n    return a + b\n",
         "import torch\ndef f(gen):\n    a = torch.randn(3, generator=gen)\n"
         "    b = torch.rand(3)\n    return a + b\n", "fixture.py"),
        ("import jax\ndef f(key):\n    k1, k2 = jax.random.split(key)\n"
         "    return jax.random.normal(key, (3,))\n",
         "import torch\ndef f(gen, seed):\n    gen.manual_seed(seed)\n"
         "    return torch.randn(3)\n", "fixture.py"),
        ("import jax\ndef f(key):\n    out = []\n    for i in range(4):\n"
         "        out.append(jax.random.normal(key, (3,)))\n    return out\n",
         "import torch\ndef f(gen):\n    out = []\n    for i in range(4):\n"
         "        out.append(torch.randn(3, generator=gen.manual_seed(7)))\n"
         "    return out\n", "fixture.py"),
    ], [
        ("import jax\nkey = jax.random.PRNGKey(0)\n",
         "import torch\ngen = torch.Generator().manual_seed(0)\n",
         "scripts/bench_foo.py"),
        ("import jax\ndef f(key, pool):\n"
         "    key = jax.random.fold_in(key, 7)\n"
         "    k1, k2 = jax.random.split(key)\n"
         "    a = jax.random.normal(k1, (3,))\n    if pool is None:\n"
         "        b = jax.random.uniform(k2, (3,))\n    else:\n"
         "        b = jax.random.randint(k2, (3,), 0, 9)\n    return a + b\n",
         "import torch\ndef f(gen, pool):\n    gen.manual_seed(seed_of(pool))\n"
         "    k = torch.randint(0, 9, (1,), generator=gen)\n"
         "    a = torch.randn(3, generator=gen)\n    if pool is None:\n"
         "        b = torch.rand(3, generator=gen)\n    else:\n"
         "        b = torch.randint(0, 9, (3,), generator=gen)\n"
         "    return a + b\n", "fixture.py"),
    ]),
    "side-effect": ([
        ("import jax\nacc = []\n@jax.jit\ndef f(x):\n    print(x)\n"
         "    acc.append(x)\n    return x\n",
         "import torch\nacc = []\n# captured\ndef f(x):\n    print(x)\n"
         "    acc.append(x)\n    return x\n" + REG, "fixture.py"),
    ], [
        ("import jax\n@jax.jit\ndef f(x):\n    parts = []\n"
         "    parts.append(x)\n    jax.debug.print('x={x}', x=x)\n"
         "    return parts[0]\n",
         "import torch\n# captured\ndef f(x):\n    parts = []\n"
         "    parts.append(x)\n    torch.cuda.nvtx.range_push('f')\n"
         "    return parts[0]\n" + REG, "fixture.py"),
    ]),
    "aot": ([
        ("import jax\n@jax.jit\ndef render(params, rays):\n"
         "    return rays * 2\nstep = jax.jit(lambda s, b: s)\n",
         "import torch\n@torch.compile\ndef render(params, rays):\n"
         "    return rays * 2\nstep = torch.cuda.CUDAGraph()\n", _LIB),
    ], [
        ("import jax\nclass T:\n    def _build_step(self):\n"
         "        return jax.jit(lambda s, b: s)\n    def warm(self, sig):\n"
         "        self.aot.register('k', self._build_step(), sig)\n"
         "        self.aot.register('r', jax.jit(lambda r: r), sig)\n",
         "import torch\nclass T:\n    def _build_step(self):\n"
         "        return lambda s, b: s\n    def warm(self, sig):\n"
         "        self.aot.register('k', self._build_step(), sig)\n"
         "        self.aot.register('r', lambda r: r, sig)\n", _LIB),
        *[("import jax\nf = jax.jit(lambda x: x + 1)\n",
           "import torch\ng = torch.cuda.CUDAGraph()\n", path)
          for path in ("scripts/bench_foo.py", "tests/test_foo.py",
                       "serve.py", "nerf_replication_tpu/compile/registry.py")],
        ("import jax\n# graftlint: ok(aot: one-shot debug helper)\n"
         "f = jax.jit(lambda x: x + 1)\n",
         "import torch\n# graftlint: ok(aot: one-shot debug helper)\n"
         "g = torch.cuda.CUDAGraph()\n", _LIB),
    ]),
}

_KNOWN = {("train",), ("train", "lr"), ("task_arg",), ("seed",)}
_CFG_POS = ("def setup(cfg):\n    lr = cfg.train.lr\n"
            "    return cfg.get('definitely_not_a_key', 1)\n")
_CFG_NEG = ("def setup(cfg):\n    lr = cfg.train.lr\n"
            "    n = cfg.task_arg.get('N_rays', 1024)\n    return lr, n\n"
            "def encoder(cfg):\n    return cfg.get('num_levels', 16)\n")
TWINS["config-key"] = ([(_CFG_POS, _CFG_POS, "fixture.py")],
                       [(_CFG_NEG, _CFG_NEG, "fixture.py")])


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_twins_flag_the_same_lines(rule):
    """Every positive flags ``rule`` on the same lines in both engines
    (and nothing else differs); every negative is clean in both."""
    positives, negatives = TWINS[rule]
    kw = {"config_keys": _KNOWN} if rule == "config-key" else {}
    for jax_src, torch_src, path in positives:
        want = lines(jax_lint(jax_src, path=path, **kw))
        got = lines(port_lint(torch_src, path=port_path(path), **kw))
        assert any(r == rule for r, _ in want), (rule, jax_src)
        assert got == want, (rule, torch_src)
    for jax_src, torch_src, path in negatives:
        assert lines(jax_lint(jax_src, path=path, **kw)) == set(), path
        assert lines(port_lint(torch_src, path=port_path(path), **kw)) \
            == set(), (rule, torch_src)


def _flagged(src, rule, path="fixture.py"):
    return sorted(f.line for f in port_lint(src, path=path)
                  if f.rule == rule)


def test_host_sync_torch_calls():
    """The torch syncs JAX has no twin for: .tolist/.cpu/.numpy, the
    card-wide and Event/Stream synchronize, data-dependent shapes; mask
    indexing only in captured code (a numpy mask on the host is not a
    sync), and nothing in cold code."""
    src = (
        "import torch\n"
        "# captured\n"
        "def f(x, ev):\n"
        "    a = x.tolist()\n"                              # 4
        "    b = x.cpu()\n"                                 # 5
        "    c = x.numpy()\n"                               # 6
        "    torch.cuda.synchronize()\n"                    # 7
        "    ev.synchronize()\n"                            # 8
        "    i = torch.nonzero(x)\n"                        # 9
        "    m = x.masked_select(x > 0)\n"                  # 10
        "    y = x[x > 0]\n"                                # 11
        "    z = x[valid_mask]\n"                           # 12
        "    return int(torch.count_nonzero(x)) + x.shape[0]\n"  # 13
        "# graftlint: hot\n"
        "def per_request(rays, mask):\n"
        "    return rays[mask], rays.cpu()\n"               # 16
        "def cold(x):\n"
        "    return x.cpu(), x.item(), torch.nonzero(x)\n"
        + REG
    )
    assert _flagged(src, "host-sync") == list(range(4, 14)) + [16]


def test_capture_roots():
    """What makes a function captured: a register's callable by name, a
    method, a lambda's callees, a builder's closures, a dict of callables
    handed to a wrapper that registers each, a ``torch.cuda.graph`` body;
    and what does not: the fleet's one-argument ``registry.register``."""
    src = (
        "import torch\n"
        "class Engine:\n"
        "    def _inference(self, bucket):\n"
        "        def route(rays):\n"
        "            return rays.cpu()\n"                   # 5
        "        return route\n"
        "    def warm(self, lane, static):\n"
        "        lane.aot.register('r', self._inference(64), (static,))\n"
        "        self.aot.register('s', self.step, ())\n"
        "        self.aot.register('t', lambda: self._body(1), ())\n"
        "        entries = {'u': lambda: helper(2)}\n"
        "        capture(self, entries)\n"
        "    def step(self):\n"
        "        return self.x.item()\n"                    # 14
        "    def _body(self, k):\n"
        "        print(k)\n"                                # 16
        "def capture(trainer, entries):\n"
        "    for name, fn in entries.items():\n"
        "        trainer.aot.register(name, fn)\n"
        "def helper(k):\n"
        "    return torch.nonzero(k)\n"                     # 21
        "def publish(registry, record):\n"
        "    registry.register(record)\n"
        "    record.cpu()\n"                                # 24: not captured
        "def run(graph, x):\n"
        "    with torch.cuda.graph(graph):\n"
        "        y = x.item()\n"                            # 27
        "    return y, x.item()\n"                          # 28: after it
    )
    assert _flagged(src, "host-sync") == [5, 14, 21, 27]
    assert _flagged(src, "side-effect") == [16]
    ctx = ModuleContext("fixture.py", src)
    captured = {q for q, i in ctx.functions.items() if i.captured}
    assert captured == {"_inference.route", "step", "_body", "helper"}


def test_rng_torch_draws_and_exemptions():
    """Global-generator draws (functions and in-place methods, nn.init
    included) flag in library code and not in tools, the smoke script or
    tests; ``generator=`` draws are clean; a constant re-seed in a loop
    flags everywhere."""
    src = (
        "import torch\n"
        "def init(w, gen, seed):\n"
        "    torch.nn.init.uniform_(w, -1.0, 1.0)\n"        # 3
        "    w.normal_()\n"                                  # 4
        "    idx = torch.randperm(8)\n"                      # 5
        "    torch.manual_seed(seed)\n"
        "    x = torch.rand(3, generator=gen)\n"
        "    w.uniform_(-1.0, 1.0, generator=gen)\n"
        "    for _ in range(3):\n"
        "        gen.manual_seed(123)\n"                     # 10
        "    return x, idx\n"
    )
    lib = "nerf_replication_tpu_torch/models/foo.py"
    assert _flagged(src, "rng", lib) == [3, 4, 5, 10]
    for path in ("nerf_replication_tpu_torch/tools/foo.py", "chip_smoke.py",
                 "tests/test_foo.py"):
        assert _flagged(src, "rng", path) == [10], path


def test_retrace_and_aot_torch_constructions():
    """R2: a registry, a captured graph or a kernel library built in a
    loop; R7: every capture and ``torch.compile`` form in library code,
    none under ``compile/`` or ``tools/``."""
    src = (
        "import torch\n"
        "def bench(fns, kernels):\n"
        "    for fn in fns:\n"
        "        reg = AOTRegistry(device=None)\n"           # 4
        "        lib = kernels.load('fused_mlp')\n"          # 5
        "        with torch.cuda.graph(g):\n"                # 6
        "            fn()\n"
        "        torch.cuda.make_graphed_callables(fn, ())\n"  # 8
        "    return torch.compile(fns[0])\n"                 # 9
    )
    assert _flagged(src, "retrace") == [4, 5, 6, 8]
    lib = "nerf_replication_tpu_torch/serve/foo.py"
    assert _flagged(src, "aot", lib) == [6, 8, 9]
    for path in ("nerf_replication_tpu_torch/compile/registry.py",
                 "nerf_replication_tpu_torch/tools/foo.py"):
        assert _flagged(src, "aot", path) == [], path


HOT_ROOTS = {
    "nerf_replication_tpu_torch/serve/engine.py": (
        "warm_up", "render_request", "render_view"),
    "nerf_replication_tpu_torch/serve/batcher.py": ("_render_batch",),
    "nerf_replication_tpu_torch/train/trainer.py": ("train_epoch",),
}


@pytest.mark.parametrize("path", sorted(HOT_ROOTS))
def test_port_hot_roots_are_marked_and_clean(path):
    """The JAX package's five dispatch-hot roots carry ``# graftlint:
    hot`` in the port too, and R1/R9 leave nothing unsuppressed on their
    paths (the trainer's captured step included)."""
    with open(os.path.join(ROOT, path), encoding="utf-8") as f:
        src = f.read()
    ctx = ModuleContext(path, src, rel_path=path)
    for qual in HOT_ROOTS[path]:
        info = ctx.functions[qual]
        assert info.node.lineno - 1 in ctx.hot_marker_lines, qual
        assert info.hot, qual
    if path.endswith("trainer.py"):
        assert ctx.functions["_step_body"].captured
    found = [f for f in port_lint(src, path=path)
             if f.rule in ("host-sync", "emit-hot")]
    assert found == []
