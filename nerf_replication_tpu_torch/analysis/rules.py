"""graftlint rules R1-R9 for torch code (port of
``nerf_replication_tpu/analysis/rules.py``).

The rule ids are the JAX package's; each torch hazard takes the place of
the JAX one. "Captured" is core.py's word for code that runs while a CUDA
graph is captured (the JAX rules' "traced").

=====================  ==========================================================
rule id                hazard
=====================  ==========================================================
``host-sync``   (R1)   ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``
                       / ``np.asarray`` / ``torch.cuda.synchronize`` /
                       ``Event``/``Stream.synchronize`` / ``float()`` of a
                       torch expression / ``torch.nonzero`` /
                       ``masked_select`` in captured or dispatch-hot code;
                       boolean-mask indexing in captured code
``retrace``     (R2)   ``CUDAGraph()`` / ``torch.cuda.graph(...)`` /
                       ``AOTRegistry(...)`` / a kernel-library ``load`` built
                       inside a loop; a variable-length slice passed to a
                       captured callable (``AOTRegistry.take``)
``donate``      (R3)   a step-shaped callable registered for capture that
                       rebinds its parameters out of place (``p = p - lr *
                       g``, ``.data =``) — two copies in the graph's pool
``rng``         (R4)   ``torch.manual_seed(const)`` / ``.manual_seed(const)``
                       or a draw from the global generator (no
                       ``generator=``) in library code; a generator re-seeded
                       to one constant inside a loop
``side-effect`` (R5)   ``print`` / ``global`` / closure mutation inside a
                       captured body — runs at capture, never on replay
``config-key``  (R6)   ``cfg.*`` accesses that no default/YAML defines, and
                       default keys nothing reads
``aot``         (R7)   library-code ``torch.cuda.graph`` / ``CUDAGraph`` /
                       ``make_graphed_callables`` / ``torch.compile`` outside
                       ``compile/`` — a capture the registry never counts
``swallow``     (R8)   ``except Exception`` / bare ``except`` in library
                       code that neither re-raises nor emits telemetry
``emit-hot``    (R9)   ``Emitter.emit`` / metrics-registry calls inside a
                       captured or dispatch-hot body
=====================  ==========================================================

Where the AST cannot be precise, each rule's ``doc`` says so: a tensor
cannot be told from a numpy array or a Python number, so R1's casts count
only arguments that call ``torch.*`` and its mask indexing only a
comparison or a name holding ``mask``; R2's captured callables are names
assigned from ``*.take(...)`` on a registry in the same module; R3 sees
only a registered callable defined in the same module.
"""

from __future__ import annotations

import ast
import os

from .core import (
    Finding,
    FunctionInfo,
    ModuleContext,
    ProjectContext,
    Rule,
    _attr_chain,
    aot_register_fn,
    is_graph_capture,
    is_library,
    register,
)

_NUMPY_NAMES = {"np", "numpy", "onp"}


def _contains_torch_call(node: ast.expr) -> bool:
    """True when the expression subtree calls into ``torch.*`` — its value
    is a tensor on the device, not a host number."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = _attr_chain(sub.func)
            if chain and chain[0] == "torch":
                return True
    return False


def _walk_scope(fn: ast.AST):
    """Walk ``fn``'s own body without descending into nested function
    scopes (their locals are separate runtime instances)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop(0)
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack[0:0] = list(ast.iter_child_nodes(node))


def _where(info: FunctionInfo) -> str:
    return "captured" if info.captured else "dispatch-hot"


# --------------------------------------------------------------------------
# R1 host-sync
# --------------------------------------------------------------------------

_SYNC_METHODS = {
    "item": "blocks on the device value; keep scalars on the card or "
            "sync once at the logging cadence",
    "tolist": "copies the tensor to the host and waits for it",
    "cpu": "a device-to-host copy that waits for the stream",
    "numpy": "needs a host tensor: a device-to-host copy and a wait",
}
_DATA_DEPENDENT = ("nonzero", "masked_select", "argwhere")


@register
class HostSyncRule(Rule):
    rule_id = "host-sync"
    doc = (
        "host synchronization on a captured or dispatch-hot path: "
        ".item(), .tolist(), .cpu(), .numpy(), np.asarray(), "
        "torch.cuda.synchronize(), Event/Stream.synchronize(), "
        "float()/int()/bool() of a torch.* expression, torch.nonzero / "
        "masked_select (data-dependent shapes); boolean-mask indexing "
        "(a comparison or a name holding 'mask' as the index) in captured "
        "code only — the AST cannot tell a numpy mask on the host from a "
        "tensor one"
    )

    def check(self, module: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        for info in module.scopes():
            if not (info.captured or info.hot):
                continue
            for node in _walk_scope(info.node):
                f = None
                if isinstance(node, ast.Call):
                    f = self._classify(node)
                elif isinstance(node, ast.Subscript) and info.captured:
                    f = self._mask_index(node)
                if f is None:
                    continue
                call_desc, hint = f
                finding = module.finding(
                    self.rule_id,
                    node,
                    f"{call_desc} inside {_where(info)} `{info.qualname}` "
                    f"— {hint}",
                )
                if finding:
                    findings.append(finding)
        return findings

    def _classify(self, node: ast.Call):
        func = node.func
        chain = _attr_chain(func)
        # np.asarray / np.array / np.copy of a tensor: a device pull
        if chain[:1] and chain[0] in _NUMPY_NAMES and chain[-1] in (
            "asarray", "array", "copy"
        ):
            return (
                f"`{'.'.join(chain)}(...)`",
                "pulls the buffer to host; hoist off the hot path, or mark "
                "intentional with `# graftlint: ok(host-sync: why)`",
            )
        if chain[-2:] == ["cuda", "synchronize"]:
            return (
                "`torch.cuda.synchronize()`",
                "waits for every stream of the card; sync once at the "
                "logging cadence or mark intentional",
            )
        if isinstance(func, ast.Attribute):
            if func.attr == "synchronize" and not node.args:
                return (
                    f"`{'.'.join(chain) or '<expr>.synchronize'}()`",
                    "an Event/Stream wait on the host; keep the order on "
                    "the card (wait_stream / wait_event) or mark "
                    "intentional",
                )
            if func.attr in _SYNC_METHODS and not node.args:
                return f"`.{func.attr}()`", _SYNC_METHODS[func.attr]
            if func.attr in _DATA_DEPENDENT:
                return (
                    f"`{'.'.join(chain) or '<expr>.' + func.attr}(...)`",
                    "a data-dependent shape: the host waits for the count; "
                    "keep a fixed shape (a mask multiply, a padded "
                    "compaction)",
                )
        # float()/int()/bool() of a torch.* value: a device read
        if isinstance(func, ast.Name) and func.id in ("float", "int", "bool"):
            if node.args and _contains_torch_call(node.args[0]):
                return (
                    f"`{func.id}(...)` on a torch computation",
                    "reads the tensor on the host (a sync; under capture an "
                    "error); keep it a tensor or hoist to the host side",
                )
        return None

    def _mask_index(self, node: ast.Subscript):
        idx = node.slice
        masky = isinstance(idx, ast.Compare) or (
            isinstance(idx, ast.Name) and "mask" in idx.id.lower())
        if not masky:
            return None
        return (
            "boolean-mask indexing",
            "a data-dependent shape: the host waits for the count (a "
            "capture fails); multiply by the mask or use torch.where",
        )


# --------------------------------------------------------------------------
# R2 retrace
# --------------------------------------------------------------------------


def _capture_construction(node: ast.AST) -> str | None:
    """What a node builds when it is a capture or a kernel library."""
    if not isinstance(node, ast.Call):
        return None
    chain = _attr_chain(node.func)
    if is_graph_capture(node):
        return "torch.cuda.graph(...)"
    if chain[-1:] == ["CUDAGraph"]:
        return "torch.cuda.CUDAGraph()"
    if chain[-1:] == ["AOTRegistry"]:
        return "AOTRegistry(...)"
    if chain[-1:] == ["make_graphed_callables"]:
        return "make_graphed_callables(...)"
    if chain[-2:] == ["kernels", "load"]:
        return "kernels.load(...)"
    return None


def _is_take(node: ast.AST) -> bool:
    """``<registry>.take(name)``: a captured callable."""
    if not isinstance(node, ast.Call):
        return False
    chain = _attr_chain(node.func)
    return len(chain) >= 2 and chain[-1] == "take" and any(
        "aot" in s.lower() or "registry" in s.lower() for s in chain[:-1])


@register
class RetraceRule(Rule):
    rule_id = "retrace"
    doc = (
        "recapture hazards: CUDAGraph() / torch.cuda.graph(...) / "
        "AOTRegistry(...) / a kernel-library load built inside a loop; a "
        "variable-length slice passed to a captured callable (a name "
        "assigned from <registry>.take(...) in the same module) without "
        "bucket padding"
    )

    def check(self, module: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        findings += self._built_in_loop(module)
        findings += self._varying_shapes(module)
        return findings

    def _built_in_loop(self, module: ModuleContext) -> list[Finding]:
        out: list[Finding] = []
        for top in ast.walk(module.tree):
            if not isinstance(top, (ast.For, ast.While)):
                continue
            for node in ast.walk(top):
                if node is top:
                    continue
                what = _capture_construction(node)
                if what is None:
                    continue
                f = module.finding(
                    self.rule_id,
                    node,
                    f"{what} constructed inside a loop — every iteration "
                    "captures (or loads) afresh, in a new pool; hoist it "
                    "out of the loop or cache it keyed on its static "
                    "config (compile/registry.py)",
                )
                if f:
                    out.append(f)
        return out

    def _captured_callables(self, module: ModuleContext) -> set[str]:
        names: set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and _is_take(node.value):
                for t in node.targets:
                    chain = _attr_chain(t)
                    if chain:
                        names.add(chain[-1])
        return names

    def _varying_shapes(self, module: ModuleContext) -> list[Finding]:
        out: list[Finding] = []
        captured = self._captured_callables(module)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            name = chain[-1] if chain else None
            if name not in captured:
                continue
            for arg in node.args:
                if not self._varying_slice(arg):
                    continue
                f = module.finding(
                    self.rule_id,
                    arg,
                    f"a variable-length slice flows into captured callable "
                    f"`{name}` — a graph replays one shape; pad into a "
                    "fixed bucket (cf. serve/engine.py buckets) and slice "
                    "the outputs instead",
                )
                if f:
                    out.append(f)
        return out

    @staticmethod
    def _varying_slice(arg: ast.expr) -> bool:
        if isinstance(arg, ast.Subscript) and isinstance(arg.slice, ast.Slice):
            s = arg.slice
            return any(b is not None and not isinstance(b, ast.Constant)
                       for b in (s.lower, s.upper))
        return False


# --------------------------------------------------------------------------
# R3 donate
# --------------------------------------------------------------------------

_STATE_PARAM_NAMES = {"state", "train_state", "opt_state", "params",
                      "parameters"}


def _positional(fn: ast.AST) -> list[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return []
    return [a.arg for a in list(args.posonlyargs) + list(args.args)]


def _is_step_shaped(fn: ast.AST) -> bool:
    pos = _positional(fn)
    first = pos[0] if pos else ""
    if first in ("self", "cls") and len(pos) > 1:
        first = pos[1]
    if first in _STATE_PARAM_NAMES:
        return True
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain[-1:] == ["backward"] or chain[-2:] == ["autograd", "grad"]:
                return True
            if (len(chain) >= 2 and chain[-1] == "step"
                    and "opt" in chain[-2].lower()):
                return True
    return False


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _out_of_place_rebind(fn: ast.AST) -> ast.AST | None:
    """The first statement of ``fn`` that rebinds a parameter out of
    place: ``x.data = ...``, or ``p = <expr of p>`` / ``(p := <expr of
    p>)`` where ``p`` is a parameter or a loop variable."""
    bound = set(_positional(fn))
    args = getattr(fn, "args", None)
    if args is not None:
        bound |= {a.arg for a in args.kwonlyargs}
    for node in ast.walk(fn):
        if isinstance(node, ast.For):
            bound |= _names_in(node.target)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.NamedExpr):
            targets, value = [node.target], node.value
        else:
            continue
        if isinstance(value, (ast.Name, ast.Attribute, ast.Constant)):
            continue  # an alias or a plain value, not arithmetic
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr == "data":
                return node
            if (isinstance(t, ast.Name) and t.id in bound
                    and t.id in _names_in(value)):
                return node
            chain = _attr_chain(t)
            if (len(chain) >= 2 and chain[0] in bound and any(
                    _attr_chain(v) == chain for v in ast.walk(value))):
                return node
    return None


@register
class DonateRule(Rule):
    rule_id = "donate"
    doc = (
        "a step-shaped callable registered for capture "
        "(AOTRegistry.register) that rebinds its parameters or optimizer "
        "state out of place (p = p - lr * g, .data =): the graph's pool "
        "holds both copies; only callables defined in the same module "
        "(a name, a method, a lambda) are resolved"
    )

    def check(self, module: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        local_defs = {
            info.name: info.node for info in module.functions.values()
        }
        for node in ast.walk(module.tree):
            fn = aot_register_fn(node)
            if fn is None:
                continue
            target = None
            if isinstance(fn, ast.Lambda):
                target = fn
            elif isinstance(fn, ast.Name):
                target = local_defs.get(fn.id)
            elif isinstance(fn, ast.Attribute):
                target = local_defs.get(fn.attr)
            if target is None or not _is_step_shaped(target):
                continue
            bad = _out_of_place_rebind(target)
            if bad is None:
                continue
            f = module.finding(
                self.rule_id, node,
                "step-shaped callable registered for capture rebinds its "
                f"parameters out of place (line {bad.lineno}) — the graph's "
                "pool keeps the old and the new state, doubling parameter "
                "+ optimizer memory; update in place (.copy_, .add_, "
                "optimizer.step(); cf. train/trainer.py)",
            )
            if f:
                findings.append(f)
        return findings


# --------------------------------------------------------------------------
# R4 rng
# --------------------------------------------------------------------------

_GLOBAL_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                 "randint_like", "randperm", "normal", "bernoulli",
                 "multinomial", "poisson"}
_INPLACE_DRAWS = {"normal_", "uniform_", "random_", "bernoulli_",
                  "exponential_", "cauchy_", "log_normal_", "geometric_"}


def _const_seed(node: ast.Call) -> bool:
    """``*.manual_seed(<constant>)`` (torch's or a Generator's)."""
    chain = _attr_chain(node.func)
    is_seed = (chain[-1:] in (["manual_seed"], ["manual_seed_all"])) or (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in ("manual_seed", "manual_seed_all"))
    return is_seed and bool(node.args) and isinstance(node.args[0],
                                                     ast.Constant)


def _global_draw(node: ast.Call) -> str | None:
    """The call's name when it draws from torch's global generator."""
    if any(kw.arg == "generator" for kw in node.keywords):
        return None
    chain = _attr_chain(node.func)
    if len(chain) == 2 and chain[0] == "torch" and chain[1] in _GLOBAL_DRAWS:
        return ".".join(chain)
    if isinstance(node.func, ast.Attribute) and node.func.attr in \
            _INPLACE_DRAWS:
        return ".".join(chain) if chain else f".{node.func.attr}"
    return None


@register
class RngRule(Rule):
    rule_id = "rng"
    doc = (
        "RNG hygiene: torch.manual_seed(const) / <gen>.manual_seed(const) "
        "or a draw from the global generator (torch.rand*/randn*/randint/"
        "randperm/normal, normal_/uniform_ without generator=) in library "
        "code; a generator re-seeded to one constant inside a loop"
    )

    # tools, the smoke script and tests pin seeds for reproducibility on
    # purpose; the hardcoded-seed and global-draw checks cover the rest
    HARDCODED_EXEMPT_PREFIXES = ("nerf_replication_tpu_torch/tools",
                                 "chip_smoke.py", "tests")

    def check(self, module: ModuleContext) -> list[Finding]:
        looped: set[int] = set()
        findings = self._loop_reseed(module, looped)
        if not self._exempt(module):
            findings += self._hardcoded(module, looped)
        return findings

    def _exempt(self, module: ModuleContext) -> bool:
        rel = module.rel_path.replace(os.sep, "/")
        return any(
            rel.startswith(p + "/") or rel == p
            for p in self.HARDCODED_EXEMPT_PREFIXES
        )

    def _hardcoded(self, module: ModuleContext,
                   looped: set[int]) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call) or id(node) in looped:
                continue  # a re-seed in a loop has its own finding
            chain = _attr_chain(node.func)
            msg = None
            if _const_seed(node):
                what = ".".join(chain) if chain else "<expr>.manual_seed"
                msg = (
                    f"hardcoded `{what}({node.args[0].value!r})` in library "
                    "code — callers can never vary the stream; thread the "
                    "config seed (cfg.seed) through instead"
                )
            elif (draw := _global_draw(node)) is not None:
                msg = (
                    f"`{draw}(...)` draws from torch's global generator in "
                    "library code — its stream depends on every other "
                    "draw in the process (and a captured graph must "
                    "register the generator); pass generator= seeded from "
                    "cfg.seed"
                )
            if msg is None:
                continue
            f = module.finding(self.rule_id, node, msg)
            if f:
                out.append(f)
        return out

    def _loop_reseed(self, module: ModuleContext,
                     looped: set[int]) -> list[Finding]:
        out: list[Finding] = []
        for top in ast.walk(module.tree):
            if not isinstance(top, (ast.For, ast.While)):
                continue
            for node in ast.walk(top):
                if not (isinstance(node, ast.Call) and _const_seed(node)):
                    continue
                looped.add(id(node))
                f = module.finding(
                    self.rule_id, node,
                    "generator re-seeded to one constant inside a loop — "
                    "every iteration draws identical randomness; seed from "
                    "(seed, step) or seed once outside the loop",
                )
                if f:
                    out.append(f)
        return out


# --------------------------------------------------------------------------
# R5 side-effect
# --------------------------------------------------------------------------

_MUTATORS = {"append", "extend", "insert", "add", "update", "setdefault"}


@register
class SideEffectRule(Rule):
    rule_id = "side-effect"
    doc = (
        "side effects in captured bodies: print, global mutation, "
        "appending to closed-over containers — they run once while the "
        "graph is captured and never on a replay"
    )

    def check(self, module: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        for info in module.scopes():
            if not info.captured:
                continue
            locals_ = info.local_names
            for node in _walk_scope(info.node):
                msg = None
                if isinstance(node, ast.Global):
                    msg = (
                        "`global` inside a captured body — the mutation "
                        "happens once at capture, not per replay"
                    )
                elif isinstance(node, ast.Call):
                    chain = _attr_chain(node.func)
                    if chain == ["print"]:
                        msg = (
                            "`print` inside a captured body runs at capture "
                            "time only, never on a replay; print outside "
                            "the captured function"
                        )
                    elif (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr in _MUTATORS
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id not in locals_
                    ):
                        msg = (
                            f"`{node.func.value.id}.{node.func.attr}(...)` "
                            "mutates a closed-over container from a "
                            "captured body — it fires once at capture and "
                            "never on a replay"
                        )
                if msg is None:
                    continue
                f = module.finding(self.rule_id, node, msg)
                if f:
                    findings.append(f)
        return findings


# --------------------------------------------------------------------------
# R6 config-key
# --------------------------------------------------------------------------

# containers whose sub-keys are task-plugin/YAML-defined, not template
# defaults — unknown keys under them are expected
_DYNAMIC_CONTAINERS = {
    "task_arg", "sampler_meta", "train_dataset", "test_dataset", "network",
}

# dict/ConfigNode methods that terminate a key chain
_NODE_METHODS = {
    "items", "keys", "values", "merge", "merge_from_list", "merge_from_file",
    "freeze", "defrost", "clone", "dump", "to_dict", "is_frozen",
    "setdefault", "pop", "update", "copy", "popitem", "clear",
}

_CONFIG_DIR = "nerf_replication_tpu_torch/config/"


def _dict_literal_paths(node: ast.expr, prefix: tuple[str, ...]):
    """Key paths of a (possibly nested / ConfigNode-wrapped) dict literal."""
    if isinstance(node, ast.Call) and node.args:
        chain = _attr_chain(node.func)
        if chain and chain[-1] == "ConfigNode":
            node = node.args[0]
    if not isinstance(node, ast.Dict):
        return
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            path = prefix + (k.value,)
            yield path, k.lineno
            yield from _dict_literal_paths(v, path)


def collect_config_keys(
    repo_root: str, with_defaults: bool = False
):
    """Known config key-paths: template defaults (the port's
    config/config.py ``cfg.<k> = ...`` assignments, nested dict literals
    included) plus every YAML under configs/. ``with_defaults`` also
    returns the default-template leaf paths with their definition lines
    (for the dead-key check)."""
    known: set[tuple[str, ...]] = set()
    default_leaves: dict[tuple[str, ...], int] = {}

    cfg_py = os.path.join(repo_root, _CONFIG_DIR, "config.py")
    if os.path.exists(cfg_py):
        with open(cfg_py, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=cfg_py)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            chain = _attr_chain(t)
            if len(chain) >= 2 and chain[0] == "cfg":
                path = tuple(chain[1:])
                known.add(path)
                nested = list(_dict_literal_paths(node.value, path))
                for sub, line in nested:
                    known.add(sub)
                if nested:
                    # leaves = nested paths with no deeper nested path
                    for sub, line in nested:
                        if not any(
                            other[: len(sub)] == sub and other != sub
                            for other, _ in nested
                        ):
                            default_leaves[sub] = line
                else:
                    default_leaves[path] = node.lineno

    def _yaml_paths(data, prefix=()):
        if isinstance(data, dict):
            for k, v in data.items():
                if isinstance(k, str):
                    yield prefix + (k,)
                    yield from _yaml_paths(v, prefix + (k,))

    configs_dir = os.path.join(repo_root, "configs")
    if os.path.isdir(configs_dir):
        try:
            import yaml
        except ImportError:  # pragma: no cover - yaml ships with the repo
            yaml = None
        if yaml is not None:
            for root, _dirs, files in os.walk(configs_dir):
                for f in sorted(files):
                    if not f.endswith((".yaml", ".yml")):
                        continue
                    try:
                        with open(os.path.join(root, f), encoding="utf-8") as fh:
                            data = yaml.safe_load(fh) or {}
                    except Exception:
                        continue
                    known.update(_yaml_paths(data))

    if with_defaults:
        return known, default_leaves
    return known


def _cfg_access_path(node: ast.expr) -> tuple[str, ...] | None:
    """Resolve ``cfg.a.b`` / ``self.cfg.get("a").b`` ... into a key path
    rooted at the config; None when not a cfg access."""
    parts: list[str] = []
    cur = node
    while True:
        if isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        elif (
            isinstance(cur, ast.Call)
            and isinstance(cur.func, ast.Attribute)
            and cur.func.attr == "get"
            and cur.args
            and isinstance(cur.args[0], ast.Constant)
            and isinstance(cur.args[0].value, str)
        ):
            parts.append(cur.args[0].value)
            cur = cur.func.value
        else:
            break
    if isinstance(cur, ast.Name) and cur.id == "cfg":
        pass
    elif (
        isinstance(cur, ast.Attribute)
        and cur.attr == "cfg"
        and isinstance(cur.value, ast.Name)
        and cur.value.id == "self"
    ):
        pass
    else:
        return None
    path = tuple(parts[::-1])
    # truncate at the first dict/node method ("cfg.train.items" -> train)
    for i, seg in enumerate(path):
        if seg in _NODE_METHODS or seg == "get":
            return path[:i]
    return path


@register
class ConfigKeyRule(Rule):
    rule_id = "config-key"
    doc = (
        "cfg.* accesses that neither the config template nor any YAML "
        "defines (typos, silently-dead .get defaults), and template "
        "default keys nothing in the repo reads"
    )
    project_wide = True

    def check_project(self, project: ProjectContext) -> list[Finding]:
        if project.config_keys is None:
            return []
        known = project.config_keys
        top_level = {p[0] for p in known}
        findings: list[Finding] = []
        accessed: set[tuple[str, ...]] = set()

        for module in project.modules:
            if module.skip_file:
                continue
            rel = module.rel_path.replace(os.sep, "/")
            # the template/merge machinery reads keys too (parse_cfg
            # consumes exp_name_tag/save_tag) — its accesses count as
            # usage, but unknown-key findings there would be circular
            flag_unknown = not rel.startswith(_CONFIG_DIR)
            for scope_node, scope_name in self._scopes(module):
                accesses = []
                for node in _walk_scope(scope_node):
                    if isinstance(node, (ast.Attribute, ast.Call)):
                        # an assignment TARGET (cfg.x = ...) defines, it
                        # doesn't read — else default_cfg's own template
                        # assignments would mark every key as used
                        if isinstance(node, ast.Attribute) and isinstance(
                            node.ctx, (ast.Store, ast.Del)
                        ):
                            continue
                        path = _cfg_access_path(node)
                        if path:
                            accesses.append((path, node))
                if not accesses:
                    continue
                # a scope's `cfg` is the ROOT config only if it touches at
                # least one known top-level key — encoder/task sub-configs
                # are also conventionally named `cfg`
                is_root = any(p[0] in top_level for p, _ in accesses if p)
                # keep only the outermost access per location (cfg.a.b also
                # matches cfg.a; the longest path at a line wins)
                best: dict[tuple[int, int], tuple[tuple[str, ...], ast.AST]] = {}
                for path, node in accesses:
                    loc = (node.lineno, node.col_offset)
                    cur = None
                    for (l, c), (p, n) in list(best.items()):
                        if l == node.lineno and abs(c - node.col_offset) <= 1:
                            cur = (l, c)
                    if cur is not None:
                        if len(path) > len(best[cur][0]):
                            best[cur] = (path, node)
                    else:
                        best[loc] = (path, node)
                for path, node in best.values():
                    if not path:
                        continue
                    for i in range(1, len(path) + 1):
                        accessed.add(path[:i])
                    if not is_root or not flag_unknown:
                        continue
                    unknown = self._first_unknown(path, known)
                    if unknown is None:
                        continue
                    f = module.finding(
                        self.rule_id,
                        node,
                        f"config key `{'.'.join(path)}` is not defined by "
                        "the template defaults (config/config.py) or any "
                        "YAML under configs/ — a typo reads the .get "
                        "fallback forever; add the key to default_cfg or "
                        "fix the access",
                    )
                    if f:
                        findings.append(f)

        findings += self._dead_keys(project, accessed)
        return findings

    def _scopes(self, module: ModuleContext):
        yield module.tree, "<module>"
        for info in module.functions.values():
            yield info.node, info.qualname

    def _first_unknown(
        self, path: tuple[str, ...], known: set[tuple[str, ...]]
    ) -> int | None:
        for i in range(1, len(path) + 1):
            prefix = path[:i]
            if prefix in known:
                continue
            # anything under a dynamic container is plugin-defined
            if any(seg in _DYNAMIC_CONTAINERS for seg in prefix[:i]):
                return None
            return i
        return None

    def _dead_keys(
        self, project: ProjectContext, accessed: set[tuple[str, ...]]
    ) -> list[Finding]:
        if not project.is_full_scan or project.repo_root is None:
            return []
        _, default_leaves = collect_config_keys(
            project.repo_root, with_defaults=True
        )
        cfg_module = next(
            (
                m for m in project.modules
                if m.rel_path.replace(os.sep, "/").endswith(
                    _CONFIG_DIR + "config.py"
                )
            ),
            None,
        )
        if cfg_module is None:
            return []
        out: list[Finding] = []
        for path, line in sorted(default_leaves.items()):
            if any(seg in _DYNAMIC_CONTAINERS for seg in path):
                continue
            if any(path[:i] in accessed for i in range(1, len(path) + 1)):
                continue
            if cfg_module.is_suppressed(self.rule_id, line):
                continue
            out.append(
                Finding(
                    rule=self.rule_id,
                    path=cfg_module.rel_path,
                    line=line,
                    col=0,
                    message=(
                        f"default config key `{'.'.join(path)}` is never "
                        "read anywhere in the scanned tree — dead weight "
                        "or a key the reader spells differently; delete "
                        "it or mark `# graftlint: ok(config-key: why)`"
                    ),
                    snippet=cfg_module.snippet(line),
                )
            )
        return out


# --------------------------------------------------------------------------
# R7 aot
# --------------------------------------------------------------------------


@register
class AotRule(Rule):
    rule_id = "aot"
    doc = (
        "library-code torch.cuda.graph / CUDAGraph / "
        "make_graphed_callables / torch.compile outside compile/: a capture "
        "or compile that the registry (compile/registry.py) never warms "
        "up and total_compiles never counts"
    )

    # tools, tests and chip_smoke.py are one-shot processes; the registry
    # itself captures
    EXEMPT_PREFIXES = (
        "nerf_replication_tpu_torch/compile/",
        "nerf_replication_tpu_torch/analysis/",
    )

    _MSG = (
        "{what} in library code outside the AOT registry — the capture "
        "happens inline at dispatch time and total_compiles never counts "
        "it; hand the callable to AOTRegistry.register "
        "(compile/registry.py) so it is captured during warm-up, or mark "
        "intentional with `# graftlint: ok(aot: why)`"
    )

    def check(self, module: ModuleContext) -> list[Finding]:
        rel = module.rel_path.replace(os.sep, "/")
        if not is_library(rel):
            return []
        if any(rel.startswith(p) for p in self.EXEMPT_PREFIXES):
            return []
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            sites = []
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sites = [d for d in node.decorator_list
                         if _attr_chain(d) == ["torch", "compile"]]
            elif isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if (is_graph_capture(node)
                        or chain[-1:] in (["CUDAGraph"],
                                          ["make_graphed_callables"])
                        or chain == ["torch", "compile"]):
                    sites = [node]
            for site in sites:
                what = ".".join(_attr_chain(
                    site.func if isinstance(site, ast.Call) else site))
                f = module.finding(self.rule_id, site,
                                   self._MSG.format(what=f"`{what}`"))
                if f:
                    findings.append(f)
        return findings


# ---------------------------------------------------------------------------
# R8: swallowed exceptions
# ---------------------------------------------------------------------------

#: call names (terminal segment of the callee chain) that count as "the
#: failure left a trace" — telemetry rows, log lines, or collected errors.
_SWALLOW_SIGNALS = frozenset(
    {
        "emit",
        "warn",
        "warning",
        "warnings",
        "log",
        "print",
        "report",
        "record",
        "error",
        "exception",
        "debug",
        "info",
        "fail",
        "fault_point",
    }
)


@register
class SwallowRule(Rule):
    """R8: broad except handlers in library code must re-raise or emit.

    A ``try``/``except Exception`` (or bare ``except``) whose handler body
    neither contains a ``raise`` nor calls anything that records the failure
    (``report``/``emit``/``warn``/``log``/...) makes the error vanish: no
    telemetry row, no log line, no propagation.

    Narrow handlers (``except OSError``, ``except (KeyError, ValueError)``)
    are out of scope — catching a specific exception is a statement of
    intent; catching *everything* silently is not.
    """

    rule_id = "swallow"
    doc = (
        "broad `except Exception`/bare `except` in library code that "
        "neither re-raises nor emits telemetry — the failure vanishes; "
        "re-raise, call resil.report()/emitter.emit(), or suppress with "
        "a reason"
    )

    #: the lint engine itself parses/walks arbitrary source and recovers
    #: from malformed modules by design; its handlers are not failure sinks.
    EXEMPT_PREFIXES = ("nerf_replication_tpu_torch/analysis/",)

    _BROAD = ("Exception", "BaseException")

    def check(self, module: ModuleContext) -> list[Finding]:
        rel = module.rel_path.replace(os.sep, "/")
        if not is_library(rel):
            return []
        if any(rel.startswith(p) for p in self.EXEMPT_PREFIXES):
            return []
        findings: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if not self._is_broad(handler):
                    continue
                if self._leaves_trace(handler):
                    continue
                f = module.finding(
                    self.rule_id,
                    handler,
                    "broad except swallows the failure: handler neither "
                    "re-raises nor emits telemetry/logging — add "
                    "resil.report(...)/raise, narrow the exception type, "
                    "or suppress with `# graftlint: ok(swallow: reason)`",
                )
                if f is not None:
                    findings.append(f)
        return findings

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        if handler.type is None:  # bare `except:`
            return True
        types = (
            handler.type.elts
            if isinstance(handler.type, ast.Tuple)
            else [handler.type]
        )
        for t in types:
            chain = _attr_chain(t)
            if chain and chain[-1] in self._BROAD:
                return True
        return False

    def _leaves_trace(self, handler: ast.ExceptHandler) -> bool:
        for sub in ast.walk(handler):
            if isinstance(sub, ast.Raise):
                return True
            if isinstance(sub, ast.Call):
                chain = _attr_chain(sub.func)
                if chain and chain[-1] in _SWALLOW_SIGNALS:
                    return True
        return False


# --------------------------------------------------------------------------
# R9 emit-hot
# --------------------------------------------------------------------------


@register
class EmitHotRule(Rule):
    """R9: telemetry/metrics writes inside captured or dispatch-hot bodies.

    Inside a **captured** body an ``emit``/metrics call runs once, while the
    graph is captured, and never on a replay — the telemetry it appears to
    produce is a lie. Inside a **dispatch-hot** body (``# graftlint: hot``)
    the call is real but rides the latency-critical path on every
    dispatch; the sanctioned shapes are batch-cadence records and
    post-sync completion rows, which suppress with a reason.

    Matched receivers: ``get_emitter().emit`` / ``<...>emitter.emit``
    (obs/emit.py) and ``get_metrics().counter|gauge|observe`` /
    ``metrics.*`` / ``mx.*`` (obs/metrics.py). Span context managers are
    deliberately NOT flagged — obs/trace.py is the sanctioned hot-path
    instrument and its disabled cost is one null contextmanager.
    """

    rule_id = "emit-hot"
    doc = (
        "Emitter.emit / metrics-registry call inside a captured or "
        "dispatch-hot body — captured: runs once at capture, never on a "
        "replay; hot: telemetry rides the latency-critical path on every "
        "dispatch; move to batch cadence / post-sync or suppress with "
        "a reason"
    )

    _METRIC_METHODS = ("counter", "gauge", "observe")
    _METRIC_RECEIVERS = ("metrics", "mx", "registry")

    def check(self, module: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        for info in module.scopes():
            if not (info.captured or info.hot):
                continue
            for node in _walk_scope(info.node):
                if not isinstance(node, ast.Call):
                    continue
                desc = self._classify(node)
                if desc is None:
                    continue
                f = module.finding(
                    self.rule_id,
                    node,
                    f"`{desc}` inside {_where(info)} `{info.qualname}` — "
                    + ("telemetry in a captured body runs once at capture, "
                       "never on a replay"
                       if info.captured else
                       "telemetry on the dispatch-hot path; keep it at "
                       "batch cadence / post-sync, or suppress with a "
                       "reason"),
                )
                if f is not None:
                    findings.append(f)
        return findings

    def _classify(self, node: ast.Call) -> str | None:
        func = node.func
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        recv = func.value
        # get_emitter().emit(...) / get_metrics().observe(...): the chain
        # helper bottoms out at a Call, so match the inner call directly
        if isinstance(recv, ast.Call):
            inner = _attr_chain(recv.func)
            base = inner[-1] if inner else ""
            if attr == "emit" and base == "get_emitter":
                return "get_emitter().emit"
            if attr in self._METRIC_METHODS and base == "get_metrics":
                return f"get_metrics().{attr}"
            return None
        chain = _attr_chain(recv)
        if not chain:
            return None
        last = chain[-1]
        if attr == "emit" and last.endswith("emitter"):
            return ".".join(chain + [attr])
        if attr in self._METRIC_METHODS and (
            last in self._METRIC_RECEIVERS or last.endswith("metrics")
        ):
            return ".".join(chain + [attr])
        return None
