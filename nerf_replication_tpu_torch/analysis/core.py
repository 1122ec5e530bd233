"""graftlint engine core: findings, suppressions, module context, registry
(port of ``nerf_replication_tpu/analysis/core.py``).

The engine imports neither torch nor JAX (pure stdlib ``ast`` +
``tokenize``), so the gate runs on any host, the card's included. Rules
are visitor-style checkers registered in :data:`RULES`; each receives a
:class:`ModuleContext` (one parsed file plus its hot-path / capture
analysis) or, for project-wide rules, the whole :class:`ProjectContext`.

Two kinds of "hotness" drive the torch-specific rules (README, "graftlint
for the port"):

* **captured** — code that runs while a CUDA graph is captured, and never
  again on a replay: functions handed as the callable to
  ``AOTRegistry.register(name, fn, ...)`` (``compile/registry.py``; a
  builder call there, ``self._inference(...)``, makes the closures it
  defines captured; a lambda there makes what it calls captured), the
  body of ``with torch.cuda.graph(...)``, plus everything reachable from
  those through the intra-module call graph. A host sync here fails the
  capture; a Python side effect runs once at capture and never on replay.
  The fleet's ``registry.register(record)`` (one argument, no callable) is
  not a capture.
* **dispatch-hot** — host code on a per-step/per-request path, marked
  ``# graftlint: hot`` on (or above) its ``def`` line, plus everything it
  calls. A device read here stalls the host's queue of launches.

What the AST cannot see: a callable reaches a register through names in
the same module only (a local assignment, a dict of callables, a wrapper
that registers each of its parameter's items, such as
``train/trainer.py::capture_steps``), and the call graph is intra-module,
so a captured step's callees in other modules are not captured for the
rules.

Suppressions are inline comments::

    x = out.cpu()  # graftlint: ok(host-sync: the reply leaves the card)
    # graftlint: ok(rng)          <- on its own line: applies to the NEXT line
    # graftlint: skip-file        <- first 10 lines: skips the whole file

``ok()`` with no rule list suppresses every rule on that line.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

# rule id -> one-line description (registry filled by rules.py import)
RULES: dict[str, "Rule"] = {}

# R1..R13 short names used in findings, suppressions, and the baseline
RULE_IDS = (
    "host-sync",           # R1
    "retrace",             # R2
    "donate",              # R3
    "rng",                 # R4
    "side-effect",         # R5
    "config-key",          # R6
    "aot",                 # R7
    "swallow",             # R8
    "emit-hot",            # R9
    "lock-order",          # R10
    "unguarded-shared",    # R11
    "blocking-under-lock", # R12
    "thread-hygiene",      # R13
)

# the interprocedural concurrency pass (R10-R13, concurrency.py)
CONCURRENCY_RULE_IDS = RULE_IDS[9:]

# the port's library code; its tools/ (like chip_smoke.py and the tests,
# outside the package) are one-shot processes
LIB_PREFIX = "nerf_replication_tpu_torch/"
TOOLS_PREFIX = LIB_PREFIX + "tools/"

_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*ok(?:\(([^)]*)\))?")
_HOT_RE = re.compile(r"#\s*graftlint:\s*hot\b")
_SKIP_FILE_RE = re.compile(r"#\s*graftlint:\s*skip-file\b")


@dataclass(frozen=True)
class Finding:
    """One lint finding. ``snippet`` (the stripped source line) rather than
    the line number is the stable part of its identity — see baseline.py."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


class Rule:
    """A registered checker. Subclasses set ``rule_id``/``doc`` and
    implement ``check`` (per-module) or ``check_project`` (whole scan)."""

    rule_id: str = ""
    doc: str = ""
    project_wide = False

    def check(self, module: "ModuleContext") -> list[Finding]:
        return []

    def check_project(self, project: "ProjectContext") -> list[Finding]:
        return []


def register(rule_cls: type[Rule]) -> type[Rule]:
    RULES[rule_cls.rule_id] = rule_cls()
    return rule_cls


def is_library(rel_path: str) -> bool:
    """Port package code that is not a one-shot tool."""
    rel = rel_path.replace(os.sep, "/")
    return rel.startswith(LIB_PREFIX) and not rel.startswith(TOOLS_PREFIX)


# --------------------------------------------------------------------------
# per-module analysis
# --------------------------------------------------------------------------


@dataclass
class FunctionInfo:
    node: ast.AST  # FunctionDef | AsyncFunctionDef | With (a capture body)
    qualname: str
    name: str
    cls: str | None  # enclosing class name, for self.method resolution
    captured: bool = False  # runs while a CUDA graph is captured
    hot: bool = False  # host-side per-step/per-request path
    calls: set[str] = field(default_factory=set)  # callee names (bare / Cls.m)
    local_names: set[str] = field(default_factory=set)


def _attr_chain(node: ast.AST) -> list[str]:
    """``torch.cuda.graph`` -> ["torch", "cuda", "graph"]; [] when not a
    pure chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def is_graph_capture(node: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (the capture context manager)."""
    return isinstance(node, ast.Call) and _attr_chain(node.func)[-2:] == [
        "cuda", "graph"]


def aot_register_fn(node: ast.AST) -> ast.expr | None:
    """The callable of an ``AOTRegistry.register(name, fn, ...)`` call: a
    ``register`` on a receiver whose chain names an ``aot`` or
    ``registry``, with the callable as its second argument (or ``fn=``).
    The fleet's ``registry.register(record)`` has one argument: None."""
    if not isinstance(node, ast.Call):
        return None
    chain = _attr_chain(node.func)
    if len(chain) < 2 or chain[-1] != "register":
        return None
    if not any("aot" in seg.lower() or "registry" in seg.lower()
               for seg in chain[:-1]):
        return None
    if len(node.args) >= 2:
        return node.args[1]
    return next((kw.value for kw in node.keywords if kw.arg == "fn"), None)


def _bound_values(scope: ast.AST, name: str) -> list[ast.expr]:
    """What ``scope`` assigns to ``name``: ``name = v``, ``name[k] = v``,
    and each value of a dict literal so assigned."""
    out: list[ast.expr] = []
    for n in ast.walk(scope):
        if not isinstance(n, ast.Assign):
            continue
        for t in n.targets:
            if (isinstance(t, ast.Name) and t.id == name) or (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name) and t.value.id == name):
                v = n.value
                out.extend(v.values if isinstance(v, ast.Dict) else [v])
    return out


def _register_sites(tree: ast.AST):
    """``(register call, enclosing def or None)`` of every AOT register."""
    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            inner = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope
            if aot_register_fn(child) is not None:
                yield child, scope
            yield from visit(child, inner)

    yield from visit(tree, None)


def _capture_roots(tree: ast.AST) -> tuple[set[str], set[str]]:
    """``(names, builders)``: functions registered for capture by name,
    and builders (called inside a register) whose nested defs are the
    captured closures. A callable reaches a register through a local
    name (``render = eval_entry(...)``), a dict of callables, or a
    wrapper whose parameter it registers (``capture_steps(trainer,
    state, entries)`` registering each of ``entries.items()``)."""
    names: set[str] = set()
    builders: set[str] = set()
    defs = {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    # wrapper name -> index of the positional parameter it registers
    wrappers: dict[str, int] = {}

    def take(expr: ast.expr, scope, depth: int = 0) -> None:
        if isinstance(expr, ast.Name):
            if expr.id in defs:
                names.add(expr.id)
            elif scope is not None and depth < 3:
                for v in _bound_values(scope, expr.id):
                    take(v, scope, depth + 1)
        elif isinstance(expr, ast.Attribute):
            names.add(expr.attr)
        elif isinstance(expr, ast.Lambda):
            names.update(_callee_names(expr))
        elif isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            if chain:
                builders.add(chain[-1])
            for a in list(expr.args) + [kw.value for kw in expr.keywords]:
                if isinstance(a, (ast.Lambda, ast.Name, ast.Attribute)):
                    take(a, scope, depth + 1)

    for call, scope in _register_sites(tree):
        fn = aot_register_fn(call)
        take(fn, scope)
        if scope is None or not isinstance(fn, ast.Name):
            continue
        params = [a.arg for a in scope.args.posonlyargs + scope.args.args]
        source = fn.id
        for loop in ast.walk(scope):
            # for name, fn in entries.items(): register(name, fn)
            if (isinstance(loop, ast.For)
                    and fn.id in {n.id for n in ast.walk(loop.target)
                                  if isinstance(n, ast.Name)}):
                it = loop.iter
                if isinstance(it, ast.Call) and isinstance(
                        it.func, ast.Attribute):
                    it = it.func.value
                if isinstance(it, ast.Name):
                    source = it.id
        if source in params:
            wrappers[scope.name] = params.index(source)

    if wrappers:
        def visit(node, scope):
            for child in ast.iter_child_nodes(node):
                inner = child if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope
                if isinstance(child, ast.Call):
                    chain = _attr_chain(child.func)
                    idx = wrappers.get(chain[-1]) if chain else None
                    if idx is not None and len(chain) > 1:
                        idx -= 1  # a method: self is not passed
                    if idx is not None and 0 <= idx < len(child.args):
                        take(child.args[idx], scope)
                visit(child, inner)

        visit(tree, None)
    return names, builders


class ModuleContext:
    """One parsed file plus everything the rules need to know about it."""

    def __init__(self, path: str, source: str, rel_path: str | None = None):
        self.path = path
        self.rel_path = rel_path or path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.skip_file = any(
            _SKIP_FILE_RE.search(line) for line in self.lines[:10]
        )
        # line -> set of suppressed rule ids ("*" = all)
        self.suppressions: dict[int, set[str]] = {}
        self.hot_marker_lines: set[int] = set()
        self._scan_comments()
        self.functions: dict[str, FunctionInfo] = {}
        # bodies of ``with torch.cuda.graph(...)``: captured code that is
        # not a function of its own
        self.capture_regions: list[FunctionInfo] = []
        self._collect_functions()
        self._propagate()

    # -- comments ------------------------------------------------------------
    def _scan_comments(self) -> None:
        for i, line in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                spec = (m.group(1) or "").strip()
                rules = {"*"}
                if spec:
                    # "rule1, rule2: free-text reason" — reason after ':'
                    rule_part = spec.split(":", 1)[0]
                    rules = {
                        r.strip() for r in rule_part.split(",") if r.strip()
                    } or {"*"}
                # a bare-comment line suppresses the next line instead
                target = i + 1 if line.split("#", 1)[0].strip() == "" else i
                self.suppressions.setdefault(target, set()).update(rules)
            if _HOT_RE.search(line):
                self.hot_marker_lines.add(i)

    def is_suppressed(self, rule: str, line: int) -> bool:
        rules = self.suppressions.get(line, ())
        return "*" in rules or rule in rules

    # -- function table ------------------------------------------------------
    def _collect_functions(self) -> None:
        roots, builders = _capture_roots(self.tree)
        module = self

        class Collector(ast.NodeVisitor):
            def __init__(collector):
                collector.stack: list[str] = []
                collector.cls_stack: list[str] = []
                collector.captured_depth = 0
                collector.builder_depth = 0

            def visit_ClassDef(collector, node):
                collector.cls_stack.append(node.name)
                collector.generic_visit(node)
                collector.cls_stack.pop()

            def _handle_fn(collector, node):
                qual = ".".join(collector.stack + [node.name])
                # a closure defined inside a captured function or inside a
                # builder handed to register() runs under the capture
                captured = (collector.captured_depth > 0
                            or collector.builder_depth > 0
                            or node.name in roots)
                hot = (
                    node.lineno in module.hot_marker_lines
                    or (node.lineno - 1) in module.hot_marker_lines
                    or any(
                        d.lineno in module.hot_marker_lines
                        for d in node.decorator_list
                    )
                )
                info = FunctionInfo(
                    node=node,
                    qualname=qual,
                    name=node.name,
                    cls=collector.cls_stack[-1] if collector.cls_stack else None,
                    captured=captured,
                    hot=hot,
                )
                info.local_names = _local_names(node)
                info.calls = _callee_names(node)
                module.functions[qual] = info
                collector.stack.append(node.name)
                builder = node.name in builders
                collector.captured_depth += captured
                collector.builder_depth += builder
                collector.generic_visit(node)
                collector.captured_depth -= captured
                collector.builder_depth -= builder
                collector.stack.pop()

            visit_FunctionDef = _handle_fn
            visit_AsyncFunctionDef = _handle_fn

            def visit_With(collector, node):
                if any(is_graph_capture(it.context_expr)
                       for it in node.items):
                    qual = ".".join(collector.stack + ["<graph capture>"])
                    region = FunctionInfo(
                        node=node, qualname=qual, name="<graph capture>",
                        cls=(collector.cls_stack[-1]
                             if collector.cls_stack else None),
                        captured=True,
                    )
                    body = ast.Module(body=node.body, type_ignores=[])
                    region.calls = _callee_names(body)
                    region.local_names = _local_names(body)
                    module.capture_regions.append(region)
                collector.generic_visit(node)

        Collector().visit(self.tree)

    def _propagate(self) -> None:
        """Flood ``captured``/``hot`` along the intra-module call graph."""
        by_name: dict[str, list[FunctionInfo]] = {}
        for info in self.functions.values():
            by_name.setdefault(info.name, []).append(info)
            if info.cls:
                by_name.setdefault(f"{info.cls}.{info.name}", []).append(info)

        everything = list(self.functions.values()) + self.capture_regions
        for flag in ("captured", "hot"):
            changed = True
            while changed:
                changed = False
                for info in everything:
                    if not getattr(info, flag):
                        continue
                    for callee in info.calls:
                        targets = by_name.get(callee, [])
                        if info.cls and "." not in callee:
                            # a bare call inside a method prefers a sibling
                            # method of the same class when one exists
                            scoped = by_name.get(f"{info.cls}.{callee}")
                            if scoped:
                                targets = scoped
                        for t in targets:
                            if not getattr(t, flag):
                                setattr(t, flag, True)
                                changed = True

    def scopes(self) -> list[FunctionInfo]:
        """Every function, then every graph-capture body."""
        return list(self.functions.values()) + self.capture_regions

    # -- lookup helpers ------------------------------------------------------
    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding | None:
        line = getattr(node, "lineno", 1)
        if self.is_suppressed(rule, line):
            return None
        return Finding(
            rule=rule,
            path=self.rel_path,
            line=line,
            col=getattr(node, "col_offset", 0),
            message=message,
            snippet=self.snippet(line),
        )


def _local_names(fn: ast.AST) -> set[str]:
    """Names bound inside ``fn`` (params + assignments), own scope only."""
    names: set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        ):
            names.add(a.arg)
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)
    for node in ast.walk(fn):
        if node is fn:
            continue
        # ast.walk flattens nested scopes too: an over-approximation that
        # only ever makes rules QUIETER, never noisier
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.comprehension):
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _callee_names(fn: ast.AST) -> set[str]:
    """Bare and ``self.``-qualified callee names referenced from ``fn``
    (calls AND first-argument names, so callables passed to helpers and
    executors count as edges)."""
    calls: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                calls.add(f.id)
            elif isinstance(f, ast.Attribute):
                chain = _attr_chain(f)
                if chain[:1] == ["self"] and len(chain) == 2:
                    calls.add(chain[1])
            # first-arg callables (helper(body, ...), executor.submit(fn))
            for a in node.args[:1]:
                if isinstance(a, ast.Name):
                    calls.add(a.id)
    return calls


# --------------------------------------------------------------------------
# project context
# --------------------------------------------------------------------------

DEFAULT_SCAN = ("nerf_replication_tpu_torch", "chip_smoke.py")


class ProjectContext:
    """All parsed modules of one scan + repo-level config-key knowledge."""

    def __init__(self, modules: list[ModuleContext], repo_root: str | None,
                 config_keys: set[tuple[str, ...]] | None = None):
        self.modules = modules
        self.repo_root = repo_root
        # known config key-paths, e.g. ("train", "lr"); every prefix of a
        # known path is itself known. None => R6 key checks are skipped.
        self.config_keys = config_keys
        self.is_full_scan = repo_root is not None and any(
            m.rel_path.replace(os.sep, "/").startswith(
                LIB_PREFIX + "config/"
            )
            for m in modules
        ) and len(modules) >= 20


def iter_py_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [
                    d for d in dirs
                    if d not in ("__pycache__", ".git", "data", "logs")
                ]
                out.extend(
                    os.path.join(root, f) for f in sorted(files)
                    if f.endswith(".py")
                )
        elif p.endswith(".py") and os.path.exists(p):
            out.append(p)
    return sorted(dict.fromkeys(out))


def lint_source(
    source: str,
    path: str = "<string>",
    rules: tuple[str, ...] | None = None,
    config_keys: set[tuple[str, ...]] | None = None,
) -> list[Finding]:
    """Lint one source string (the test-fixture surface)."""
    module = ModuleContext(path, source)
    project = ProjectContext([module], repo_root=None, config_keys=config_keys)
    return _run_rules(project, rules)


def lint_paths(
    paths: list[str],
    repo_root: str | None = None,
    rules: tuple[str, ...] | None = None,
    config_keys: set[tuple[str, ...]] | None = None,
    timings: dict | None = None,
) -> tuple[list[Finding], list[str]]:
    """Lint files/dirs. Returns ``(findings, errors)`` — errors are files
    that failed to parse (reported, not fatal: a lint gate must not die on
    one syntax error in an unrelated script). ``timings``, when passed,
    is filled with per-rule wall seconds (the CLI's --format json and
    lint_run telemetry surface)."""
    modules: list[ModuleContext] = []
    errors: list[str] = []
    for f in iter_py_files(paths):
        rel = os.path.relpath(f, repo_root) if repo_root else f
        try:
            with open(f, encoding="utf-8") as fh:
                src = fh.read()
            modules.append(ModuleContext(f, src, rel_path=rel))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{rel}: {type(e).__name__}: {e}")
    if config_keys is None and repo_root is not None:
        from .rules import collect_config_keys

        config_keys = collect_config_keys(repo_root)
    project = ProjectContext(modules, repo_root, config_keys=config_keys)
    return _run_rules(project, rules, timings=timings), errors


def _run_rules(
    project: ProjectContext, rules: tuple[str, ...] | None,
    timings: dict | None = None,
) -> list[Finding]:
    import time

    from . import concurrency as _conc  # noqa: F401  (populates RULES)
    from . import rules as _rules  # noqa: F401  (populates RULES)

    active = [
        r for rid, r in RULES.items() if rules is None or rid in rules
    ]
    if timings is None:
        timings = {}
    findings: list[Finding] = []
    for module in project.modules:
        if module.skip_file:
            continue
        for rule in active:
            if not rule.project_wide:
                t0 = time.perf_counter()
                findings.extend(rule.check(module))
                timings[rule.rule_id] = (
                    timings.get(rule.rule_id, 0.0)
                    + time.perf_counter() - t0
                )
    for rule in active:
        if rule.project_wide:
            t0 = time.perf_counter()
            findings.extend(rule.check_project(project))
            timings[rule.rule_id] = (
                timings.get(rule.rule_id, 0.0) + time.perf_counter() - t0
            )
    # nested loops / overlapping walks can surface the same hazard twice
    findings = list(dict.fromkeys(findings))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
