"""graftlint rules R10-R13 — interprocedural concurrency analysis (port of
``nerf_replication_tpu/analysis/concurrency.py``: the same model; torch's
synchronizing calls take the place of JAX's device waits).

The serving fleet holds real thread state (batcher cuts, residency
demotions, router failover, prefetch closures); these rules build a
module-spanning **lock model** + **call graph** and check the discipline
the per-function R1-R9 rules cannot see.

=====================  ======================================================
rule id                hazard
=====================  ======================================================
``lock-order``   (R10) a cycle in the static lock-acquisition graph —
                       two call chains that take the same locks in
                       opposite orders deadlock under load; also the
                       re-acquisition of a non-reentrant ``Lock``
``unguarded-shared``   a field written inside some lock's critical
                 (R11) section and also read/written from a ``Thread``
                       target / timer / executor closure without that
                       lock — a data race the GIL hides until it doesn't
``blocking-under-lock``urlopen / socket / subprocess / sleep /
                 (R12) ``torch.cuda.synchronize`` / ``Event``/``Stream``
                       ``.synchronize()`` / ``.item()`` / ``.cpu()`` /
                       file-I/O (incl. the global telemetry emitter)
                       reachable while a lock is held — every waiter pays
                       the wait
``thread-hygiene``     non-daemon threads never joined, ``Condition.wait``
                 (R13) without a predicate loop, ``current_ctx()`` read
                       inside a thread-entry closure (capture it on the
                       submitting thread — fleet/residency.py prefetch)
=====================  ======================================================

Lock model
----------
Every ``threading.Lock/RLock/Condition`` bound to an attribute
(``self._lock = threading.Lock()``), a module-level name, or a function
local becomes a **named lock** (``Router._lock``, ``native:_LOCK``).
``with self._lock:`` blocks and ``acquire()``/``release()`` pairs define
critical sections. Receiver types resolve through parameter annotations
and ``self.attr = annotated_param`` assignments, so
``res = self.residency; with res._cond:`` names
``ResidencyManager._cond``. ``Condition()`` wraps an RLock, so conditions
count as reentrant.

Interprocedural facts flow along a project-wide call graph
(``self.m()`` resolves through the MRO plus subclass overrides; other
receivers resolve by annotation type or, failing that, by a
project-unique method name), with two fixpoints: the set of locks a
function may transitively acquire, and the blocking calls it may
transitively reach. A third fixpoint recovers the **held-at-entry** set
for contract functions ("called under the lock"): the intersection of
the locks held at every observed call site.

Annotations
-----------
``# graftlint: guards(f1, f2)`` on (or the line above) a lock's
assignment declares the lock's guarded-field set **exactly** — inference
for that lock is replaced by the declaration, so documented
single-writer counters that are merely *touched* under the lock stop
counting as guarded (the R11 suppression path for the batcher's
worker-owned counters). Per-call-site allowlisting for intentional
blocking uses the standard ``# graftlint: ok(blocking-under-lock:
reason)`` suppression; the reason is the audit trail.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field as dc_field

from .core import (
    Finding,
    ModuleContext,
    ProjectContext,
    Rule,
    _attr_chain,
    register,
)

_GUARDS_RE = re.compile(r"#\s*graftlint:\s*guards\(([^)]*)\)")

_LOCK_CTORS = {
    ("threading", "Lock"): "lock",
    ("Lock",): "lock",
    ("threading", "RLock"): "rlock",
    ("RLock",): "rlock",
    ("threading", "Condition"): "condition",
    ("Condition",): "condition",
}

# Condition() builds on an RLock: re-entry by the owning thread is legal
_REENTRANT_KINDS = ("rlock", "condition")

# method names shared with stdlib containers/files/threads: the
# unique_named fallback must never claim these for a project class
_UBIQUITOUS_METHODS = frozenset((
    "get", "put", "pop", "add", "append", "extend", "update", "clear",
    "copy", "close", "items", "keys", "values", "join", "start", "run",
    "read", "write", "send", "recv", "next", "set", "remove", "discard",
    "count", "index", "insert", "sort", "reverse", "wait", "notify",
    "notify_all", "acquire", "release", "submit", "result", "done",
    "cancel", "flush", "seek", "tell", "open", "stop", "reset", "step",
    "setdefault", "move_to_end", "popitem", "format", "strip", "split",
))


@dataclass(frozen=True)
class LockInfo:
    """One named lock: where it was constructed and what it guards."""

    name: str            # "Router._lock" | "native:_LOCK" | "f.<local>lk"
    kind: str            # lock | rlock | condition
    module: str          # rel_path of the defining module
    line: int
    cls: str | None      # owning class (None: module-level / local)
    attr: str
    guards: frozenset | None = None  # declared guarded fields (None: infer)


@dataclass
class ClassInfo:
    name: str
    module: ModuleContext
    bases: tuple[str, ...]
    methods: dict = dc_field(default_factory=dict)     # name -> FuncNode
    locks: dict = dc_field(default_factory=dict)       # attr -> LockInfo
    attr_types: dict = dc_field(default_factory=dict)  # attr -> class name


@dataclass(eq=False)  # identity hash: nodes are graph keys
class FuncNode:
    """One function/method/nested closure plus its concurrency facts."""

    qual: str
    name: str
    cls: str | None
    module: ModuleContext
    node: ast.AST
    parent: "FuncNode | None" = None
    children: dict = dc_field(default_factory=dict)    # name -> FuncNode
    # facts (filled by the walker)
    acquires: list = dc_field(default_factory=list)    # (LockInfo, held, node)
    calls: list = dc_field(default_factory=list)       # (targets, held, node)
    blocking: list = dc_field(default_factory=list)    # (label, held, node)
    accesses: list = dc_field(default_factory=list)    # (cls, attr, rw, held, node)
    waits: list = dc_field(default_factory=list)       # (LockInfo, in_while, node)
    ctx_calls: list = dc_field(default_factory=list)   # current_ctx() nodes
    spawns: list = dc_field(default_factory=list)      # (node, daemon, bind)
    is_thread_target = False
    # fixpoint results
    trans_locks: set = dc_field(default_factory=set)       # lock names
    trans_blocking: dict = dc_field(default_factory=dict)  # label -> via
    held_in: frozenset = frozenset()                       # lock names

    def short(self) -> str:
        return self.qual.split("::", 1)[-1]


def _lock_ctor_kind(node: ast.AST) -> str | None:
    if isinstance(node, ast.Call):
        return _LOCK_CTORS.get(tuple(_attr_chain(node.func)))
    return None


def _ann_name(ann: ast.AST | None) -> str | None:
    """Last segment of a simple annotation (``ResidencyManager``,
    ``residency.ResidencyManager``, ``"Router"``)."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1].strip() or None
    chain = _attr_chain(ann)
    return chain[-1] if chain else None


# --------------------------------------------------------------------------
# the shared model (built once per ProjectContext, cached on it)
# --------------------------------------------------------------------------


class ConcurrencyModel:
    """Locks + classes + call graph + fixpoints over one project scan."""

    def __init__(self, project: ProjectContext):
        self.project = project
        self.classes: dict[str, ClassInfo] = {}
        self.subclasses: dict[str, set[str]] = {}
        self.module_locks: dict[str, dict[str, LockInfo]] = {}  # rel -> name
        self.module_funcs: dict[str, dict[str, FuncNode]] = {}
        self.funcs: list[FuncNode] = []
        self.methods_named: dict[str, list[FuncNode]] = {}
        self.locks_by_name: dict[str, LockInfo] = {}
        self.lock_attr_owners: dict[str, list[str]] = {}  # attr -> [cls]
        self.joins: dict[str, set] = {}        # rel_path -> joined chains
        self.daemon_later: dict[str, set] = {}  # rel_path -> chains
        self.module_imports: dict[str, set] = {}  # rel_path -> import names
        self._pending_attr_types: list[tuple] = []  # (cls, attr, ctor name)
        for m in project.modules:
            if not m.skip_file:
                self._collect(m)
        for cinfo, attr, ctor in self._pending_attr_types:
            if ctor in self.classes:
                cinfo.attr_types.setdefault(attr, ctor)
        self._attach_guards()
        for fn in self.funcs:
            _FactWalker(self, fn).run()
        self._resolve_calls()
        self._fix_trans_locks()
        self._fix_trans_blocking()
        self._fix_held_in()
        self._flood_thread_ctx()

    @classmethod
    def of(cls, project: ProjectContext) -> "ConcurrencyModel":
        model = getattr(project, "_concurrency_model", None)
        if model is None:
            model = cls(project)
            project._concurrency_model = model
        return model

    # -- pass 1: classes / functions / locks ---------------------------------

    def _collect(self, module: ModuleContext) -> None:
        model = self
        rel = module.rel_path
        model.module_locks.setdefault(rel, {})
        model.module_funcs.setdefault(rel, {})
        model.joins.setdefault(rel, set())
        model.daemon_later.setdefault(rel, set())
        imports = model.module_imports.setdefault(rel, set())
        for sub in ast.walk(module.tree):
            if isinstance(sub, ast.Import):
                for a in sub.names:
                    imports.add(a.asname or a.name.split(".", 1)[0])

        class Collector(ast.NodeVisitor):
            def __init__(self):
                self.cls_stack: list[ClassInfo] = []
                self.fn_stack: list[FuncNode] = []

            def visit_ClassDef(self, node):
                bases = tuple(
                    c[-1] for b in node.bases if (c := _attr_chain(b))
                )
                info = ClassInfo(node.name, module, bases)
                model.classes.setdefault(node.name, info)
                for b in bases:
                    model.subclasses.setdefault(b, set()).add(node.name)
                self.cls_stack.append(model.classes[node.name])
                self.generic_visit(node)
                self.cls_stack.pop()

            def _fn(self, node):
                cls = self.cls_stack[-1].name if self.cls_stack else None
                scope = [f.name for f in self.fn_stack] + [node.name]
                if cls:
                    scope = [cls] + scope
                fn = FuncNode(
                    qual=f"{rel}::{'.'.join(scope)}", name=node.name,
                    cls=cls, module=module, node=node,
                    parent=self.fn_stack[-1] if self.fn_stack else None,
                )
                model.funcs.append(fn)
                if fn.parent is not None:
                    fn.parent.children[node.name] = fn
                elif cls:
                    self.cls_stack[-1].methods.setdefault(node.name, fn)
                    model.methods_named.setdefault(node.name, []).append(fn)
                else:
                    model.module_funcs[rel].setdefault(node.name, fn)
                self.fn_stack.append(fn)
                self._scan_method_body(node)
                self.generic_visit(node)
                self.fn_stack.pop()

            visit_FunctionDef = _fn
            visit_AsyncFunctionDef = _fn

            def _scan_method_body(self, node):
                """Class attr types + ``self.x = threading.Lock()``."""
                if not self.cls_stack or len(self.fn_stack) != 1:
                    return
                cinfo = self.cls_stack[-1]
                ann_params = {}
                args = node.args
                for a in (list(args.posonlyargs) + list(args.args)
                          + list(args.kwonlyargs)):
                    t = _ann_name(a.annotation)
                    if t:
                        ann_params[a.arg] = t
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign):
                        for tgt in sub.targets:
                            chain = _attr_chain(tgt)
                            if len(chain) != 2 or chain[0] != "self":
                                continue
                            attr = chain[1]
                            kind = _lock_ctor_kind(sub.value)
                            if kind:
                                lk = model._add_lock(
                                    f"{cinfo.name}.{attr}", kind, rel,
                                    sub.lineno, cinfo.name, attr)
                                cinfo.locks.setdefault(attr, lk)
                            vchain = _attr_chain(sub.value)
                            if len(vchain) == 1 and vchain[0] in ann_params:
                                cinfo.attr_types.setdefault(
                                    attr, ann_params[vchain[0]])
                            if (isinstance(sub.value, ast.Call)
                                    and (c := _attr_chain(sub.value.func))):
                                # deferred: the ctor's class may live in a
                                # module not collected yet
                                model._pending_attr_types.append(
                                    (cinfo, attr, c[-1]))
                    elif isinstance(sub, ast.AnnAssign):
                        chain = _attr_chain(sub.target)
                        t = _ann_name(sub.annotation)
                        if len(chain) == 2 and chain[0] == "self" and t:
                            cinfo.attr_types.setdefault(chain[1], t)

            def visit_Assign(self, node):
                if not self.fn_stack and not self.cls_stack:
                    kind = _lock_ctor_kind(node.value)
                    if kind:
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                stem = rel.rsplit("/", 1)[-1]
                                stem = stem[:-3] if stem.endswith(".py") \
                                    else stem
                                lk = model._add_lock(
                                    f"{stem}:{tgt.id}", kind, rel,
                                    node.lineno, None, tgt.id)
                                model.module_locks[rel][tgt.id] = lk
                self.generic_visit(node)

            def visit_Call(self, node):
                # module-wide join / daemon-late-assignment census
                chain = _attr_chain(node.func)
                if len(chain) >= 2 and chain[-1] == "join":
                    model.joins[rel].add(tuple(chain[:-1]))
                self.generic_visit(node)

            def visit_Attribute(self, node):
                self.generic_visit(node)

        collector = Collector()
        collector.visit(module.tree)
        for sub in ast.walk(module.tree):
            if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                    and (c := _attr_chain(sub.targets[0]))
                    and c[-1] == "daemon"
                    and isinstance(sub.value, ast.Constant)
                    and sub.value.value is True):
                model.daemon_later[rel].add(tuple(c[:-1]))

    def _add_lock(self, name, kind, rel, line, cls, attr) -> LockInfo:
        lk = self.locks_by_name.get(name)
        if lk is None:
            lk = LockInfo(name, kind, rel, line, cls, attr)
            self.locks_by_name[name] = lk
            if cls:
                self.lock_attr_owners.setdefault(attr, []).append(cls)
        return lk

    def _attach_guards(self) -> None:
        """``# graftlint: guards(f1, f2)`` on (or above) a lock assign."""
        by_loc = {(lk.module, lk.line): name
                  for name, lk in self.locks_by_name.items()}
        for module in self.project.modules:
            for i, line in enumerate(module.lines, 1):
                m = _GUARDS_RE.search(line)
                if not m:
                    continue
                target = i + 1 if line.split("#", 1)[0].strip() == "" else i
                name = by_loc.get((module.rel_path, target))
                if name is None:
                    continue
                fields = frozenset(
                    f.strip() for f in m.group(1).split(",") if f.strip()
                )
                old = self.locks_by_name[name]
                new = LockInfo(old.name, old.kind, old.module, old.line,
                               old.cls, old.attr, guards=fields)
                self.locks_by_name[name] = new
                if old.cls and old.cls in self.classes:
                    self.classes[old.cls].locks[old.attr] = new

    # -- resolution helpers --------------------------------------------------

    def mro(self, cls: str) -> list[ClassInfo]:
        out, seen, queue = [], set(), [cls]
        while queue:
            c = queue.pop(0)
            if c in seen or c not in self.classes:
                continue
            seen.add(c)
            info = self.classes[c]
            out.append(info)
            queue.extend(info.bases)
        return out

    def family_root(self, cls: str) -> str:
        cur = cls
        seen = set()
        while cur in self.classes and cur not in seen:
            seen.add(cur)
            nxt = next((b for b in self.classes[cur].bases
                        if b in self.classes), None)
            if nxt is None:
                return cur
            cur = nxt
        return cur

    def _descendants(self, cls: str) -> list[str]:
        out, queue = [], [cls]
        while queue:
            c = queue.pop(0)
            for s in self.subclasses.get(c, ()):
                if s not in out:
                    out.append(s)
                    queue.append(s)
        return out

    def find_lock(self, cls: str | None, attr: str) -> LockInfo | None:
        if cls is None:
            return None
        for info in self.mro(cls):
            lk = info.locks.get(attr)
            if lk is not None:
                return lk
        return None

    def unique_attr_lock(self, attr: str) -> LockInfo | None:
        """Lock attr defined by exactly one class family project-wide."""
        owners = self.lock_attr_owners.get(attr, [])
        roots = {self.family_root(c) for c in owners}
        if len(roots) == 1:
            return self.find_lock(owners[0], attr)
        return None

    def family_methods(self, cls: str, name: str) -> list[FuncNode]:
        """``name`` resolved through cls's MRO plus subclass overrides
        (a static type's call may dispatch to any override below it)."""
        out = []
        for info in self.mro(cls):
            fn = info.methods.get(name)
            if fn is not None and fn not in out:
                out.append(fn)
        for sub in self._descendants(cls):
            fn = self.classes[sub].methods.get(name)
            if fn is not None and fn not in out:
                out.append(fn)
        return out

    def unique_named(self, name: str) -> list[FuncNode]:
        """Every project def named ``name`` IF they form one class family
        (or a single module-level def) — the over-approximate fallback."""
        if name in _UBIQUITOUS_METHODS:
            # names every container/file/thread also answers to: an
            # unresolved receiver is far more likely a dict or a handle
            # than the one project class that shares the name (a partial
            # --changed scan would otherwise "uniquely" resolve sub.get
            # to SceneStore.get and invent a deadlock)
            return []
        if not self.project.is_full_scan:
            # uniqueness is a project-wide property; a partial (--changed)
            # scan that sees one class family named ``name`` cannot know a
            # second family exists outside the diff
            return []
        methods = self.methods_named.get(name, [])
        mod_fns = [f for fns in self.module_funcs.values()
                   for n, f in fns.items() if n == name]
        if methods and mod_fns:
            return []
        if mod_fns:
            return mod_fns if len(mod_fns) == 1 else []
        roots = {self.family_root(f.cls) for f in methods}
        return methods if len(roots) == 1 else []

    # -- pass 3: call resolution + fixpoints ---------------------------------

    def _resolve_calls(self) -> None:
        self.edges: dict[FuncNode, list] = {}        # f -> [(g, held, node)]
        self.sites: dict[FuncNode, list] = {}        # g -> [(f, held)]
        for f in self.funcs:
            out = []
            for targets, held, node in f.calls:
                for g in targets:
                    out.append((g, held, node))
                    self.sites.setdefault(g, []).append((f, held))
            self.edges[f] = out

    def _fix_trans_locks(self) -> None:
        for f in self.funcs:
            f.trans_locks = {lk.name for lk, _, _ in f.acquires}
        changed = True
        while changed:
            changed = False
            for f in self.funcs:
                for g, _, _ in self.edges[f]:
                    if not g.trans_locks <= f.trans_locks:
                        f.trans_locks |= g.trans_locks
                        changed = True

    def _fix_trans_blocking(self) -> None:
        for f in self.funcs:
            f.trans_blocking = {
                label: f"{label} at {f.module.rel_path}:{node.lineno}"
                for label, _, node in f.blocking
            }
        changed = True
        while changed:
            changed = False
            for f in self.funcs:
                for g, _, _ in self.edges[f]:
                    for label, via in g.trans_blocking.items():
                        if label not in f.trans_blocking:
                            f.trans_blocking[label] = \
                                f"via {g.short()}: {via}"[:200]
                            changed = True

    def _fix_held_in(self) -> None:
        """Held-at-entry: the intersection of locks held at every observed
        call site — honors the repo's "called under the lock" contract
        hooks without an annotation."""
        held: dict[FuncNode, frozenset | None] = {
            f: (frozenset()
                if f.is_thread_target or not self.sites.get(f) else None)
            for f in self.funcs
        }
        for _ in range(len(self.funcs) + 1):
            changed = False
            for f in self.funcs:
                if held[f] == frozenset() and (
                        f.is_thread_target or not self.sites.get(f)):
                    continue  # roots stay empty
                vals = [
                    frozenset(lk.name for lk in site_held) | base
                    for caller, site_held in self.sites.get(f, ())
                    if (base := held.get(caller)) is not None
                ]
                nv = frozenset.intersection(*vals) if vals else None
                if nv is not None and nv != held[f]:
                    held[f] = nv
                    changed = True
            if not changed:
                break
        for f in self.funcs:
            f.held_in = held[f] if held[f] is not None else frozenset()

    def _flood_thread_ctx(self) -> None:
        self.thread_ctx: set[FuncNode] = set()
        queue = [f for f in self.funcs if f.is_thread_target]
        while queue:
            f = queue.pop()
            if f in self.thread_ctx:
                continue
            self.thread_ctx.add(f)
            queue.extend(g for g, _, _ in self.edges.get(f, ()))


# --------------------------------------------------------------------------
# pass 2: the per-function fact walker
# --------------------------------------------------------------------------

_BLOCKING_BARE = {"urlopen": "urlopen", "open": "file I/O (open)",
                  "sleep": "time.sleep"}

# torch calls that wait for the card: the host blocks until the stream
# (or every stream) has drained
_SYNC_METHODS = ("item", "cpu")

# receivers that are modules, not objects: ``os.replace(...)`` must never
# fall back to a project method that happens to be named ``replace``
_MODULE_RECEIVERS = frozenset((
    "os", "sys", "time", "json", "math", "re", "ast", "io", "shutil",
    "glob", "subprocess", "socket", "threading", "queue", "ctypes",
    "platform", "random", "itertools", "functools", "collections",
    "contextlib", "traceback", "logging", "tempfile", "pickle", "struct",
    "hashlib", "heapq", "bisect", "gc", "signal", "inspect", "copy",
    "enum", "argparse", "dataclasses", "urllib", "warnings", "weakref",
    "pathlib", "typing", "uuid", "datetime", "operator", "statistics",
    "np", "numpy", "jax", "jnp", "lax", "pytest", "torch",
))
_SKIP_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class _FactWalker:
    """One function's lexical critical sections and the facts in them."""

    def __init__(self, model: ConcurrencyModel, fn: FuncNode):
        self.model = model
        self.fn = fn
        self.local_types: dict[str, str] = {}
        self.local_locks: dict[str, LockInfo] = {}
        args = fn.node.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            t = _ann_name(a.annotation)
            if t and t in model.classes:
                self.local_types[a.arg] = t

    def run(self) -> None:
        self._body(self.fn.node.body, (), 0)

    def _block(self, label: str, held: tuple, node: ast.AST) -> None:
        """Record a blocking call — unless the site is allowlisted, in
        which case it neither fires directly nor propagates to callers."""
        if self.fn.module.is_suppressed(
                "blocking-under-lock", getattr(node, "lineno", 0)):
            return
        self.fn.blocking.append((label, held, node))

    # -- lock / type resolution ---------------------------------------------

    def _resolve_lock(self, expr: ast.AST) -> LockInfo | None:
        chain = _attr_chain(expr)
        if not chain:
            return None
        if len(chain) == 1:
            name = chain[0]
            if name in self.local_locks:
                return self.local_locks[name]
            return self.model.module_locks.get(
                self.fn.module.rel_path, {}).get(name)
        attr = chain[-1]
        if chain[0] == "self" and self.fn.cls:
            if len(chain) == 2:
                lk = self.model.find_lock(self.fn.cls, attr)
                if lk is not None:
                    return lk
                return None
            if len(chain) == 3:  # self.res._cond via attr type
                t = self._self_attr_type(chain[1])
                return self.model.find_lock(t, attr) if t else None
            return None
        if len(chain) == 2:
            t = self.local_types.get(chain[0])
            if t:
                return self.model.find_lock(t, attr)
            return self.model.unique_attr_lock(attr)
        return None

    def _self_attr_type(self, attr: str) -> str | None:
        for info in self.model.mro(self.fn.cls or ""):
            t = info.attr_types.get(attr)
            if t:
                return t
        return None

    def _owner_cls(self) -> str | None:
        return self.fn.cls

    # -- statement walk -------------------------------------------------------

    def _body(self, stmts: list, held: tuple, in_while: int) -> None:
        i = 0
        while i < len(stmts):
            s = stmts[i]
            lk = self._acquire_stmt(s)
            if lk is not None:
                self.fn.acquires.append((lk, held, s))
                j = self._find_release(stmts, i + 1, lk)
                self._body(stmts[i + 1:j], held + (lk,), in_while)
                i = j + 1
                continue
            self._stmt(s, held, in_while)
            i += 1

    def _acquire_stmt(self, s: ast.stmt) -> LockInfo | None:
        if (isinstance(s, ast.Expr) and isinstance(s.value, ast.Call)
                and (c := _attr_chain(s.value.func))
                and c[-1] == "acquire"):
            return self._resolve_lock_chain(c[:-1])
        return None

    def _resolve_lock_chain(self, chain: list) -> LockInfo | None:
        if not chain:
            return None
        node: ast.AST = ast.Name(id=chain[0])
        for part in chain[1:]:
            node = ast.Attribute(value=node, attr=part)
        return self._resolve_lock(node)

    def _find_release(self, stmts: list, start: int, lk: LockInfo) -> int:
        for j in range(start, len(stmts)):
            s = stmts[j]
            for sub in ast.walk(s):
                if (isinstance(sub, ast.Call)
                        and (c := _attr_chain(sub.func))
                        and c[-1] == "release"
                        and self._resolve_lock_chain(c[:-1]) is lk):
                    return j
        return len(stmts)

    def _stmt(self, s: ast.stmt, held: tuple, in_while: int) -> None:
        if isinstance(s, _SKIP_SCOPES[:2]):
            return  # nested defs get their own walker
        if isinstance(s, ast.With):
            inner = list(held)
            for item in s.items:
                lk = self._resolve_lock(item.context_expr)
                if lk is not None:
                    self.fn.acquires.append((lk, tuple(inner), item.context_expr))
                    inner.append(lk)
                else:
                    self._expr(item.context_expr, held, in_while)
            self._body(s.body, tuple(inner), in_while)
            return
        if isinstance(s, ast.While):
            self._expr(s.test, held, in_while)
            self._body(s.body, held, in_while + 1)
            self._body(s.orelse, held, in_while)
            return
        if isinstance(s, (ast.If,)):
            self._expr(s.test, held, in_while)
            self._body(s.body, held, in_while)
            self._body(s.orelse, held, in_while)
            return
        if isinstance(s, ast.For):
            self._expr(s.iter, held, in_while)
            self._body(s.body, held, in_while + 1)
            self._body(s.orelse, held, in_while)
            return
        if isinstance(s, ast.Try):
            self._body(s.body, held, in_while)
            for h in s.handlers:
                self._body(h.body, held, in_while)
            self._body(s.orelse, held, in_while)
            self._body(s.finalbody, held, in_while)
            return
        if isinstance(s, ast.Assign):
            self._expr(s.value, held, in_while)
            kind = _lock_ctor_kind(s.value)
            for tgt in s.targets:
                chain = _attr_chain(tgt)
                if kind and len(chain) == 1 and self.fn.cls is None:
                    self.local_locks[chain[0]] = LockInfo(
                        f"{self.fn.name}.{chain[0]}", kind,
                        self.fn.module.rel_path, s.lineno, None, chain[0])
                if len(chain) == 1:
                    vchain = _attr_chain(s.value)
                    if (isinstance(s.value, ast.Call) and vchain
                            and vchain[-1] in self.model.classes):
                        self.local_types[chain[0]] = vchain[-1]
                    elif (isinstance(s.value, ast.Call)
                          and len(vchain) == 2
                          and vchain[0] in self.model.classes
                          and vchain[1].startswith("from")):
                        # alternate-constructor idiom: Cls.from_x() -> Cls
                        self.local_types[chain[0]] = vchain[0]
                    elif (len(vchain) == 2 and vchain[0] == "self"
                          and self.fn.cls):
                        t = self._self_attr_type(vchain[1])
                        if t:
                            self.local_types[chain[0]] = t
                    elif len(vchain) == 1 and vchain[0] in self.local_types:
                        self.local_types[chain[0]] = \
                            self.local_types[vchain[0]]
                self._record_target(tgt, held, s)
            return
        if isinstance(s, ast.AugAssign):
            self._expr(s.value, held, in_while)
            self._record_target(s.target, held, s, aug=True)
            return
        if isinstance(s, ast.Expr):
            self._expr(s.value, held, in_while)
            return
        if isinstance(s, ast.Return) and s.value is not None:
            self._expr(s.value, held, in_while)
            return
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self._expr(child, held, in_while)
            elif isinstance(child, ast.stmt):
                self._stmt(child, held, in_while)

    def _record_target(self, tgt, held, s, aug=False) -> None:
        chain = _attr_chain(tgt)
        if len(chain) >= 2 and chain[0] == "self" and self.fn.cls:
            self.fn.accesses.append(
                (self.fn.cls, chain[1], "write", held, s))
            if aug:
                self.fn.accesses.append(
                    (self.fn.cls, chain[1], "read", held, s))
        elif isinstance(tgt, ast.Tuple):
            for el in tgt.elts:
                self._record_target(el, held, s, aug=aug)

    # -- expression walk ------------------------------------------------------

    def _expr(self, node: ast.AST, held: tuple, in_while: int) -> None:
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, _SKIP_SCOPES):
                continue
            if isinstance(n, ast.Call):
                self._call(n, held, in_while)
            elif isinstance(n, ast.Attribute):
                chain = _attr_chain(n)
                if (len(chain) == 2 and chain[0] == "self" and self.fn.cls
                        and isinstance(n.ctx, ast.Load)):
                    self.fn.accesses.append(
                        (self.fn.cls, chain[1], "read", held, n))
            stack.extend(ast.iter_child_nodes(n))

    def _call(self, node: ast.Call, held: tuple, in_while: int) -> None:
        chain = _attr_chain(node.func)
        if not chain:
            # get_emitter().emit(...) — receiver is itself a call
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "emit"
                    and isinstance(f.value, ast.Call)
                    and (rc := _attr_chain(f.value.func))
                    and rc[-1] == "get_emitter"):
                self._block("telemetry emit (file I/O)", held, node)
            return
        last = chain[-1]
        # waits: predicate-loop discipline + blocking classification
        if last in ("wait", "wait_for") and len(chain) >= 2:
            lk = self._resolve_lock_chain(chain[:-1])
            if lk is not None and lk.kind == "condition":
                if last == "wait":
                    self.fn.waits.append((lk, in_while > 0, node))
                # waiting on a held condition releases it — not blocking
                # w.r.t. itself; other held locks stay a hazard but the
                # repo idiom (park on the manager's own cond) is clean
                return
            if chain[-2] in ("event", "_event") or last == "wait_for":
                self._block(".".join(chain[-2:]), held, node)
            return
        label = self._blocking_label(chain)
        if label is not None:
            self._block(label, held, node)
        if last == "current_ctx":
            self.fn.ctx_calls.append(node)
        self._register_thread_targets(node, chain)
        # call-graph edge
        targets = self._resolve_call(chain)
        if targets:
            self.fn.calls.append((targets, held, node))

    def _blocking_label(self, chain: list) -> str | None:
        last = chain[-1]
        if last in _BLOCKING_BARE and (len(chain) == 1 or chain[0] in (
                "urllib", "request", "time", "torch", "np", "os")):
            if last == "open" and len(chain) > 1:
                return None  # os.open etc.: keep to the builtin
            return _BLOCKING_BARE[last]
        if chain[0] == "subprocess":
            return f"subprocess.{last}"
        if chain[0] == "socket" and len(chain) > 1:
            return f"socket.{last}"
        if last == "synchronize" and len(chain) >= 2:
            return ("torch.cuda.synchronize" if chain[-2] == "cuda"
                    else f"{chain[-2]}.synchronize")
        if last in _SYNC_METHODS and len(chain) >= 2:
            return f".{last}()"
        if last == "emit" and len(chain) >= 2 and "emitter" in chain[-2].lower():
            return "telemetry emit (file I/O)"
        return None

    def _register_thread_targets(self, node: ast.Call, chain: list) -> None:
        target_expr = None
        daemon = None
        if chain[-1] == "Thread" and (len(chain) == 1
                                      or chain[0] == "threading"):
            for kw in node.keywords:
                if kw.arg == "target":
                    target_expr = kw.value
                if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                    daemon = bool(kw.value.value)
            if target_expr is None and node.args:
                target_expr = node.args[0]
            self.fn.spawns.append((node, daemon, None))
        elif chain[-1] == "Timer" and (len(chain) == 1
                                       or chain[0] == "threading"):
            if len(node.args) >= 2:
                target_expr = node.args[1]
            for kw in node.keywords:
                if kw.arg == "function":
                    target_expr = kw.value
        elif (chain[-1] == "submit" and len(chain) >= 2
                and any(k in chain[-2].lower()
                        for k in ("executor", "pool"))):
            if node.args:
                target_expr = node.args[0]
        if target_expr is None:
            return
        for g in self._resolve_call(_attr_chain(target_expr)):
            g.is_thread_target = True

    def _resolve_call(self, chain: list) -> list[FuncNode]:
        if not chain:
            return []
        model = self.model
        name = chain[-1]
        if len(chain) >= 2 and (
                chain[0] in _MODULE_RECEIVERS
                or chain[0] in model.module_imports.get(
                    self.fn.module.rel_path, ())):
            return []  # module function, not a method: no fallback
        if len(chain) == 1:
            fn = self.fn
            while fn is not None:  # nested defs shadow outward
                if name in fn.children:
                    return [fn.children[name]]
                fn = fn.parent
            mod_fn = model.module_funcs.get(
                self.fn.module.rel_path, {}).get(name)
            if mod_fn is not None:
                return [mod_fn]
            if self.fn.cls:  # bare sibling-method call (rare)
                hit = model.family_methods(self.fn.cls, name)
                if hit:
                    return hit
            return model.unique_named(name)
        if chain[0] == "self" and len(chain) == 2 and self.fn.cls:
            hit = model.family_methods(self.fn.cls, name)
            return hit or model.unique_named(name)
        if chain[0] == "self" and len(chain) == 3 and self.fn.cls:
            t = self._self_attr_type(chain[1])
            if t:
                hit = model.family_methods(t, name)
                if hit:
                    return hit
            return model.unique_named(name)
        if len(chain) == 2:
            t = self.local_types.get(chain[0])
            if t:
                hit = model.family_methods(t, name)
                if hit:
                    return hit
            return model.unique_named(name)
        return model.unique_named(name)


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------


def _eff_held(f: FuncNode, held: tuple) -> frozenset:
    return frozenset(lk.name for lk in held) | f.held_in


@register
class LockOrderRule(Rule):
    rule_id = "lock-order"
    doc = ("cycle in the static lock-acquisition graph (potential "
           "deadlock), or re-acquisition of a non-reentrant Lock")
    project_wide = True

    def check_project(self, project: ProjectContext) -> list[Finding]:
        model = ConcurrencyModel.of(project)
        findings: list[Finding] = []
        # edge -> (module, node, qual) evidence, first occurrence wins
        edges: dict[tuple[str, str], tuple] = {}

        def add_edge(a: str, b: str, f: FuncNode, node) -> None:
            edges.setdefault((a, b), (f.module, node, f.short()))

        for f in model.funcs:
            for lk, held, node in f.acquires:
                eff = _eff_held(f, held)
                for a in eff:
                    if a == lk.name:
                        if lk.kind not in _REENTRANT_KINDS:
                            fnd = f.module.finding(
                                self.rule_id, node,
                                f"non-reentrant lock {lk.name} re-acquired "
                                f"while already held in {f.short()} — "
                                "immediate self-deadlock; use an RLock or "
                                "split the *_locked helper out",
                            )
                            if fnd:
                                findings.append(fnd)
                        continue
                    add_edge(a, lk.name, f, node)
            for g, held, node in model.edges.get(f, ()):
                eff = _eff_held(f, held)
                if not eff:
                    continue
                for a in eff:
                    for b in g.trans_locks:
                        if b == a:
                            lk = model.locks_by_name.get(b)
                            if lk is not None and \
                                    lk.kind not in _REENTRANT_KINDS:
                                fnd = f.module.finding(
                                    self.rule_id, node,
                                    f"non-reentrant lock {b} re-acquired "
                                    f"via call chain through {g.short()} "
                                    f"while held in {f.short()} — "
                                    "self-deadlock",
                                )
                                if fnd:
                                    findings.append(fnd)
                            continue
                        add_edge(a, b, f, node)

        findings.extend(self._cycles(edges))
        return findings

    def _cycles(self, edges: dict) -> list[Finding]:
        graph: dict[str, set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
        findings, seen = [], set()
        for start in sorted(graph):
            path: list[str] = []
            on_path: set[str] = set()

            def dfs(n: str) -> list[str] | None:
                if n in on_path:
                    return path[path.index(n):] + [n]
                if n not in graph:
                    return None
                path.append(n)
                on_path.add(n)
                for nxt in sorted(graph[n]):
                    cyc = dfs(nxt)
                    if cyc:
                        return cyc
                path.pop()
                on_path.discard(n)
                return None

            cycle = dfs(start)
            if not cycle:
                continue
            key = frozenset(cycle)
            if key in seen:
                continue
            seen.add(key)
            pairs = list(zip(cycle, cycle[1:]))
            sites = "; ".join(
                f"{a} -> {b} at {edges[(a, b)][0].rel_path}:"
                f"{edges[(a, b)][1].lineno} (in {edges[(a, b)][2]})"
                for a, b in pairs if (a, b) in edges
            )
            module, node, _ = edges[pairs[0]]
            fnd = module.finding(
                self.rule_id, node,
                "potential deadlock: lock-order cycle "
                + " -> ".join(cycle) + f"; {sites} — pick one global "
                "order or drop the nested acquire",
            )
            if fnd:
                findings.append(fnd)
        return findings


@register
class UnguardedSharedRule(Rule):
    rule_id = "unguarded-shared"
    doc = ("field written under a lock but read/written from a Thread "
           "target / timer / executor closure without that lock")
    project_wide = True

    def check_project(self, project: ProjectContext) -> list[Finding]:
        model = ConcurrencyModel.of(project)
        guards: dict[tuple[str, str], set[str]] = {}
        declared_locks = {name for name, lk in model.locks_by_name.items()
                          if lk.guards is not None}
        # declarations pin a lock's guarded set exactly
        for name, lk in model.locks_by_name.items():
            if lk.guards is None or lk.cls is None:
                continue
            root = model.family_root(lk.cls)
            for fld in lk.guards:
                guards.setdefault((root, fld), set()).add(name)
        # inference: a write under a lock of the same class family
        for f in model.funcs:
            if f.cls is None:
                continue
            for cls, attr, rw, held, _node in f.accesses:
                if rw != "write":
                    continue
                eff = _eff_held(f, held)
                root = model.family_root(cls)
                for ln in eff:
                    lk = model.locks_by_name.get(ln)
                    if lk is None or ln in declared_locks:
                        continue
                    if lk.cls is None or \
                            model.family_root(lk.cls) != root:
                        continue
                    guards.setdefault((root, attr), set()).add(ln)
        lock_attrs = {lk.attr for lk in model.locks_by_name.values()}
        findings, reported = [], set()
        for f in sorted(model.thread_ctx, key=lambda x: x.qual):
            if f.cls is None:
                continue
            for cls, attr, rw, held, node in f.accesses:
                if attr in lock_attrs:
                    continue
                key = (model.family_root(cls), attr)
                need = guards.get(key)
                if not need:
                    continue
                if _eff_held(f, held) & need:
                    continue
                if (f.qual, key) in reported:
                    continue
                reported.add((f.qual, key))
                fnd = f.module.finding(
                    self.rule_id, node,
                    f"field {attr!r} of {cls} is guarded by "
                    f"{'/'.join(sorted(need))} elsewhere but "
                    f"{'written' if rw == 'write' else 'read'} without it "
                    f"in {f.short()}, which runs on a background thread — "
                    "take the lock, or declare the lock's true guarded "
                    "set with # graftlint: guards(...) on its assignment",
                )
                if fnd:
                    findings.append(fnd)
        return findings


@register
class BlockingUnderLockRule(Rule):
    rule_id = "blocking-under-lock"
    doc = ("urlopen/socket/subprocess/sleep/torch.cuda.synchronize/"
           "Event|Stream.synchronize/.item()/.cpu()/file-I/O reachable "
           "while a lock is held")
    project_wide = True

    def check_project(self, project: ProjectContext) -> list[Finding]:
        model = ConcurrencyModel.of(project)
        findings, reported = [], set()
        for f in model.funcs:
            for label, held, node in f.blocking:
                eff = _eff_held(f, held)
                if not eff or (f.qual, node.lineno) in reported:
                    continue
                reported.add((f.qual, node.lineno))
                fnd = f.module.finding(
                    self.rule_id, node,
                    f"blocking {label} while holding "
                    f"{'/'.join(sorted(eff))} in {f.short()} — every "
                    "waiter on the lock pays this wait; move it outside "
                    "the critical section or allowlist the site with "
                    "# graftlint: ok(blocking-under-lock: reason)",
                )
                if fnd:
                    findings.append(fnd)
            for g, held, node in model.edges.get(f, ()):
                if not held or not g.trans_blocking:
                    continue
                if (f.qual, node.lineno) in reported:
                    continue
                reported.add((f.qual, node.lineno))
                label, via = next(iter(sorted(g.trans_blocking.items())))
                locks = "/".join(sorted(lk.name for lk in held))
                fnd = f.module.finding(
                    self.rule_id, node,
                    f"call to {g.short()} while holding {locks} reaches "
                    f"blocking {label} ({via}) — hoist the blocking work "
                    "out of the critical section or allowlist with "
                    "# graftlint: ok(blocking-under-lock: reason)",
                )
                if fnd:
                    findings.append(fnd)
        return findings


@register
class ThreadHygieneRule(Rule):
    rule_id = "thread-hygiene"
    doc = ("non-daemon threads never joined; Condition.wait without a "
           "predicate loop; current_ctx() inside a thread-entry closure")
    project_wide = True

    def check_project(self, project: ProjectContext) -> list[Finding]:
        model = ConcurrencyModel.of(project)
        findings: list[Finding] = []
        for f in model.funcs:
            findings.extend(self._spawns(model, f))
            for lk, in_while, node in f.waits:
                if in_while:
                    continue
                fnd = f.module.finding(
                    self.rule_id, node,
                    f"{lk.name}.wait() outside a predicate loop in "
                    f"{f.short()} — spurious wakeups and missed notifies "
                    "are legal; use `while not pred: cond.wait()` or "
                    "wait_for()",
                )
                if fnd:
                    findings.append(fnd)
            if f.is_thread_target:
                for node in f.ctx_calls:
                    fnd = f.module.finding(
                        self.rule_id, node,
                        f"current_ctx() inside thread-entry {f.short()} "
                        "reads the NEW thread's empty context — capture "
                        "ctx = current_ctx() on the submitting thread "
                        "before the def (fleet/residency.py prefetch "
                        "idiom) and pass it in",
                    )
                    if fnd:
                        findings.append(fnd)
        return findings

    def _spawns(self, model: ConcurrencyModel, f: FuncNode) -> list[Finding]:
        out = []
        rel = f.module.rel_path
        joins = model.joins.get(rel, set())
        daemon_later = model.daemon_later.get(rel, set())
        for node, daemon, _bind in f.spawns:
            if daemon:
                continue
            bind = self._binding(f, node)
            if bind is not None and (bind in joins
                                     or bind in daemon_later):
                continue
            fnd = f.module.finding(
                self.rule_id, node,
                f"non-daemon Thread in {f.short()} is never joined — it "
                "outlives shutdown and blocks interpreter exit; pass "
                "daemon=True or join it on the close path",
            )
            if fnd:
                out.append(fnd)
        return out

    def _binding(self, f: FuncNode, call: ast.Call) -> tuple | None:
        """The name/attr chain the Thread was assigned to, if any."""
        for sub in ast.walk(f.node):
            if isinstance(sub, ast.Assign) and sub.value is call:
                for tgt in sub.targets:
                    chain = _attr_chain(tgt)
                    if chain:
                        return tuple(chain)
        return None
