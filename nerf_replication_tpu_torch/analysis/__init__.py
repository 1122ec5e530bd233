"""graftlint for torch code: static analysis + runtime sanitizers (port of
``nerf_replication_tpu/analysis``).

An AST engine (``core``) runs the JAX package's rule ids over the port:
R1-R9 (``rules``: host-sync, retrace, donate, rng, side-effect,
config-key, aot, swallow, emit-hot), each re-aimed at the torch hazard
that takes the JAX one's place — "traced" becomes "captured" (a callable
handed to ``AOTRegistry.register`` or a ``torch.cuda.graph`` body), and a
device read, a capture built per call, a side effect that runs once at
capture, a hard-wired seed or a graph outside the registry are what they
look for. ``concurrency`` builds the module-spanning lock model + call
graph of R10-R13 (lock-order, unguarded-shared, blocking-under-lock,
thread-hygiene), with torch's synchronizing calls among the blocking
ones. Findings are gated through a committed baseline
(``baseline``, ``analysis/graftlint_baseline.json``) so only NEW hazards
fail. ``python -m nerf_replication_tpu_torch.tools.graftlint`` is the CLI.

The runtime half is ``sanitizer``: :func:`sanitizer` (zero compiles over
a region, and torch's sync debug mode armed for it) and
:class:`LockOrderRecorder` (the observed per-thread lock-acquisition DAG,
the dynamic witness of what R10 claims statically). The engine imports
neither torch nor JAX; only ``sanitizer`` imports torch, lazily.

Suppressions are the JAX package's: ``# graftlint: ok(rule: reason)``,
``# graftlint: hot``, ``# graftlint: skip-file``. README.md ("graftlint
for the port") has the rule table and the baseline workflow.
"""

from .baseline import (
    BASELINE_FILENAME,
    diff_baseline,
    load_baseline,
    save_baseline,
    to_baseline,
    validate_baseline_data,
)
from .core import (
    CONCURRENCY_RULE_IDS,
    DEFAULT_SCAN,
    RULE_IDS,
    RULES,
    Finding,
    lint_paths,
    lint_source,
)
from .reporters import render_json, render_text, rule_counts
from .sanitizer import (
    LockOrderError,
    LockOrderRecorder,
    SanitizerError,
    SanitizerProbe,
    sanitizer,
)

__all__ = [
    "BASELINE_FILENAME",
    "CONCURRENCY_RULE_IDS",
    "DEFAULT_SCAN",
    "Finding",
    "LockOrderError",
    "LockOrderRecorder",
    "RULES",
    "RULE_IDS",
    "SanitizerError",
    "SanitizerProbe",
    "diff_baseline",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "render_json",
    "render_text",
    "rule_counts",
    "sanitizer",
    "save_baseline",
    "to_baseline",
    "validate_baseline_data",
]
