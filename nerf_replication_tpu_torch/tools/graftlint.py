"""graftlint CLI for the port: the torch-aware static-analysis gate (port of
``scripts/graftlint.py``).

    python -m nerf_replication_tpu_torch.tools.graftlint           # full scan
    python -m nerf_replication_tpu_torch.tools.graftlint nerf_replication_tpu_torch/serve
    python -m nerf_replication_tpu_torch.tools.graftlint --format json
    python -m nerf_replication_tpu_torch.tools.graftlint --changed main
    python -m nerf_replication_tpu_torch.tools.graftlint --write-baseline
    python -m nerf_replication_tpu_torch.tools.graftlint --no-baseline

The full scan is the port package and ``chip_smoke.py``. ``--changed
[BASE]`` lints only the ``.py`` files of that scan that ``git diff
--name-only BASE`` reports (default base ``HEAD``); the project-wide rules
(R6, R10-R13) then see only the changed files, so the full scan remains
the authority on cross-module findings.

Exit code is nonzero exactly when there are NEW findings — ones absent
from the committed ``nerf_replication_tpu_torch/analysis/
graftlint_baseline.json`` — or files that failed to parse. Every run
appends one schema-valid ``lint_run`` row (obs/schema.py) through the
port's emitter to ``logs/graftlint_torch/telemetry.jsonl``
(``--telemetry`` to redirect, ``--no-telemetry`` to skip). Host-only: the
engine imports neither torch nor JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..analysis import (
    BASELINE_FILENAME,
    DEFAULT_SCAN,
    diff_baseline,
    lint_paths,
    load_baseline,
    render_json,
    render_text,
    rule_counts,
    save_baseline,
)
from ..analysis.core import iter_py_files

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join("nerf_replication_tpu_torch", "analysis",
                                BASELINE_FILENAME)
DEFAULT_TELEMETRY = os.path.join("logs", "graftlint_torch", "telemetry.jsonl")


def emit_lint_run(path: str, *, n_findings: int, n_new: int, n_baselined: int,
                  duration_s: float, counts: dict, n_files: int,
                  exit_code: int, baseline_path: str,
                  rule_times_s: dict | None = None,
                  new_rule_counts: dict | None = None) -> None:
    from ..obs.emit import Emitter

    emitter = Emitter(path, chief=True)
    try:
        emitter.emit(
            "lint_run",
            n_findings=n_findings,
            n_new=n_new,
            n_baselined=n_baselined,
            duration_s=duration_s,
            rule_counts=counts,
            n_files=n_files,
            exit_code=exit_code,
            baseline_path=baseline_path,
            rule_times_s={r: round(t, 4)
                          for r, t in (rule_times_s or {}).items()},
            new_rule_counts=dict(new_rule_counts or {}),
        )
    finally:
        emitter.close()


def changed_paths(base: str, repo_root: str) -> list[str]:
    """Absolute paths of changed ``.py`` files inside the default scan
    set, per ``git diff --name-only --diff-filter=d BASE``."""
    import subprocess

    proc = subprocess.run(
        ["git", "diff", "--name-only", "--diff-filter=d", base],
        capture_output=True, text=True, cwd=repo_root, timeout=30,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"git diff --name-only {base} failed: {proc.stderr.strip()}"
        )
    scan_roots = tuple(
        p if p.endswith(".py") else p + "/" for p in DEFAULT_SCAN
    )
    out = []
    for rel in proc.stdout.splitlines():
        rel = rel.strip()
        if not rel.endswith(".py"):
            continue
        if not any(rel == r or rel.startswith(r) for r in scan_roots):
            continue
        path = os.path.join(repo_root, rel)
        if os.path.exists(path):
            out.append(path)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="torch-aware static analysis gate of the port (rules "
                    "R1-R13; README, 'graftlint for the port')"
    )
    p.add_argument(
        "paths", nargs="*",
        help="files/dirs to lint (default: the port package + "
             "chip_smoke.py)",
    )
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument(
        "--baseline", default=None, metavar="FILE",
        help=f"baseline file (default: <repo>/{DEFAULT_BASELINE})",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline: every finding is new (and fails)",
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="accept the current findings as the new baseline and exit 0",
    )
    p.add_argument(
        "--rules", default=None, metavar="R1,R2",
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--telemetry", default=None, metavar="JSONL",
        help=f"lint_run telemetry sink (default: <repo>/{DEFAULT_TELEMETRY})",
    )
    p.add_argument("--no-telemetry", action="store_true")
    p.add_argument(
        "--changed", nargs="?", const="HEAD", default=None, metavar="BASE",
        help="lint only changed .py files (git diff --name-only BASE; "
             "BASE defaults to HEAD)",
    )
    args = p.parse_args(argv)

    if args.changed is not None and args.write_baseline:
        p.error("--write-baseline needs a full scan; a --changed baseline "
                "would silently drop every finding outside the diff")

    t0 = time.perf_counter()
    if args.changed is not None:
        scan = changed_paths(args.changed, _REPO)
        if not scan:
            print(f"graftlint: no changed .py files vs {args.changed}")
            return 0
    else:
        scan = args.paths or [
            os.path.join(_REPO, p) for p in DEFAULT_SCAN
        ]
    rules = tuple(r.strip() for r in args.rules.split(",")) if args.rules \
        else None
    timings: dict[str, float] = {}
    findings, errors = lint_paths(scan, repo_root=_REPO, rules=rules,
                                  timings=timings)

    baseline_path = args.baseline or os.path.join(_REPO, DEFAULT_BASELINE)
    if args.write_baseline:
        save_baseline(baseline_path, findings)
        print(
            f"wrote {len(findings)} finding(s) to {baseline_path}"
        )
        return 0

    baseline: set = set()
    if not args.no_baseline and os.path.exists(baseline_path):
        baseline = load_baseline(baseline_path)
    new, accepted, n_fixed = diff_baseline(findings, baseline)
    if args.changed is not None:
        n_fixed = 0  # a partial scan not observing an entry proves nothing
    duration = time.perf_counter() - t0
    exit_code = 1 if (new or errors) else 0

    if args.format == "json":
        print(render_json(new, accepted, n_fixed, errors=errors,
                          duration_s=duration, rule_times_s=timings))
    else:
        print(render_text(new, accepted, n_fixed, errors=errors))
        print(f"graftlint: {len(iter_py_files(scan))} file(s), "
              f"{len(findings)} finding(s) in {duration:.2f} s")

    if not args.no_telemetry:
        telem = args.telemetry or os.path.join(_REPO, DEFAULT_TELEMETRY)
        try:
            emit_lint_run(
                telem,
                n_findings=len(findings),
                n_new=len(new),
                n_baselined=len(accepted),
                duration_s=duration,
                counts=rule_counts(findings),
                n_files=len({f.path for f in findings}) if findings else 0,
                exit_code=exit_code,
                baseline_path=os.path.relpath(baseline_path, _REPO),
                rule_times_s=timings,
                new_rule_counts=rule_counts(new),
            )
        except OSError as e:  # telemetry must never break the gate
            print(f"warning: lint_run telemetry not written: {e}",
                  file=sys.stderr)

    return exit_code


if __name__ == "__main__":
    raise SystemExit(main())
