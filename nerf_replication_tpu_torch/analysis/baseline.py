"""Baseline workflow: accepted legacy findings, diffed on every run (port
of ``nerf_replication_tpu/analysis/baseline.py``: the same schema).

The gate (``python -m nerf_replication_tpu_torch.tools.graftlint``, and
tests/test_torch_analysis_cli.py) fails only on findings NOT in the
committed ``nerf_replication_tpu_torch/analysis/graftlint_baseline.json``
— accepted legacy findings ride there until someone fixes them, while
any NEW hazard fails review immediately. Fixing a baselined finding
shrinks the baseline (``--write-baseline`` regenerates it; the diff shows
the shrink).

A finding's identity deliberately excludes the line number: it is
``(rule, path, stripped source line, occurrence index)``, so unrelated
edits shifting a file don't churn the baseline, while touching the flagged
line itself (you're editing the hazard — re-judge it) or adding another
identical hazard does.

File schema (:func:`validate_baseline_data`)::

    {"version": 1, "tool": "graftlint",
     "findings": [{"rule": ..., "path": ..., "snippet": ..., "index": 0,
                   "line": 123, "message": ...}, ...]}

``line``/``message`` are informational; only the identity fields match.
"""

from __future__ import annotations

import json
from collections import Counter

from .core import Finding

BASELINE_VERSION = 1
BASELINE_FILENAME = "graftlint_baseline.json"

_IDENTITY_FIELDS = ("rule", "path", "snippet", "index")


def fingerprints(findings: list[Finding]) -> list[tuple[Finding, tuple]]:
    """Pair each finding with its identity tuple; identical (rule, path,
    snippet) occurrences are disambiguated by order of appearance."""
    seen: Counter = Counter()
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        base = (f.rule, f.path.replace("\\", "/"), f.snippet)
        out.append((f, base + (seen[base],)))
        seen[base] += 1
    return out


def to_baseline(findings: list[Finding]) -> dict:
    rows = []
    for f, fp in fingerprints(findings):
        rows.append(
            {
                "rule": fp[0],
                "path": fp[1],
                "snippet": fp[2],
                "index": fp[3],
                "line": f.line,
                "message": f.message,
            }
        )
    return {"version": BASELINE_VERSION, "tool": "graftlint", "findings": rows}


def save_baseline(path: str, findings: list[Finding]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(to_baseline(findings), fh, indent=1, sort_keys=True)
        fh.write("\n")


def load_baseline(path: str) -> set[tuple]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    errors = validate_baseline_data(data)
    if errors:
        raise ValueError(f"{path}: " + "; ".join(errors[:3]))
    return {
        tuple(row[k] for k in _IDENTITY_FIELDS) for row in data["findings"]
    }


def diff_baseline(
    findings: list[Finding], baseline: set[tuple]
) -> tuple[list[Finding], list[Finding], int]:
    """``(new, accepted, n_fixed)`` — findings not in / in the baseline,
    and the count of baseline entries no longer observed (fixed or moved:
    the shrink ``--write-baseline`` would commit)."""
    new: list[Finding] = []
    accepted: list[Finding] = []
    observed: set[tuple] = set()
    for f, fp in fingerprints(findings):
        observed.add(fp)
        (accepted if fp in baseline else new).append(f)
    return new, accepted, len(baseline - observed)


def validate_baseline_data(data) -> list[str]:
    """Structural errors for a parsed baseline file (empty = valid).
    Mirrors obs/schema.py's validate_* contract so the schema checker can
    gate the committed file."""
    if not isinstance(data, dict):
        return [f"baseline is {type(data).__name__}, not an object"]
    errors: list[str] = []
    v = data.get("version")
    if not isinstance(v, int):
        errors.append("missing/non-int field 'version'")
    elif v > BASELINE_VERSION:
        errors.append(f"baseline version {v} is newer than {BASELINE_VERSION}")
    if data.get("tool") != "graftlint":
        errors.append("field 'tool' must be 'graftlint'")
    rows = data.get("findings")
    if not isinstance(rows, list):
        return errors + ["missing/non-list field 'findings'"]
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            errors.append(f"findings[{i}]: not an object")
            continue
        for k in _IDENTITY_FIELDS:
            if k not in row:
                errors.append(f"findings[{i}]: missing field {k!r}")
            elif k == "index" and not isinstance(row[k], int):
                errors.append(f"findings[{i}]: field 'index' is not an int")
            elif k != "index" and not isinstance(row[k], str):
                errors.append(f"findings[{i}]: field {k!r} is not a string")
        if len(errors) > 10:
            errors.append("... (truncated)")
            break
    return errors
