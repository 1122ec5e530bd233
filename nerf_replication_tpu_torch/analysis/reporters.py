"""Finding reporters: human text and machine JSON (the CLI's --format;
port of ``nerf_replication_tpu/analysis/reporters.py``)."""

from __future__ import annotations

import json
from collections import Counter

from .core import RULES, Finding


def rule_counts(findings: list[Finding]) -> dict[str, int]:
    return dict(Counter(f.rule for f in findings))


def render_text(
    new: list[Finding],
    accepted: list[Finding],
    n_fixed: int = 0,
    errors: list[str] | None = None,
) -> str:
    lines: list[str] = []
    for f in new:
        lines.append(f"{f.location()}: [{f.rule}] {f.message}")
        if f.snippet:
            lines.append(f"    {f.snippet}")
    for e in errors or ():
        lines.append(f"error: {e}")
    counts = rule_counts(new)
    summary = ", ".join(f"{r}:{n}" for r, n in sorted(counts.items()))
    lines.append(
        f"graftlint: {len(new)} new finding(s)"
        + (f" ({summary})" if summary else "")
        + f", {len(accepted)} baselined"
        + (f", {n_fixed} baseline entr(ies) no longer observed" if n_fixed else "")
    )
    if n_fixed:
        lines.append(
            "    (fixed or moved — regenerate with --write-baseline to "
            "commit the shrink)"
        )
    return "\n".join(lines)


def render_json(
    new: list[Finding],
    accepted: list[Finding],
    n_fixed: int = 0,
    errors: list[str] | None = None,
    duration_s: float | None = None,
    rule_times_s: dict | None = None,
) -> str:
    def row(f: Finding) -> dict:
        return {
            "rule": f.rule,
            "path": f.path.replace("\\", "/"),
            "line": f.line,
            "col": f.col,
            "message": f.message,
            "snippet": f.snippet,
        }

    return json.dumps(
        {
            "tool": "graftlint",
            "version": 1,
            "rules": {rid: r.doc for rid, r in sorted(RULES.items())},
            "new": [row(f) for f in new],
            "baselined": [row(f) for f in accepted],
            "n_new": len(new),
            "n_baselined": len(accepted),
            "n_fixed": n_fixed,
            "rule_counts": rule_counts(new + accepted),
            "new_rule_counts": rule_counts(new),
            "errors": list(errors or ()),
            "duration_s": duration_s,
            "rule_times_s": {
                r: round(t, 4) for r, t in (rule_times_s or {}).items()
            },
        },
        indent=1,
        sort_keys=True,
    )
