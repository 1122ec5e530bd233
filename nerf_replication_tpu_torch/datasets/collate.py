"""Named-collator registry (port of
``nerf_replication_tpu/datasets/collate.py``).

A dict of task-name → collator falling back to ``default_collate``, which
stacks numpy leaves and passes ``meta`` dicts through as a list.
"""

from __future__ import annotations

import numpy as np

_collators: dict = {}


def register_collator(name: str):
    def deco(fn):
        _collators[name] = fn
        return fn

    return deco


def default_collate(items: list):
    """List of per-item dicts → one batch dict with stacked array leaves."""
    if not items:
        return {}
    first = items[0]
    if not isinstance(first, dict):
        return np.stack([np.asarray(x) for x in items], 0)
    out = {}
    for key in first:
        vals = [it[key] for it in items]
        if key == "meta" or isinstance(first[key], dict):
            # ALWAYS a list — a batch-size-dependent type fork (dict when 1,
            # list when >1) makes consumers fragile
            out[key] = vals
        elif np.isscalar(first[key]) or getattr(first[key], "ndim", 1) == 0:
            out[key] = np.asarray(vals)
        else:
            out[key] = np.stack([np.asarray(v) for v in vals], 0)
    return out


def make_collator(cfg, split: str = "train"):
    node = cfg.train if split == "train" else cfg.test
    name = str(node.get("collator", "default"))
    if name in ("", "default"):
        return default_collate
    if name not in _collators:
        raise KeyError(
            f"unknown collator {name!r}; registered: {sorted(_collators)}"
        )
    return _collators[name]
