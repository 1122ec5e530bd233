"""Attribute-style nested configuration node (the port's copy of
``nerf_replication_tpu/config/node.py``).

Plays the role of the reference's vendored yacs (`src/config/yacs.py`): a dict
subclass with attribute access, deep typed merges, immutability, and YAML
round-tripping. Written from scratch and intentionally small — the semantics we
preserve are the ones the reference's configs actually rely on:

* nested attribute access (``cfg.train.lr``),
* deep merge where dicts merge recursively and scalars overwrite,
* type coercion on merge (int→float promotion, str↔number rejection),
* ``merge_from_list`` for trailing CLI ``opts`` overrides,
* ``freeze()`` so a config can be treated as a constant.

New keys are allowed by default (the reference sets ``new_allowed`` implicitly
by merging arbitrary YAML into the template defaults).
"""

from __future__ import annotations

import copy
from typing import Any, Iterable

import yaml

_FROZEN = "__frozen__"


class ConfigNode(dict):
    """A dict with attribute access and controlled deep merging."""

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = _wrap(v)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"Config has no key {name!r}; available: {sorted(self.keys())}"
            ) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if self.is_frozen():
            raise AttributeError(f"Cannot set {name!r} on a frozen ConfigNode")
        self[name] = _wrap(value)

    def __setitem__(self, key, value):
        if self.is_frozen():
            raise AttributeError(f"Cannot set {key!r} on a frozen ConfigNode")
        super().__setitem__(key, _wrap(value))

    def __delattr__(self, name: str) -> None:
        del self[name]

    def __delitem__(self, key) -> None:
        if self.is_frozen():
            raise AttributeError(f"Cannot delete {key!r} on a frozen ConfigNode")
        super().__delitem__(key)

    # dict's C-level mutators bypass __setitem__; route them through it so
    # freeze and _wrap hold for every mutation path.
    def update(self, other=(), **kw):  # type: ignore[override]
        items = other.items() if isinstance(other, dict) else other
        for k, v in items:
            self[k] = v
        for k, v in kw.items():
            self[k] = v

    def setdefault(self, key, default=None):  # type: ignore[override]
        if key not in self:
            self[key] = default
        return self[key]

    def pop(self, key, *default):  # type: ignore[override]
        if self.is_frozen():
            raise AttributeError(f"Cannot pop {key!r} from a frozen ConfigNode")
        return super().pop(key, *default)

    def popitem(self):  # type: ignore[override]
        if self.is_frozen():
            raise AttributeError("Cannot popitem from a frozen ConfigNode")
        return super().popitem()

    def clear(self):  # type: ignore[override]
        if self.is_frozen():
            raise AttributeError("Cannot clear a frozen ConfigNode")
        super().clear()

    # -- freeze -------------------------------------------------------------
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, _FROZEN)

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, _FROZEN, False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    # -- merge --------------------------------------------------------------
    def merge(self, other: dict) -> "ConfigNode":
        """Deep-merge ``other`` into self (other wins)."""
        if self.is_frozen():
            raise AttributeError("Cannot merge into a frozen ConfigNode")
        for key, new in other.items():
            if (
                key in self
                and isinstance(self[key], ConfigNode)
                and isinstance(new, dict)
            ):
                self[key].merge(new)
            elif key in self:
                self[key] = _coerce(new, self[key], key)
            else:
                self[key] = _wrap(copy.deepcopy(new))
        return self

    def merge_from_file(self, path: str) -> "ConfigNode":
        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
        return self.merge(data)

    def merge_from_list(self, opts: Iterable[Any]) -> "ConfigNode":
        """Merge ``[key1, v1, key2, v2, ...]`` with dotted keys.

        Values may be python-literal strings (``"1e-3"``, ``"[1,2]"``,
        ``"True"``) which are YAML-parsed, mirroring the reference CLI
        ``opts`` behavior.
        """
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError(f"opts must be key/value pairs, got {opts}")
        for key, raw in zip(opts[0::2], opts[1::2]):
            value = _parse_literal(raw) if isinstance(raw, str) else raw
            node = self
            parts = str(key).split(".")
            for i, p in enumerate(parts[:-1]):
                if p in node and not isinstance(node[p], ConfigNode):
                    raise TypeError(
                        f"Key {'.'.join(parts[: i + 1])!r} is a scalar; cannot "
                        f"descend into it for override {key!r}"
                    )
                if p not in node:
                    node[p] = ConfigNode()
                node = node[p]
            leaf = parts[-1]
            if leaf in node:
                node[leaf] = _coerce(value, node[leaf], key)
            else:
                node[leaf] = _wrap(value)
        return self

    # -- export -------------------------------------------------------------
    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    def clone(self) -> "ConfigNode":
        return ConfigNode(self.to_dict())

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def __deepcopy__(self, memo):
        return ConfigNode(self.to_dict())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ConfigNode({dict.__repr__(self)})"


def _parse_literal(raw: str) -> Any:
    """Parse a CLI value string: YAML first, then bare-float forms like 1e-3
    that YAML 1.1 treats as strings."""
    value = yaml.safe_load(raw)
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, dict):
        return ConfigNode(value)
    return value


_NUMERIC = (int, float)


def _coerce(new: Any, old: Any, key: str) -> Any:
    """Type-checked replacement mirroring yacs' merge coercion rules."""
    if old is None or new is None:
        return _wrap(new)
    if isinstance(old, ConfigNode) and isinstance(new, dict):
        node = old.clone()
        node.merge(new)
        return node
    # Replacing a whole subtree with a scalar (or vice versa) is an error.
    if isinstance(old, ConfigNode) != isinstance(new, dict):
        raise TypeError(
            f"Cannot merge {type(new).__name__} into {type(old).__name__} "
            f"for key {key!r}"
        )
    if isinstance(old, bool) != isinstance(new, bool):
        # bool is an int subclass; 1 -> True style coercion is allowed only
        # when the template value is bool (the reference's `white_bkgd: 1`).
        if isinstance(old, bool) and isinstance(new, int):
            return bool(new)
        raise TypeError(f"Cannot merge bool/non-bool for key {key!r}")
    if isinstance(old, _NUMERIC) and isinstance(new, _NUMERIC):
        if isinstance(old, float):
            return float(new)  # int → float promotion
        if isinstance(new, float):
            raise TypeError(
                f"Cannot merge float {new!r} into int-typed key {key!r}"
            )
        return new
    if type(old) is not type(new) and not (
        isinstance(old, (list, tuple)) and isinstance(new, (list, tuple))
    ):
        raise TypeError(
            f"Type mismatch for key {key!r}: {type(old).__name__} vs "
            f"{type(new).__name__}"
        )
    return _wrap(copy.deepcopy(new))
