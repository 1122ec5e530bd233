"""Config-driven plugin registry (port of ``nerf_replication_tpu/registry.py``).

The YAML names one module per role (``*_module`` keys). Configs written for
the JAX package name ``nerf_replication_tpu.*`` modules, and reference-style
configs name ``src.*`` modules; both resolve here to the PyTorch port's
module at the same relative path, so one config file drives either package.
A role whose module the port does not have yet raises ``ImportError`` naming
the port module it looked for.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any

_PKG = "nerf_replication_tpu_torch"
_JAX_PKG = "nerf_replication_tpu"

# the reference repo's module names, as the JAX package aliases them
_ALIASES: dict[str, str] = {
    "src.datasets.nerf.blender": f"{_PKG}.datasets.blender",
    "src.datasets.img_fit.synthetic": f"{_PKG}.datasets.img_fit",
    "src.datasets.latent": f"{_PKG}.datasets.latent",
    "src.datasets.light_stage": f"{_PKG}.datasets.light_stage",
    "src.models.nerf.network": f"{_PKG}.models.nerf.network",
    "src.models.img_fit.network": f"{_PKG}.models.img_fit.network",
    "src.models.nerf.renderer.volume_renderer": f"{_PKG}.renderer.volume",
    "src.models.nerf.renderer.make_renderer": f"{_PKG}.renderer",
    "src.train.trainers.nerf": f"{_PKG}.train.loss",
    "src.train.losses.img_fit": f"{_PKG}.train.loss_img_fit",
    "src.evaluators.nerf": f"{_PKG}.evaluators.nerf",
    "src.evaluators.img_fit": f"{_PKG}.evaluators.img_fit",
}


def port_module_name(name: str) -> str:
    """The port's dotted module name for a config's module string."""
    if name in _ALIASES:
        return _ALIASES[name]
    if name == _JAX_PKG or name.startswith(_JAX_PKG + "."):
        return _PKG + name[len(_JAX_PKG):]
    if name.startswith("src."):
        return _PKG + name[len("src"):]
    return name


def resolve_module(name: str) -> ModuleType:
    """Import the port module a ``*_module`` config string names."""
    target = port_module_name(name)
    try:
        return importlib.import_module(target)
    except ModuleNotFoundError as e:
        raise ImportError(
            f"Cannot resolve plugin module {name!r}: the PyTorch port has no "
            f"module {target!r} yet"
        ) from e


def load_attr(module_name: str, attr: str, *fallbacks: str) -> Any:
    """Load ``attr`` (or the first present fallback) from a plugin module."""
    mod = resolve_module(module_name)
    for candidate in (attr, *fallbacks):
        if hasattr(mod, candidate):
            return getattr(mod, candidate)
    raise AttributeError(
        f"Plugin module {module_name!r} defines none of {(attr, *fallbacks)}"
    )
