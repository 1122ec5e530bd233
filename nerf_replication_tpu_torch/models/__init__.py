"""Network factory: resolves the ``network_module`` plugin key."""

from __future__ import annotations

from ..registry import load_attr


def make_network(cfg):
    factory = load_attr(cfg.network_module, "make_network", "Network")
    return factory(cfg)


def init_params_for(cfg):
    """The network plugin's ``init_params``; defaults to the NeRF one."""
    try:
        return load_attr(cfg.network_module, "init_params")
    except (AttributeError, ImportError):
        from .nerf.network import init_params

        return init_params
