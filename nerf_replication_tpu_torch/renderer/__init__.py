"""Renderer factory: resolves the ``renderer_module`` plugin key."""

from __future__ import annotations

from ..registry import load_attr


def make_renderer(cfg, network):
    factory = load_attr(cfg.renderer_module, "make_renderer", "Renderer")
    return factory(cfg, network)
