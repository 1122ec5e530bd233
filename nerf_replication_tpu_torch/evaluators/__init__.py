"""Evaluator factory: resolves the ``evaluator_module`` plugin key
(port of ``nerf_replication_tpu/evaluators/__init__.py``)."""

from __future__ import annotations

from ..registry import load_attr


def make_evaluator(cfg):
    factory = load_attr(cfg.evaluator_module, "make_evaluator", "Evaluator")
    return factory(cfg)
