"""Whole-image render gate and the baked-bounds check (port of
``nerf_replication_tpu/renderer/gate.py``).

``full_image_render_fn`` is the one factory every whole-image surface uses
(in-training validation, eval, the sharded video). One process: the
renderer's chunked render, and with ``use_grid`` its occupancy-accelerated
march (``Renderer.render_accelerated``, a grid already loaded), both
honouring each batch's near/far. ``eval.sharded`` in a process group of
several ranks: the sequence-parallel renderer or per-ray march
(``parallel/sequence.py``) over the ranks, every rank rendering its slice of
each image and all-gathering the result; their near/far are baked from the
test set, so a batch with other bounds raises :class:`BakedBoundsError`.
The returned ``render`` carries ``mesh`` (None: one process) and, sharded,
``surface`` (what ``parallel.sequence.aot_register_sequence_renderer`` /
``_march`` capture).
"""

from __future__ import annotations

import numpy as np


class BakedBoundsError(ValueError):
    """A render surface with baked near/far received other bounds."""


def check_baked_bounds(baked_near, baked_far, near, far,
                       surface: str = "render gate") -> None:
    """Reject a near/far pair that differs from the baked ones (both sides
    compared after rounding to float32, as requests carry float32)."""
    bn, bf = float(np.float32(baked_near)), float(np.float32(baked_far))
    rn, rf = float(np.float32(near)), float(np.float32(far))
    if bn != rn or bf != rf:
        raise BakedBoundsError(
            f"{surface}: baked bounds near={bn:g} far={bf:g} do not match "
            f"the requested bounds near={rn:g} far={rf:g} — rebuild the "
            "render surface for the new bounds, or fix the batch"
        )


def full_image_render_fn(cfg, network, renderer, test_ds, use_grid=False):
    """``render(batch) -> out`` for whole test images (``batch`` holds
    ``rays`` on the renderer's device, ``near`` and ``far``). ``use_grid``
    selects the occupancy-accelerated march."""
    import torch

    from ..parallel.mesh import make_mesh_from_cfg

    mesh = None
    if bool(cfg.get("eval", {}).get("sharded", False)):
        mesh = make_mesh_from_cfg(cfg, device=renderer._device())
    if mesh is None:
        whole = renderer.render_accelerated if use_grid else \
            renderer.render_chunked

        def render(batch):
            with torch.no_grad():
                return whole(batch)

        render.mesh = None
        return render

    from ..parallel.sequence import (
        build_sequence_parallel_march,
        build_sequence_parallel_renderer,
    )

    near, far = float(test_ds.near), float(test_ds.far)
    apply_fn = renderer._apply_fn()
    if use_grid:
        options = renderer.march_options
        surface = build_sequence_parallel_march(
            mesh, apply_fn, options, near, far, chunk_size=options.chunk_size)

        def render(batch):
            check_baked_bounds(near, far, batch["near"], batch["far"])
            out = surface(batch["rays"], renderer.occupancy_grid,
                          renderer.grid_bbox)
            renderer.accumulate_truncated(out.pop("n_truncated"))
            return out
    else:
        options = renderer.eval_options
        surface = build_sequence_parallel_renderer(
            mesh, apply_fn, options, near, far, chunk_size=options.chunk_size)

        def render(batch):
            check_baked_bounds(near, far, batch["near"], batch["far"])
            return surface(batch["rays"])

    render.mesh, render.surface = mesh, surface
    return render
