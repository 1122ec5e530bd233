"""Whole-image render gate and the baked-bounds check (port of
``nerf_replication_tpu/renderer/gate.py``).

``full_image_render_fn`` is the one factory every whole-image surface uses
(in-training validation, eval). The port has the single-device branches:
the renderer's chunked render, and with ``use_grid`` its occupancy-
accelerated march (``Renderer.render_accelerated``, a grid already loaded).
The sequence-parallel branch (``eval.sharded`` on several cards) comes with
port slice 7 and raises.
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

    if bool(cfg.get("eval", {}).get("sharded", False)) and \
            torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "eval.sharded: sequence-parallel rendering over several cards "
            "comes with port slice 7"
        )

    whole = renderer.render_accelerated if use_grid else \
        renderer.render_chunked

    def render(batch):
        with torch.no_grad():
            return whole(batch)

    return render
