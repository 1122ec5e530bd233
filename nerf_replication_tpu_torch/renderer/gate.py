"""Baked-bounds check (port of ``check_baked_bounds`` in
``nerf_replication_tpu/renderer/gate.py``)."""

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
