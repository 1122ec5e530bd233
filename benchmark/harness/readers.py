"""The arithmetic of the per-layer readers that several metrics share
(a training cell's share of the peak, a traced stretch's idle share)."""

from __future__ import annotations

from counts.peaks import PEAK_BF16


def train_mfu(ctx):
    """The model's operations of the traced steps (the family's
    ``step_flops``) over the traced stretch, as a share of the bf16
    peak."""
    window = ctx.trace["window_s"]
    if window <= 0.0 or ctx.steps <= 0:
        return None
    flops = ctx.cell.family.step_flops(ctx.spec)
    return 100.0 * flops * ctx.steps / window / PEAK_BF16


def idle_pct(ctx):
    """One minus the union of the device's operations over the traced
    stretch."""
    window = ctx.trace["window_s"]
    if window <= 0.0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.trace["busy_s"] / window)
