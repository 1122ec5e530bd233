"""K5 (``ops/fused_march.py`` -> ``csrc/fused_march_full.cu``, the whole
march in one kernel) against its bound: the samples the march keeps for
the requests answered in the traced stretch (counted by the reference's
march on the same rays) through the MLP in the served precision, over
K5's device time."""

from counts import mlp
from counts.peaks import bound_s, compute_peak
from harness.trace import kernel_seconds


def read(ctx):
    t = kernel_seconds(ctx.trace, "fused_march_full_kernel")
    if t <= 0.0 or ctx.samples <= 0:
        return None
    flops = ctx.samples * mlp.row_flops(*mlp.nerf_widths(ctx.spec))
    rays = sum(r.side * r.side for r in ctx.traced)
    nbytes = rays * 4 * (6 + 5)
    return 100.0 * bound_s(flops, nbytes,
                           compute_peak(ctx.serve["compute_dtype"])) / t
