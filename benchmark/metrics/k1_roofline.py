"""K1 (``csrc/fused_mlp.cu``, the fused NeRF MLP forward) against its
bound: the coarse and fine rows of the traced steps at the configuration's
compute type, over K1's device time."""

from counts import mlp
from harness.trace import kernel_seconds


def read(ctx):
    t = kernel_seconds(ctx.trace, "fused_mlp_fwd_kernel")
    if t <= 0.0 or ctx.steps <= 0:
        return None
    widths = mlp.nerf_widths(ctx.spec)
    rows = sum(mlp.nerf_rows_per_step(ctx.spec).values()) * ctx.steps
    w_bytes = 2 * ctx.steps * mlp.param_bytes(*widths)
    bound = mlp.k1_bound_s(rows, mlp.row_flops(*widths),
                           ctx.spec["compute_dtype"], w_bytes)
    return 100.0 * bound / t
