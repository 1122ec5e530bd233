"""K2 (``csrc/fused_mlp_bwd.cu``: K2a rows, K2b weight gradients and the
reduce) against its bound over the traced steps' coarse and fine rows."""

from counts import mlp
from harness.trace import kernel_seconds


def read(ctx):
    t = kernel_seconds(ctx.trace, "fused_mlp_bwd_rows_kernel",
                       "fused_mlp_bwd_dw_kernel", "fused_mlp_reduce_kernel")
    if t <= 0.0 or ctx.steps <= 0:
        return None
    widths = mlp.nerf_widths(ctx.spec)
    rows = sum(mlp.nerf_rows_per_step(ctx.spec).values()) * ctx.steps
    w_bytes = 2 * ctx.steps * mlp.param_bytes(*widths)
    bound = mlp.k2_bound_s(rows, mlp.row_flops(*widths),
                           ctx.spec["compute_dtype"], w_bytes)
    return 100.0 * bound / t
