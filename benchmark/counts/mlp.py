"""Operations and bytes of the NeRF MLP (kernels K1 and K2) and of a
training step, from the widths alone.

A row is one sample through one MLP: the trunk (D layers of width W, the
encoded position re-entering after each skip), the density head, the
feature layer, the view layer (width W/2) and the rgb head. ``padded``
counts what the fused kernels run (inputs padded to 64 and 32 columns,
heads 8 wide), which the repository's kernel table states (1.194 MFLOP a
row at lego width); the roofline shares count the model's own rows.
"""

from __future__ import annotations

from .peaks import PEAK_TF32, bound_s, compute_peak


def row_flops(D: int, W: int, skips, c_pts: int, c_views: int,
              padded: bool = False) -> int:
    """Multiply-adds x 2 of one row forward."""
    if padded:
        c_pts = -(-c_pts // 64) * 64
        c_views = -(-c_views // 32) * 32
    head = 8 if padded else 1
    rgb = 8 if padded else 3
    macs = 0
    for i in range(D):
        c_in = c_pts if i == 0 else (c_pts + W if (i - 1) in skips else W)
        macs += c_in * W
    head_in = W + (c_pts if (D - 1) in skips else 0)
    macs += head_in * head + head_in * W + (W + c_views) * (W // 2) \
        + (W // 2) * rgb
    return 2 * macs


# bytes a row reads and writes once: its point and view direction in, its
# raw (r, g, b, sigma) out, float32
ROW_BYTES = 4 * (3 + 3 + 4)


def param_bytes(D: int, W: int, skips, c_pts: int, c_views: int) -> int:
    macs_per_row = row_flops(D, W, skips, c_pts, c_views) // 2
    return 4 * macs_per_row  # one float32 per weight (biases aside)


def k1_bound_s(rows: int, flops_row: int, dtype: str, w_bytes: int) -> float:
    """K1, the fused forward: ``rows`` rows in the compute type."""
    return bound_s(rows * flops_row, rows * ROW_BYTES + w_bytes,
                   compute_peak(dtype))


def k2_bound_s(rows: int, flops_row: int, dtype: str, w_bytes: int) -> float:
    """K2 (K2a + K2b + reduce), the fused backward: the forward recomputed
    in the compute type, then the input-gradient chain and the weight
    gradients, each the forward's size, as float32 products (three TF32
    products each); the row's inputs, its output gradient and its input
    gradient once, the weights and their gradients once."""
    fwd = rows * flops_row
    t_ops = fwd / compute_peak(dtype) + 3 * 2 * fwd / PEAK_TF32
    nbytes = rows * (ROW_BYTES + 4 * 4) + 2 * w_bytes
    return max(t_ops, nbytes / 3.35e12)


def train_step_flops(rows_per_step: int, flops_row: int) -> int:
    """A training step's model operations: forward and the backward's two
    products of the same size, over every MLP row of the step."""
    return 3 * rows_per_step * flops_row


def nerf_widths(spec: dict) -> tuple:
    """``(D, W, skips, c_pts, c_views)`` of a NeRF configuration (positions
    and directions frequency-encoded, the input included)."""
    return (spec["D"], spec["W"], tuple(spec["skips"]),
            3 * (1 + 2 * spec["pe_xyz"]), 3 * (1 + 2 * spec["pe_dir"]))


def nerf_rows_per_step(spec: dict) -> dict:
    """MLP rows of one coarse + fine training step: the coarse network at
    the stratified samples, the fine one at those and the importance
    samples."""
    n = spec["N_rays"]
    return {"coarse": n * spec["N_samples"],
            "fine": n * (spec["N_samples"] + spec["N_importance"])}
