"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense,
without sparsity), at its full 700 W power limit. A share is stated
against these, with the card's own power limit beside it."""

PEAK_BF16 = 989e12       # FLOP/s, bf16 / fp16 tensor cores
PEAK_TF32 = 495e12       # FLOP/s, TF32 tensor cores
PEAK_F32_SIMT = 67e12    # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12     # bytes/s, HBM3


def compute_peak(dtype: str) -> float:
    """The peak of the products a kernel makes in ``dtype``: bf16 on the
    tensor cores; float32 as three TF32 products on them."""
    if dtype == "bfloat16":
        return PEAK_BF16
    if dtype == "float32":
        return PEAK_TF32 / 3.0
    raise ValueError(f"no peak for {dtype!r}")


def bound_s(flops: float, nbytes: float, flop_peak: float) -> float:
    """The least time the chip could take: the larger of the operations
    over their peak and the bytes over the bandwidth."""
    return max(flops / flop_peak, nbytes / PEAK_BYTES)
