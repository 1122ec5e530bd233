"""Device seat: where the port's tensors live.

The counterpart of ``nerf_replication_tpu/utils/platform.py`` (which pins
JAX's backend). Every entry point takes an explicit ``device`` and defaults to
``"cuda"``; a run on the CPU happens only when the caller asks for it, so a
machine without a card never serves silently from its CPU. Float32 matrix
products stay in full float32: TF32 is switched off for cuBLAS and cuDNN,
because the kernels and their plain versions are held to float32 tolerances.
"""

from __future__ import annotations

import torch


def pin_float32_math() -> None:
    """Full-precision float32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent. ``"cpu"`` must be asked for by name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    pin_float32_math()
    return dev
