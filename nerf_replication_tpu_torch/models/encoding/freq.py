"""NeRF frequency (positional) encoding on tensors.

Port of ``nerf_replication_tpu/models/encoding/freq.py``: the output is
``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{L-1} x), cos(2^{L-1} x)]`` with the
sin and cos of one band interleaved per band (the reference's order), giving
``d*(1+2L)`` features. The bands are powers of two, so ``x * band`` is exact
in float32 and the kernel in ``csrc/`` reproduces the same arguments.
"""

from __future__ import annotations

import numpy as np
import torch


class FrequencyEncoder:
    """Parameter-free encoder ``[..., d] -> [..., out_dim]`` (float32)."""

    def __init__(self, input_dim: int, n_freqs: int, include_input: bool = True,
                 log_sampling: bool = True):
        self.input_dim = int(input_dim)
        self.n_freqs = int(n_freqs)
        self.include_input = bool(include_input)
        if self.n_freqs <= 0:
            bands = np.zeros((0,), np.float32)
        elif log_sampling:
            bands = 2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs)
        else:
            bands = np.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs)
        self.freq_bands = np.asarray(bands, np.float32)
        if self.n_freqs <= 0:
            self.out_dim = self.input_dim
        else:
            self.out_dim = self.input_dim * (
                2 * self.n_freqs + (1 if include_input else 0)
            )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.n_freqs <= 0:
            return x
        bands = torch.as_tensor(self.freq_bands, device=x.device)
        xb = x[..., None, :] * bands[:, None]  # [..., L, d]
        enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
        enc = enc.reshape(*x.shape[:-1], 2 * self.n_freqs * x.shape[-1])
        if self.include_input:
            enc = torch.cat([x, enc], dim=-1)
        return enc


def frequency_encoder(input_dim: int, n_freqs: int, include_input: bool = True,
                      log_sampling: bool = True):
    """Returns ``(encode_fn, out_dim)`` as the JAX package's factory does."""
    enc = FrequencyEncoder(input_dim, n_freqs, include_input, log_sampling)
    return enc, enc.out_dim
