"""Density-only proposal MLP, the learned sampler's network half (port of
``nerf_replication_tpu/models/proposal.py``).

A small frequency-encoded MLP (default D=2, W=64, 5 bands) whose only job is
a per-sample raw density that the resampler (``renderer/sampling.py``) turns
into a weight histogram. It rides inside ``models.nerf.network.Network`` as
a third branch (``model="proposal"``, state keys ``proposal.*``), so
checkpoints, the bf16 clone and the serving engine carry it unchanged.
Layer names follow the Flax module: ``prop_linear_i`` and ``sigma_linear``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .nerf.network import Dense


class ProposalMLP(nn.Module):
    """[..., S, d] points → [..., S, 1] raw density (pre-relu σ).

    The encoding is inline: the points, then sin and cos of the points times
    ``2^k`` for k < ``n_freqs`` (band-major, sin before cos). No view
    dependence. The hidden layers compute in the caller's ``dtype``; the
    density head runs in float32, like the trunk's ``alpha_linear``."""

    def __init__(self, D: int = 2, W: int = 64, n_freqs: int = 5):
        super().__init__()
        self.D, self.W, self.n_freqs = int(D), int(W), int(n_freqs)
        width = 3 * (1 + 2 * self.n_freqs)  # 3-D points, encoded
        for i in range(self.D):
            self.add_module(f"prop_linear_{i}", Dense(width, self.W))
            width = self.W
        self.sigma_linear = Dense(width, 1)

    def forward(self, pts: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        f32 = torch.float32
        if self.n_freqs > 0:
            bands = 2.0 ** torch.arange(self.n_freqs, dtype=f32,
                                        device=pts.device)
            xb = pts[..., None, :] * bands[:, None]
            enc = torch.stack([torch.sin(xb), torch.cos(xb)], -2)
            h = torch.cat([pts, enc.reshape(*pts.shape[:-1], -1)], -1)
        else:
            h = pts
        h = h.to(dtype)
        for i in range(self.D):
            h = torch.relu(getattr(self, f"prop_linear_{i}")(h, dtype))
        return self.sigma_linear(h.to(f32), f32)
