"""img_fit network: frequency-encoded (u, v) → MLP → sigmoid rgb (port of
``nerf_replication_tpu/models/img_fit/network.py``).

``D`` ReLU layers of width ``W`` (``backbone_i``) over the uv positional
encoding, then the ``rgb`` head and a sigmoid; weights in the ``[out, in]``
layout under the Flax names (``convert.params_from_jax`` carries a JAX tree
over). No chunking loop: the eval render chunks (``train/loss_img_fit``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..encoding import get_encoder
from ..nerf.network import Dense, lecun_init


class Network(nn.Module):
    def __init__(self, D: int = 4, W: int = 128, uv_encoder=None,
                 input_ch: int = 2):
        super().__init__()
        self.D, self.W = int(D), int(W)
        self.uv_encoder = uv_encoder
        width = int(input_ch)
        for i in range(self.D):
            self.add_module(f"backbone_{i}", Dense(width, self.W))
            width = self.W
        self.rgb = Dense(width, 3)

    def forward(self, uv: torch.Tensor) -> torch.Tensor:
        """``[..., 2]`` → ``[..., 3]`` rgb in (0, 1)."""
        h = self.uv_encoder(uv)
        for i in range(self.D):
            h = torch.relu(getattr(self, f"backbone_{i}")(h))
        return torch.sigmoid(self.rgb(h))


def make_network(cfg) -> Network:
    uv_enc, input_ch = get_encoder(cfg.network.uv_encoder)
    return Network(D=int(cfg.network.D), W=int(cfg.network.W),
                   uv_encoder=uv_enc, input_ch=input_ch)


@torch.no_grad()
def init_params(network: Network, generator: torch.Generator) -> Network:
    """Lecun-normal kernels (flax's truncated normal) and zero biases, drawn
    from ``generator`` in layer order."""
    lecun_init(network, generator)
    return network
