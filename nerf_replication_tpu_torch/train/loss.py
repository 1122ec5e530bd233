"""NeRF loss module — the ``loss_module`` plugin of the nerf task (port of
``nerf_replication_tpu/train/loss.py``).

Renders the batch through the renderer it owns, MSE on the coarse map + MSE
on the fine map, ``total = loss_c + loss_f``, and a train PSNR stat from the
fine loss. Callable as ``(batch, gen, train) -> (output, loss, stats)``.
The proposal sampler's interlevel loss comes with port slice 5.
"""

from __future__ import annotations

import math

import torch

from ..renderer import make_renderer


def mse(pred, target):
    return torch.mean((pred - target) ** 2)


def mse_to_psnr(m):
    """-10·log10(mse)."""
    return -10.0 * torch.log(m) / math.log(10.0)


class NeRFLoss:
    def __init__(self, cfg, network):
        self.renderer = make_renderer(cfg, network)
        self.network = network

    def __call__(self, batch, gen=None, train: bool = True):
        output = self.renderer.render(batch, gen=gen, train=train)
        target = batch["rgbs"]
        stats = {}
        loss = 0.0
        if "prop_w" in output:
            raise NotImplementedError(
                "the proposal interlevel loss comes with port slice 5")
        if "rgb_map_c" in output:
            loss_c = mse(output["rgb_map_c"], target)
            stats["loss_c"] = loss_c
            loss = loss + loss_c
        if "rgb_map_f" in output:
            loss_f = mse(output["rgb_map_f"], target)
            stats["loss_f"] = loss_f
            loss = loss + loss_f
            stats["psnr"] = mse_to_psnr(loss_f)
        else:
            stats["psnr"] = mse_to_psnr(stats["loss_c"])
        stats["loss"] = loss
        return output, loss, stats


def make_loss(cfg, network) -> NeRFLoss:
    return NeRFLoss(cfg, network)


# reference-style name: the trainer factory looks for NetworkWrapper too
NetworkWrapper = NeRFLoss
