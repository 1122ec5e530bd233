"""NeRF loss module — the ``loss_module`` plugin of the nerf task (port of
``nerf_replication_tpu/train/loss.py``).

Renders the batch through the renderer it owns, MSE on the coarse map + MSE
on the fine map, ``total = loss_c + loss_f``, and a train PSNR stat from the
fine loss. Callable as ``(batch, gen, train) -> (output, loss, stats)``.
In proposal sampling mode there is no coarse map: the photometric loss is
the fine one, and ``loss_mult × interlevel_loss`` over the two histograms the
renderer returns trains the proposal branch (``stats["loss_prop"]``).
"""

from __future__ import annotations

import math

import torch

from ..renderer import make_renderer
from ..renderer.sampling import interlevel_loss


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
        if "prop_w" in output:
            loss_p = interlevel_loss(output["fine_t"], output["fine_w"],
                                     output["prop_t"], output["prop_w"])
            mult = self.renderer.train_options.sampling.loss_mult
            stats["loss_prop"] = loss_p
            loss = loss + mult * loss_p
        stats["loss"] = loss
        return output, loss, stats


def make_loss(cfg, network) -> NeRFLoss:
    return NeRFLoss(cfg, network)


# reference-style name: the trainer factory looks for NetworkWrapper too
NetworkWrapper = NeRFLoss
