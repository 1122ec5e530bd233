"""Shared run bootstrap (port of ``nerf_replication_tpu/utils/setup.py``):
the config's debug and determinism switches, and the eval-time
make_network → seeded init → load sequence every inference entry point
needs."""

from __future__ import annotations

import random

import numpy as np
import torch


def configure_runtime(cfg) -> None:
    """Apply the config's debug/determinism switches.

    ``debug_nans`` turns on autograd's anomaly detection
    (``torch.autograd.set_detect_anomaly``: each backward op checks its
    output for NaN; it costs throughput, so only on request). ``fix_random``
    seeds the host-side RNGs (``random``, ``numpy``); the device path needs
    no switch, because its generators are reseeded from ``(seed, step)``."""
    if cfg.get("debug_nans", False):
        torch.autograd.set_detect_anomaly(True)
    if cfg.get("fix_random", False):
        seed = int(cfg.get("seed", 0))
        random.seed(seed)
        np.random.seed(seed)


def load_trained_network(cfg, device="cuda", verbose: bool = True):
    """``(network, epoch)``: the config's network, initialised from
    ``cfg.seed`` as the trainer does, then loaded from the checkpoint in
    ``cfg.trained_model_dir`` (epoch ``cfg.test.epoch``, -1 = latest; the
    seeded init stays when there is none), on ``device`` (the card unless
    the caller asks for the CPU; raises without CUDA), in eval mode."""
    from ..models import init_params_for, make_network
    from ..train.checkpoint import load_network
    from .platform import resolve_device

    device = resolve_device(device)
    network = make_network(cfg)
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    init_params_for(cfg)(network, gen)
    epoch = load_network(cfg.trained_model_dir, network,
                         epoch=int(cfg.test.get("epoch", -1)))
    if verbose:
        print(f"loaded network from {cfg.trained_model_dir} (epoch {epoch})")
    return network.to(device).eval(), epoch
