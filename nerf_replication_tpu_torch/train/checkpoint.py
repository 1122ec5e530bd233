"""Checkpoints of the port (port of
``nerf_replication_tpu/train/checkpoint.py``).

The port stores one ``torch.save`` file per checkpoint:
``<model_dir>/latest.pt`` and ``<model_dir>/<epoch>.pt``. A training bundle
holds the network's state dict, the optimizer's state (Adam moments and step
counts), the global step, the epoch and the recorder's state; numbered
checkpoints keep the newest ``KEEP_EPOCHS``. An NGP state's live grid EMA
rides the bundle (``grid_ema``), and its host-side warm/carve phase counters a
JSON sidecar ``<name>_phase.json`` (:func:`load_phase_state`), so a resumed
run re-enters the phase it left. ``load_network`` reads the
weights of either a training bundle or a weights-only file
(``save_network``), which is how the serving engine loads a trained model.
The JAX package's Orbax directories are not read here;
``convert.params_from_jax`` carries a JAX parameter tree across.
"""

from __future__ import annotations

import json
import os
import re
import sys

import torch

KEEP_EPOCHS = 5


def _available_epochs(model_dir: str) -> list[int]:
    if not os.path.isdir(model_dir):
        return []
    return sorted(
        int(m.group(1)) for f in os.listdir(model_dir)
        if (m := re.fullmatch(r"(\d+)\.pt", f))
    )


def _cpu_state(network: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in network.state_dict().items()}


def _write(model_dir: str, name: str, blob: dict) -> str:
    """``torch.save`` to ``<model_dir>/<name>.pt`` through a temporary file
    and a rename, so a reader never sees a half-written checkpoint."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"{name}.pt")
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def save_network(model_dir: str, network: torch.nn.Module,
                 epoch: int = -1) -> str:
    """Write the network's weights as ``latest.pt`` (epoch -1) or
    ``<epoch>.pt``, atomically; returns the path."""
    name = "latest" if epoch == -1 else str(int(epoch))
    return _write(model_dir, name,
                  {"network": _cpu_state(network), "epoch": int(epoch)})


def _phase_sidecar(model_dir: str, name: str) -> str:
    return os.path.join(model_dir, f"{name}_phase.json")


def save_model(model_dir: str, state, epoch: int, recorder_state=None,
               latest: bool = False, phase_state=None) -> str:
    """Save a training bundle (``state``: network, optimizer, step, and an
    NGP state's ``grid_ema``) as ``latest.pt`` or ``<epoch>.pt``; prune
    numbered ones to KEEP_EPOCHS. ``phase_state`` (the NGP trainer's phase
    counters) goes to a sidecar written atomically AFTER the bundle, so a
    crash leaves at worst a bundle with a stale or absent sidecar."""
    blob = {
        "network": _cpu_state(state.network),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "recorder": recorder_state or {},
    }
    grid = getattr(state, "grid_ema", None)
    if grid is not None:
        blob["grid_ema"] = grid.detach().cpu()
    name = "latest" if latest else str(int(epoch))
    path = _write(model_dir, name, blob)
    if phase_state:
        sidecar = _phase_sidecar(model_dir, name)
        tmp = f"{sidecar}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(phase_state, f)
        os.replace(tmp, sidecar)
    if not latest:
        for old in _available_epochs(model_dir)[:-KEEP_EPOCHS]:
            os.remove(os.path.join(model_dir, f"{old}.pt"))
            sidecar = _phase_sidecar(model_dir, str(old))
            if os.path.exists(sidecar):
                os.remove(sidecar)
    return path


def has_checkpoint(model_dir: str) -> bool:
    """Anything resumable on disk?"""
    return os.path.exists(os.path.join(model_dir, "latest.pt")) or bool(
        _available_epochs(model_dir))


def load_model(model_dir: str, state, epoch: int = -1):
    """Full resume into ``state`` in place: ``(state, begin_epoch,
    recorder_state)``, or ``(state, 0, None)`` when there is nothing to
    resume. ``epoch == -1`` takes ``latest.pt``, else the newest numbered
    checkpoint; a pinned epoch loads exactly that one."""
    epochs = _available_epochs(model_dir)
    target = None
    if epoch == -1:
        latest = os.path.join(model_dir, "latest.pt")
        if os.path.exists(latest):
            target = latest
        elif epochs:
            target = os.path.join(model_dir, f"{epochs[-1]}.pt")
    elif epoch in epochs:
        target = os.path.join(model_dir, f"{epoch}.pt")
    if target is None:
        return state, 0, None
    blob = torch.load(target, map_location="cpu", weights_only=True)
    if "optimizer" not in blob:
        raise ValueError(f"{target} holds weights only, not a training "
                         "bundle to resume from")
    state.network.load_state_dict(blob["network"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    if getattr(state, "grid_ema", None) is not None:
        if "grid_ema" not in blob:
            raise ValueError(f"{target} holds no grid_ema to resume an NGP "
                             "run from")
        state.grid_ema = blob["grid_ema"].to(state.grid_ema.device)
    return state, int(blob["epoch"]) + 1, dict(blob.get("recorder") or {})


def load_phase_state(model_dir: str, epoch: int = -1) -> dict | None:
    """The NGP phase sidecar matching what ``load_model`` would resume
    (``latest`` unless a numbered epoch is pinned), or None — a missing or
    torn sidecar degrades to the trainer's occupancy-based estimate."""
    if epoch == -1 and os.path.exists(os.path.join(model_dir, "latest.pt")):
        name = "latest"
    else:
        epochs = _available_epochs(model_dir)
        if not epochs:
            return None
        name = str(epoch if epoch != -1 and epoch in epochs else epochs[-1])
    try:
        with open(_phase_sidecar(model_dir, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def save_trained_config(cfg) -> None:
    """Provenance snapshot: merged YAML + command line."""
    os.makedirs(cfg.trained_config_dir, exist_ok=True)
    with open(os.path.join(cfg.trained_config_dir, "train_config.yaml"),
              "w") as f:
        f.write("# cmd: " + " ".join(sys.argv) + "\n")
        f.write(cfg.dump())


def load_network(model_dir: str, network: torch.nn.Module,
                 epoch: int = -1) -> int:
    """Weights-only load with epoch selection, into ``network`` in place.

    ``epoch == -1`` takes ``latest.pt``, else the newest numbered one; a
    pinned epoch loads exactly that file. Returns the loaded epoch (-1 for
    ``latest``), and leaves ``network`` unchanged (returning -1) when there
    is no checkpoint."""
    epochs = _available_epochs(model_dir)
    target, picked = None, -1
    if epoch == -1:
        latest = os.path.join(model_dir, "latest.pt")
        if os.path.exists(latest):
            target = latest
        elif epochs:
            target, picked = os.path.join(model_dir, f"{epochs[-1]}.pt"), epochs[-1]
    elif epoch in epochs:
        target, picked = os.path.join(model_dir, f"{epoch}.pt"), epoch
    if target is None:
        return -1
    blob = torch.load(target, map_location="cpu", weights_only=True)
    network.load_state_dict(blob["network"], strict=True)
    return picked


def load_trained_network(cfg, device="cuda", verbose: bool = True):
    """``(network, epoch)``: the config's network, initialised from
    ``cfg.seed`` as the trainer does, then loaded from the checkpoint in
    ``cfg.trained_model_dir`` (epoch ``cfg.test.epoch``, -1 = latest; the
    seeded init stays when there is none), on ``device`` (the card unless
    the caller asks for the CPU; raises without CUDA), in eval mode."""
    from ..models import init_params_for, make_network
    from ..utils.platform import resolve_device

    device = resolve_device(device)
    network = make_network(cfg)
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    init_params_for(cfg)(network, gen)
    epoch = load_network(cfg.trained_model_dir, network,
                         epoch=int(cfg.test.get("epoch", -1)))
    if verbose:
        print(f"loaded network from {cfg.trained_model_dir} (epoch {epoch})")
    return network.to(device).eval(), epoch
