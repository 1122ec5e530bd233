"""Network checkpoints of the port (load side of
``nerf_replication_tpu/train/checkpoint.py``).

The port stores a ``torch.save`` state dict per checkpoint:
``<model_dir>/latest.pt`` and ``<model_dir>/<epoch>.pt``. The JAX package's
Orbax directories are not read here; ``convert.params_from_jax`` carries a
JAX parameter tree across.
"""

from __future__ import annotations

import os
import re

import torch


def _available_epochs(model_dir: str) -> list[int]:
    if not os.path.isdir(model_dir):
        return []
    return sorted(
        int(m.group(1)) for f in os.listdir(model_dir)
        if (m := re.fullmatch(r"(\d+)\.pt", f))
    )


def save_network(model_dir: str, network: torch.nn.Module,
                 epoch: int = -1) -> str:
    """Write the network's weights as ``latest.pt`` (epoch -1) or
    ``<epoch>.pt``, atomically; returns the path."""
    os.makedirs(model_dir, exist_ok=True)
    name = "latest" if epoch == -1 else str(int(epoch))
    path = os.path.join(model_dir, f"{name}.pt")
    tmp = f"{path}.tmp.{os.getpid()}"
    state = {k: v.detach().cpu() for k, v in network.state_dict().items()}
    torch.save({"network": state, "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)
    return path


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
