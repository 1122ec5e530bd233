"""Checkpoints of the port (port of
``nerf_replication_tpu/train/checkpoint.py``).

The port stores one ``torch.save`` file per checkpoint:
``<model_dir>/latest.pt`` and ``<model_dir>/<epoch>.pt``. A training bundle
holds the network's state dict, the optimizer's state (Adam moments and step
counts), the global step, the epoch, the steps already taken of the next
epoch (``epoch_it``: a SIGTERM flush lands mid-epoch) and the recorder's
state; numbered checkpoints keep the newest ``KEEP_EPOCHS``. An NGP state's
live grid EMA rides the bundle (``grid_ema``), and its host-side warm/carve
phase counters a JSON sidecar ``<name>_phase.json`` (:func:`load_phase_state`),
so a resumed run re-enters the phase it left. ``load_network`` reads the
weights of either a training bundle or a weights-only file
(``save_network``), which is how the serving engine loads a trained model.

Resilience (``resil/``), as in the JAX package: every ``.pt`` gets a
checksum sidecar (``<file>.sha256``) after it lands; saves pass the fault
points ``checkpoint.save`` (before the write: a kill there leaves the
previous checkpoint whole) and ``checkpoint.save.sidecar`` (between the
bundle and its sidecars) and retry under ``save_model_with_retry``; loads
pass ``checkpoint.load`` with retries, and a torn or mismatched
``latest.pt`` falls back to the newest numbered checkpoint with a ``fault``
row. :func:`load_model` restores INTO the caller's tensors (parameters,
Adam's moments and step counts, the grid EMA) with ``copy_``, never
rebinding them: a captured CUDA graph keeps reading those very tensors, so
a rollback or warm start in the middle of a run is seen by its replays.

The JAX package's Orbax directories are not read here;
``convert.params_from_jax`` carries a JAX parameter tree across.
"""

from __future__ import annotations

import json
import os
import re
import sys

import torch

from ..resil import (
    fault_point,
    report,
    retry_params,
    verify_checksum,
    with_retry,
    write_checksum,
)

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
    write_checksum(path)
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
               latest: bool = False, phase_state=None,
               epoch_it: int = 0) -> str:
    """Save a training bundle (``state``: network, optimizer, step, and an
    NGP state's ``grid_ema``) as ``latest.pt`` or ``<epoch>.pt``; prune
    numbered ones to KEEP_EPOCHS. ``epoch`` is the last epoch completed;
    ``epoch_it`` the steps of the next one already taken. ``phase_state``
    (the NGP trainer's phase counters) goes to a sidecar written atomically
    AFTER the bundle, so a crash leaves at worst a bundle with a stale or
    absent sidecar."""
    blob = {
        "network": _cpu_state(state.network),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "epoch_it": int(epoch_it),
        "recorder": recorder_state or {},
    }
    grid = getattr(state, "grid_ema", None)
    if grid is not None:
        blob["grid_ema"] = grid.detach().cpu()
    name = "latest" if latest else str(int(epoch))
    # before the write: a kill here leaves the previous checkpoint whole
    fault_point("checkpoint.save",
                path=os.path.join(model_dir, f"{name}.pt"))
    path = _write(model_dir, name, blob)
    # the torn window: a kill between the bundle and its sidecars leaves a
    # loadable bundle with a stale or absent phase sidecar
    fault_point("checkpoint.save.sidecar", path=path)
    if phase_state:
        sidecar = _phase_sidecar(model_dir, name)
        tmp = f"{sidecar}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(phase_state, f)
        os.replace(tmp, sidecar)
    if not latest:
        for old in _available_epochs(model_dir)[:-KEEP_EPOCHS]:
            for f in (os.path.join(model_dir, f"{old}.pt"),
                      os.path.join(model_dir, f"{old}.pt.sha256"),
                      _phase_sidecar(model_dir, str(old))):
                if os.path.exists(f):
                    os.remove(f)
    return path


def save_model_with_retry(cfg, model_dir: str, state, epoch: int,
                          recorder_state=None, *, log=print, **kw) -> bool:
    """``save_model`` under the bounded retry ladder (``resil:`` knobs).

    An exhausted ladder is logged and ABSORBED: losing one cadence save
    must not kill a healthy run — the next cadence saves again, and a
    resume falls back to the previous epoch. The ``retry`` telemetry rows
    (status ``exhausted``) still record the loss."""
    try:
        with_retry(
            lambda: save_model(model_dir, state, epoch, recorder_state,
                               **kw),
            point="checkpoint.save",
            **retry_params(cfg),
        )
        return True
    except OSError as exc:
        log(f"warning: checkpoint save (epoch {epoch}) failed after "
            f"retries: {exc} — training continues")
        return False


def has_checkpoint(model_dir: str) -> bool:
    """Anything resumable on disk?"""
    return os.path.exists(os.path.join(model_dir, "latest.pt")) or bool(
        _available_epochs(model_dir))


def _read(path: str) -> dict:
    """One checkpoint file through the ``checkpoint.load`` fault point and
    its checksum sidecar (a mismatch raises)."""
    fault_point("checkpoint.load", path=path)
    if verify_checksum(path) is False:
        raise ValueError(f"checksum mismatch: {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def _candidates(model_dir: str, epoch: int) -> list[str]:
    """What to load, in order: ``latest.pt`` then the numbered ones newest
    first (``epoch == -1``), or exactly the pinned epoch."""
    epochs = _available_epochs(model_dir)
    if epoch != -1:
        return ([os.path.join(model_dir, f"{epoch}.pt")]
                if epoch in epochs else [])
    out = []
    if os.path.exists(os.path.join(model_dir, "latest.pt")):
        out.append(os.path.join(model_dir, "latest.pt"))
    return out + [os.path.join(model_dir, f"{e}.pt")
                  for e in reversed(epochs)]


def _load_first(cands: list[str], point: str = "checkpoint.load"):
    """``(blob, path)`` of the first candidate that reads whole, each read
    retried; a torn one is reported and the next is tried. The last
    candidate's failure raises."""
    for i, cand in enumerate(cands):
        try:
            return with_retry(lambda cand=cand: _read(cand), point=point), cand
        except Exception as exc:
            if i + 1 >= len(cands):
                raise
            report(point, "torn", path=cand,
                   detail=f"{type(exc).__name__}: falling back to "
                          f"{os.path.basename(cands[i + 1])}")
    raise FileNotFoundError("no checkpoint")


def load_optimizer_state(optimizer, saved: dict) -> None:
    """``optimizer.load_state_dict(saved)`` into the optimizer's own
    tensors: existing state (Adam's moments and step counts) is filled with
    ``copy_`` and new state lands on its parameter's device, and the
    groups' hyperparameters are taken, except the lr tensor, which
    ``set_lr`` fills before every step. A captured step reads these
    tensors, so nothing it holds is rebound."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    saved_groups = saved["param_groups"]
    if len(saved_groups) != len(optimizer.param_groups) or sum(
            len(g["params"]) for g in saved_groups) != len(params):
        raise ValueError("the saved optimizer state does not match the "
                         "optimizer's parameter groups")
    for g, sg in zip(optimizer.param_groups, saved_groups):
        for k, v in sg.items():
            if k not in ("params", "lr", "capturable"):
                g[k] = v
    # the saved ids, in group order, name the parameters in group order
    index = dict(zip((i for sg in saved_groups for i in sg["params"]),
                     params))
    capturable = any(g.get("capturable", False)
                     for g in optimizer.param_groups)
    with torch.no_grad():
        for i, st in saved["state"].items():
            p = index[int(i)]
            mine = optimizer.state[p]
            for k, v in st.items():
                if not torch.is_tensor(v):
                    mine[k] = v
                elif k in mine and torch.is_tensor(mine[k]):
                    mine[k].copy_(v)
                elif k == "step":
                    mine[k] = v.to(device=p.device if capturable else "cpu",
                                   dtype=torch.float32)
                else:
                    mine[k] = v.to(p.device)


def load_model(model_dir: str, state, epoch: int = -1):
    """Full resume into ``state`` in place: ``(state, begin_epoch,
    recorder_state)``, or ``(state, 0, None)`` when there is nothing to
    resume. ``epoch == -1`` takes ``latest.pt``, falling back to the newest
    numbered checkpoint that reads whole; a pinned epoch loads exactly that
    one. ``state.epoch_it`` becomes the steps of ``begin_epoch`` already
    taken."""
    cands = _candidates(model_dir, epoch)
    if not cands:
        return state, 0, None
    blob, target = _load_first(cands)
    if "optimizer" not in blob:
        raise ValueError(f"{target} holds weights only, not a training "
                         "bundle to resume from")
    if getattr(state, "grid_ema", None) is not None and "grid_ema" not in blob:
        raise ValueError(f"{target} holds no grid_ema to resume an NGP "
                         "run from")
    state.network.load_state_dict(blob["network"], strict=True)
    saved_opt = blob["optimizer"]
    tp = getattr(state, "tp", None)
    if tp is not None:
        # a tensor-parallel state slices the one-card bundle to its blocks
        tp.pull_blocks()
        saved_opt = tp.slice_optimizer_state(saved_opt)
    load_optimizer_state(state.optimizer, saved_opt)
    state.step = int(blob["step"])
    state.epoch_it = int(blob.get("epoch_it", 0))
    if getattr(state, "grid_ema", None) is not None:
        with torch.no_grad():
            state.grid_ema.copy_(blob["grid_ema"])
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

    ``epoch == -1`` takes ``latest.pt`` (falling back to the newest
    numbered file that reads whole), else the newest numbered one; a
    pinned epoch loads exactly that file. Returns the loaded epoch (-1 for
    ``latest``), and leaves ``network`` unchanged (returning -1) when there
    is no checkpoint."""
    state, loaded = read_network(model_dir, epoch)
    if state is not None:
        network.load_state_dict(state, strict=True)
    return loaded


def read_network(model_dir: str, epoch: int = -1) -> tuple[dict | None,
                                                            int]:
    """``(state dict of CPU tensors, loaded epoch)`` as :func:`load_network`
    picks it (``-1`` for ``latest``), or ``(None, -1)`` without a
    checkpoint."""
    cands = _candidates(model_dir, epoch)
    if not cands:
        return None, -1
    blob, target = _load_first(cands)
    name = os.path.basename(target)[:-len(".pt")]
    return blob["network"], -1 if name == "latest" else int(name)


def save_pretrain(pretrain_dir: str, network: torch.nn.Module) -> str:
    """Write the network's weights as ``<pretrain_dir>/pretrain.pt``, the
    warm start :func:`load_pretrain` reads."""
    return _write(pretrain_dir, "pretrain",
                  {"network": _cpu_state(network), "epoch": -1})


def load_pretrain(pretrain: str, network: torch.nn.Module) -> bool:
    """Warm-start the parameters only, in place (``copy_``), from a port
    checkpoint: ``pretrain`` is a ``.pt`` file, or a directory holding
    ``pretrain.pt`` or training checkpoints (``latest.pt``, else the newest
    numbered). False when there is none. A JAX Orbax directory is refused:
    ``convert.params_from_jax`` carries its parameter tree across."""
    if os.path.isfile(pretrain):
        cands = [pretrain]
    elif os.path.isdir(os.path.join(pretrain, "pretrain")) or os.path.exists(
            os.path.join(pretrain, "_CHECKPOINT_METADATA")):
        raise ValueError(
            f"{pretrain} is a JAX Orbax checkpoint, which the port does not "
            "read: convert its parameters with convert.params_from_jax and "
            "save them with train.checkpoint.save_pretrain")
    elif os.path.exists(os.path.join(pretrain, "pretrain.pt")):
        cands = [os.path.join(pretrain, "pretrain.pt")]
    else:
        cands = _candidates(pretrain, -1)
    if not cands:
        return False
    blob, _ = _load_first(cands)
    network.load_state_dict(blob["network"], strict=True)
    return True
