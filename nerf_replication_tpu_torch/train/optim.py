"""Optimizer and LR schedule (port of ``nerf_replication_tpu/train/optim.py``,
which builds them on optax).

* ``exponential``: lr·gamma^(step/(decay_epochs·ep_iter)), per step;
* ``multi_step`` / ``warmup_multi_step``: piecewise-constant decay at epoch
  milestones (+ linear warmup), optax's boundary semantics;
* gradients clipped **by value** at 40 before the update
  (:func:`clip_gradients`), then Adam / AdamW / RAdam / SGD (momentum 0.9).

optax evaluates ``schedule(count)`` with ``count`` = the number of updates
made before this one (0 for the first), so :func:`set_lr` fills every
group's lr with ``schedule(count)`` before ``optimizer.step()``.
``torch.optim.Adam`` adds eps outside the bias-corrected square root, where
optax's ``scale_by_adam`` (eps_root 0) adds it; the tests hold one step of
each side against the other.

The lr is a 0-dim tensor that :func:`set_lr` fills in place (float64 on the
CPU, so that it equals a float lr bit for bit; float32 on the card), and
Adam / AdamW run ``capturable`` on the card (the step count on the card):
a captured step (``compile/registry.py``) reads both from the card, so a
replay takes the lr and bias corrections of its own step, not the capture's.
:func:`optimizer_step` is that step's device part (clip + update).
"""

from __future__ import annotations

import torch

GRAD_CLIP_VALUE = 40.0


def make_lr_schedule(cfg):
    """``schedule(step) -> lr`` (a Python float)."""
    sched = cfg.train.scheduler
    base_lr = float(cfg.train.lr)
    ep_iter = max(int(cfg.get("ep_iter", -1)), 1)
    stype = sched.get("type", "multi_step")

    if stype == "exponential":
        gamma = float(sched.gamma)
        decay_steps = float(sched.decay_epochs) * ep_iter

        def schedule(step):
            return base_lr * gamma ** (float(step) / decay_steps)

        return schedule

    if stype in ("multi_step", "warmup_multi_step"):
        gamma = float(sched.gamma)
        milestones = sorted(int(m) * ep_iter for m in sched.milestones)

        def base(step):
            # optax.piecewise_constant_schedule: scaled from the boundary on
            n = sum(1 for m in milestones if step >= m)
            return base_lr * gamma ** n

        if stype == "warmup_multi_step":
            warmup_steps = int(sched.get("warmup_epochs", 1)) * ep_iter
            warmup_factor = float(sched.get("warmup_factor", 1.0 / 3))
            lo = base_lr * warmup_factor

            def schedule(step):
                # optax.join_schedules: the second starts at step - boundary
                if step < warmup_steps:
                    frac = min(max(step, 0), warmup_steps) / warmup_steps
                    return lo + (base_lr - lo) * frac
                return base(step - warmup_steps)

            return schedule
        return base

    raise NotImplementedError(f"scheduler type {stype!r}")


def make_optimizer(cfg, params):
    """Returns ``(optimizer, schedule)`` over ``params`` (on their device);
    the lr of every group is set per step by :func:`set_lr`."""
    schedule = make_lr_schedule(cfg)
    name = cfg.train.get("optim", "adam")
    wd = float(cfg.train.get("weight_decay", 0.0))
    eps = float(cfg.train.get("eps", 1e-8))
    params = list(params)
    dev = params[0].device if params else torch.device("cpu")
    lr0 = schedule(0)
    if name == "adam":
        cls = torch.optim.AdamW if wd > 0 else torch.optim.Adam
        kw = {"weight_decay": wd} if wd > 0 else {}
        opt = cls(params, lr=_lr_tensor(lr0, dev), eps=eps, **kw)
    elif name == "radam":
        opt = torch.optim.RAdam(params, lr=lr0, eps=eps, weight_decay=wd)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr0, momentum=0.9)
    else:
        raise NotImplementedError(f"optimizer {name!r}")
    make_capturable(opt)
    return opt, schedule


def _lr_tensor(value: float, device) -> torch.Tensor:
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    return torch.full((), float(value), dtype=dtype, device=device)


def capturable(optimizer) -> bool:
    """Whether a step of ``optimizer`` can be captured in a CUDA graph: a
    tensor lr and ``capturable`` in every group (Adam / AdamW on the
    card)."""
    return all(torch.is_tensor(g["lr"]) and g.get("capturable", False)
               for g in optimizer.param_groups)


def make_capturable(optimizer) -> None:
    """Put a tensor-lr optimizer in the form its device wants, also after
    ``load_state_dict`` (which brings the saved groups' flags and a
    CPU-loaded lr): on the card ``capturable`` with the lr and the step
    counts on the card; on the CPU not capturable. Float-lr optimizers
    (RAdam, SGD) are left as they are."""
    for g in optimizer.param_groups:
        if not torch.is_tensor(g["lr"]) or not g["params"]:
            continue
        dev = g["params"][0].device
        want = _lr_tensor(float(g["lr"]), dev)
        if g["lr"].device != dev or g["lr"].dtype != want.dtype:
            g["lr"] = want
        g["capturable"] = dev.type == "cuda"
        for p in g["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st and torch.is_tensor(st["step"]):
                st["step"] = st["step"].to(device=dev, dtype=torch.float32)


def clip_gradients(params) -> None:
    torch.nn.utils.clip_grad_value_(params, GRAD_CLIP_VALUE)


def set_lr(optimizer, schedule, count: int) -> float:
    """Every group's lr = ``schedule(count)``, filled in place when it is a
    tensor (host work, outside any captured step); returns the lr."""
    lr = schedule(count)
    for g in optimizer.param_groups:
        if torch.is_tensor(g["lr"]):
            g["lr"].fill_(lr)
        else:
            g["lr"] = lr
    return lr


def optimizer_step(optimizer) -> None:
    """The device part of an update: clip by value, then step (capturable
    on the card)."""
    clip_gradients([p for g in optimizer.param_groups for p in g["params"]])
    optimizer.step()


def apply_update(optimizer, schedule, count: int) -> float:
    """Clip by value, set lr = schedule(count), step; returns the lr."""
    lr = set_lr(optimizer, schedule, count)
    optimizer_step(optimizer)
    return lr
