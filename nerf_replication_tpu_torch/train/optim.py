"""Optimizer and LR schedule (port of ``nerf_replication_tpu/train/optim.py``,
which builds them on optax).

* ``exponential``: lr·gamma^(step/(decay_epochs·ep_iter)), per step;
* ``multi_step`` / ``warmup_multi_step``: piecewise-constant decay at epoch
  milestones (+ linear warmup), optax's boundary semantics;
* gradients clipped **by value** at 40 before the update
  (:func:`clip_gradients`), then Adam / AdamW / RAdam / SGD (momentum 0.9).

optax evaluates ``schedule(count)`` with ``count`` = the number of updates
made before this one (0 for the first), so :func:`apply_update` sets every
group's lr to ``schedule(count)`` before ``optimizer.step()``.
``torch.optim.Adam`` adds eps outside the bias-corrected square root, where
optax's ``scale_by_adam`` (eps_root 0) adds it; the tests hold one step of
each side against the other.
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
    """Returns ``(optimizer, schedule)``; the lr of every group is set per
    step by :func:`apply_update`."""
    schedule = make_lr_schedule(cfg)
    name = cfg.train.get("optim", "adam")
    wd = float(cfg.train.get("weight_decay", 0.0))
    eps = float(cfg.train.get("eps", 1e-8))
    lr0 = schedule(0)
    params = list(params)
    if name == "adam":
        if wd > 0:
            opt = torch.optim.AdamW(params, lr=lr0, eps=eps, weight_decay=wd)
        else:
            opt = torch.optim.Adam(params, lr=lr0, eps=eps)
    elif name == "radam":
        opt = torch.optim.RAdam(params, lr=lr0, eps=eps, weight_decay=wd)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr0, momentum=0.9)
    else:
        raise NotImplementedError(f"optimizer {name!r}")
    return opt, schedule


def clip_gradients(params) -> None:
    torch.nn.utils.clip_grad_value_(params, GRAD_CLIP_VALUE)


def apply_update(optimizer, schedule, count: int) -> float:
    """Clip by value, set lr = schedule(count), step; returns the lr."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    clip_gradients(params)
    lr = schedule(count)
    for g in optimizer.param_groups:
        g["lr"] = lr
    optimizer.step()
    return lr
