"""The first steps of lego training, done plainly: each step draws its
rays, stratified jitter and importance quantiles from the step's stream
(``draws.py``), takes the coarse + fine loss (``nerf.py``), its gradients by
autograd, and an Adam step after clipping by value."""

from __future__ import annotations

import torch

from . import draws, nerf
from .precision import operand_rounding


def train_steps(params0: dict, spec: dict, bank_rays: torch.Tensor,
                bank_rgbs: torch.Tensor, seed: int, n_steps: int,
                precision: str = "float32", fault: str | None = None) -> dict:
    """``{"losses": [n_steps], "grad1": {leaf: the first step's clipped
    gradient}, "delta": {leaf: theta_n - theta_0}}``. ``fault``
    ``"half_batch"`` takes each loss over the first half of the batch (a
    planted fault, for reading what the comparison makes of it)."""
    q = operand_rounding(precision)
    dev = bank_rays.device
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = nerf.Adam(params, nerf.lr_schedule(spec),
                    eps=spec["optimizer"]["eps"])
    n = spec["N_rays"]
    keep = (torch.arange(n, device=dev) < n // 2
            if fault == "half_batch" else None)
    losses, grad1 = [], None
    for step in range(n_steps):
        gen = draws.step_stream(seed, step, dev)
        rows = draws.batch_rows(gen, bank_rays.shape[0], n, dev)
        t_rand = draws.uniform(gen, (n, spec["N_samples"]), dev)
        u = draws.uniform(gen, (n, spec["N_importance"]), dev)
        loss = nerf.loss_coarse_fine(params, spec, bank_rays[rows],
                                     bank_rgbs[rows], t_rand, u, q, keep)
        grads = torch.autograd.grad(loss, list(params.values()))
        clipped = opt.step(params, dict(zip(params, grads)))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = clipped
    delta = {k: (params[k].detach() - params0[k]) for k in params}
    return {"losses": losses, "grad1": grad1, "delta": delta}
