"""The shared train-step core (port of
``nerf_replication_tpu/train/step_core.py``): draw a ray batch from the
device-resident bank, render it through the loss module, and leave the
gradients in the parameters' ``.grad``.
"""

from __future__ import annotations

import torch

from ..datasets.sampling import sample_rays


def sampled_grad_step(loss, params, bank_rays, bank_rgbs, n_rays: int,
                      near: float, far: float, gen: torch.Generator,
                      index_pool=None, grad_accum: int = 1,
                      step: int | None = None) -> dict:
    """Draw ``n_rays`` from the bank, backpropagate the loss into
    ``params``' ``.grad`` (zeroed first) and return the stats (tensors).
    ``step`` (the optimizer steps taken so far) rides the batch as
    ``batch["step"]``, which drives the proposal sampler's PDF anneal.

    ``grad_accum > 1`` splits the draw into A microbatches, run one after
    the other, and averages their gradients — the mean-loss gradient of the
    full batch with activation memory bounded by one microbatch, as in the
    JAX package; stats are the microbatch means, psnr recomputed from the
    mean mse (:func:`fix_accum_psnr`)."""
    params = list(params)
    for p in params:
        p.grad = None
    if grad_accum <= 1:
        return _one_grad(loss, bank_rays, bank_rgbs, n_rays, near, far, gen,
                         index_pool, step)
    if n_rays % grad_accum != 0:
        raise ValueError(
            f"n_rays={n_rays} must be divisible by "
            f"task_arg.grad_accum={grad_accum}"
        )
    n_micro = n_rays // grad_accum
    sums: dict = {}
    for _ in range(grad_accum):
        stats = _one_grad(loss, bank_rays, bank_rgbs, n_micro, near, far, gen,
                          index_pool, step)
        for k, v in stats.items():
            sums[k] = sums[k] + v if k in sums else v
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad /= grad_accum
    return fix_accum_psnr({k: v / grad_accum for k, v in sums.items()})


def fix_accum_psnr(stats: dict) -> dict:
    """Recompute psnr from the microbatch-averaged mse (psnr is nonlinear
    in mse, so the mean of per-microbatch psnrs is not the batch's)."""
    if "psnr" in stats:
        from .loss import mse_to_psnr

        base = next(
            (stats[k] for k in ("loss_f", "loss_c", "loss") if k in stats),
            None,
        )
        if base is not None:
            stats = dict(stats)
            stats["psnr"] = mse_to_psnr(base)
    return stats


def _one_grad(loss, bank_rays, bank_rgbs, n_rays, near, far, gen,
              index_pool, step=None):
    rays, rgbs = sample_rays(gen, bank_rays, bank_rgbs, n_rays,
                             index_pool=index_pool)
    batch = {"rays": rays, "rgbs": rgbs, "near": near, "far": far}
    if step is not None:
        batch["step"] = step
    _, value, stats = loss(batch, gen=gen, train=True)
    value.backward()
    return {k: v.detach() for k, v in stats.items()}
