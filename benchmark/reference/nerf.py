"""Plain NeRF (Mildenhall et al. 2020) in float32: the frequency encoding,
the coarse and fine MLPs, stratified and importance sampling, alpha
compositing over a white background, the photometric loss, value clipping
and Adam. Written from the paper and its published code, independent of
the program.

Parameter names are the paper code's layers (``pts_linear_<i>``,
``alpha_linear``, ``feature_linear``, ``views_linear_0``, ``rgb_linear``)
under ``coarse.`` / ``fine.``, weights ``[out, in]``; the skip layer's input
is ``[embedded position, h]``.
"""

from __future__ import annotations

import torch

from .precision import linear


def mlp_layout(prefix: str, D: int, W: int, skips, c_pts: int,
               c_views: int) -> list[tuple[str, tuple[int, ...]]]:
    """``(name, shape)`` of one NeRF MLP's parameters."""
    out = []
    for i in range(D):
        c_in = c_pts if i == 0 else (c_pts + W if (i - 1) in skips else W)
        out += [(f"{prefix}.pts_linear_{i}.weight", (W, c_in)),
                (f"{prefix}.pts_linear_{i}.bias", (W,))]
    head_in = W + (c_pts if (D - 1) in skips else 0)
    out += [(f"{prefix}.alpha_linear.weight", (1, head_in)),
            (f"{prefix}.alpha_linear.bias", (1,)),
            (f"{prefix}.feature_linear.weight", (W, head_in)),
            (f"{prefix}.feature_linear.bias", (W,)),
            (f"{prefix}.views_linear_0.weight", (W // 2, W + c_views)),
            (f"{prefix}.views_linear_0.bias", (W // 2,)),
            (f"{prefix}.rgb_linear.weight", (3, W // 2)),
            (f"{prefix}.rgb_linear.bias", (3,))]
    return out


def encoded_width(n_freqs: int, dim: int = 3) -> int:
    return dim * (1 + 2 * n_freqs)


def positional(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]``
    (each band's sines, then its cosines)."""
    parts = [x]
    for k in range(n_freqs):
        xb = x * float(2 ** k)
        parts += [torch.sin(xb), torch.cos(xb)]
    return torch.cat(parts, -1)


def mlp(params: dict, prefix: str, x_pts: torch.Tensor, x_views: torch.Tensor,
        D: int, skips, q) -> torch.Tensor:
    """Raw ``[..., 4]`` (r, g, b, sigma) of the NeRF MLP ``prefix`` on
    encoded positions and view directions."""
    def lin(name, x):
        return linear(x, params[f"{prefix}.{name}.weight"],
                      params[f"{prefix}.{name}.bias"], q)

    h = x_pts
    for i in range(D):
        if (i - 1) in skips:
            h = torch.cat([x_pts, h], -1)
        h = torch.relu(lin(f"pts_linear_{i}", h))
    if (D - 1) in skips:
        h = torch.cat([x_pts, h], -1)
    sigma = lin("alpha_linear", h)
    feature = lin("feature_linear", h)
    h = torch.relu(lin("views_linear_0", torch.cat([feature, x_views], -1)))
    return torch.cat([lin("rgb_linear", h), sigma], -1)


def field(params: dict, prefix: str, pts: torch.Tensor, viewdirs: torch.Tensor,
          spec: dict, q) -> torch.Tensor:
    """Raw ``[N, S, 4]`` at points ``[N, S, 3]`` seen along ``viewdirs [N,
    3]``."""
    x_pts = positional(pts, spec["pe_xyz"])
    views = positional(viewdirs, spec["pe_dir"])[:, None, :].expand(
        *pts.shape[:-1], -1)
    return mlp(params, prefix, x_pts, views, spec["D"], spec["skips"], q)


def composite(raw: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor):
    """``(rgb over white [N, 3], weights [N, S])``: alpha compositing with
    the last interval 1e10 long."""
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    rgb = torch.sigmoid(raw[..., :3])
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    acc = torch.sum(weights, -1)
    return rgb_map + (1.0 - acc[:, None]), weights


def stratified(near: float, far: float, n: int, s: int,
               t_rand: torch.Tensor) -> torch.Tensor:
    """[n, s] depths: ``s`` even bins over [near, far], each jittered
    uniformly by ``t_rand``."""
    t = torch.linspace(0.0, 1.0, s, dtype=torch.float32,
                       device=t_rand.device)
    z = (near * (1.0 - t) + far * t).expand(n, s)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * t_rand


def inverse_cdf(bins: torch.Tensor, weights: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Importance samples at quantiles ``u [N, K]`` of the piecewise-
    constant PDF of ``weights [N, B-1]`` over ``bins [N, B]``."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                    -1)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def loss_coarse_fine(params: dict, spec: dict, rays: torch.Tensor,
                     target: torch.Tensor, t_rand: torch.Tensor,
                     u: torch.Tensor, q, keep: torch.Tensor | None = None):
    """Coarse + fine photometric loss of one ray batch (the training
    objective), the rows ``keep`` only when given."""
    near, far = spec["near"], spec["far"]
    rays_o, rays_d = rays[:, :3], rays[:, 3:6]
    n = rays.shape[0]
    z = stratified(near, far, n, spec["N_samples"], t_rand)
    viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    rgb_c, w_c = composite(field(params, "coarse", pts, viewdirs, spec, q),
                           z, rays_d)
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_imp = inverse_cdf(z_mid, w_c[:, 1:-1].detach(), u).detach()
    z_f, _ = torch.sort(torch.cat([z, z_imp], -1), -1)
    pts_f = rays_o[:, None, :] + rays_d[:, None, :] * z_f[..., None]
    rgb_f, _ = composite(field(params, "fine", pts_f, viewdirs, spec, q),
                         z_f, rays_d)
    if keep is not None:
        rgb_c, rgb_f, target = rgb_c[keep], rgb_f[keep], target[keep]
    return (torch.mean((rgb_c - target) ** 2)
            + torch.mean((rgb_f - target) ** 2))


class Adam:
    """Adam (Kingma & Ba) with the update ``lr * m_hat / (sqrt(v_hat) +
    eps)``, after clipping each gradient entry to [-clip, clip]."""

    def __init__(self, params: dict, lr_at, betas=(0.9, 0.999), eps=1e-8,
                 clip: float = 40.0):
        self.lr_at, self.b1, self.b2 = lr_at, betas[0], betas[1]
        self.eps, self.clip = eps, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Updates ``params`` in place; returns the clipped gradients."""
        lr = self.lr_at(self.t)
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        clipped = {}
        for k, p in params.items():
            g = torch.clamp(grads[k], -self.clip, self.clip)
            clipped[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = torch.sqrt(self.v[k] / c2) + self.eps
            p.sub_(lr * (self.m[k] / c1) / denom)
        return clipped


def exponential_lr(lr: float, gamma: float, decay_steps: float):
    return lambda step: lr * gamma ** (step / decay_steps)


def lr_schedule(spec: dict):
    o = spec["optimizer"]
    return exponential_lr(o["lr"], o["gamma"], o["decay_steps"])

