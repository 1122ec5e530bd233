"""How far the fused MLP forward (K1, and its plain version) lands from the
same function in float64.

``raw_f64`` evaluates the fused MLP's flat weight list in float64 (the
order of ``ops.fused_mlp._forward_acts``, every operand widened), so the
error of K1's 3xTF32 chain and that of the plain float32 version can each
be read against the exact result. ``chip_smoke.py`` prints both on the
proposal path's fine pass and on a lego-trained network (phase 12).
"""

from __future__ import annotations

import torch


def raw_f64(spec, x: torch.Tensor, v: torch.Tensor,
            flat: list[torch.Tensor]) -> torch.Tensor:
    """``raw8 [M, 8]`` float64 of the fused MLP on ``x``/``v`` (padded
    rows and columns, as the kernels take them)."""
    d = torch.float64
    it = iter([w.to(d) for w in flat])
    x, v = x.to(d), v.to(d)
    h = torch.relu(x @ next(it) + next(it))
    for i in range(1, spec.D):
        if spec.skip is not None and i == spec.skip + 1:
            wx, wh, b = next(it), next(it), next(it)
            h = x @ wx + h @ wh + b
        else:
            w, b = next(it), next(it)
            h = h @ w + b
        h = torch.relu(h)
    wa, ba = next(it), next(it)
    alpha8 = h @ wa + ba
    wf, bf = next(it), next(it)
    f = h @ wf + bf
    wvf, wvv, bv = next(it), next(it), next(it)
    vh = torch.relu(f @ wvf + v @ wvv + bv)
    wr, br = next(it), next(it)
    return vh @ wr + br + alpha8


def forward_errors(spec, x: torch.Tensor, v: torch.Tensor,
                   flat: list[torch.Tensor], m: int) -> dict:
    """K1 (``mlp_forward``) and the plain version against float64 on the
    first ``m`` rows: max |error| of each over max |raw| (the live four
    columns), and max |raw|."""
    from ..ops import fused_mlp as fmlp

    with torch.no_grad():
        k1 = fmlp.mlp_forward(spec, x, v, flat, m)[:m, :4].double()
        plain = fmlp.forward_tile(spec, x[:m], v[:m], flat)[:, :4].double()
        exact = raw_f64(spec, x[:m], v[:m], flat)[:, :4]
    scale = float(exact.abs().max())
    return {
        "max_abs_raw": scale,
        "k1_rel_f64": float((k1 - exact).abs().max()) / max(scale, 1e-30),
        "plain_rel_f64": float((plain - exact).abs().max())
        / max(scale, 1e-30),
    }
