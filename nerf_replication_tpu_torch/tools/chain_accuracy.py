"""How far the fused MLP forward (K1, and its plain version) lands from the
same function in float64, and the backward (K2) from its float64 gradients.

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


def backward_errors(spec, x: torch.Tensor, v: torch.Tensor,
                    draw: torch.Tensor, flat: list[torch.Tensor],
                    m: int) -> dict:
    """K2 (``mlp_backward``) and the plain version (``backward_tile``)
    against the float64 gradients of :func:`raw_f64` under the cotangent
    ``draw [M, 8]`` on the first ``m`` rows: dx as max |error| over
    max |dx|, the weight gradients as the largest relative Frobenius error
    of any tensor."""
    from ..ops import fused_mlp as fmlp

    d = torch.float64
    xs = x[:m].to(d).requires_grad_(True)
    ws = [w.detach().to(d).requires_grad_(True) for w in flat]
    with torch.enable_grad():
        raw = raw_f64(spec, xs, v[:m], ws)
        exact = torch.autograd.grad((raw * draw[:m].to(d)).sum(),
                                    [xs, *ws])
    with torch.no_grad():
        dx_k2, _, g_k2 = fmlp.mlp_backward(spec, x, v, draw, flat, m)
        dx_pl, _, g_pl = fmlp.backward_tile(spec, x[:m], v[:m], draw[:m],
                                            flat)

    def dx_rel(got):
        return float((got[:m].double() - exact[0]).abs().max()) / max(
            float(exact[0].abs().max()), 1e-30)

    def dw_fro(got):
        return max(float(torch.linalg.vector_norm(g.double() - e))
                   / max(float(torch.linalg.vector_norm(e)), 1e-30)
                   for g, e in zip(got, exact[1:]))

    return {"k2_dx_rel_f64": dx_rel(dx_k2), "plain_dx_rel_f64": dx_rel(dx_pl),
            "k2_dw_fro_f64": dw_fro(g_k2), "plain_dw_fro_f64": dw_fro(g_pl)}
