"""Fused NeRF-MLP tile chain: host side and its plain PyTorch version.

Port of the host side of ``nerf_replication_tpu/ops/fused_mlp.py``:
:class:`FusedSpec` (padded widths), :meth:`FusedSpec.flatten_params` (the
canonical weight order every fused kernel reads), :func:`fused_spec_for`
(the family gate) and :func:`forward_tile`, the plain version of the tile
chain that runs inside the fused march kernel (``csrc/mlp_tile.cuh``).

Rounding points follow the JAX ``_forward_tile``, not ``Network.forward``:
operands are cast to the compute dtype, every product accumulates in float32,
activations stay float32 between layers, biases are streamed in the compute
dtype, and the alpha and rgb heads run in float32 on float32 activations.
``raw = rgb8 + alpha8`` with rgb in columns 0-2 and alpha in column 3.

The standalone MLP kernel (TPU kernel K1) is not ported yet; this module
holds only what the fused march needs.
"""

from __future__ import annotations

import torch


def _rup(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_rows(a: torch.Tensor, to: int) -> torch.Tensor:
    r = a.shape[0]
    if r == to:
        return a
    return torch.cat([a, a.new_zeros((to - r,) + tuple(a.shape[1:]))], 0)


def _pad_cols(a: torch.Tensor, to: int) -> torch.Tensor:
    c = a.shape[-1]
    if c == to:
        return a
    return torch.cat([a, a.new_zeros(tuple(a.shape[:-1]) + (to - c,))], -1)


def _place_col(a: torch.Tensor, col: int, to: int) -> torch.Tensor:
    """Pad ``[..., 1]`` to ``[..., to]`` with the live column at ``col``."""
    out = a.new_zeros(tuple(a.shape[:-1]) + (to,))
    out[..., col:col + a.shape[-1]] = a
    return out


class FusedSpec:
    """Static geometry of one fused MLP (shapes after padding)."""

    def __init__(self, D, W, skip, c_in, c_views, compute_dtype):
        if skip is not None and not (0 <= skip < D - 1):
            raise ValueError(
                f"fused_trunk: skip={skip} must feed a later trunk layer "
                f"(D={D}) — a skip at the last layer changes the head width"
            )
        self.D, self.W, self.skip = int(D), int(W), skip
        self.W2 = self.W // 2
        self.c_in, self.c_views = int(c_in), int(c_views)
        self.c_in_pad = _rup(max(self.c_in, 1), 64)
        self.c_views_pad = _rup(max(self.c_views, 1), 32)
        self.compute_dtype = compute_dtype

    # canonical order (compute-dtype streams for trunk/feature/views,
    # float32 heads; [in, out] layout; padded):
    #   W0 [c_in_pad, W], b0 [1, W]
    #   per trunk layer i in 1..D-1:
    #       skip+1: Wsx [c_in_pad, W], Wsh [W, W], bs [1, W]
    #       else:   Wi [W, W], bi [1, W]
    #   Wa [W, 8], ba [1, 8]       (alpha head, live column 3)
    #   Wf [W, W], bf [1, W]       (feature head)
    #   Wvf [W, W2], Wvv [c_views_pad, W2], bv [1, W2]
    #   Wr [W2, 8], br [1, 8]      (rgb head, live columns 0..2)
    def flatten_params(self, branch) -> list[torch.Tensor]:
        """``branch`` is one ``NeRFMLP`` (``network.fine`` / ``.coarse``)."""
        sd = self.compute_dtype
        f32 = torch.float32

        def kb(name, dtype=None):
            dt = sd if dtype is None else dtype
            layer = getattr(branch, name)
            k = layer.weight.detach().T.to(dt)
            b = layer.bias.detach().to(dt).reshape(1, -1)
            return k, b

        out = []
        k0, b0 = kb("pts_linear_0")
        out += [_pad_rows(k0, self.c_in_pad), b0]
        for i in range(1, self.D):
            ki, bi = kb(f"pts_linear_{i}")
            if self.skip is not None and i == self.skip + 1:
                out += [_pad_rows(ki[: self.c_in], self.c_in_pad),
                        ki[self.c_in:], bi]
            else:
                out += [ki, bi]
        ka, ba = kb("alpha_linear", f32)
        out += [_place_col(ka, 3, 8), _place_col(ba, 3, 8)]
        kf, bf = kb("feature_linear")
        out += [kf, bf]
        kv, bv = kb("views_linear_0")
        out += [kv[: self.W], _pad_rows(kv[self.W:], self.c_views_pad), bv]
        kr, br = kb("rgb_linear", f32)
        out += [_pad_cols(kr, 8), _pad_cols(br, 8)]
        return [t.contiguous() for t in out]

    def n_params(self) -> int:
        n = 2
        for i in range(1, self.D):
            n += 3 if (self.skip is not None and i == self.skip + 1) else 2
        return n + 2 + 2 + 3 + 2

    def head_indices(self) -> tuple[int, int, int, int]:
        """Positions of (Wa, ba, Wr, br) in the flattened list."""
        n = self.n_params()
        ia = n - 9
        return ia, ia + 1, n - 2, n - 1


def pack_for_kernel(spec: FusedSpec, flat: list[torch.Tensor]):
    """The kernel's two weight buffers: every compute-dtype tensor of the
    canonical order concatenated flat (``stream``), and the float32 heads
    ``[Wa, ba, Wr, br]`` concatenated flat (``heads``). The kernel derives
    each tensor's offset from (D, W, skip, c_in_pad, c_views_pad) in the
    same order. float32 matrices keep the ``[in, out]`` layout of the
    CUDA-core GEMM; bfloat16 matrices are stored ``[out, in]``, the layout
    the tensor cores take their B operand in (``csrc/mlp_tile.cuh``)."""
    heads_at = set(spec.head_indices())
    out_major = spec.compute_dtype == torch.bfloat16

    def kernel_layout(t):
        return t.T.contiguous() if out_major and t.shape[0] > 1 else t

    stream = torch.cat([kernel_layout(t).reshape(-1)
                        for i, t in enumerate(flat)
                        if i not in heads_at]).contiguous()
    heads = torch.cat([flat[i].reshape(-1).to(torch.float32)
                       for i in sorted(heads_at)]).contiguous()
    return stream, heads


def forward_tile(spec: FusedSpec, x: torch.Tensor, v: torch.Tensor,
                 ws: list[torch.Tensor]) -> torch.Tensor:
    """The whole MLP on one tile of rows: ``x [M, c_in_pad]``, ``v [M,
    c_views_pad]`` float32, ``ws`` in flatten order → ``raw8 [M, 8]``.

    bfloat16 operands are exact in float32, so a float32 product of the
    rounded operands is the bf16-operand / f32-accumulate product."""
    cd = spec.compute_dtype
    f32 = torch.float32

    def mm(a, w):
        return a.to(cd).to(f32) @ w.to(f32)

    it = iter(ws)
    h = torch.relu(mm(x, next(it)) + next(it).to(f32))
    for i in range(1, spec.D):
        if spec.skip is not None and i == spec.skip + 1:
            wx, wh, b = next(it), next(it), next(it)
            h = mm(x, wx) + mm(h, wh) + b.to(f32)
        else:
            w, b = next(it), next(it)
            h = mm(h, w) + b.to(f32)
        h = torch.relu(h)
    wa, ba = next(it), next(it)
    alpha8 = h @ wa + ba
    wf, bf = next(it), next(it)
    f = mm(h, wf) + bf.to(f32)
    wvf, wvv, bv = next(it), next(it), next(it)
    vh = torch.relu(mm(f, wvf) + mm(v, wvv) + bv.to(f32))
    wr, br = next(it), next(it)
    rgb8 = vh @ wr + br
    return rgb8 + alpha8


def fused_spec_for(network) -> FusedSpec:
    """Validate a network is kernel-fusable and return its FusedSpec
    (the same family gate as the JAX package; refuses loudly)."""
    from ..models.encoding import FrequencyEncoder
    from ..models.nerf.network import Network

    if not isinstance(network, Network):
        raise ValueError("fused_trunk supports the NeRF Network family")
    if not isinstance(network.xyz_encoder, FrequencyEncoder) or not (
            network.dir_encoder is None
            or isinstance(network.dir_encoder, FrequencyEncoder)):
        raise ValueError(
            "fused_trunk requires parameter-free frequency encoders"
        )
    if not network.use_viewdirs:
        raise ValueError("fused_trunk requires use_viewdirs (rgb branch)")
    skips = tuple(network.skips)
    if len(skips) != 1:
        raise ValueError("fused_trunk supports exactly one skip index")
    return FusedSpec(
        D=network.D, W=network.W, skip=skips[0],
        c_in=network.input_ch, c_views=network.input_ch_views,
        compute_dtype=network.compute_dtype,
    )
