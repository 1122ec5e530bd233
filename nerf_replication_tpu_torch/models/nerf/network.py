"""Coarse+fine NeRF network as ``nn.Module``s.

Port of ``nerf_replication_tpu/models/nerf/network.py``: the original-paper
MLP (D trunk layers of width W, the embedded position re-injected after layer
``skips``, a float32 density head, and a viewdirs branch feature(W) ⊕
dir-embedding → W/2 → float32 rgb head), coarse and fine instances owned by
one :class:`Network`.

Layout: each layer keeps the JAX parameter name (``pts_linear_i``,
``alpha_linear``, ``feature_linear``, ``views_linear_0``, ``rgb_linear``) and
the ``nn.Linear`` weight layout ``[out, in]``. A :class:`SplitDense` holds one
``[out, c1 + c2]`` weight and never builds the concatenated input, like the
Flax module. ``compute_dtype`` rounds the operands and the outputs of the
trunk, feature and views layers (Flax ``Dense(dtype=...)`` semantics); the
heads always run in float32 on a float32 copy of their input. A
proposal-sampling config adds the density-only ``proposal`` branch
(``models/proposal.py``) as a third model.
"""

from __future__ import annotations

import copy
import math
from typing import Sequence

import torch
import torch.nn as nn

from ..encoding import get_encoder

# the truncated-normal stddev correction flax's lecun_normal applies
# (variance_scaling "truncated_normal": stddev / .87962566103423978)
_TRUNC_STD = 0.87962566103423978


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """``x @ W.T + b`` with operands, product and sum in ``dtype``."""
    return x.to(dtype) @ weight.to(dtype).T + bias.to(dtype)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x, dtype=torch.float32):
        return _dense(x, self.weight, self.bias, dtype)


class SplitDense(nn.Module):
    """``Dense`` over ``concat([x1, x2], -1)`` without the concat: one
    ``[out, c1 + c2]`` weight, forward ``x1 @ W[:, :c1].T + x2 @ W[:, c1:].T
    + b`` (the Flax module's order of sums)."""

    def __init__(self, c1: int, c2: int, out_features: int):
        super().__init__()
        self.c1 = int(c1)
        self.weight = nn.Parameter(torch.empty(out_features, c1 + c2))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x1, x2, dtype=torch.float32):
        w = self.weight.to(dtype)
        return (
            x1.to(dtype) @ w[:, : self.c1].T
            + x2.to(dtype) @ w[:, self.c1:].T
            + self.bias.to(dtype)
        )


class NeRFMLP(nn.Module):
    """The original-paper NeRF MLP over pre-embedded inputs."""

    def __init__(self, D: int = 8, W: int = 256, input_ch: int = 63,
                 input_ch_views: int = 27, skips: Sequence[int] = (4,),
                 use_viewdirs: bool = True):
        super().__init__()
        self.D, self.W = int(D), int(W)
        self.input_ch, self.input_ch_views = int(input_ch), int(input_ch_views)
        self.skips = tuple(int(s) for s in skips)
        self.use_viewdirs = bool(use_viewdirs)
        for i in range(self.D):
            if i == 0:
                layer = Dense(self.input_ch, self.W)
            elif (i - 1) in self.skips:
                layer = SplitDense(self.input_ch, self.W, self.W)
            else:
                layer = Dense(self.W, self.W)
            self.add_module(f"pts_linear_{i}", layer)
        head_in = self.W + (self.input_ch if (self.D - 1) in self.skips else 0)
        if self.use_viewdirs:
            self.alpha_linear = Dense(head_in, 1)
            self.feature_linear = Dense(head_in, self.W)
            self.views_linear_0 = SplitDense(
                self.W, self.input_ch_views, self.W // 2
            )
            self.rgb_linear = Dense(self.W // 2, 3)
        else:
            self.output_linear = Dense(head_in, 4)

    def forward(self, embedded: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[..., input_ch + input_ch_views] → [..., 4] raw (r, g, b, σ)."""
        f32 = torch.float32
        input_pts = embedded[..., : self.input_ch]
        input_views = embedded[..., self.input_ch:]
        h = input_pts.to(dtype)
        pending_skip = None
        for i in range(self.D):
            layer = getattr(self, f"pts_linear_{i}")
            if pending_skip is not None:
                h = layer(pending_skip, h, dtype)
                pending_skip = None
            else:
                h = layer(h, dtype)
            h = torch.relu(h)
            if i in self.skips:
                pending_skip = input_pts.to(dtype)
        if pending_skip is not None:
            h = torch.cat([pending_skip, h], dim=-1)
        if self.use_viewdirs:
            alpha = self.alpha_linear(h.to(f32), f32)
            feature = self.feature_linear(h, dtype)
            h = torch.relu(
                self.views_linear_0(feature, input_views.to(dtype), dtype)
            )
            rgb = self.rgb_linear(h.to(f32), f32)
            return torch.cat([rgb, alpha], dim=-1)
        return self.output_linear(h.to(f32), f32)


class Network(nn.Module):
    """Coarse + fine NeRF pair behind one forward. A parametric
    ``xyz_encoder`` (a hash grid) is a submodule shared by both MLPs (state
    key ``xyz_encoder.embeddings``, the JAX tree's
    ``params["xyz_encoder"]["embeddings"]``); its output stays float32, as in
    Flax. ``compute_dtype`` is a forward-time attribute, so :meth:`clone`
    makes a bfloat16-compute view of the SAME parameters, table included.

    ``proposal_cfg`` (``(D, W, n_freqs)``, None = absent) adds the learned
    sampler's density branch (``models/proposal.py``) as a third model:
    ``model="proposal"`` returns raw ``[..., S, 1]`` σ."""

    def __init__(self, D: int = 8, W: int = 256, skips: Sequence[int] = (4,),
                 use_viewdirs: bool = True, xyz_encoder=None, dir_encoder=None,
                 input_ch: int = 63, input_ch_views: int = 27,
                 compute_dtype: torch.dtype = torch.float32,
                 proposal_cfg: tuple[int, int, int] | None = None):
        super().__init__()
        self.D, self.W = int(D), int(W)
        self.skips = tuple(int(s) for s in skips)
        self.use_viewdirs = bool(use_viewdirs)
        self.xyz_encoder = xyz_encoder
        self.dir_encoder = dir_encoder
        self.input_ch = int(input_ch)
        self.input_ch_views = int(input_ch_views) if use_viewdirs else 0
        self.compute_dtype = compute_dtype
        kwargs = dict(D=self.D, W=self.W, input_ch=self.input_ch,
                      input_ch_views=self.input_ch_views, skips=self.skips,
                      use_viewdirs=self.use_viewdirs)
        self.coarse = NeRFMLP(**kwargs)
        self.fine = NeRFMLP(**kwargs)
        self.proposal = None
        if proposal_cfg is not None:
            from ..proposal import ProposalMLP

            d_p, w_p, f_p = proposal_cfg
            self.proposal = ProposalMLP(D=d_p, W=w_p, n_freqs=f_p)

    def clone(self, compute_dtype: torch.dtype) -> "Network":
        """A view of this network that computes in ``compute_dtype``; the
        parameters (and their device) are shared, not copied."""
        other = copy.copy(self)
        object.__setattr__(other, "compute_dtype", compute_dtype)
        return other

    def forward(self, pts: torch.Tensor, viewdirs: torch.Tensor | None,
                model: str = "coarse") -> torch.Tensor:
        """``pts [..., S, 3]``, ``viewdirs [..., 3]`` → raw ``[..., S, 4]``
        (``[..., S, 1]`` raw σ for ``model="proposal"``)."""
        if model == "proposal":
            # density-only branch with its own encoding, no view input
            return self.proposal(pts, self.compute_dtype)
        embedded = self.xyz_encoder(pts)
        if self.use_viewdirs:
            dirs = viewdirs[..., None, :].expand(
                *pts.shape[:-1], viewdirs.shape[-1]
            )
            embedded = torch.cat([embedded, self.dir_encoder(dirs)], dim=-1)
        mlp = self.fine if model == "fine" else self.coarse
        return mlp(embedded, self.compute_dtype)


def _dtype(name) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def make_network(cfg) -> Network:
    """Build the Network from the reference-schema config; ``sampling.mode:
    proposal`` adds the proposal branch sized by ``sampling.net``."""
    if bool(cfg.network.nerf.get("scan_trunk", False)):
        raise NotImplementedError(
            "network.nerf.scan_trunk is a JAX compile-time layout and has no "
            "PyTorch counterpart"
        )
    prec = cfg.get("precision", {})
    xyz_enc, input_ch = get_encoder(cfg.network.xyz_encoder, prec)
    use_viewdirs = bool(cfg.task_arg.use_viewdirs)
    if use_viewdirs:
        dir_enc, input_ch_views = get_encoder(cfg.network.dir_encoder)
    else:
        dir_enc, input_ch_views = None, 0
    if str(prec.get("param_dtype", "float32")) != "float32":
        raise NotImplementedError("the port keeps float32 parameters")
    samp = cfg.get("sampling", {})
    proposal_cfg = None
    if str(samp.get("mode", "coarse_fine")) == "proposal":
        net = samp.get("net", {})
        proposal_cfg = (int(net.get("D", 2)), int(net.get("W", 64)),
                        int(net.get("freq", 5)))
    return Network(
        D=int(cfg.network.nerf.D),
        W=int(cfg.network.nerf.W),
        skips=tuple(cfg.network.nerf.skips),
        use_viewdirs=use_viewdirs,
        xyz_encoder=xyz_enc,
        dir_encoder=dir_enc,
        input_ch=input_ch,
        input_ch_views=input_ch_views,
        compute_dtype=_dtype(prec.get("compute_dtype", "float32")),
        proposal_cfg=proposal_cfg,
    )


def lecun_init(mlp: nn.Module, generator: torch.Generator) -> None:
    for module in mlp.modules():
        if isinstance(module, (Dense, SplitDense)):
            fan_in = module.weight.shape[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(module.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            module.weight.copy_(w)
            module.bias.zero_()


# the proposal branch's stream: its own generator, seeded from the caller's
# seed and this constant, so adding the branch leaves the other draws alone
_PROPOSAL_STREAM = 0x70726F70


@torch.no_grad()
def init_params(network: Network, generator: torch.Generator) -> Network:
    """Initialize both MLPs in place: lecun-normal kernels (flax's
    truncated normal, fan_in = the layer's input width) and zero biases,
    drawn from ``generator`` (coarse first, then fine), then a parametric
    encoder's table (uniform ±1e-4). A proposal branch draws from its own
    generator (seed ``generator.initial_seed() ^ _PROPOSAL_STREAM``), so the
    coarse, fine and table draws are those of a network without it. The
    draws differ from ``jax.random``'s; tests carry JAX weights over with
    ``convert.params_from_jax`` instead."""
    for mlp in (network.coarse, network.fine):
        lecun_init(mlp, generator)
    for enc in (network.xyz_encoder, network.dir_encoder):
        if isinstance(enc, nn.Module):
            enc.reset_parameters(generator)
    if network.proposal is not None:
        stream = torch.Generator().manual_seed(
            generator.initial_seed() ^ _PROPOSAL_STREAM)
        lecun_init(network.proposal, stream)
    return network
