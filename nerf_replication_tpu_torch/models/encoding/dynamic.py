"""Time-conditioned encoder family (port of
``nerf_replication_tpu/models/encoding/dynamic.py``).

Per-frame latent codes, a 4-D hash, basis-grid mixtures, and deformation
fields warping points into a canonical hash grid. Every class takes
``[..., 4]`` inputs ``(x, y, z, t)`` with ``t`` a frame index in ``[0,
num_frames)`` (the renderer broadcasts a ray's 7th column onto its samples).
"Frame 0 is canonical" is a per-point ``torch.where``, as in JAX.

The hash grids are :class:`~.hashgrid.HashGridEncoder` s, so on the card
every encode is kernel K6 and its backward K6b: D = 3 for the canonical and
basis grids, D = 2 for the motion planes, D = 4 for ``HashEncoder4d`` and
the coefficient grid. The deformation encoders (``DNeRFEncoder``,
``Motion2dEncoder``, ``DNeRFNGPEncoder``) differentiate through the encoded
points, so their K6b launches compute dx as well. Clips are
``hashgrid.clip`` (``jnp.clip``'s tie gradient). Parameter names follow the
Flax tree (``convert.params_from_jax`` carries a JAX tree over).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nerf.network import Dense, lecun_init
from .freq import frequency_encoder
from .hashgrid import HashGridEncoder, _register_bbox, clip, normalize_points
from .triplane import encode_planes, make_planes


def _hash_out_dim(hash_kwargs: dict | None) -> int:
    kw = hash_kwargs or {}
    return int(kw.get("num_levels", 16)) * int(kw.get("level_dim", 2))


def _hash(hash_kwargs: dict | None, **overrides) -> HashGridEncoder:
    return HashGridEncoder(**{**(hash_kwargs or {}), **overrides})


class _Dynamic(nn.Module):
    """Shared parts: the world bbox as buffers, and the seeded init of
    every table (uniform ±1e-4) and Dense layer (lecun normal) in module
    order."""

    def __init__(self, num_frames: int, bbox):
        super().__init__()
        self.num_frames = int(num_frames)
        _register_bbox(self, bbox)

    def _normalize(self, xyzt: torch.Tensor) -> torch.Tensor:
        return normalize_points(self, xyzt[..., :3])

    def _t_unit(self, xyzt: torch.Tensor) -> torch.Tensor:
        """``t / max(num_frames - 1, 1)``: the frame index in [0, 1]."""
        return xyzt[..., 3:] / max(self.num_frames - 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, HashGridEncoder):
                    module.reset_parameters(generator)
            lecun_init(self, generator)
            self._reset_own(generator)

    def _reset_own(self, generator: torch.Generator) -> None:
        pass


class HashLatentEncoder(_Dynamic):
    """hash(xyz) ⊕ the frame's latent code ``latent_t [num_frames,
    latent_dim]`` (the frame index truncated, as ``astype(int32)`` does,
    then clipped to the table)."""

    def __init__(self, num_frames: int, latent_dim: int = 32, bbox=None,
                 hash_kwargs: dict | None = None):
        super().__init__(num_frames, None)
        self.latent_dim = int(latent_dim)
        self.hash_kwargs = dict(hash_kwargs or {})
        self.hash = _hash(hash_kwargs, bbox=bbox)
        self.latent_t = nn.Parameter(
            torch.zeros(self.num_frames, self.latent_dim))

    @property
    def out_dim(self) -> int:
        return _hash_out_dim(self.hash_kwargs) + self.latent_dim

    def _reset_own(self, generator):
        t = torch.rand(self.latent_t.shape, generator=generator)
        self.latent_t.copy_(t * 2e-4 - 1e-4)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        feat = self.hash(xyzt[..., :3])
        t_idx = torch.clamp(xyzt[..., 3].to(torch.int64), 0,
                            self.num_frames - 1)
        # index_select: its backward is index_add_ (capturable)
        lat = torch.index_select(self.latent_t, 0, t_idx.reshape(-1))
        return torch.cat([feat, lat.reshape(*t_idx.shape, -1)], dim=-1)


class HashEncoder4d(_Dynamic):
    """A 4-D hash over (xyz normalized, t / num_frames)."""

    def __init__(self, num_frames: int, bbox, hash_kwargs: dict | None = None):
        super().__init__(num_frames, bbox)
        self.hash_kwargs = dict(hash_kwargs or {})
        self.hash = _hash(hash_kwargs, input_dim=4)

    @property
    def out_dim(self) -> int:
        return _hash_out_dim(self.hash_kwargs)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz = self._normalize(xyzt)
        t = xyzt[..., 3:] / self.num_frames
        return self.hash(torch.cat([xyz, t], dim=-1))


class HashCoefEncoder(_Dynamic):
    """A mixture of ``basis_num`` 3-D basis grids with (x, t)-dependent
    softmax coefficients from a 4-D grid at ``log2_hashmap_size`` 20 →
    Dense 64 → relu → Dense ``basis_num``."""

    def __init__(self, num_frames: int, bbox, basis_num: int = 6,
                 hash_kwargs: dict | None = None):
        super().__init__(num_frames, bbox)
        self.hash_kwargs = dict(hash_kwargs or {})
        self.basis = []
        for i in range(int(basis_num)):
            grid = _hash(hash_kwargs)
            self.add_module(f"basis_{i}", grid)
            self.basis.append(grid)
        self.coefs = _hash(hash_kwargs, input_dim=4, log2_hashmap_size=20)
        self.coef_hidden = Dense(self.coefs.out_dim, 64)
        self.coef_out = Dense(64, int(basis_num))

    @property
    def out_dim(self) -> int:
        return _hash_out_dim(self.hash_kwargs)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz = self._normalize(xyzt)
        xyzt_n = torch.cat([xyz, xyzt[..., 3:] / self.num_frames], dim=-1)
        h = torch.relu(self.coef_hidden(self.coefs(xyzt_n)))
        coefs = torch.softmax(self.coef_out(h), dim=-1)
        embs = torch.stack([b(xyz) for b in self.basis], dim=-2)  # [..., B, F]
        return torch.sum(embs * coefs[..., None], dim=-2)


class DeformationMLP(nn.Module):
    """Freq-embedded (x, t) → displacement Δx, zero at frame 0: ``depth``
    ReLU layers of ``width`` (``linear_i``, the embedded input re-joined
    after layer ``depth // 2``), then ``delta``."""

    def __init__(self, depth: int = 8, width: int = 128, xyz_freq: int = 10,
                 t_freq: int = 4):
        super().__init__()
        self.depth = int(depth)
        self.embed_x, dx = frequency_encoder(3, xyz_freq)
        self.embed_t, dt = frequency_encoder(1, t_freq)
        d_in = dx + dt
        width_in = d_in
        for i in range(self.depth):
            self.add_module(f"linear_{i}", Dense(width_in, width))
            width_in = width + (d_in if i == self.depth // 2 else 0)
        self.delta = Dense(width_in, 3)

    def forward(self, xyz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        h = torch.cat([self.embed_x(xyz), self.embed_t(t)], dim=-1)
        inp = h
        for i in range(self.depth):
            h = torch.relu(getattr(self, f"linear_{i}")(h))
            if i == self.depth // 2:
                h = torch.cat([inp, h], dim=-1)
        delta = self.delta(h)
        # canonical frame: no deformation at t == 0
        return torch.where(t == 0.0, torch.zeros_like(delta), delta)


class DNeRFEncoder(_Dynamic):
    """Deformation MLP → canonical hash grid; frame 0 maps unwarped."""

    def __init__(self, num_frames: int, bbox, hash_kwargs: dict | None = None,
                 depth: int = 8, width: int = 128):
        super().__init__(num_frames, bbox)
        self.hash_kwargs = dict(hash_kwargs or {})
        self.warp = DeformationMLP(depth=depth, width=width)
        self.hash = _hash(hash_kwargs)

    @property
    def out_dim(self) -> int:
        return _hash_out_dim(self.hash_kwargs)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz = self._normalize(xyzt)
        delta = self.warp(xyz, self._t_unit(xyzt))
        return self.hash(clip(xyz + delta, 0.0, 1.0))


class Motion2dEncoder(_Dynamic):
    """Tri-plane of 2-D hash grids on points warped by a sigmoid
    displacement MLP: ``xyz' = clip(x + 2·mlp(x, t) − 1, 0, 1)``, identity
    at frame 0."""

    def __init__(self, num_frames: int, bbox, mlp_depth: int = 8,
                 mlp_width: int = 128, hash_kwargs: dict | None = None):
        super().__init__(num_frames, bbox)
        self.hash_kwargs = dict(hash_kwargs or {})
        self.planes = make_planes(self, self.hash_kwargs)
        self.n_mlp = int(mlp_depth) - 1
        width_in = 4
        for i in range(self.n_mlp):
            self.add_module(f"mlp_{i}", Dense(width_in, mlp_width))
            width_in = mlp_width
        self.mlp_out = Dense(width_in, 3)

    @property
    def out_dim(self) -> int:
        return 3 * _hash_out_dim(self.hash_kwargs)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz = self._normalize(xyzt)
        t = self._t_unit(xyzt)
        h = torch.cat([xyz, t], dim=-1)
        for i in range(self.n_mlp):
            h = torch.relu(getattr(self, f"mlp_{i}")(h))
        delta = torch.sigmoid(self.mlp_out(h))
        warped = clip(xyz + 2.0 * delta - 1.0, 0.0, 1.0)
        xyz_eff = torch.where(t == 0.0, xyz, warped)
        return encode_planes(self.planes, xyz_eff)


class DNeRFNGPEncoder(_Dynamic):
    """Hash grid + a factorized (coordinate, time) deformation field with a
    temporal TV regularizer: per axis i, three ``[F, T, R]`` feature planes
    sampled at (t, x_j); their products summed over F give Δx_i."""

    def __init__(self, num_frames: int, bbox, feat_dim: int = 64,
                 feat_res: int = 256, hash_kwargs: dict | None = None):
        super().__init__(num_frames, bbox)
        self.hash_kwargs = dict(hash_kwargs or {})
        self.hash = _hash(hash_kwargs)
        # [axis i of Δx, the 3 factor planes, F, T, R]
        self.feat = nn.Parameter(torch.zeros(
            3, 3, int(feat_dim), self.num_frames, int(feat_res)))

    @property
    def out_dim(self) -> int:
        return _hash_out_dim(self.hash_kwargs)

    def _reset_own(self, generator):
        self.feat.copy_(0.1 * torch.randn(self.feat.shape,
                                          generator=generator))

    @staticmethod
    def _sample_plane(plane: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
        """Bilinear sample of ``[F, T, R]`` at (u ∈ [0, 1] → T, v ∈ [0, 1]
        → R), align_corners semantics: ``[F, ...]``. The four corners are
        ``index_select`` s of the flattened plane (backward: index_add_)."""
        f, n_t, n_r = plane.shape
        tu = clip(u, 0.0, 1.0) * (n_t - 1)
        rv = clip(v, 0.0, 1.0) * (n_r - 1)
        t0 = torch.clamp(torch.floor(tu).to(torch.int64), 0, n_t - 2)
        r0 = torch.clamp(torch.floor(rv).to(torch.int64), 0, n_r - 2)
        ft, fr = tu - t0, rv - r0
        flat = plane.reshape(f, n_t * n_r)
        base = (t0 * n_r + r0).reshape(-1)

        def corner(off):
            return torch.index_select(flat, 1, base + off).reshape(
                f, *u.shape)

        p00, p01, p10, p11 = corner(0), corner(1), corner(n_r), \
            corner(n_r + 1)
        return (p00 * (1 - ft) * (1 - fr) + p01 * (1 - ft) * fr
                + p10 * ft * (1 - fr) + p11 * ft * fr)

    def compute_delta(self, xyz_n: torch.Tensor,
                      t_n: torch.Tensor) -> torch.Tensor:
        """Δxyz ``[..., 3]`` from normalized coords and t ∈ [0, 1]."""
        deltas = []
        for i in range(3):
            prod = None
            for j in range(3):
                s = self._sample_plane(self.feat[i, j], t_n[..., 0],
                                       xyz_n[..., j])
                prod = s if prod is None else prod * s
            deltas.append(torch.sum(prod, dim=0))
        return torch.stack(deltas, dim=-1)

    def forward(self, xyzt: torch.Tensor) -> torch.Tensor:
        xyz = self._normalize(xyzt)
        t = self._t_unit(xyzt)
        d = self.compute_delta(xyz, t)
        delta = torch.where(t == 0.0, torch.zeros_like(d), d)
        return self.hash(clip(xyz + delta, 0.0, 1.0))

    def tv_loss(self, xyzt: torch.Tensor) -> torch.Tensor:
        """Temporal smoothness: ‖Δ(t) − Δ(t−1)‖² (‖Δ(0)‖² at frame 0)."""
        xyz = self._normalize(xyzt)
        t_idx = xyzt[..., 3:]
        denom = max(self.num_frames - 1, 1)
        d_now = self.compute_delta(xyz, t_idx / denom)
        d_prev = self.compute_delta(xyz, (t_idx - 1.0) / denom)
        sq = torch.where(t_idx == 0.0,
                         torch.sum(d_now ** 2, dim=-1, keepdim=True),
                         torch.sum((d_now - d_prev) ** 2, dim=-1,
                                   keepdim=True))
        return torch.mean(sq)
