"""The fused NeRF MLP: host side, the kernels K1/K2/K3a/K3b and their plain
versions.

Port of ``nerf_replication_tpu/ops/fused_mlp.py``: :class:`FusedSpec`
(padded widths) and :meth:`FusedSpec.flatten_params` (the canonical weight
order every fused kernel reads, differentiable as the JAX one is),
:func:`fused_spec_for` (the family gate), :func:`fused_mlp_raw` and
:func:`make_fused_apply` (the MLP of ``network.nerf.fused_trunk: true``).

Two TPU kernels become hand-written CUDA kernels, each beside a plain
PyTorch version of the same function:

* **K1**, :func:`mlp_forward` (replaces ``_fwd_kernel``, fused_mlp.py:339;
  ``csrc/fused_mlp.cu``): the whole MLP per tile of rows (128 bf16, 64
  float32) on the Hopper chain of ``csrc/mlp_chain_sm90.cuh`` (wgmma
  products, bf16 or 3xTF32 into IEEE float32 sums; weights through a TMA
  ring in :func:`pack_for_chain`'s image), writing only ``raw8 [M, 8]``;
  plain version :func:`forward_tile`.
* **K2**, :func:`mlp_backward` (replaces ``_bwd_kernel``, fused_mlp.py:348;
  ``csrc/fused_mlp_bwd.cu``): two kernels and an ordered reduce. **K2a**
  recomputes the forward per 64-row tile and runs the dX chain on K1's
  Hopper chain (wgmma products; the forward's weights in
  :func:`pack_for_chain`'s image, then each ``w^T`` in
  :func:`pack_for_dx_chain`'s, through one TMA ring), and writes every
  operand of the weight gradients to a scratch by bulk copies. Its bound
  on the card is the operations (the recompute in the compute dtype, the
  dX chain as three TF32 products a float32 product), then the scratch's
  bytes (plain version :func:`backward_rows`); **K2b** sums ``dW = A^T
  Z`` and ``db = sum Z`` over all rows as long-K products, each split of
  the rows into its own partial (plain version :func:`weight_grads`).
  Rows go through in chunks of at most MAX_CHUNK_TILES x 64 rows
  (``csrc/fused_mlp_bwd.cu``: bounds the scratch, ~2.8 GB at lego width);
  one reduce sums every chunk's partials in order. Plain version of the
  whole: :func:`backward_tile`.

:class:`FusedMLPFunction` ties them into autograd: its forward launches K1
and saves only ``(x, v, flat weights)``; its backward launches K2. A wrapper
runs the plain version for tensors on the CPU and the kernel for tensors on
a card; there is no fallback from one to the other. Each launch adds one to
:data:`LAUNCHES`.

Rounding points follow the JAX ``_forward_tile``, not ``Network.forward``:
operands are cast to the compute dtype, every product accumulates in float32,
activations stay float32 between layers, biases are streamed in the compute
dtype, and the alpha and rgb heads run in float32 on float32 activations.
``raw = rgb8 + alpha8`` with rgb in columns 0-2 and alpha in column 3. Every
backward product is float32 whatever the compute dtype (``_backward_tile``),
and a bf16-streamed weight's gradient is rounded to bf16 before it flows back
to its float32 parameter (fused_mlp.py:501-504).

Two more TPU kernels, the masked variants the packed march streams its
occupancy bit into, become :func:`mlp_forward` / :func:`mlp_backward` with a
``valid`` argument (the same CUDA source, a compile-time ``MASKED`` flag on
the K1/K2 bodies):

* **K3a** (replaces ``_fwd_kernel_masked``, fused_mlp.py:370): K1 times the
  per-row valid bit; a 64-row tile with no valid row writes zeros and skips
  its chain. Plain version: ``forward_tile(...) * valid``.
* **K3b** (replaces ``_bwd_kernel_masked``, fused_mlp.py:397): K2 with the
  cotangent times the valid bit; K2a flags a tile with no valid row dead
  (zero dx/dv, nothing into the scratch) and K2b skips dead tiles. Plain
  version: ``backward_tile`` with ``draw * valid``.

:class:`FusedMLPMaskedFunction` ties K3a/K3b into autograd; the bit is data
routing and gets no gradient. :func:`fused_mlp_raw_masked` pads rows to the
tile as the JAX package does, the pad rows invalid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# kernel launches per wrapper since the last reset (chip_smoke.py resets it
# right before it drives the training path and reads it right after)
# (K2 / K3b count once per backward call; their kernels K2a, K2b and the
# reduce count per launch beside them)
LAUNCHES: dict[str, int] = {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0,
                            "fused_mlp_fwd_masked": 0,
                            "fused_mlp_bwd_masked": 0,
                            "fused_mlp_bwd_rows": 0, "fused_mlp_bwd_dw": 0,
                            "fused_mlp_bwd_reduce": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rup(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pad_rows(a: torch.Tensor, to: int) -> torch.Tensor:
    r = a.shape[0]
    if r == to:
        return a
    return F.pad(a, (0, 0) * (a.dim() - 1) + (0, to - r))


def _pad_cols(a: torch.Tensor, to: int) -> torch.Tensor:
    c = a.shape[-1]
    if c == to:
        return a
    return F.pad(a, (0, to - c))


def _place_col(a: torch.Tensor, col: int, to: int) -> torch.Tensor:
    """Pad ``[..., 1]`` to ``[..., to]`` with the live column at ``col``
    (its gradient is the live column's)."""
    return F.pad(a, (col, to - col - a.shape[-1]))


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
        """``branch`` is one ``NeRFMLP`` (``network.fine`` / ``.coarse``).

        Differentiable: the transposes, casts and pads route a gradient of
        the flat list back to the branch's parameters (the JAX trainer
        differentiates through its flatten the same way); the cast's
        backward upcasts a bf16 gradient to the float32 parameter."""
        sd = self.compute_dtype
        f32 = torch.float32

        def kb(name, dtype=None):
            dt = sd if dtype is None else dtype
            layer = getattr(branch, name)
            return layer.weight.T.to(dt), layer.bias.to(dt).reshape(1, -1)

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


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32, to nearest with ties away from zero
    (``cvt.rna``; the chain's ``tf32_rna``): half a TF32 ulp added to the
    magnitude bits, the low 13 mantissa bits cleared."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 4096) & -8192).view(torch.float32)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t ~ hi + lo`` with ``hi`` and ``lo`` TF32 values, each
    rounded to nearest (CUTLASS's 3xTF32 split; the chain's device
    ``split_tf32`` bit for bit): ``|t - hi - lo| <= 2^-22 |t|`` without a
    sign bias. The tensor core reads a TF32 operand as it is."""
    hi = tf32_rna(t)
    return hi, tf32_rna(t - hi)


def split_trunc(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``t = hi + lo`` exactly, ``hi`` = ``t`` truncated to TF32
    (its low 13 mantissa bits cleared), ``lo = t - hi`` (|lo| < 2^-10 |t|;
    the tensor core reads its TF32 part): K2's split, the chain's device
    ``split_trunc``."""
    t = t.contiguous()
    hi = (t.view(torch.int32) & -8192).view(torch.float32)
    return hi, t - hi


# (matrix shapes, values in 16 bytes, parts a step, transposed, device) ->
# (gather index, low-part flag) of a chain weight image; see _chain_layout
_CHAIN_LAYOUTS: dict = {}


def _chain_layout(shapes: list[tuple[int, int]], e: int, two_parts: bool,
                  transposed: bool, device):
    """Where each element of a chain weight image comes from: an index into
    the matrices concatenated flat (each ``[in, out]`` row-major, in flatten
    order) and, with ``two_parts`` (a TF32-high and a low part a k-step),
    whether the element is a low part. ``e`` values fill 16 bytes (4
    float32, 8 bf16). ``shapes`` are the products' ``B [K, N]``: the
    matrices themselves, or (``transposed``) their transposes, read from the
    untransposed matrices. Built once per geometry, so that packing is one
    gather and an elementwise split (a handful of kernels), not a chain of
    small copies per matrix on every call."""
    key = (tuple(shapes), e, two_parts, transposed, str(device))
    if key not in _CHAIN_LAYOUTS:
        idx, low, off = [], [], 0
        for k, n in shapes:
            src = torch.arange(off, off + k * n)
            src = src.reshape(n, k).T if transposed else src.reshape(k, n)
            steps = src.T.reshape(n, k // (2 * e), 2, e).permute(1, 2, 0, 3)
            if two_parts:  # each step: high part, then low part
                steps = torch.stack([steps, steps], 1)
                part = torch.zeros(steps.shape, dtype=torch.bool)
                part[:, 1] = True
                low.append(part.reshape(-1))
            idx.append(steps.reshape(-1))
            off += k * n
        _CHAIN_LAYOUTS[key] = (torch.cat(idx).to(device),
                               torch.cat(low).to(device) if low else None)
    return _CHAIN_LAYOUTS[key]


def _chain_matrices(spec: FusedSpec, flat: list[torch.Tensor]):
    """``(matrices, biases)`` of the canonical order but the heads, each
    checked to stream in the spec's compute dtype."""
    heads_at = set(spec.head_indices())
    cd = spec.compute_dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype {cd} (f32 or bf16)")
    mats, biases = [], []
    for i, t in enumerate(flat):
        if i in heads_at:
            continue
        if t.dtype != cd:
            raise TypeError(f"weights stream as {t.dtype}, the spec computes "
                            f"in {cd}")
        (biases if t.shape[0] == 1 else mats).append(t)
    return mats, biases


def pack_for_chain(spec: FusedSpec, flat: list[torch.Tensor]):
    """The forward chain's three buffers (K1/K3a, K5 and K2a's recompute;
    ``csrc/mlp_chain_sm90.cuh``): ``wmat``, every matrix of the canonical
    order but the heads, in the shared-memory image its tensor-core products
    read;
    ``bias``, every bias but the heads' as float32 (of its compute-dtype
    value); ``heads``, the float32 ``[Wa, ba, Wr, br]``.

    A matrix ``w [K, N]`` (``[in, out]``) is stored K-major, ``w.T``, as
    k-steps of 32 bytes (8 float32 or 16 bf16 values of k), each step as
    ``[2, N, 16 bytes]`` (the two 16-byte halves of its k, every output row
    n within each: the core-matrix layout of a no-swizzle wgmma operand).
    float32 steps hold two such parts: the TF32 high part, then the low
    part (:func:`split_tf32`), split here once instead of per tile."""
    mats, biases = _chain_matrices(spec, flat)
    f32 = spec.compute_dtype == torch.float32
    idx, low = _chain_layout([tuple(t.shape) for t in mats], 4 if f32 else 8,
                             f32, False, flat[0].device)
    wmat = torch.cat([t.reshape(-1) for t in mats])[idx]
    if low is not None:
        hi, lo = split_tf32(wmat)
        wmat = torch.where(low, lo, hi)
    heads = torch.cat([flat[i].reshape(-1).to(torch.float32)
                       for i in spec.head_indices()])
    bias = torch.cat([b.reshape(-1) for b in biases]).to(torch.float32)
    return wmat, bias, heads


def pack_for_dx_chain(spec: FusedSpec, flat: list[torch.Tensor]):
    """K2a's dX-chain weights (``csrc/mlp_chain_sm90.cuh``, the backward's
    pieces): for every matrix of the canonical order but the heads, in that
    order, ``w.T`` — the B operand of ``dotT(dz, w) = dz @ w.T``, ``[K, N]``
    = ``[out, in]`` — as float32 in :func:`pack_for_chain`'s float32 layout
    (K-major k-steps of 8, each a TF32-high part then a low part), split
    truncating (:func:`split_trunc`, K2's split) whatever the compute dtype:
    every backward product is float32. A bf16 weight is a TF32 value, its
    low part zero: the bf16 family's image holds the high parts alone (the
    kernel reads the low part from zeros in shared memory). The kernel
    streams the products in the dX chain's order from these offsets."""
    mats, _ = _chain_matrices(spec, flat)
    f32 = spec.compute_dtype == torch.float32
    idx, low = _chain_layout([tuple(t.shape[::-1]) for t in mats], 4, f32,
                             True, flat[0].device)
    hi, lo = split_trunc(torch.cat([t.reshape(-1) for t in mats])[idx]
                         .to(torch.float32))
    return torch.where(low, lo, hi) if f32 else hi


def _forward_acts(spec: FusedSpec, x: torch.Tensor, v: torch.Tensor,
                  ws: list[torch.Tensor]):
    """``(raw8, acts)``: the JAX ``_forward_tile`` with its activation list
    (the D trunk outputs after relu, the feature, the views branch)."""
    cd = spec.compute_dtype
    f32 = torch.float32

    def mm(a, w):
        return a.to(cd).to(f32) @ w.to(f32)

    it = iter(ws)
    acts = []
    h = torch.relu(mm(x, next(it)) + next(it).to(f32))
    acts.append(h)
    for i in range(1, spec.D):
        if spec.skip is not None and i == spec.skip + 1:
            wx, wh, b = next(it), next(it), next(it)
            h = mm(x, wx) + mm(h, wh) + b.to(f32)
        else:
            w, b = next(it), next(it)
            h = mm(h, w) + b.to(f32)
        h = torch.relu(h)
        acts.append(h)
    wa, ba = next(it), next(it)
    alpha8 = h @ wa + ba
    wf, bf = next(it), next(it)
    f = mm(h, wf) + bf.to(f32)
    acts.append(f)
    wvf, wvv, bv = next(it), next(it), next(it)
    vh = torch.relu(mm(f, wvf) + mm(v, wvv) + bv.to(f32))
    acts.append(vh)
    wr, br = next(it), next(it)
    rgb8 = vh @ wr + br
    return rgb8 + alpha8, acts


def forward_tile(spec: FusedSpec, x: torch.Tensor, v: torch.Tensor,
                 ws: list[torch.Tensor]) -> torch.Tensor:
    """The whole MLP on one tile of rows: ``x [M, c_in_pad]``, ``v [M,
    c_views_pad]`` float32, ``ws`` in flatten order → ``raw8 [M, 8]``.

    bfloat16 operands are exact in float32, so a float32 product of the
    rounded operands is the bf16-operand / f32-accumulate product."""
    return _forward_acts(spec, x, v, ws)[0]


def _t_dot(a, b):  # a.T @ b, float32
    return a.to(torch.float32).T @ b.to(torch.float32)


def backward_rows(spec: FusedSpec, x: torch.Tensor, v: torch.Tensor,
                  draw: torch.Tensor, ws: list[torch.Tensor]):
    """K2a's plain version: the recompute and the dX chain of the JAX
    ``_backward_tile``. Returns ``(dx, dv, rows)``; ``rows`` holds every
    float32 operand of the weight gradients, what K2a writes to its
    scratch: ``x``, ``v``, ``d8`` (the cotangent), ``acts`` (the D trunk
    outputs after relu, the feature, the views branch), ``dz`` (the D
    trunk cotangents after their relu masks), ``df`` and ``dvh``. Every
    product is float32; both heads take the full ``[M, 8]`` cotangent."""
    f32 = torch.float32
    _, acts = _forward_acts(spec, x, v, ws)
    it = iter(ws)
    w0, _b0 = next(it), next(it)
    trunk = []
    for i in range(1, spec.D):
        if spec.skip is not None and i == spec.skip + 1:
            trunk.append((next(it), next(it), next(it)))
        else:
            trunk.append((next(it), next(it)))
    wa, _ba = next(it), next(it)
    wf, _bf = next(it), next(it)
    wvf, wvv, _bv = next(it), next(it), next(it)
    wr, _br = next(it), next(it)

    def dot_t(a, b):  # a @ b.T
        return a.to(f32) @ b.to(f32).T

    draw = draw.to(f32)
    vh = acts[spec.D + 1]
    dvh = dot_t(draw, wr) * (vh > 0)
    df = dot_t(dvh, wvf)
    dv = dot_t(dvh, wvv)
    dh = dot_t(df, wf) + dot_t(draw, wa)
    dx = torch.zeros_like(x, dtype=f32)
    dz = [None] * spec.D
    for i in range(spec.D - 1, 0, -1):
        dz[i] = dh * (acts[i] > 0)
        if spec.skip is not None and i == spec.skip + 1:
            wx, wh, _ = trunk[i - 1]
            dx = dx + dot_t(dz[i], wx)
            dh = dot_t(dz[i], wh)
        else:
            w, _ = trunk[i - 1]
            dh = dot_t(dz[i], w)
    dz[0] = dh * (acts[0] > 0)
    dx = dx + dot_t(dz[0], w0)
    rows = {"x": x, "v": v, "d8": draw, "acts": acts, "dz": dz, "df": df,
            "dvh": dvh}
    return dx, dv, rows


def grad_operands(spec: FusedSpec, rows: dict):
    """``(A, Z)`` of every tensor of the flatten order: its gradient is
    ``A^T Z`` for a weight and the column sum of ``Z`` for a bias (``A``
    None) — the jobs of K2b."""
    x, v, d8, acts, dz = (rows[k] for k in ("x", "v", "d8", "acts", "dz"))
    ops = [(x, dz[0]), (None, dz[0])]
    for i in range(1, spec.D):
        if spec.skip is not None and i == spec.skip + 1:
            ops += [(x, dz[i]), (acts[i - 1], dz[i]), (None, dz[i])]
        else:
            ops += [(acts[i - 1], dz[i]), (None, dz[i])]
    h, f, vh = acts[spec.D - 1], acts[spec.D], acts[spec.D + 1]
    df, dvh = rows["df"], rows["dvh"]
    return ops + [(h, d8), (None, d8), (h, df), (None, df), (f, dvh),
                  (v, dvh), (None, dvh), (vh, d8), (None, d8)]


def weight_grads(spec: FusedSpec, rows: dict, bounds=None):
    """K2b and the reduce, plain: one float32 gradient per tensor of the
    flatten order from K2a's operands ``rows``, each taken over the row
    ranges ``bounds`` (``[(lo, hi), ...]``; default all rows at once) and
    summed in their order, as the kernels sum their splits and chunks."""
    if bounds is None:
        bounds = [(0, rows["d8"].shape[0])]
    grads = []
    for a, z in grad_operands(spec, rows):
        g = None
        for lo, hi in bounds:
            part = z[lo:hi].sum(0, keepdim=True) if a is None \
                else _t_dot(a[lo:hi], z[lo:hi])
            g = part if g is None else g + part
        grads.append(g)
    return grads


def backward_tile(spec: FusedSpec, x: torch.Tensor, v: torch.Tensor,
                  draw: torch.Tensor, ws: list[torch.Tensor]):
    """The JAX ``_backward_tile``: recompute the forward, return ``(dx,
    dv, grads)`` with one float32 gradient per tensor of ``ws`` — K2a's
    and K2b's plain versions over all rows at once."""
    dx, dv, rows = backward_rows(spec, x, v, draw, ws)
    return dx, dv, weight_grads(spec, rows)


# -- kernels -------------------------------------------------------------------


def _desc(spec: FusedSpec):
    from .kernels import MlpDescC

    return MlpDescC(spec.D, spec.W, -1 if spec.skip is None else spec.skip,
                    spec.c_in_pad, spec.c_views_pad, 0, 0)


def _check(spec: FusedSpec, x, v, flat, m: int):
    dev = x.device
    if x.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("x and v must be float32")
    if x.dim() != 2 or x.shape[1] != spec.c_in_pad or v.dim() != 2 or \
            v.shape != (x.shape[0], spec.c_views_pad):
        raise ValueError(
            f"x must be [M, {spec.c_in_pad}] and v [M, {spec.c_views_pad}], "
            f"got {tuple(x.shape)} and {tuple(v.shape)}")
    if not 0 <= m <= x.shape[0]:
        raise ValueError(f"m={m} real rows of {x.shape[0]}")
    if len(flat) != spec.n_params():
        raise ValueError(f"{len(flat)} weight tensors, expected "
                         f"{spec.n_params()}")
    for t in (v, *flat):
        if t.device != dev:
            raise ValueError(f"a tensor is on {t.device}, x on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _check_kernel_shape(spec: FusedSpec):
    if spec.W % 64 or spec.W > 256 or spec.c_in_pad > 64 or \
            spec.c_views_pad > 32 or not 2 <= spec.D <= 24:
        raise ValueError(
            f"the fused MLP kernels take 2 <= D <= 24, W a multiple of 64 up "
            f"to 256 and padded encodings <= 64/32 wide, got D={spec.D}, "
            f"W={spec.W}, c_in_pad={spec.c_in_pad}, "
            f"c_views_pad={spec.c_views_pad}")
    if spec.compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute dtype {spec.compute_dtype} (f32 or bf16)")


def _check_valid(valid, x) -> torch.Tensor | None:
    """The per-row valid bit as a contiguous float32 [M] (0/1, or bool /
    uint8 converted), on x's device; ``None`` passes through."""
    if valid is None:
        return None
    if valid.shape not in ((x.shape[0],), (x.shape[0], 1)) or \
            valid.device != x.device:
        raise ValueError(f"valid must be [{x.shape[0]}] (or [M, 1]) on "
                         f"{x.device}, got {tuple(valid.shape)} on "
                         f"{valid.device}")
    return valid.reshape(-1).to(torch.float32).contiguous()


def mlp_forward(spec: FusedSpec, x: torch.Tensor, v: torch.Tensor,
                flat: list[torch.Tensor], m: int | None = None,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """K1 (or K3a with ``valid``): ``raw8 [M, 8]`` of the first ``m`` rows
    (default all), times the row's valid bit when ``valid [M]`` is given;
    the other rows are zero. The plain version for CPU tensors, the CUDA
    kernel (``csrc/fused_mlp.cu``) for CUDA tensors."""
    m = x.shape[0] if m is None else int(m)
    _check(spec, x, v, flat, m)
    valid = _check_valid(valid, x)
    if x.device.type == "cpu":
        out = x.new_zeros((x.shape[0], 8))
        if m:
            raw = forward_tile(spec, x[:m], v[:m], flat)
            out[:m] = raw if valid is None else raw * valid[:m, None]
        return out
    _check_kernel_shape(spec)
    from .kernels import _ptr, _raise_on, _stream, load

    lib = load("fused_mlp")
    wmat, bias, heads = pack_for_chain(spec, flat)
    x, v = x.contiguous(), v.contiguous()
    out = torch.empty((x.shape[0], 8), dtype=torch.float32, device=x.device)
    if m < x.shape[0]:
        out[m:].zero_()
    desc = _desc(spec)
    import ctypes

    bf16 = int(spec.compute_dtype == torch.bfloat16)
    name = "fused_mlp_fwd" if valid is None else "fused_mlp_fwd_masked"
    err = lib.nrt_fused_mlp_fwd(
        _ptr(x), _ptr(v), _ptr(valid), m, ctypes.byref(desc), _ptr(wmat),
        _ptr(bias), bf16, _ptr(heads), _ptr(out), _stream(x.device))
    _raise_on(lib, err, name)
    LAUNCHES[name] += 1
    return out


def _bwd_layout(lib, desc) -> tuple[int, int, int, int]:
    """(scratch floats per 64-row tile, K2b gradient tiles, gradient
    floats, the most tiles a chunk may hold) of one geometry."""
    import ctypes

    out = (ctypes.c_longlong * 4)()
    err = lib.nrt_fused_mlp_bwd_layout(ctypes.byref(desc), out)
    if err:
        raise ValueError(
            "the fused MLP backward kernels take what the forward takes "
            "with D >= 2, c_in_pad 32 or 64 and c_views_pad 32")
    return tuple(int(t) for t in out)


def chunk_tiles(m: int, chunk: int) -> list[int]:
    """The 64-row tiles of each K2a + K2b chunk of ``chunk`` rows over the
    first ``m`` rows."""
    return [-(-min(chunk, m - c0) // 64) for c0 in range(0, m, chunk)]


def _splits(device: torch.device, n_tiles: int, jobs: int) -> int:
    """K2b's row splits of a chunk of ``n_tiles`` tiles: about eight waves
    of its ``jobs`` x splits CTAs (one an SM), so that the short jobs (the
    heads, the narrow x and v operands) fill the gaps of the long ones, and
    at least sixteen tiles a split."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(8 * sms // jobs, n_tiles // 16))


def mlp_backward(spec: FusedSpec, x: torch.Tensor, v: torch.Tensor,
                 draw: torch.Tensor, flat: list[torch.Tensor],
                 m: int | None = None, want_dx: bool = True,
                 want_dv: bool = True, valid: torch.Tensor | None = None, *,
                 chunk_rows: int | None = None, splits: int | None = None):
    """K2 (or K3b with ``valid``): ``(dx, dv, grads)`` of the first ``m``
    rows under cotangent ``draw [M, 8]`` (times the row's valid bit when
    ``valid [M]`` is given): dx/dv float32 (rows past ``m`` zero; ``None``
    unless asked for), one float32 gradient per tensor of ``flat``. The
    plain version for CPU tensors, the CUDA kernels for CUDA tensors:
    K2a + K2b per chunk of ``chunk_rows`` rows (a multiple of 64; default
    the most a chunk may hold), each chunk's rows in
    ``splits`` partials (default :func:`_splits`), then one ordered
    reduce."""
    m = x.shape[0] if m is None else int(m)
    _check(spec, x, v, flat, m)
    if draw.shape != (x.shape[0], 8) or draw.device != x.device:
        raise ValueError(f"draw must be [{x.shape[0]}, 8] on {x.device}")
    valid = _check_valid(valid, x)
    draw = draw.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        if m:
            d_m = draw[:m] if valid is None else draw[:m] * valid[:m, None]
            dx_m, dv_m, grads = backward_tile(spec, x[:m], v[:m], d_m, flat)
        else:
            dx_m, dv_m = x[:0], v[:0]
            grads = [torch.zeros(t.shape, dtype=torch.float32) for t in flat]
        dx = _pad_rows(dx_m, x.shape[0]) if want_dx else None
        dv = _pad_rows(dv_m, x.shape[0]) if want_dv else None
        return dx, dv, grads
    _check_kernel_shape(spec)
    import ctypes

    from .kernels import _ptr, _raise_on, _stream, load

    dev = x.device
    lib = load("fused_mlp_bwd")
    desc = _desc(spec)
    tile_floats, jobs, total, max_tiles = _bwd_layout(lib, desc)
    chunk = 64 * max_tiles if chunk_rows is None else int(chunk_rows)
    if chunk % 64 or not 64 <= chunk <= 64 * max_tiles:
        raise ValueError(f"chunk_rows={chunk}: a multiple of 64 up to "
                         f"{64 * max_tiles}")
    wmat, bias, heads = pack_for_chain(spec, flat)
    wdx = pack_for_dx_chain(spec, flat)
    x, v = x.contiguous(), v.contiguous()
    sizes = [t.numel() for t in flat]
    if sum(sizes) != total:
        raise ValueError(f"{sum(sizes)} gradient floats, the kernel "
                         f"counts {total}")
    grad = torch.empty((total,), dtype=torch.float32, device=dev)
    dx = torch.zeros_like(x) if want_dx else None
    dv = torch.zeros_like(v) if want_dv else None
    if m:
        starts = range(0, m, chunk)
        tiles = chunk_tiles(m, chunk)
        n_split = [_splits(dev, t, jobs) if splits is None else int(splits)
                   for t in tiles]
        scratch = torch.empty((max(tiles) * tile_floats,),
                              dtype=torch.float32, device=dev)
        live = torch.empty((max(tiles),), dtype=torch.int32, device=dev)
        partials = torch.empty((sum(n_split), total), dtype=torch.float32,
                               device=dev)
        bf16 = int(spec.compute_dtype == torch.bfloat16)
        p0 = 0
        for c0, s_c in zip(starts, n_split):
            mc = min(chunk, m - c0)
            rows = slice(c0, c0 + mc)
            err = lib.nrt_fused_mlp_bwd_rows(
                _ptr(x[rows]), _ptr(v[rows]),
                _ptr(None if valid is None else valid[rows]),
                _ptr(draw[rows]), mc, ctypes.byref(desc), _ptr(wmat),
                _ptr(bias), bf16, _ptr(heads), _ptr(wdx), _ptr(scratch),
                _ptr(live),
                _ptr(None if dx is None else dx[rows]),
                _ptr(None if dv is None else dv[rows]), _stream(dev))
            _raise_on(lib, err, "fused_mlp_bwd_rows (K2a)")
            LAUNCHES["fused_mlp_bwd_rows"] += 1
            err = lib.nrt_fused_mlp_bwd_dw(
                mc, ctypes.byref(desc), _ptr(scratch), _ptr(live), s_c,
                _ptr(partials[p0]), _stream(dev))
            _raise_on(lib, err, "fused_mlp_bwd_dw (K2b)")
            LAUNCHES["fused_mlp_bwd_dw"] += 1
            p0 += s_c
        err = lib.nrt_fused_mlp_bwd_reduce(ctypes.byref(desc), _ptr(partials),
                                           p0, _ptr(grad), _stream(dev))
        _raise_on(lib, err, "fused_mlp_reduce")
        LAUNCHES["fused_mlp_bwd_reduce"] += 1
        LAUNCHES["fused_mlp_bwd" if valid is None
                 else "fused_mlp_bwd_masked"] += 1
    else:
        grad.zero_()
    grads = [g.view(t.shape) for g, t in zip(torch.split(grad, sizes), flat)]
    return dx, dv, grads


class FusedMLPFunction(torch.autograd.Function):
    """``raw8 = MLP(x, v; flat)`` whose forward is K1 and whose backward is
    K2 — or, with a ``valid`` bit, K3a and K3b (the bit gets no gradient:
    it routes data). Saves only ``(x, v, valid, flat)``: the backward
    recomputes the forward, as the JAX custom VJP does. dx/dv are computed
    only when autograd asks for them (in the train step rays are data and
    need none)."""

    @staticmethod
    def forward(ctx, spec, m, x, v, valid, *flat):
        ctx.spec, ctx.m = spec, m
        ctx.save_for_backward(x, v, valid, *flat)
        return mlp_forward(spec, x, v, list(flat), m, valid=valid)

    @staticmethod
    def backward(ctx, draw):
        x, v, valid, *flat = ctx.saved_tensors
        want_dx, want_dv = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        dx, dv, grads = mlp_backward(ctx.spec, x, v, draw, flat, ctx.m,
                                     want_dx, want_dv, valid=valid)
        # a bf16-streamed weight's cotangent is bf16, as in JAX (:504)
        dws = [g.to(w.dtype) if need else None for g, w, need in
               zip(grads, flat, ctx.needs_input_grad[5:])]
        return (None, None, dx, dv, None, *dws)


def _padded_inputs(spec: FusedSpec, x_enc, d_enc, tile: int):
    m = x_enc.shape[0]
    m_pad = _rup(max(m, 1), int(tile))
    x = _pad_rows(_pad_cols(x_enc.to(torch.float32), spec.c_in_pad), m_pad)
    v = _pad_rows(_pad_cols(d_enc.to(torch.float32), spec.c_views_pad), m_pad)
    return m, m_pad, x, v


def fused_mlp_raw(spec: FusedSpec, branch, x_enc: torch.Tensor,
                  d_enc: torch.Tensor, tile: int = 512) -> torch.Tensor:
    """``[M, c_in]`` encoded points + ``[M, c_views]`` encoded dirs → ``[M,
    4]`` raw. Pads M to a ``tile`` multiple (as the JAX package does) and
    the channels to the spec's padded widths; differentiable in the
    branch's parameters, ``x_enc`` and ``d_enc``."""
    m, _, x, v = _padded_inputs(spec, x_enc, d_enc, tile)
    flat = spec.flatten_params(branch)
    raw8 = FusedMLPFunction.apply(spec, m, x, v, None, *flat)
    return raw8[:m, :4]


def fused_mlp_raw_masked(spec: FusedSpec, branch, x_enc: torch.Tensor,
                         d_enc: torch.Tensor, valid: torch.Tensor,
                         tile: int = 512) -> torch.Tensor:
    """:func:`fused_mlp_raw` with a ``[M]`` validity mask streamed into the
    kernel (K3a/K3b): rows with ``valid == 0`` return raw 0 and receive
    zero cotangent. The pad rows to the tile multiple are invalid."""
    m, m_pad, x, v = _padded_inputs(spec, x_enc, d_enc, tile)
    val = _pad_rows(valid.reshape(-1).to(torch.float32), m_pad)
    flat = spec.flatten_params(branch)
    raw8 = FusedMLPFunction.apply(spec, m, x, v, val.detach(), *flat)
    return raw8[:m, :4]


def fused_spec_for(network) -> FusedSpec:
    """Validate a network is kernel-fusable and return its FusedSpec
    (the same family gate as the JAX package; refuses loudly)."""
    from ..models.encoding import FrequencyEncoder
    from ..models.nerf.network import Network

    if not isinstance(network, Network):
        raise ValueError("fused_trunk supports the NeRF Network family")
    if isinstance(network.xyz_encoder, torch.nn.Module) or isinstance(
            network.dir_encoder, torch.nn.Module):
        raise ValueError(
            "fused_trunk requires parameter-free encoders (frequency "
            "family): a learnable encoder (hashgrid) runs outside the fused "
            "kernels and its table would get no gradient through them"
        )
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


def make_fused_apply(network, cfg):
    """``apply_fn(pts, viewdirs, model, valid=None) -> raw [..., 4]``
    running the MLP of ``network`` through K1/K2, or K3a/K3b when a per-row
    ``valid`` mask is given (``network.nerf.fused_tile`` rows of host
    padding). Refuses unsupported families loudly."""
    tile = int(cfg.network.nerf.get("fused_tile", 512))
    spec = fused_spec_for(network)

    def apply_fn(pts, viewdirs, model, valid=None):
        x_enc = network.xyz_encoder(pts)
        dirs = viewdirs[..., None, :].expand(
            *pts.shape[:-1], viewdirs.shape[-1])
        d_enc = network.dir_encoder(dirs)
        lead = x_enc.shape[:-1]
        x_enc = x_enc.reshape(-1, x_enc.shape[-1])
        d_enc = d_enc.reshape(-1, d_enc.shape[-1])
        branch = getattr(network, model)
        if valid is None:
            raw = fused_mlp_raw(spec, branch, x_enc, d_enc, tile=tile)
        else:
            raw = fused_mlp_raw_masked(spec, branch, x_enc, d_enc,
                                       valid.reshape(-1), tile=tile)
        return raw.reshape(*lead, 4)

    # the packed march streams its per-sample occupancy bit into the kernel
    # (K3a) when the apply advertises this flag
    apply_fn.supports_valid_mask = True
    return apply_fn
