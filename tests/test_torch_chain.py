"""The Hopper forward chain's host side (``ops/fused_mlp.pack_for_chain``)
and its float32 arithmetic, on the CPU.

* The packing: decoded by the layout ``csrc/mlp_chain_sm90.cuh`` reads
  (products in stream order, K-major k-steps of 32 bytes, each as [2, N,
  16 bytes] core matrices; float32 steps as a TF32-high part then a low
  part), every matrix comes back: float32 as its round-to-nearest split
  (hi and lo TF32 values, hi + lo within 2^-22 of w), the bf16 values
  themselves (bf16); biases and heads as the flatten order holds them.
* The split itself rounds to nearest: over 10^6 seeded values its error
  has no sign bias (the truncating split it replaced is biased toward zero
  by ~1e-7 relative, which the chain's products compound).
* K2a's dX-chain image (``pack_for_dx_chain``): decoded the same way, with
  each product's ``B = w.T`` (``[out, in]``), every matrix of the flatten
  order comes back in that order as its truncating TF32 split (hi = w with
  the low 13 mantissa bits cleared, lo = w - hi exactly), in both compute
  dtypes (bf16: the hi parts alone, the lo parts being zero) at every
  width the backward kernels take; the transposed gather equals the
  forward layout of explicitly transposed matrices.
* The names ``benchmark/metrics/k2_roofline.py`` sums are ``__global__``
  kernels of ``csrc/fused_mlp_bwd.cu``; ``tools/sass_check``'s SASS counts.
* The error budget of 3xTF32 before any card run: a plain emulation of the
  chain's products (a_lo b_hi + a_hi b_lo + a_hi b_hi; activations split
  as the kernel splits them, hi rounded and lo read as TF32; float32
  sums), fed from the decoded stream, stays within K1's
  float32 gate (raw atol 1e-5) of the JAX ``fused_mlp_raw`` under the
  Pallas interpreter, at D=4, W=128 (skip after layer 1) and at lego's
  D=8, W=256 (skip after layer 4) with its default init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import jax_tree_numpy, nets

from nerf_replication_tpu.ops.fused_mlp import (
    fused_mlp_raw as jax_fused_mlp_raw,
    fused_spec_for as jax_spec_for,
)
from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

SMALL = ["network.nerf.W", "128", "network.nerf.D", "4",
         "network.nerf.skips", "[1]"]
M, TILE = 185, 64


def _products(spec):
    """(K, N) of every product of the chain, in stream order (the
    kernel's ``for_each_product``)."""
    out = [(spec.c_in_pad, spec.W)]
    for i in range(1, spec.D):
        if spec.skip is not None and i == spec.skip + 1:
            out.append((spec.c_in_pad, spec.W))
        out.append((spec.W, spec.W))
    return out + [(spec.W, spec.W), (spec.W, spec.W2),
                  (spec.c_views_pad, spec.W2)]


def _decode(spec, wmat, shapes=None, e=None, parts=None):
    """The stream back as one ``[K, N]`` matrix per product (two parts: its
    (hi, lo) pair), read as the kernel reads it; by default the forward
    image's products, e and parts of the spec's compute dtype."""
    f32 = spec.compute_dtype == torch.float32
    e = (4 if f32 else 8) if e is None else e
    parts = (2 if f32 else 1) if parts is None else parts
    pos, mats = 0, []
    for k, n in _products(spec) if shapes is None else shapes:
        size = k * n * parts
        chunk = wmat[pos:pos + size]
        pos += size
        # [step, part, kh, n, e] -> per part [K, N]
        steps = chunk.reshape(k // (2 * e), parts, 2, n, e)
        per_part = [steps[:, p].permute(0, 1, 3, 2).reshape(k, n)
                    for p in range(parts)]
        mats.append(tuple(per_part) if parts == 2 else per_part[0])
    assert pos == wmat.numel()
    return mats


def _matrices(spec, flat):
    heads = set(spec.head_indices())
    return [t for i, t in enumerate(flat)
            if i not in heads and t.shape[0] > 1]


def _flat(dtype, extra=SMALL, seed=1):
    jnet, params, pnet = nets(extra=extra, seed=seed)
    rng = np.random.default_rng(5)
    tree = jax_tree_numpy(params)
    for layers in tree["params"].values():
        for leaf in layers.values():
            leaf["bias"] = rng.normal(0, 0.05, leaf["bias"].shape).astype(
                np.float32)
    from nerf_replication_tpu_torch.convert import params_from_jax

    pnet.load_state_dict(params_from_jax(tree), strict=True)
    spec = fmlp.fused_spec_for(pnet.clone(dtype))
    with torch.no_grad():
        flat = spec.flatten_params(pnet.fine)
    return jnet, jax.tree.map(jnp.asarray, tree), pnet, spec, flat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_for_chain_decodes_exactly(dtype):
    _, _, _, spec, flat = _flat(dtype)
    wmat, bias, heads = fmlp.pack_for_chain(spec, flat)
    assert wmat.dtype == dtype and bias.dtype == heads.dtype == torch.float32
    mats = _matrices(spec, flat)
    decoded = _decode(spec, wmat)
    assert len(decoded) == len(mats)
    for w, got in zip(mats, decoded):
        if dtype == torch.float32:
            hi, lo = got
            for part, want in zip(got, fmlp.split_tf32(w)):
                assert torch.equal(part, want)
                assert not (part.view(torch.int32) & 0x1FFF).any()
            assert bool(((hi.double() + lo.double() - w.double()).abs()
                         <= w.double().abs() * 2.0 ** -22).all())
            # |lo| <= 2^-11 |w|: hi is w rounded to 11 significant bits
            assert bool((lo.abs() <= w.abs() * 2.0 ** -11).all())
        else:
            assert torch.equal(got, w)
    biases = [t for i, t in enumerate(flat)
              if i not in set(spec.head_indices()) and t.shape[0] == 1]
    assert torch.equal(bias, torch.cat([b.reshape(-1).float()
                                        for b in biases]))
    assert torch.equal(heads, torch.cat([
        flat[i].reshape(-1).float() for i in spec.head_indices()]))


def _trunc(t):
    """A float32 value as the tensor core reads it as TF32."""
    return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _torch_flat(dtype, W, D=4, skip=1, seed=3):
    """(spec, flat) of a seeded port network (no JAX) at width W."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params

    from test_torch_helpers import LEGO

    net = make_network(make_cfg(LEGO, [
        "network.nerf.W", str(W), "network.nerf.D", str(D),
        "network.nerf.skips", f"[{skip}]"]))
    init_params(net, torch.Generator().manual_seed(seed))
    spec = fmlp.fused_spec_for(net.clone(dtype))
    with torch.no_grad():
        flat = spec.flatten_params(net.fine)
    return spec, flat


# every width the backward kernels take (rows_shape_ok: W a multiple of 64
# up to 256), at lego's depth and skip at the widest
DX_WIDTHS = [(64, 4, 1), (128, 4, 1), (192, 4, 1), (256, 8, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("W,D,skip", DX_WIDTHS,
                         ids=[f"W{w}" for w, _, _ in DX_WIDTHS])
def test_pack_for_dx_chain_decodes_exactly(dtype, W, D, skip):
    spec, flat = _torch_flat(dtype, W, D, skip)
    wdx = fmlp.pack_for_dx_chain(spec, flat)
    assert wdx.dtype == torch.float32
    mats = _matrices(spec, flat)
    f32 = dtype == torch.float32
    # each product's B = w.T [out, in], in the flatten order (the kernel's
    # offsets); the bf16 family's image holds the hi parts alone
    shapes = [(n, k) for k, n in _products(spec)]
    assert [tuple(w.T.shape) for w in mats] == shapes
    decoded = _decode(spec, wdx, shapes, e=4, parts=2 if f32 else 1)
    assert len(decoded) == len(mats)
    for w, got in zip(mats, decoded):
        wt = w.T.float()
        hi = (wt.contiguous().view(torch.int32) & -8192).view(torch.float32)
        if f32:
            assert torch.equal(got[0], hi)  # the truncating split
            assert torch.equal(got[1], wt - hi)
            assert torch.equal(got[0].double() + got[1].double(),
                               wt.double())
            assert torch.equal(got[0], fmlp.split_trunc(wt)[0])
        else:  # a bf16 weight is a TF32 value: lo is zero
            assert torch.equal(got, wt)
            assert torch.equal(got, hi)
            assert not fmlp.split_trunc(wt)[1].any()


def test_dx_layout_gathers_the_transposes():
    """The transposed gather of ``_chain_layout`` (the dX image) equals the
    forward's layout over explicitly transposed matrices."""
    spec, flat = _torch_flat(torch.float32, 128)
    mats = _matrices(spec, flat)
    shapes = [tuple(w.shape[::-1]) for w in mats]
    flat_in = torch.cat([w.reshape(-1) for w in mats])
    flat_t = torch.cat([w.T.contiguous().reshape(-1) for w in mats])
    idx_t, low_t = fmlp._chain_layout(shapes, 4, True, True, "cpu")
    idx, low = fmlp._chain_layout(shapes, 4, True, False, "cpu")
    assert torch.equal(flat_in[idx_t], flat_t[idx])
    assert torch.equal(low_t, low)


def test_bwd_kernels_carry_the_roofline_names():
    """Every kernel name fragment that ``benchmark/metrics/k2_roofline.py``
    sums is a ``__global__`` kernel of ``csrc/fused_mlp_bwd.cu`` (a kernel
    named otherwise would leave K2's time out of ``k2_roofline``)."""
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    metric = open(os.path.join(root, "benchmark", "metrics",
                               "k2_roofline.py")).read()
    frags = re.findall(r'"(fused_mlp_\w+_kernel)"', metric)
    assert sorted(frags) == ["fused_mlp_bwd_dw_kernel",
                             "fused_mlp_bwd_rows_kernel",
                             "fused_mlp_reduce_kernel"]
    src = open(os.path.join(root, "nerf_replication_tpu_torch", "csrc",
                            "fused_mlp_bwd.cu")).read()
    kernels = re.findall(r"__global__\s+(?:void\s+__launch_bounds__\([^)]*"
                         r"\)|__launch_bounds__\([^)]*\)\s+void|void)\s+"
                         r"(\w+)\s*\(", src)
    assert sorted(kernels) == sorted(frags)


def test_sass_counts_per_function():
    from nerf_replication_tpu_torch.tools import sass_check

    sass = """
        code for sm_90a
                Function : _ZN4rows_kernelEv
        /*0010*/   HGMMA.64x128x8.F32.TF32 R24, gdesc[UR4], R24 ;
        /*0020*/   HGMMA.64x128x8.F32.TF32 R24, gdesc[UR8], R24 ;
        /*0030*/   UBLKCP.S.G [UR4], [UR6], UR8 ;
        /*0040*/   SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR4+0x8], RZ ;
                Function : _ZN6dw_kernelEv
        /*0010*/   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0020*/   LDGSTS.E.BYPASS.128 [R2], desc[UR4][R6.64] ;
    """
    counts = sass_check._counts(sass)
    assert counts == {
        "_ZN4rows_kernelEv": {"HGMMA": 2, "UBLKCP": 1, "SYNCS": 1},
        "_ZN6dw_kernelEv": {"HGMMA": 0, "UBLKCP": 0, "SYNCS": 0}}
    assert sass_check._gated("fused_mlp_bwd",
                             "_ZN4fused_mlp_bwd_rows_kernelEv")
    assert not sass_check._gated("fused_mlp_bwd",
                                 "_ZN4fused_mlp_bwd_dw_kernelEv")
    assert sass_check._gated("fused_mlp", "_ZN4anyEv")


def _emulate(spec, x, v, wmat, bias, heads):
    """The float32 chain as the kernel computes it: every product as
    3xTF32 on the decoded stream, bias + relu, the heads in float32."""
    mats = iter(_decode(spec, wmat))
    b = iter(torch.split(bias, [spec.W] * (spec.D + 1) + [spec.W2]))

    def mm(a, pair):
        w_hi, w_lo = pair
        a_hi = fmlp.tf32_rna(a)
        return (_trunc(a - a_hi) @ w_hi + a_hi @ _trunc(w_lo)) + a_hi @ w_hi

    h = torch.relu(mm(x, next(mats)) + next(b))
    for i in range(1, spec.D):
        if spec.skip is not None and i == spec.skip + 1:
            z = mm(x, next(mats))
            z = z + mm(h, next(mats))
        else:
            z = mm(h, next(mats))
        h = torch.relu(z + next(b))
    W, W2 = spec.W, spec.W2
    wa, ba = heads[:W * 8].reshape(W, 8), heads[W * 8:W * 8 + 8]
    wr = heads[W * 8 + 8:W * 8 + 8 + W2 * 8].reshape(W2, 8)
    br = heads[W * 8 + 8 + W2 * 8:]
    alpha = h @ wa[:, 3] + ba[3]
    f = mm(h, next(mats)) + next(b)
    vh = torch.relu(mm(f, next(mats)) + mm(v, next(mats)) + next(b))
    rgb = vh @ wr[:, :3] + br[:3]
    return torch.cat([rgb, alpha[:, None]], 1)


def test_split_tf32_rounds_to_nearest():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.lognormal(0.0, 3.0, 10**6)
                          * rng.choice([-1.0, 1.0], 10**6)).astype(np.float32))
    hi, lo = fmlp.split_tf32(x)
    for part in (hi, lo):  # TF32 values: the tensor core reads them as are
        assert torch.equal(part, _trunc(part))
    err = (x.double() - hi.double() - lo.double()) / x.double()
    assert float(err.abs().max()) <= 2.0 ** -22
    assert abs(float(err.mean())) < 1e-9
    # the truncating split (hi truncated, lo read truncated) it replaced
    # is biased toward zero
    t_hi = _trunc(x)
    t_err = (x.double() - t_hi.double() - _trunc(x - t_hi).double()) \
        / x.double()
    assert float(t_err.mean()) > 1e-8


@pytest.mark.parametrize("extra", [
    SMALL, ["network.nerf.skips", "[4]"]], ids=["D4_W128", "lego_D8_W256"])
def test_3xtf32_emulation_within_k1_gate(extra):
    jnet, params, pnet, spec, flat = _flat(torch.float32, extra)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.5, 1.5, (M, 3)).astype(np.float32)
    d = rng.normal(0, 1, (M, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x_enc = pnet.xyz_encoder(torch.from_numpy(pts))
    d_enc = pnet.dir_encoder(torch.from_numpy(d))
    jspec = jax_spec_for(jnet)
    raw_j = np.asarray(jax_fused_mlp_raw(
        jspec, params["params"]["fine"], jnp.asarray(x_enc.numpy()),
        jnp.asarray(d_enc.numpy()), tile=TILE))
    x = fmlp._pad_cols(x_enc, spec.c_in_pad)
    v = fmlp._pad_cols(d_enc, spec.c_views_pad)
    with torch.no_grad():
        wmat, bias, heads = fmlp.pack_for_chain(spec, flat)
        emu = _emulate(spec, x, v, wmat, bias, heads).numpy()
        plain = fmlp.forward_tile(spec, x, v, flat)[:, :4].numpy()
    err = float(np.abs(emu - raw_j).max())
    assert err <= 1e-5, err
    # the emulation differs from the float32 products, within that gate
    assert 0 < float(np.abs(emu - plain).max()) <= 1e-5
