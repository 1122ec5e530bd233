"""The Hopper forward chain (``csrc/mlp_chain_sm90.cuh``) of K1/K3a against
the plain version, on the card.

Needs an NVIDIA card and ``nvcc``; skips elsewhere. It imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_chain.py -q

K1 and K3a at every width the chain takes (W = 64, 128, 192, 256; the
products' N = W and W/2, and in K5's column split W/2 and W/4, so every
wgmma width the chain instantiates), a row count below one 64-row
warpgroup, one that leaves a 128-row tile ragged (64·5 + 13) and the smoke's
65,573, in both families, under the three masks: f32 raw within 1e-5
absolute (3xTF32 products, ~21 bits each, against float32 ones), bf16 raw
within 5e-3 of max|raw|; rows past M and the dead columns 4-7 exactly 0;
K3a's invalid rows exactly 0 and its valid rows bitwise K1's. The weights
have lego's init (lecun normal) and non-zero biases. K5 runs the same chain
(column split) in ``tests/test_torch_cuda.py::test_k5_kernel_matches_plain``
over its four march cases."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_replication_tpu_torch.config import make_cfg  # noqa: E402
from nerf_replication_tpu_torch.models import make_network  # noqa: E402
from nerf_replication_tpu_torch.models.nerf.network import init_params  # noqa: E402

LEGO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "nerf", "lego.yaml")

pytestmark = pytest.mark.cuda

# (W, D, skip)
WIDTHS = [(64, 4, 1), (128, 4, 1), (192, 6, 2), (256, 8, 4)]
ROWS = [37, 64 * 5 + 13, 65536 + 37]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, W, D, skip, dtype, m):
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    cfg = make_cfg(LEGO, ["network.nerf.W", str(W), "network.nerf.D", str(D),
                          "network.nerf.skips", f"[{skip}]"])
    net = make_network(cfg)
    init_params(net, torch.Generator().manual_seed(W + D))
    gen = torch.Generator().manual_seed(m)
    with torch.no_grad():
        for p in net.fine.parameters():
            if p.dim() == 1:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    spec = fmlp.fused_spec_for(net.clone(getattr(torch, dtype)))
    rng = np.random.default_rng(W + m)
    x = fmlp._pad_cols(torch.from_numpy(rng.normal(
        0, 1, (m + 5, spec.c_in)).astype(np.float32)), spec.c_in_pad)
    v = fmlp._pad_cols(torch.from_numpy(rng.normal(
        0, 1, (m + 5, spec.c_views)).astype(np.float32)), spec.c_views_pad)
    with torch.no_grad():
        flat = [t.to(dev) for t in spec.flatten_params(net.fine)]
    return fmlp, spec, x.to(dev), v.to(dev), flat


def _mask(kind, m, n, seed):
    valid = torch.zeros(n)
    if kind == "sorted":  # the packed stream: a valid prefix of ~5%
        valid[:max(1, m // 20)] = 1.0
    elif kind == "random":
        g = torch.Generator().manual_seed(seed)
        valid[:m] = (torch.rand(m, generator=g) < 0.6).float()
    return valid


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("W,D,skip", WIDTHS)
def test_k1_k3a_chain_match_plain(dev, W, D, skip, m):
    for dtype in ("float32", "bfloat16"):
        fmlp, spec, x, v, flat = _case(dev, W, D, skip, dtype, m)
        with torch.no_grad():
            n0 = fmlp.LAUNCHES["fused_mlp_fwd"]
            raw = fmlp.mlp_forward(spec, x, v, flat, m)
            ref = fmlp.forward_tile(spec, x[:m], v[:m], flat)
        torch.cuda.synchronize()
        assert fmlp.LAUNCHES["fused_mlp_fwd"] == n0 + 1
        assert not raw[m:].any() and not raw[:m, 4:].any()
        err = float((raw[:m] - ref).abs().max())
        if dtype == "float32":
            assert err <= 1e-5, (W, m, err)
        else:
            assert err <= 5e-3 * float(ref.abs().max()), (W, m, err)
        for kind in ("sorted", "random", "all_invalid"):
            valid = _mask(kind, m, x.shape[0], W + m).to(dev)
            with torch.no_grad():
                raw_m = fmlp.mlp_forward(spec, x, v, flat, m, valid=valid)
            torch.cuda.synchronize()
            ok = valid > 0
            assert not raw_m[~ok].any(), (kind, "K3a invalid rows")
            assert torch.equal(raw_m[ok], raw[ok]), (kind, "K3a vs K1")
