"""The compile registry's CUDA graphs and K1's float32 chain, on the card.

Needs an NVIDIA card and ``nvcc``; skips elsewhere. It imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_compile.py -q

* A lego step (fused trunk, K1/K2, float32) replayed from its CUDA graph
  equals the eager step bitwise, step after step (parameters, Adam's
  moments, stats), and the registry captures nothing after warm-up.
* A capture that cannot be made (a host read of a device value) lands in
  ``summary()["errors"]`` and ``take`` gives None.
* K1 float32 on weights that reach a trained net's magnitudes (max|raw|
  above 5; ~30 trained):
  within 3e-6 of max|raw| of the float64 function (the truncating split
  and the tensor cores' own sums put it at 1.1-1.8e-5).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_replication_tpu_torch.config import make_cfg  # noqa: E402

LEGO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "nerf", "lego.yaml")

pytestmark = pytest.mark.cuda

TOL_K1_F64_REL = 3e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nerf_replication_tpu_torch.utils.platform import resolve_device

    return resolve_device("cuda")


def _trainer(dev, graphed):
    from nerf_replication_tpu_torch.bench import synthetic_bank
    from nerf_replication_tpu_torch.compile import AOTRegistry
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train.loss import make_loss
    from nerf_replication_tpu_torch.train.trainer import (
        Trainer,
        make_train_state,
    )

    cfg = make_cfg(LEGO, ["network.nerf.fused_trunk", "true",
                          "network.nerf.fused_tile", "512",
                          "task_arg.N_rays", "256", "task_arg.N_samples",
                          "32", "task_arg.N_importance", "32",
                          "task_arg.precrop_iters", "0"])
    net = make_network(cfg)
    tr = Trainer(cfg, net, make_loss(cfg, net))
    state = make_train_state(cfg, net, dev)
    bank = synthetic_bank(torch, dev, n=1 << 14)
    if graphed:
        tr.aot = AOTRegistry(device=dev)
        tr.aot_register_steps(state, bank)
    return tr, state, bank


def test_graphed_lego_step_equals_eager_and_captures_once(dev):
    e, es, bank = _trainer(dev, False)
    g, gs, _ = _trainer(dev, True)
    assert g.aot.summary()["errors"] == [], g.aot.status()
    assert g.aot.take("train_step") is not None
    captures = g.aot.captures
    for _ in range(4):
        _, e_stats = e.step(es, *bank)
        _, g_stats = g.step(gs, *bank)
        for k in e_stats:
            assert torch.equal(e_stats[k], g_stats[k]), k
        for pe, pg in zip(es.network.parameters(), gs.network.parameters()):
            assert torch.equal(pe, pg)
            for k, v in es.optimizer.state[pe].items():
                assert torch.equal(v, gs.optimizer.state[pg][k]), k
    assert g.aot.captures == captures
    assert gs.step == es.step == 4


def test_a_capture_error_lands_in_the_summary(dev):
    from nerf_replication_tpu_torch.compile import AOTRegistry

    reg = AOTRegistry(device=dev)
    x = torch.ones(4, device=dev)
    reg.register("host_read", lambda: x * float(x.sum()))
    reg.register("fine", lambda: x * 2)
    reg.compile_all()
    assert reg.take("host_read") is None
    # the entry after a failed one is captured on a new stream and pool
    assert reg.summary()["errors"] == ["host_read"], reg.status()
    fn = reg.take("fine")
    assert fn is not None and torch.equal(fn(), x * 2)


def test_k1_f32_lands_within_3e6_of_float64(dev):
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.tools.chain_accuracy import (
        forward_errors,
    )

    net = make_network(make_cfg(LEGO, []))
    init_params(net, torch.Generator().manual_seed(0))
    with torch.no_grad():  # weights at a trained net's magnitudes
        for name, p in net.fine.named_parameters():
            if "weight" in name and p.shape[1] > 8:
                p.mul_(1.5)
            elif "bias" in name:
                p.add_(0.05)
    net = net.to(dev)
    spec = fmlp.fused_spec_for(net)
    rng = np.random.default_rng(0)
    m = 8192
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (m, 3)).astype(np.float32))
    d = rng.normal(0, 1, (m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = fmlp._pad_cols(net.xyz_encoder(pts.to(dev)), spec.c_in_pad)
    v = fmlp._pad_cols(net.dir_encoder(torch.from_numpy(d).to(dev)),
                       spec.c_views_pad)
    flat = [t.detach() for t in spec.flatten_params(net.fine)]
    err = forward_errors(spec, x.contiguous(), v.contiguous(), flat, m)
    assert err["max_abs_raw"] > 5.0, err
    assert err["k1_rel_f64"] <= TOL_K1_F64_REL, err
