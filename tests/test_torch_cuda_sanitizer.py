"""The sanitizer's sync guard on the card (``analysis/sanitizer.py``).

Needs an NVIDIA card and ``nvcc``; skips elsewhere. It imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sanitizer.py -q

* A lego step (fused trunk: K1/K2) captured by the trainer's registry
  replays under ``sanitizer(tracker, syncs="error")`` with no sync and no
  capture, and launches K1/K2.
* In the same region a host tensor copied into the step's input raises,
  and so does ``.item()`` on the loss; each error names the sync, and the
  sync debug mode is back at 0 after each.
* ``syncs="warn"`` warns where "error" raises, and leaves the mode as it
  found it.
"""

import os
import sys
import warnings

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_replication_tpu_torch.analysis import sanitizer  # noqa: E402
from nerf_replication_tpu_torch.config import make_cfg  # noqa: E402

LEGO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "nerf", "lego.yaml")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def graphed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nerf_replication_tpu_torch.bench import synthetic_bank
    from nerf_replication_tpu_torch.compile import AOTRegistry
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train.loss import make_loss
    from nerf_replication_tpu_torch.train.trainer import (
        Trainer,
        make_train_state,
    )
    from nerf_replication_tpu_torch.utils.platform import resolve_device

    dev = resolve_device("cuda")
    cfg = make_cfg(LEGO, ["network.nerf.fused_trunk", "true",
                          "network.nerf.fused_tile", "512",
                          "task_arg.N_rays", "256", "task_arg.N_samples",
                          "32", "task_arg.N_importance", "32",
                          "task_arg.precrop_iters", "0"])
    net = make_network(cfg)
    tr = Trainer(cfg, net, make_loss(cfg, net))
    state = make_train_state(cfg, net, dev)
    bank = synthetic_bank(torch, dev, n=1 << 14)
    tr.aot = AOTRegistry(device=dev, tracker=tr.tracker)
    tr.aot_register_steps(state, bank)
    assert tr.aot.summary()["errors"] == [], tr.aot.status()
    tr.step(state, *bank)  # one replay outside every region
    torch.cuda.synchronize()
    return tr, state, bank


def test_replays_are_sync_free_and_capture_nothing(graphed):
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp

    tr, state, bank = graphed
    before = dict(fmlp.LAUNCHES)
    with sanitizer(tr.tracker, syncs="error") as probe:
        for _ in range(20):
            state, stats = tr.step(state, *bank)
    torch.cuda.synchronize()
    assert probe.compiles == 0
    assert torch.cuda.get_sync_debug_mode() == 0
    for k in ("fused_mlp_fwd", "fused_mlp_bwd"):
        assert fmlp.LAUNCHES[k] > before[k], k
    assert bool(torch.isfinite(stats["loss"]).item())


@pytest.mark.parametrize("hazard", ["host input", "item"])
def test_a_sync_in_the_region_raises_and_the_mode_comes_back(graphed,
                                                             hazard):
    tr, state, bank = graphed
    host = bank[0].cpu()
    with pytest.raises(RuntimeError, match="synchronizing CUDA operation"):
        with sanitizer(tr.tracker, syncs="error"):
            if hazard == "host input":
                bank[0].copy_(host)
            state, stats = tr.step(state, *bank)
            if hazard == "item":
                stats["loss"].item()
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == 0


def test_warn_mode_warns_and_restores(graphed):
    tr, state, bank = graphed
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with sanitizer(tr.tracker, syncs="warn"):
            state, stats = tr.step(state, *bank)
            stats["loss"].item()
    assert any("called a synchronizing CUDA operation" in str(w.message)
               for w in seen)
    assert torch.cuda.get_sync_debug_mode() == 0
