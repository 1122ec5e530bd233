"""The compile registry's CUDA graphs and K1's float32 chain, on the card.

Needs an NVIDIA card and ``nvcc``; skips elsewhere. It imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_compile.py -q

* A lego step (fused trunk, K1/K2, float32) replayed from its CUDA graph
  equals the eager step bitwise, step after step (parameters, Adam's
  moments, stats), and the registry captures nothing after warm-up.
* A capture that cannot be made (a host read of a device value) lands in
  ``summary()["errors"]`` and ``take`` gives None.
* A graphed eval view (``Renderer.aot_register_eval``: the per-ray march
  through K1, the packed hierarchical march through K3a, the chunked render
  through K1) equals the eager render bitwise, and a second view captures
  nothing.
* A lego_hash engine's staged routes (per-ray and packed, the plain
  Network with K6 inside) replayed from their graphs equal the eager
  engine's bitwise, with no capture after warm-up and K6 launched.
* The packed march's float64 prefix sum repeats bit for bit (a 1-D CUDA
  ``torch.cumsum`` does not: CUB's look-back order varies run to run).
* K1 float32 on weights that reach a trained net's magnitudes (max|raw|
  above 5; ~30 trained):
  within 3e-6 of max|raw| of the float64 function (the truncating split
  and the tensor cores' own sums put it at 1.1-1.8e-5).
* Mesh serving: a size-1 mesh and (2, 1) / (1, 2) meshes over the card
  twice serve the ``full`` (K5) and packed (K3a) routes' families bitwise
  the mesh-less engine, with nothing captured after warm-up.
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


@pytest.mark.parametrize("route", ["per_ray", "packed_hier", "chunked"])
def test_graphed_eval_view_equals_eager(dev, route):
    from nerf_replication_tpu_torch.compile import AOTRegistry
    from nerf_replication_tpu_torch.models import init_params_for, make_network
    from nerf_replication_tpu_torch.ops import fused_mlp as fmlp
    from nerf_replication_tpu_torch.renderer.volume import make_renderer
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        ball_grid,
        view_rays,
    )

    extra = {"per_ray": [], "chunked": [],
             "packed_hier": ["task_arg.march_coarse_block", "8"]}[route]
    cfg = make_cfg(LEGO, ["network.nerf.fused_trunk", "true",
                          "network.nerf.fused_tile", "512", *extra])
    net = make_network(cfg)
    init_params_for(cfg)(net, torch.Generator().manual_seed(0))
    net = net.to(dev).eval()
    renderers = []
    for _ in range(2):
        r = make_renderer(cfg, net)
        if route != "chunked":
            r.occupancy_grid = torch.from_numpy(ball_grid(128)).to(dev)
            r.grid_bbox = torch.tensor(np.asarray(
                cfg.train_dataset.scene_bbox, np.float32), device=dev)
        renderers.append(r)
    views = [torch.from_numpy(view_rays(t, 64)).to(dev) for t in (30.0, 90.0)]

    def render(r, rays):
        with torch.no_grad():
            out = r.render_accelerated({"rays": rays, "near": 2.0,
                                        "far": 6.0})
        return {k: v.clone() for k, v in out.items()}

    eager = [render(renderers[0], rays) for rays in views]
    reg = AOTRegistry(device=dev)
    renderers[1].aot_register_eval(reg, 64 * 64, 2.0, 6.0,
                                   chunked=route == "chunked")
    reg.compile_all()
    assert reg.summary()["errors"] == [], reg.status()
    assert renderers[1].aot_install(reg) == 1
    captures = reg.captures
    kernel = "fused_mlp_fwd_masked" if route == "packed_hier" else \
        "fused_mlp_fwd"
    before = fmlp.LAUNCHES[kernel]
    for rays, ref in zip(views, eager):
        out = render(renderers[1], rays)
        for k in ref:
            assert torch.equal(out[k], ref[k]), k
    assert reg.captures == captures
    assert fmlp.LAUNCHES[kernel] > before


def test_graphed_hash_staged_routes_equal_eager(dev):
    from nerf_replication_tpu_torch.models import init_params_for, make_network
    from nerf_replication_tpu_torch.ops import hash_encode as he
    from nerf_replication_tpu_torch.serve import RenderEngine
    from nerf_replication_tpu_torch.tools.slice_inputs import (
        ball_grid,
        view_rays,
    )

    hashy = os.path.join(os.path.dirname(LEGO), "lego_hash.yaml")
    rays = view_rays(30.0, 64)
    for coarse_block in ("0", "8"):
        outs = []
        for aot in ("false", "true"):
            cfg = make_cfg(hashy, ["compile.aot", aot, "serve.buckets",
                                   "[4096]", "task_arg.march_coarse_block",
                                   coarse_block])
            net = make_network(cfg)
            init_params_for(cfg)(net, torch.Generator().manual_seed(0))
            eng = RenderEngine(cfg, net, 2.0, 6.0, grid=ball_grid(128),
                               bbox=np.asarray(cfg.train_dataset.scene_bbox,
                                               np.float32), device=dev,
                               warmup_families=("full",))
            captures = eng.stats()["captures"]
            before = he.LAUNCHES["hash_encode_fwd"]
            for _ in range(3):
                out = eng.render_request(rays, 2.0, 6.0)
            assert he.LAUNCHES["hash_encode_fwd"] > before
            st = eng.stats()
            assert st["captures"] == captures
            if aot == "true":
                assert captures > 0 and not st["compile"]["errors"], st
                assert "serve/full/b4096" in st["captured_routes"]
            outs.append(out)
        for k in ("rgb_map_f", "depth_map_f", "acc_map_f"):
            assert np.array_equal(outs[0][k], outs[1][k]), (coarse_block, k)


def test_prefix_sum_repeats_bit_for_bit(dev):
    """The packed march's float64 stream sums (``utils.numerics.
    prefix_sum``) give the same bits run after run on a packed stream's
    length, one series or the five columns of ``[M, 5]`` at once, within
    float64 rounding of the sequential sum."""
    from nerf_replication_tpu_torch.utils.numerics import prefix_sum

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.exponential(1.0, 786_432)).to(dev)
    cols = torch.from_numpy(rng.exponential(1.0, (786_432, 5))).to(dev)
    for series in (x, cols.t()):
        first = prefix_sum(series)
        for _ in range(20):
            assert torch.equal(prefix_sum(series), first)
    ref = torch.cumsum(x.cpu(), 0)
    first = prefix_sum(x)
    # two orders of n additions: each within (n − 1)·2^-53·Σx of the sum
    assert float((first.cpu() - ref).abs().max()) <= \
        2 * x.shape[0] * 2.0 ** -53 * float(ref[-1])


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


def test_mesh_engines_are_bitwise_on_the_card(dev):
    """A size-1 mesh and meshes laid out over the card twice ((2, 1): two
    lanes, two graph sets, two streams; (1, 2): the scene sharded and
    gathered into the lane) serve every family of the ``full`` (K5) and
    packed (K3a) routes bitwise the mesh-less engine, each route captured,
    nothing captured or built after warm-up. The mesh engines render a
    fleet copy of the scene after another scene held their slots: every
    slot is gathered from the copy's placed pieces."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params
    from nerf_replication_tpu_torch.scale.mesh_dispatch import make_serve_mesh
    from nerf_replication_tpu_torch.serve import RenderEngine

    grid = np.zeros((64, 64, 64), bool)
    grid[16:48, 16:48, 16:48] = True
    bbox = np.asarray([[-1.5] * 3, [1.5] * 3], np.float32)
    rng = np.random.default_rng(3)
    rays = np.concatenate([np.tile([0.0, 0.0, 4.0], (3000, 1)),
                           np.array([0.0, 0.0, -1.0])
                           + rng.normal(0, 0.15, (3000, 3))], -1)
    rays = rays.astype(np.float32)
    for route in ("full", "off"):
        cfg = make_cfg(LEGO, [
            "network.nerf.W", "64", "network.nerf.D", "4",
            "network.nerf.skips", "[1]", "network.nerf.fused_trunk", "true",
            "network.nerf.fused_tile", "64", "task_arg.march_coarse_block",
            "8", "task_arg.march_fused", route, "task_arg.march_chunk_size",
            "512", "serve.buckets", "[1024, 4096]"])
        net = make_network(cfg)
        init_params(net, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for p in net.parameters():
                if p.dim() == 1:
                    p.normal_(0.0, 0.3, generator=torch.Generator()
                              .manual_seed(p.numel()))
        engines = {label: RenderEngine(
            cfg, _copy_net(net), 2.0, 6.0, grid=grid, bbox=bbox,
            device="cuda", mesh=mesh)
            for label, mesh in (("none", None),
                                ("1x1", make_serve_mesh(1, 1, [dev])),
                                ("2x1", make_serve_mesh(2, 1, [dev, dev])),
                                ("1x2", make_serve_mesh(1, 2, [dev, dev])))}
        for label in ("1x1", "2x1", "1x2"):
            engines[label].attach_fleet(_copy_fleet(net, grid, bbox))
            engines[label].render_request(rays[:8], 2.0, 6.0, emit=False,
                                          scene="other")
        before = {k: (e.stats()["captures"], e.route_builds)
                  for k, e in engines.items()}
        for label, eng in engines.items():
            st = eng.stats()
            assert st["captures"] > 0 and not st["compile"]["errors"], st
        for n in (37, 1024, 3000):
            for tier in ("full", "bf16", "reduced_k", "coarse"):
                ref = engines["none"].render_request(rays[:n], 2.0, 6.0,
                                                     tier=tier, emit=False)
                assert float(ref["acc_map_f"].max()) > 0.1
                for label in ("1x1", "2x1", "1x2"):
                    out = engines[label].render_request(
                        rays[:n], 2.0, 6.0, tier=tier, emit=False,
                        scene="copy")
                    for k in ("rgb_map_f", "depth_map_f", "acc_map_f"):
                        assert np.array_equal(out[k], ref[k]), (
                            route, label, tier, k, n)
        for label, eng in engines.items():
            assert (eng.stats()["captures"], eng.route_builds) == \
                before[label], (route, label)
        assert engines["2x1"].lane_overlap_ms()["span_ms"] > 0
        assert all(engines[k].slot_switches == 2
                   for k in ("1x1", "2x1", "1x2"))


def _copy_fleet(net, grid, bbox):
    """A residency of two scenes on the host: ``copy`` (``net``'s weights)
    and ``other`` (the weights scaled by 1.01)."""
    from nerf_replication_tpu_torch import fleet

    params = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    scenes = {"copy": params,
              "other": {k: v * 1.01 for k, v in params.items()}}

    def loader(rec):
        return fleet.SceneData(rec.scene_id, scenes[rec.scene_id],
                               torch.from_numpy(grid), torch.from_numpy(bbox),
                               2.0, 6.0)

    return fleet.ResidencyManager(
        fleet.SceneRegistry([fleet.SceneRecord(s) for s in scenes]), loader,
        budget_bytes=1 << 30, verify_checksums=False)


def _copy_net(net):
    import copy

    return copy.deepcopy(net)
