"""Port parity of mesh-sharded serving (``scale/mesh_dispatch.py`` and the
engine's mesh hooks) against the JAX package's ``tests/test_scale.py`` and
``tests/test_model_parallel.py``.

Under the conftest JAX sees 8 CPU devices; the port lays out the same
meshes over ``[cpu] * 8`` (``mesh_from_scale_cfg(cfg, devices)``), so every
split, shard and gather is real although the devices repeat.

* ``mesh_from_scale_cfg`` builds the shape JAX builds, or raises JAX's
  error in JAX's words; ``validate_mesh_buckets`` likewise.
* ``tree_shard_nbytes`` of the lego and lego_hash trees on ``(1, 2)``
  equals JAX's.
* Every family on every route (``full``, ``gather``, packed, per-ray,
  ``proposal``) through ``[8, 1]``, ``(1, 2)`` and ``(4, 2)`` meshes is
  bitwise equal to the mesh-less port engine, with no route built after
  warm-up; and within JAX's 1e-5 of JAX's mesh engine on the same meshes
  (bf16: the mesh-less port-vs-JAX bound of test_torch_serve).
* The ladder admits a scene only when it is sharded and re-promotes it
  bitwise; the planner packs a real mesh engine's per-shard bytes.
"""

import copy

import numpy as np
import pytest
import torch

from test_torch_helpers import (
    BBOX,
    FAR,
    NEAR,
    ROOT,
    SMALL_NET,
    box_grid,
    both_cfgs,
    nets,
    sample_rays,
)
from test_torch_scale import MESH_CASES, _err

from nerf_replication_tpu_torch import fleet as pf
from nerf_replication_tpu_torch.scale.mesh_dispatch import (
    mesh_from_scale_cfg,
    validate_mesh_buckets,
)
from nerf_replication_tpu_torch.serve import RenderEngine

CPU8 = [torch.device("cpu")] * 8
MAPS = ("rgb_map_f", "depth_map_f", "acc_map_f")
# chunk 16: the 128-ray bucket holds 8 chunks, a multiple of every data
# size below (JAX test_model_parallel's _TINY)
TINY = SMALL_NET + [
    "task_arg.render_step_size", "0.25",
    "task_arg.max_march_samples", "16",
    "task_arg.march_chunk_size", "16",
    "serve.buckets", "[128]",
    "serve.max_batch_rays", "128",
    "compile.aot", "False",
]
HIER = ["task_arg.march_coarse_block", "4", "task_arg.march_coarse_cap", "3",
        "task_arg.march_fused_block", "16"]
ROUTES = {
    "full": HIER + ["task_arg.march_fused", "full"],
    "gather": HIER + ["task_arg.march_fused", "gather",
                      "network.nerf.fused_trunk", "true"],
    "packed": HIER + ["network.nerf.fused_trunk", "true"],
    "per_ray": [],
}
SHAPES = ("[8, 1]", "[1, 2]", "[4, 2]")


def _mesh_opts(shape):
    return ["scale.mesh", "force", "scale.mesh_shape", shape]


def _shape(mesh):
    return None if mesh is None else dict(mesh.shape)


@pytest.fixture(scope="module")
def weights():
    """(JAX network, JAX params, port network): JAX's init with biases
    drawn from a seed, so the maps are not all background."""
    import jax

    from nerf_replication_tpu_torch.convert import params_from_jax

    jnet, params, pnet = nets()
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, params)
    for layers in params["params"].values():
        for leaf in layers.values():
            leaf["bias"] = rng.normal(0, 0.3, leaf["bias"].shape).astype(
                np.float32)
    pnet.load_state_dict(params_from_jax(params), strict=True)
    return jnet, params, pnet


# -- mesh construction -------------------------------------------------------


CASES = {**MESH_CASES,
         "shape_4x2": (_mesh_opts("[4, 2]"), "mesh", "mesh"),
         "shape_rest_x2": (_mesh_opts("[-1, 2]"), "mesh", "mesh"),
         "shape_8x1": (_mesh_opts("[8, 1]"), "mesh", "mesh")}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_from_scale_cfg_matches_jax(case):
    """The same layout as JAX's ``mesh_from_scale_cfg`` at 8 devices (or
    None), or the same error class and message."""
    import jax

    from nerf_replication_tpu.scale.mesh_dispatch import (
        mesh_from_scale_cfg as jax_mesh_from_scale_cfg,
    )

    assert len(jax.devices()) == 8
    opts, jax_does, _ = CASES[case]
    jcfg, pcfg = both_cfgs(opts + SMALL_NET)
    ref = _err(jax_mesh_from_scale_cfg, jcfg)
    ours = _err(lambda: mesh_from_scale_cfg(pcfg, CPU8))
    if jax_does == "error":
        assert isinstance(ref, tuple) and ours == ref
        return
    assert not isinstance(ours, tuple), ours
    assert _shape(ours) == _shape(ref)
    if ref is not None:
        assert ours.size == int(ref.size)
        assert ours.devices.shape == tuple(ref.devices.shape)


def test_validate_mesh_buckets_matches_jax():
    """JAX's 1-D and 2-D cases (test_scale / test_model_parallel): the
    same verdicts and the same messages."""
    from nerf_replication_tpu.scale.mesh_dispatch import (
        validate_mesh_buckets as jax_validate,
    )

    class FakeMesh:
        def __init__(self, d, m=1):
            self.shape = {"data": d, "model": m}

    cases = [([128, 256], 64, (1, 1)), ([128, 256], 16, (8, 1)),
             ([128, 256], 64, (3, 1)), ([128], 16, (4, 2)),
             ([128], 16, (8, 1)), ([128], 16, (3, 2))]
    errors = 0
    for buckets, chunk, dm in cases:
        ref = _err(jax_validate, buckets, chunk, FakeMesh(*dm))
        ours = _err(validate_mesh_buckets, buckets, chunk, FakeMesh(*dm))
        assert ours == ref, (buckets, chunk, dm)
        errors += isinstance(ours, tuple)
    assert errors == 2
    assert "(3, 2)" in ours[1]


def test_tree_shard_nbytes_matches_jax():
    """Per-device bytes of the full-width lego and lego_hash trees on a
    ``(1, 2)`` mesh: the port's state dicts under the port's rules equal
    JAX's trees under JAX's, and the engine's ``scene_shard_nbytes`` adds
    the grid and the bbox as JAX's does."""
    import os

    import jax

    from nerf_replication_tpu.models import init_params_for
    from nerf_replication_tpu.models import make_network as jax_network
    from nerf_replication_tpu.parallel.sharding import (
        tree_shard_nbytes as jax_nbytes,
    )
    from nerf_replication_tpu.scale.mesh_dispatch import (
        mesh_from_scale_cfg as jax_mesh_from_scale_cfg,
    )
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.parallel.sharding import (
        tree_shard_nbytes,
    )
    from nerf_replication_tpu_torch.scale.mesh_dispatch import scene_nbytes

    from nerf_replication_tpu.config import make_cfg as jax_make_cfg

    ratios = {}
    for name in ("lego", "lego_hash"):
        path = os.path.join(ROOT, "configs", "nerf", f"{name}.yaml")
        opts = _mesh_opts("[1, 2]")
        jcfg, pcfg = jax_make_cfg(path, opts), make_cfg(path, opts)
        jnet = jax_network(jcfg)
        tree = jax.eval_shape(lambda k: init_params_for(jcfg)(jnet, k),
                              jax.random.PRNGKey(0))
        jmesh = jax_mesh_from_scale_cfg(jcfg)
        pmesh = mesh_from_scale_cfg(pcfg, CPU8)
        state = make_network(pcfg).state_dict()
        ours = tree_shard_nbytes(state, pmesh)
        assert ours == jax_nbytes(tree, jmesh), name
        whole = sum(int(t.numel()) * t.element_size() for t in state.values())
        assert whole == sum(int(np.prod(a.shape)) * a.dtype.itemsize
                            for a in jax.tree.leaves(tree))
        grid = torch.zeros((16, 16, 16), dtype=torch.bool)
        bbox = torch.from_numpy(BBOX)
        assert scene_nbytes(pmesh, (state, grid, bbox)) == ours + 16 ** 3 + 24
        ratios[name] = whole / ours
    # the hash table splits by rows: about half a device
    assert ratios["lego_hash"] >= 1.8, ratios
    assert ratios["lego"] > 1.5, ratios


# -- bitwise parity with the mesh-less engine --------------------------------


def _proposal_net():
    """A small seeded proposal network (lego_proposal.yaml), biases drawn
    so the densities are not all near zero."""
    import os

    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.models.nerf.network import init_params

    path = os.path.join(ROOT, "configs", "nerf", "lego_proposal.yaml")
    opts = TINY + ["sampling.n_proposal", "16", "sampling.n_fine", "8"]
    net = make_network(make_cfg(path, opts))
    gen = torch.Generator().manual_seed(3)
    init_params(net, gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return path, opts, net


def _copy_fleet(net):
    """A residency of one scene, ``copy``: ``net``'s weights and the box
    grid on the host."""
    params = {k: v.detach().clone() for k, v in net.state_dict().items()}

    def loader(rec):
        return pf.SceneData(rec.scene_id, params,
                            torch.from_numpy(box_grid(16)),
                            torch.from_numpy(BBOX), NEAR, FAR)

    return pf.ResidencyManager(
        pf.SceneRegistry([pf.SceneRecord("copy")]), loader,
        budget_bytes=1 << 30, verify_checksums=False)


@torch.no_grad()
def _scribble(engine):
    """Overwrite every lane's slots (parameters, grid, bbox): only a
    switch that rewrites each of them renders the scene again."""
    for lane in engine.lanes:
        for t in lane.network.state_dict().values():
            t.add_(1.0)
        lane.grid.copy_(~lane.grid)
        lane.bbox.mul_(2.0)


def test_mesh_engines_are_bitwise_the_meshless_engine(weights):
    """``[8, 1]``, ``(1, 2)`` and ``(4, 2)`` engines against the mesh-less
    engine on the same weights: every family of the ``full`` (K5),
    ``gather`` (K4 + K1), packed (K3a) and per-ray routes and the
    ``proposal`` family, 37- and 128-ray requests (and a 300-ray one: two
    buckets), bitwise, the per-chunk march statistics in the same order;
    no route is built after warm-up. The mesh engine renders a fleet copy
    of the scene into slots overwritten first: every slot is gathered
    from the copy's placed pieces."""
    from nerf_replication_tpu_torch.config import make_cfg

    _, _, pnet = weights
    setups = [(route, lambda o: both_cfgs(o)[1], pnet, TINY + extra,
               ("full", "bf16", "reduced_k", "coarse", "half_res"))
              for route, extra in ROUTES.items()]
    path, popts, prop = _proposal_net()
    setups.append(("proposal", lambda o: make_cfg(path, o), prop,
                   popts + HIER, ("proposal", "full")))
    for route, cfg_of, net, opts, tiers in setups:
        for shape in SHAPES:
            plain = RenderEngine(cfg_of(opts), net, NEAR, FAR,
                                 grid=box_grid(16), bbox=BBOX, device="cpu")
            mesh = mesh_from_scale_cfg(cfg_of(opts + _mesh_opts(shape)), CPU8)
            # a network of its own: a switch writes into the slots
            eng = RenderEngine(cfg_of(opts + _mesh_opts(shape)),
                               copy.deepcopy(net), NEAR, FAR,
                               grid=box_grid(16), bbox=BBOX, device="cpu",
                               mesh=mesh)
            st = eng.stats()["mesh"]
            d, m = (int(x) for x in shape.strip("[]").split(","))
            assert st["axes"] == {"data": d, "model": m}
            assert st["devices"] == d * m and st["param_shards"] == m
            assert st["model_parallel"] is (m > 1)
            assert len(eng.lanes) == d
            eng.attach_fleet(_copy_fleet(net))
            _scribble(eng)
            builds = eng.route_builds
            for n in (37, 128, 300):
                rays = sample_rays(n, seed=n)
                for tier in tiers:
                    a = plain.render_request(rays, NEAR, FAR, tier=tier,
                                             emit=False)
                    b = eng.render_request(rays, NEAR, FAR, tier=tier,
                                           emit=False, scene="copy")
                    assert a["tier"] == b["tier"]
                    for k in MAPS:
                        np.testing.assert_array_equal(
                            a[k], b[k], err_msg=f"{route} {shape} {tier} "
                                                f"{k} {n}")
            assert eng.route_builds == builds, (route, shape)
            assert eng.slot_switches == 1, (route, shape)
            if plain.march_chunks:
                ps, ms = plain.stats()["march"], eng.stats()["march"]
                assert ps == ms, (route, shape)


# -- against JAX's mesh engine -----------------------------------------------


def test_mesh_engines_match_jax_mesh_engines(weights):
    """The port's mesh engines against JAX's mesh-sharded engines on the
    same meshes (JAX test_model_parallel's matrix: ``(1, 2)``, ``(4, 2)``
    on the full and bf16 families, ``[8, 1]`` on full): f32 within JAX's
    own 1e-5 (its allclose of mesh against mesh-less), bf16 within the
    mesh-less port-vs-JAX bound (test_torch_serve: the plain network in
    bf16 on both sides)."""
    from nerf_replication_tpu.scale.mesh_dispatch import (
        mesh_from_scale_cfg as jax_mesh_from_scale_cfg,
    )
    from nerf_replication_tpu.serve import RenderEngine as JaxEngine

    jnet, params, pnet = weights
    grid = box_grid(16)
    for shape, fams in (("[1, 2]", ("full", "bf16")),
                        ("[4, 2]", ("full", "bf16")), ("[8, 1]", ("full",))):
        jcfg, pcfg = both_cfgs(TINY + _mesh_opts(shape))
        jeng = JaxEngine(jcfg, jnet, params, near=NEAR, far=FAR, grid=grid,
                         bbox=BBOX, mesh=jax_mesh_from_scale_cfg(jcfg),
                         warmup_families=fams)
        peng = RenderEngine(pcfg, pnet, NEAR, FAR, grid=grid, bbox=BBOX,
                            device="cpu", warmup_families=fams,
                            mesh=mesh_from_scale_cfg(pcfg, CPU8))
        assert peng.stats()["mesh"]["axes"] == dict(jeng.mesh.shape)
        assert (peng.stats()["mesh"]["model_parallel"]
                == jeng.stats()["mesh"]["model_parallel"])
        for n in (37, 128):
            rays = sample_rays(n, seed=n)
            for tier in fams:
                ref = jeng.render_request(rays, NEAR, FAR, tier=tier,
                                          emit=False)
                out = peng.render_request(rays, NEAR, FAR, tier=tier,
                                          emit=False)
                for k in MAPS:
                    r = np.asarray(ref[k])
                    if tier == "bf16":
                        tol = 1e-1 if k == "depth_map_f" else 2e-2
                        np.testing.assert_allclose(out[k], r, rtol=0,
                                                   atol=tol)
                    else:
                        np.testing.assert_allclose(
                            out[k], r, rtol=1e-5, atol=1e-5,
                            err_msg=f"{shape} {tier} {k} {n}")


# -- fleet: admission by shard bytes, the ladder, the planner -----------------


def test_sharded_scene_rides_the_ladder(weights):
    """JAX test_model_parallel's ladder scenario: a scene over a budget
    between its shard bytes and its whole bytes is refused by a mesh-less
    engine's fleet and admitted by a ``(1, 2)`` engine's, rendered,
    demoted and re-promoted bitwise with no route built; a budget under
    one shard refuses it, naming both figures."""
    from nerf_replication_tpu_torch.fleet import (
        ResidencyOverloadError,
        SceneData,
        SceneRecord,
        SceneRegistry,
        TieredResidencyManager,
    )

    _, _, pnet = weights
    grid = torch.from_numpy(box_grid(16))
    bbox = torch.from_numpy(BBOX)
    _, cfg = both_cfgs(TINY + ["task_arg.march_fused", "full"] + HIER)
    _, mcfg = both_cfgs(TINY + ["task_arg.march_fused", "full"] + HIER
                        + _mesh_opts("[1, 2]"))
    eng = RenderEngine(mcfg, pnet, NEAR, FAR, grid=box_grid(16), bbox=BBOX,
                       device="cpu", warmup_families=("full",),
                       mesh=mesh_from_scale_cfg(mcfg, CPU8))
    host = {k: v.detach().clone() * 1.01 for k, v in
            pnet.state_dict().items()}

    def loader(rec):
        return SceneData(scene_id=rec.scene_id, params=host, grid=grid,
                         bbox=bbox, near=NEAR, far=FAR)

    total = (sum(t.numel() * t.element_size() for t in host.values())
             + grid.numel() + bbox.numel() * 4)
    shard = eng.scene_shard_nbytes((host, grid, bbox))
    assert shard < total
    budget = (shard + total) // 2

    def ladder(budget_bytes):
        return TieredResidencyManager(
            SceneRegistry([SceneRecord(scene_id="big")]), loader,
            budget_bytes=int(budget_bytes),
            staging_budget_bytes=int(4 * total), verify_checksums=False)

    rays = sample_rays(64)
    plain = RenderEngine(cfg, pnet, NEAR, FAR, grid=box_grid(16), bbox=BBOX,
                         device="cpu", warmup_families=("full",))
    plain.attach_fleet(ladder(budget))
    with pytest.raises(ResidencyOverloadError):
        plain.render_request(rays, NEAR, FAR, scene="big", emit=False)

    mgr = ladder(budget)
    eng.attach_fleet(mgr)
    own = eng.render_request(rays, NEAR, FAR, emit=False)
    out1 = eng.render_request(rays, NEAR, FAR, scene="big", emit=False)
    assert mgr.resident_ids() == ["big"]
    st = mgr.stats()
    assert st["param_shards"] == 2 and st["resident_bytes"] == shard
    assert mgr.evict("big")
    assert mgr.resident_ids() == [] and mgr.staged_ids() == ["big"]
    builds = eng.route_builds
    out2 = eng.render_request(rays, NEAR, FAR, scene="big", emit=False)
    assert mgr.repromotions == 1 and mgr.resident_ids() == ["big"]
    assert eng.route_builds == builds
    back = eng.render_request(rays, NEAR, FAR, emit=False)
    # the scene as a mesh-less engine renders it (its weights installed)
    import copy

    scene_net = copy.deepcopy(pnet)
    scene_net.load_state_dict(host)
    ref = RenderEngine(cfg, scene_net, NEAR, FAR, grid=box_grid(16),
                       bbox=BBOX, device="cpu", warmup_families=("full",)
                       ).render_request(rays, NEAR, FAR, emit=False)
    for k in MAPS:
        np.testing.assert_array_equal(out1[k], out2[k], err_msg=k)
        np.testing.assert_array_equal(out1[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(own[k], back[k], err_msg=k)
    assert not np.array_equal(own["rgb_map_f"], out1["rgb_map_f"])

    eng.attach_fleet(ladder(shard // 2))
    with pytest.raises(ResidencyOverloadError) as ei:
        eng.render_request(rays, NEAR, FAR, scene="big", emit=False)
    msg = str(ei.value)
    assert "param shard" in msg and str(total) in msg


def test_planner_packs_a_mesh_engines_shard_bytes(weights):
    """JAX test_model_parallel's planner case with ``param_shards`` read
    from a real ``(1, 2)`` engine: a scene too big for a replica's budget
    replicated packs once the replica reports its shards."""
    from test_placement import FakeCatalog, FakeClock, _heat, _state

    from nerf_replication_tpu_torch.scale.placement import (
        PlacementOptions,
        PlacementPlanner,
    )

    _, _, pnet = weights
    _, mcfg = both_cfgs(TINY + _mesh_opts("[1, 2]"))
    eng = RenderEngine(mcfg, pnet, NEAR, FAR, grid=box_grid(16), bbox=BBOX,
                       device="cpu", warmup_families=("full",),
                       mesh=mesh_from_scale_cfg(mcfg, CPU8))

    def planner():
        return PlacementPlanner(
            FakeCatalog("big"),
            options=PlacementOptions(enabled=True, hot_width=1, max_width=1),
            scene_bytes_fn=lambda sid: 1000, clock=FakeClock())

    replicated = {"r0": _state(hbm_budget=600)}
    assert planner().plan(replicated, _heat(big=0.1)).replicas_for(
        "big") == ()
    sharded = {"r0": dict(_state(hbm_budget=600),
                          param_shards=eng.param_shards)}
    assert eng.param_shards == 2
    assert planner().plan(sharded, _heat(big=0.1)).replicas_for(
        "big") == ("r0",)

