"""Port parity of data and sequence parallelism (``parallel/``): two gloo
ranks on the CPU, started once for the module (``_torch_parallel_ranks``:
spawned processes joined through a ``FileStore`` under ``tmp_path``),
against JAX on two devices of the conftest's 8-device CPU platform.

* Collectives over 2 ranks: sum, mean, max, all_gather and broadcast equal
  JAX's ``psum`` / ``pmean`` / ``pmax`` / ``all_gather`` inside
  ``shard_map``, bitwise.
* ``shard_bank`` / ``shard_index_pool`` / ``DistributedSampler`` at every
  rank of 4: JAX's shards bitwise, the ``bank_shard`` row's fields.
* The DP step against JAX ``build_dp_step`` on a 2-device mesh, one and two
  steps, ``perturb 0``: each rank fed the rays JAX's shard drew; loss
  within 1e-6, parameters within 2·lr and 99.9% of them within 1e-6 (as
  ``test_torch_train.py::test_two_optimizer_steps_match_jax``); plain, the
  fused trunk, and the precrop pool.
* The DP step and the NGP DP step (warm, then march) against their
  one-process emulations, bitwise on the CPU (``index_add_`` is
  deterministic): a dropped all-reduce, a division before the sum, a clip
  before the all-reduce or a grid merged otherwise than by MAX would show.
* The sequence-parallel renderer and march against JAX's on 2 devices, on
  a 16x16 view, at the single-device parity tests' tolerances (maps 1e-5,
  depth 1e-4, truncation exact); the sharded gate refuses other bounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import LEGO, run_ranks
from test_torch_helpers import BBOX, box_grid, both_cfgs, jax_tree_numpy, nets

from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets.procedural import generate_scene

NET = ["network.nerf.W", "32", "network.nerf.D", "4",
       "network.nerf.skips", "[1]", "task_arg.N_samples", "16",
       "task_arg.N_importance", "16", "task_arg.perturb", "0",
       "task_arg.raw_noise_std", "0", "network.nerf.fused_tile", "64"]
N_GLOBAL = 48
CASES = {"plain": (False, False), "fused": (True, False),
         "pool": (False, True)}
NGP = ["network.xyz_encoder.num_levels", "4",
       "network.xyz_encoder.log2_hashmap_size", "10",
       "network.xyz_encoder.desired_resolution", "64",
       "network.nerf.W", "32", "network.nerf.D", "2",
       "network.dir_encoder.freq", "2", "task_arg.N_rays", "64",
       "task_arg.render_step_size", "0.08", "task_arg.max_march_samples",
       "24", "task_arg.ngp_grid_res", "16", "task_arg.ngp_training", "true",
       "task_arg.ngp_warmup_steps", "1", "task_arg.ngp_warmup_max", "1",
       "task_arg.ngp_warmup_samples", "16"]
SEQ = NET + ["task_arg.render_step_size", "0.05",
             "task_arg.max_march_samples", "24"]
CHUNK = 100


def _mesh2():
    from nerf_replication_tpu.parallel import make_mesh

    return make_mesh(devices=jax.devices()[:2])


def _case_opts(case):
    fused, pool = CASES[case]
    return NET + ["network.nerf.fused_trunk", str(fused).lower(),
                  "task_arg.precrop_iters", "10" if pool else "0"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene_par"))
    generate_scene(root, "procedural", H=16, W=16, n_train=4, n_test=1)
    return root


def _scene_opts(root):
    return ["scene", "procedural", "train_dataset.data_root", root,
            "test_dataset.data_root", root, "train_dataset.H", "16",
            "train_dataset.W", "16", "test_dataset.H", "16",
            "test_dataset.W", "16"]


@pytest.fixture(scope="module")
def bank(scene):
    from nerf_replication_tpu_torch.datasets import make_dataset

    cfg = make_cfg(LEGO, _scene_opts(scene))
    ds = make_dataset(cfg, "train")
    rays, rgbs = ds.ray_bank()
    view = make_dataset(cfg, "test").image_batch(0)["rays"]
    return rays, rgbs, np.asarray(ds.precrop_index_pool(0.5)), view


@pytest.fixture(scope="module")
def jax_dp(bank):
    """JAX ``build_dp_step`` on 2 devices, two steps per case from the
    ``nets(NET)`` weights: (losses, params after each step) and the rays
    each shard drew at each step."""
    from flax.training.train_state import TrainState

    from nerf_replication_tpu.datasets.sampling import (
        sample_rays,
        sample_step_key,
    )
    from nerf_replication_tpu.parallel import build_dp_step, shard_bank
    from nerf_replication_tpu.parallel.sharding import shard_index_pool
    from nerf_replication_tpu.train.loss import NeRFLoss as JaxLoss
    from nerf_replication_tpu.train.optim import make_optimizer as jax_opt

    rays, rgbs, pool, _ = bank
    mesh = _mesh2()
    key = jax.random.PRNGKey(7)
    out = {}
    for case, (_, with_pool) in CASES.items():
        jnet, params, _ = nets(extra=NET)
        jcfg, _ = both_cfgs(_case_opts(case))
        tx, _ = jax_opt(jcfg)
        state = TrainState.create(apply_fn=jnet.apply,
                                  params=params["params"], tx=tx)
        b = shard_bank(rays, rgbs, mesh)
        extra = ()
        if with_pool:
            extra = (shard_index_pool(pool, rays.shape[0], mesh),)
        step = build_dp_step(mesh, JaxLoss(jcfg, jnet), N_GLOBAL, 2.0, 6.0,
                             with_pool=with_pool)
        local = rays.shape[0] // 2
        seg = None if not with_pool else np.asarray(extra[0]).reshape(2, -1)
        draws, steps = [], []
        for s in range(2):
            per = []
            for i in range(2):
                k = jax.random.fold_in(sample_step_key(key, s), i)
                ks, _ = jax.random.split(k)
                sl = slice(i * local, (i + 1) * local)
                r, g = sample_rays(
                    ks, jnp.asarray(rays[sl]), jnp.asarray(rgbs[sl]),
                    N_GLOBAL // 2,
                    None if seg is None else jnp.asarray(seg[i]))
                per.append((np.asarray(r), np.asarray(g)))
            draws.append(per)
            state, stats = step(state, b[0], b[1], key, *extra)
            steps.append((float(stats["loss"]),
                          jax_tree_numpy(state.params)))
        out[case] = {"draws": draws, "steps": steps}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, scene, bank, jax_dp):
    """Every rank-side check, from one spawn of 2 ranks."""
    tmp = tmp_path_factory.mktemp("ranks")
    _, _, pnet = nets(extra=NET)
    weights = str(tmp / "weights.pt")
    torch.save(pnet.state_dict(), weights)
    rays, rgbs, pool, view = bank
    payload = {
        "weights": weights, "bank_rays": rays, "bank_rgbs": rgbs,
        "pool": pool, "n_global": N_GLOBAL, "view_rays": view,
        "chunk": CHUNK, "grid": box_grid(16), "bbox": BBOX,
        "seq_opts": SEQ + ["eval.sharded", "true"],
        "ngp_opts": NGP + _scene_opts(scene),
        "dp_cases": {case: {"opts": _case_opts(case),
                            "pool": CASES[case][1],
                            "draws": jax_dp[case]["draws"]}
                     for case in CASES}}
    return run_ranks("checks", 2, str(tmp / "job"), payload)


def _mesh4_rank(rank):
    from nerf_replication_tpu_torch.parallel.mesh import Mesh

    return Mesh(None, rank, 4, torch.device("cpu"), "gloo")


def test_backend_topology_and_mesh_rules(monkeypatch):
    """The backend comes from the topology (gloo on the CPU; NCCL only
    when every local rank has a card); one process has no mesh, tensor
    parallelism asked for or not; a ``WORLD_SIZE > 1`` without a
    rendezvous never trains alone."""
    from nerf_replication_tpu_torch.parallel import mesh as pm

    assert pm.choose_backend("cpu")[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert pm.choose_backend("cuda") == (
        "gloo", "2 local ranks share 1 card(s): NCCL refuses two ranks on "
        "one card")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert pm.choose_backend("cuda")[0] == "nccl"
    cfg = make_cfg(LEGO, ["parallel.data_axis", "2"])
    assert pm.make_mesh_from_cfg(cfg, device="cpu") is None
    # tensor parallelism in one process: no mesh either (JAX with one
    # device trains single-chip whatever model_axis says)
    assert pm.make_mesh_from_cfg(make_cfg(LEGO, ["parallel.model_axis",
                                                 "2"]), device="cpu") is None
    with pytest.raises(RuntimeError, match="needs a process group"):
        pm.make_mesh(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="never trains alone"):
        pm.multihost_init(None, "cpu")
    assert _mesh4_rank(1).shape == {"data": 4, "model": 1}


def test_data_axis_must_be_the_world_size(ranks):
    """In a 2-rank group ``data_axis`` 1 or 3 raises (no sub-meshes), 2 and
    -1 make the mesh over both ranks."""
    for r, res in enumerate(ranks):
        rules = res["mesh_rules"]
        assert "data_axis=1 does not match the world size 2" in rules["1"]
        assert "data_axis=3" in rules["3"]
        assert rules["mesh"] == (r, 2, "gloo", "cpu")
        assert rules["default"] == {"data": 2, "model": 1}


def test_collectives_match_jax_shard_map(ranks):
    from jax.sharding import PartitionSpec as P

    from nerf_replication_tpu.parallel import all_gather, pmean, psum
    from nerf_replication_tpu.parallel.compat import shard_map

    mesh = _mesh2()
    xs = np.stack([r["collectives"]["x"] for r in ranks])  # [2, 4, 3]

    def body(v):
        v = v[0]
        return (psum(v)[None], pmean(v)[None],
                jax.lax.pmax(v, "data")[None], all_gather(v)[None],
                all_gather(v, tiled=True)[None])

    outs = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data"),
                             out_specs=P("data"), check_vma=False))(
        jnp.asarray(xs))
    names = ("psum", "pmean", "pmax", "gather", "gather_tiled")
    for r, res in enumerate(ranks):
        c = res["collectives"]
        for name, ref in zip(names, outs):
            np.testing.assert_array_equal(c[name], np.asarray(ref)[r],
                                          err_msg=name)
        np.testing.assert_array_equal(c["bcast"], xs[0])
        assert c["bcast_obj"] == {"rank": 0} and c["axis_index"] == r
        np.testing.assert_array_equal(c["tree_a"], c["pmean"])
        np.testing.assert_array_equal(
            c["tree_b"], ((xs[0, 0, :2].astype(np.float32)
                           + xs[1, 0, :2]) / 2).astype(np.float64))
        assert c["tree_b_dtype"] == "torch.float64"
        assert c["counts"]["all_reduce"] == 4 and c["counts"][
            "all_gather"] == 2


def test_shard_bank_rows_and_row_at_every_rank_of_four(bank, monkeypatch,
                                                       capsys):
    """Each rank's rows are JAX's shard of the truncated bank; the dropped
    tail is announced on stdout and as a valid ``bank_shard`` row."""
    from nerf_replication_tpu.parallel import make_mesh, shard_bank as jshard
    from nerf_replication_tpu_torch import obs
    from nerf_replication_tpu_torch.parallel.sharding import shard_bank

    rows = []

    class Rows:
        def emit(self, kind, **fields):
            rows.append({"v": obs.SCHEMA_VERSION, "kind": kind, "t": 0.0,
                         **fields})

    monkeypatch.setattr(obs, "get_emitter", lambda: Rows())
    rays, rgbs = bank[0][:1023], bank[1][:1023]  # 1023: a dropped tail
    jr, jg = jshard(rays, rgbs, make_mesh(devices=jax.devices()[:4]))
    jr, jg = np.asarray(jr), np.asarray(jg)
    for rank in range(4):
        r, g = shard_bank(rays, rgbs, _mesh4_rank(rank))
        np.testing.assert_array_equal(r, jr[rank * 255:(rank + 1) * 255])
        np.testing.assert_array_equal(g, jg[rank * 255:(rank + 1) * 255])
    assert "truncated to 1020 (3 dropped)" in capsys.readouterr().out
    assert len(rows) == 4 and not any(obs.validate_row(r) for r in rows)
    assert all(r["kind"] == "bank_shard" and r["n_rays"] == 1023
               and r["n_kept"] == 1020 and r["n_dropped"] == 3
               and r["n_shards"] == 4 for r in rows)


def test_shard_index_pool_segments_match_jax(bank):
    from nerf_replication_tpu.parallel import make_mesh
    from nerf_replication_tpu.parallel.sharding import (
        shard_index_pool as jpool,
    )
    from nerf_replication_tpu_torch.parallel.sharding import (
        shard_index_pool,
    )

    rays, pool = bank[0], bank[2]
    for cut in (pool, pool[pool < 256]):  # the second starves ranks 1-3
        ref = np.asarray(jpool(cut, rays.shape[0],
                               make_mesh(devices=jax.devices()[:4])))
        segs = [shard_index_pool(cut, rays.shape[0], _mesh4_rank(r))
                for r in range(4)]
        np.testing.assert_array_equal(np.concatenate(segs), ref)
        assert all(s.max() < rays.shape[0] // 4 for s in segs)


def test_distributed_sampler_at_every_rank_of_four():
    from nerf_replication_tpu.datasets import samplers as jax_samplers
    from nerf_replication_tpu_torch.datasets import samplers

    for rank in range(4):
        ours = samplers.DistributedSampler(10, rank, 4, seed=5)
        ref = jax_samplers.DistributedSampler(10, rank, 4, seed=5)
        for epoch in range(2):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref) and len(ours) == 3


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_jax(ranks, jax_dp, case):
    """Loss within 1e-6 at each of two steps; every parameter within 2·lr of
    JAX's, 99.9% within 1e-6; each rank drew from its own shard (and pool
    segment) with N_rays / 2 rays."""
    lr = float(make_cfg(LEGO, NET).train.lr)
    for res in ranks:
        got = res["dp_vs_jax"][case]
        for (jl, tree), step in zip(jax_dp[case]["steps"], got["steps"]):
            assert abs(step["loss"] - jl) <= 1e-6
            diffs = []
            for branch, layers in tree.items():
                for name, leaf in layers.items():
                    w = step["weights"][f"{branch}.{name}.weight"].T
                    b = step["weights"][f"{branch}.{name}.bias"]
                    diffs += [np.abs(w - leaf["kernel"]).ravel(),
                              np.abs(b - leaf["bias"]).ravel()]
            diffs = np.concatenate(diffs)
            assert float(diffs.max()) <= 2 * lr
            assert float(np.mean(diffs <= 1e-6)) >= 0.999
        for n_bank, n, pool in got["seen"]:
            assert (n_bank, n) == (512, N_GLOBAL // 2)
            assert (pool is not None) == CASES[case][1]
    w0 = ranks[0]["dp_vs_jax"][case]["steps"][-1]["weights"]
    w1 = ranks[1]["dp_vs_jax"][case]["steps"][-1]["weights"]
    assert all(np.array_equal(w0[k], w1[k]) for k in w0)


def test_dp_step_equals_its_emulation_bitwise(ranks):
    """Two DP steps with the port's own per-rank streams and precrop pool
    segments: both ranks end bitwise equal, and equal rank 0's emulation
    (both ranks' draws, ``(g0 + g1) / 2``, clip, Adam), bitwise."""
    r0, r1 = (r["lego_emulation"] for r in ranks)
    for k, v in r0["weights"].items():
        np.testing.assert_array_equal(v, r1["weights"][k], err_msg=k)
        np.testing.assert_array_equal(v, r0["emulated"][k], err_msg=k)
    assert r0["loss"] == r1["loss"] and np.isfinite(r0["loss"])


def test_ngp_dp_step_equals_its_emulation_and_grid_union(ranks):
    """A warm then a march NGP DP step: weights and the grid EMA bitwise
    the emulation, whose grid is the MAX of the ranks' single-card
    candidates (each rank's samples, refresh cells and jitter); both ranks'
    grids bitwise equal."""
    r0, r1 = (r["ngp_emulation"] for r in ranks)
    assert r0["phases"] == r1["phases"] == [True, False]
    np.testing.assert_array_equal(r0["grid"], r1["grid"])
    np.testing.assert_array_equal(r0["grid"], r0["emulated_grid"])
    for k, v in r0["weights"].items():
        np.testing.assert_array_equal(v, r1["weights"][k], err_msg=k)
        np.testing.assert_array_equal(v, r0["emulated"][k], err_msg=k)


def _jax_seq(bank, march: bool):
    from nerf_replication_tpu.parallel.sequence import (
        build_sequence_parallel_march,
        build_sequence_parallel_renderer,
    )
    from nerf_replication_tpu.renderer.volume import Renderer

    jnet, params, _ = nets(extra=NET)
    jcfg, _ = both_cfgs(SEQ)
    r = Renderer(jcfg, jnet)
    rays = jnp.asarray(bank[3])
    if march:
        fn = build_sequence_parallel_march(_mesh2(), jnet, r.march_options,
                                           2.0, 6.0, chunk_size=CHUNK)
        out = fn(params, rays, jnp.asarray(box_grid(16)), jnp.asarray(BBOX))
    else:
        fn = build_sequence_parallel_renderer(_mesh2(), jnet, r.eval_options,
                                              2.0, 6.0, chunk_size=CHUNK)
        out = fn(params, rays)
    return jax.tree.map(np.asarray, out)


def test_sequence_parallel_renderer_matches_jax(ranks, bank):
    """The 16x16 view's 256 rays over 2 ranks (128 each, chunks of 100)
    against JAX's on 2 devices within 1e-4, the chunked render's tolerance
    (``test_torch_volume.py::test_render_chunked_and_gate_match_one_pass``),
    and within 1e-6 of the port's one-process chunked render; the sharded
    gate renders the same image."""
    ref = _jax_seq(bank, march=False)
    for res in ranks:
        out = res["sequence"]["render"]
        assert set(out) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(out[k], v, rtol=0, atol=1e-4,
                                       err_msg=k)
            np.testing.assert_allclose(out[k], res["sequence"]["one"][k],
                                       rtol=0, atol=1e-6, err_msg=k)
        assert res["sequence"]["gate_sharded"]
        assert res["sequence"]["gate_equal"]


def test_sequence_parallel_march_matches_jax(ranks, bank):
    """The per-ray march over 2 ranks against JAX's: maps within 1e-5
    (depth 1e-4), the truncation count exact."""
    ref = _jax_seq(bank, march=True)
    for res in ranks:
        out = res["sequence"]["march"]
        for k in ("rgb_map_f", "acc_map_f", "depth_map_f"):
            atol = 1e-4 if k.startswith("depth") else 1e-5
            np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=atol,
                                       err_msg=k)
        assert int(out["n_truncated"]) == int(ref["n_truncated"])


def test_sharded_gate_refuses_other_bounds(ranks):
    """Under ``eval.sharded`` the bounds are baked: a batch with another
    near raises ``BakedBoundsError`` on every rank."""
    assert all(r["sequence"]["refused"] for r in ranks)


def test_rank_helper_imports_no_jax():
    """The spawned ranks' module (and the port) import no JAX."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, %r); import _torch_parallel_ranks"
            "; import nerf_replication_tpu_torch.parallel; "
            "print('jax' in sys.modules)" % here)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(here))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "False"
