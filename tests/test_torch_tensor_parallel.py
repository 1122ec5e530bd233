"""Port parity of tensor parallelism (``parallel/``: the ``(data, model)``
mesh, the rule table, ``parallel/tensor.py`` and the GSPMD step) on gloo
ranks on the CPU (``_torch_parallel_ranks``: spawned processes, a
``FileStore`` under ``tmp_path``).

* ``tree_specs`` / ``tree_shard_nbytes`` on the port's lego and lego_hash
  trees equal JAX's on the same trees, exactly, over JAX CPU meshes of
  model 1, 2 and 4 and data x model 2 x 2 (a port weight is a transposed
  JAX kernel: its spec is JAX's reversed).
* The rank layout is JAX's ``reshape(data, model)``; ``make_mesh``'s
  errors and the precrop / NGP refusals use JAX's words.
* The TP step (1 x 2, and once 2 x 2) against the port's own ``DPStep``
  over the same rank's data group, from one seeded init, on the same
  draws. The JAX TP step cannot be the oracle (JAX's own
  ``test_tp_is_pure_relayout`` is an expected failure, about 1% off, the
  hash variant about 5%), so the chain of holds is TP = port DP (here) =
  JAX DP (``test_torch_parallel.py``). Tolerances: the fused trunk (its
  plain version on gathered weights) bitwise — blocks, Adam moments and
  the gathered weights; the plain column-parallel trunk and lego_hash sum
  their products in another order (a column block's product, the input
  gradient all-reduced over the model group), so the first step's
  reduced gradient blocks within 1e-6 relative Frobenius of DP's columns,
  and after two Adam steps the blocks within 1e-5 (plain) and 1e-3
  (lego_hash: Adam's ``eps 1e-15`` divides near-zero table gradients by
  their own roots, so the last bits of a gradient move a parameter by up
  to the lr) relative Frobenius, the moments within 1e-5 / 1e-3.
* A TP checkpoint (the chief saves the gathered state) loads into a
  one-card serving engine; a 2-rank ``fit`` with ``model_axis 2`` trains,
  saves and resumes in one process.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import LEGO, LEGO_HASH, run_ranks

from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets.procedural import generate_scene

N_GLOBAL = 32
SCENE = ["scene", "procedural", "train_dataset.H", "16",
         "train_dataset.W", "16", "test_dataset.H", "16",
         "test_dataset.W", "16"]
NET = ["network.nerf.W", "32", "network.nerf.D", "4",
       "network.nerf.skips", "[1]", "task_arg.N_samples", "8",
       "task_arg.N_importance", "8", "task_arg.perturb", "0",
       "task_arg.raw_noise_std", "0", "network.nerf.fused_tile", "64",
       "task_arg.precrop_iters", "0"]
HASH = ["network.xyz_encoder.num_levels", "4",
        "network.xyz_encoder.log2_hashmap_size", "10",
        "network.xyz_encoder.desired_resolution", "64",
        "network.nerf.W", "32", "network.nerf.D", "3",
        "network.dir_encoder.freq", "2", "task_arg.N_samples", "8",
        "task_arg.N_importance", "8", "task_arg.perturb", "0",
        "task_arg.raw_noise_std", "0", "task_arg.precrop_iters", "0"]
CASES = {"fused": (LEGO, NET + ["network.nerf.fused_trunk", "true"]),
         "plain": (LEGO, NET), "hash": (LEGO_HASH, HASH)}
# relative Frobenius tolerances (module docstring): gradients, then the
# parameters and moments after two steps
TOL = {"plain": (1e-6, 1e-5), "hash": (1e-6, 1e-3)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene_tp"))
    generate_scene(root, "procedural", H=16, W=16, n_train=4, n_test=1)
    return root


def _scene_opts(root):
    return SCENE + ["train_dataset.data_root", root,
                    "test_dataset.data_root", root]


def _payload(root, model, cases, save=None):
    from nerf_replication_tpu_torch.datasets import make_dataset

    rays, rgbs = make_dataset(make_cfg(LEGO, _scene_opts(root)),
                              "train").ray_bank()
    out = {}
    for case in cases:
        cfg_file, opts = CASES[case]
        out[case] = {"cfg_file": cfg_file, "opts": _scene_opts(root) + opts,
                     "bank_rays": rays, "bank_rgbs": rgbs,
                     "save": None if save is None else save + "_" + case}
    return {"model": model, "cases": out, "n_global": N_GLOBAL, "steps": 2,
            "bad_data_axes": [3]}


@pytest.fixture(scope="module")
def tp12(tmp_path_factory, scene):
    tmp = tmp_path_factory.mktemp("tp12")
    save = str(tmp / "ckpt")
    res = run_ranks("tp", 2, str(tmp / "job"),
                    _payload(scene, 2, list(CASES), save=save))
    return res, save


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _hold(out, case):
    """``out[case]`` of one rank against its DP columns (module
    docstring's tolerances)."""
    o = out[case]
    l_tp, l_dp = zip(*o["losses"])
    if case == "fused":
        assert l_tp == l_dp
        for name, b in o["blocks"].items():
            np.testing.assert_array_equal(*b["param"], err_msg=name)
            for k, (x, y) in b["moments"].items():
                np.testing.assert_array_equal(x, y, err_msg=f"{name} {k}")
        for name, (x, y) in o["gathered"].items():
            np.testing.assert_array_equal(x, y, err_msg=name)
        return
    tol_g, tol_p = TOL[case]
    np.testing.assert_allclose(l_tp, l_dp, rtol=1e-5)
    for name, (g, ref) in o["grads"].items():
        assert _rel(g, ref) <= tol_g, (name, _rel(g, ref))
    for name, b in o["blocks"].items():
        assert _rel(*b["param"]) <= tol_p, (name, _rel(*b["param"]))
        for k, (x, y) in b["moments"].items():
            assert _rel(x, y) <= tol_p, (name, k, _rel(x, y))


@functools.lru_cache(maxsize=None)
def _jax_tree(cfg_opts, cfg_file):
    """(JAX param shapes by path, port state dict) of one config."""
    from nerf_replication_tpu.config import make_cfg as jax_make_cfg
    from nerf_replication_tpu.models import make_network as jax_net
    from nerf_replication_tpu.models import init_params_for

    from nerf_replication_tpu_torch.models import make_network

    jcfg = jax_make_cfg(cfg_file, list(cfg_opts))
    net = jax_net(jcfg)
    shapes = jax.eval_shape(lambda k: init_params_for(jcfg)(net, k),
                            jax.random.PRNGKey(0))
    return shapes, make_network(make_cfg(cfg_file,
                                         list(cfg_opts))).state_dict()


def _jax_meshes():
    from nerf_replication_tpu.parallel.mesh import make_mesh

    from nerf_replication_tpu_torch.parallel.mesh import Mesh

    devs = jax.devices()
    for data, model in ((2, 1), (1, 2), (1, 4), (2, 2)):
        jm = make_mesh(data, model, devices=devs[:data * model])
        yield (data, model), jm, Mesh(None, 0, data * model,
                                      torch.device("cpu"), "gloo",
                                      model=model)


TREES = {"lego": (LEGO, ()), "lego_hash": (LEGO_HASH, ())}


@pytest.mark.parametrize("tree", list(TREES))
def test_tree_specs_match_jax(tree):
    """Every port leaf's spec is JAX's spec of its JAX path, transposed for
    a Dense kernel; the same leaves are split."""
    from nerf_replication_tpu.parallel.sharding import tree_specs as jspecs

    from nerf_replication_tpu_torch.convert import jax_path
    from nerf_replication_tpu_torch.parallel.sharding import tree_specs

    cfg_file, opts = TREES[tree]
    shapes, sd = _jax_tree(opts, cfg_file)
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): spec
            for path, spec in jax.tree_util.tree_flatten_with_path(
                jspecs(shapes), is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    ours = tree_specs(sd)
    assert len(ours) == len(flat)
    split = 0
    for name, spec in ours.items():
        jspec = tuple(flat["params/" + jax_path(name)])
        jspec = jspec + (None,) * (sd[name].ndim - len(jspec))
        want = jspec[::-1] if name.endswith(".weight") else jspec
        assert spec == want, (name, spec, jspec)
        split += "model" in spec
    assert split > 0


@pytest.mark.parametrize("tree", list(TREES))
def test_tree_shard_nbytes_match_jax(tree):
    """Per-device bytes equal JAX's on every mesh; with model 1 the whole
    tree's; ``pts_linear_0`` is 63 x 128 elements a device at model 2 (the
    split is its output columns: a [256, 63] weight's dim 0)."""
    from nerf_replication_tpu.parallel.sharding import (
        tree_shard_nbytes as jbytes,
    )

    from nerf_replication_tpu_torch.parallel.sharding import (
        tree_shard_nbytes,
    )

    cfg_file, opts = TREES[tree]
    shapes, sd = _jax_tree(opts, cfg_file)
    total = sum(v.numel() * v.element_size() for v in sd.values())
    for (data, model), jm, pm in _jax_meshes():
        ours = tree_shard_nbytes(sd, pm)
        assert ours == jbytes(shapes, jm), (data, model)
        if model == 1:
            assert ours == total
    if tree == "lego":
        _, jm, pm = next(m for m in _jax_meshes() if m[0] == (1, 2))
        w = {"fine.pts_linear_0.weight": sd["fine.pts_linear_0.weight"]}
        assert tree_shard_nbytes(w, pm) == 63 * 128 * 4


def test_rank_layout_and_make_mesh_errors_match_jax():
    """Rank r at (r // M, r % M), JAX's ``reshape(data, model)``; a model
    axis that does not divide the ranks raises JAX's words."""
    from nerf_replication_tpu.parallel.mesh import make_mesh as jmake

    from nerf_replication_tpu_torch.parallel import mesh as pm

    devs = jax.devices()[:4]
    jm = jmake(2, 2, devices=devs)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(4):
        m = pm.Mesh(None, r, 4, torch.device("cpu"), "gloo", model=2)
        assert ids[m.data_index, m.model_index] == devs[r].id
        assert m.shape == dict(zip(jm.axis_names, jm.devices.shape))
    from nerf_replication_tpu_torch.parallel.sharding import chunk_sharding

    m = pm.Mesh(None, 3, 4, None, "gloo", model=2)
    assert chunk_sharding(m, 6) == slice(3, 6)  # data index 1 of 2
    with pytest.raises(ValueError, match="must divide the data axis"):
        chunk_sharding(m, 5)
    with pytest.raises(ValueError) as jerr:
        jmake(-1, 3, devices=jax.devices()[:1])
    import torch.distributed as dist

    # the checks run before any group is made: a one-rank group stands in
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError) as err:
            pm.make_mesh(-1, 3, device="cpu")
        assert str(err.value) == str(jerr.value)
        with pytest.raises(ValueError) as jerr:
            jmake(0, 1, devices=jax.devices()[:1])
        with pytest.raises(ValueError) as err:
            pm.make_mesh(0, 1, device="cpu")
        assert str(err.value) == str(jerr.value)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_equals_dp_step_1x2(tp12, case):
    res, _ = tp12
    for r, out in enumerate(res):
        assert out[case]["shape"] == {"data": 1, "model": 2}
        assert out[case]["index"] == (0, r)
        _hold(out, case)
        cols = {n: b["column"] for n, b in out[case]["blocks"].items()}
        # the plain trunk's layers run column-parallel, nothing else does
        assert any(cols.values()) == (case != "fused")
    assert "data_axis=3 does not match the world size 2 over model_axis " \
           "2: set -1 or 1" in res[0]["errors"][3]


def test_tp_step_equals_dp_step_2x2(tmp_path, scene):
    """Four ranks, data 2 x model 2: each rank against DP over its data
    group (two ranks); the ranks of one model index hold the same blocks."""
    res = run_ranks("tp", 4, str(tmp_path / "job"),
                    _payload(scene, 2, ["fused"]))
    for r, out in enumerate(res):
        assert out["fused"]["index"] == (r // 2, r % 2)
        _hold(out, "fused")
    for m in range(2):
        a, b = res[m]["fused"]["blocks"], res[2 + m]["fused"]["blocks"]
        for name in a:
            np.testing.assert_array_equal(a[name]["param"][0],
                                          b[name]["param"][0])


def test_tp_checkpoint_serves_from_one_card(tp12, scene):
    """The chief's gathered TP checkpoint is an ordinary port checkpoint:
    a one-card engine loads it and renders what an engine on the DP
    weights renders (bitwise: the fused case's gathered weights are)."""
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.serve import RenderEngine
    from nerf_replication_tpu_torch.train.checkpoint import load_network

    from test_torch_helpers import BBOX, box_grid, sample_rays

    res, save = tp12
    cfg = make_cfg(LEGO, _scene_opts(scene) + CASES["fused"][1] + [
        "serve.buckets", "[64]", "task_arg.render_step_size", "0.1",
        "task_arg.max_march_samples", "16"])
    net = make_network(cfg)
    assert load_network(save + "_fused", net) == 0
    ref = make_network(cfg)
    ref.load_state_dict({k: torch.from_numpy(v[1]) for k, v in
                         res[0]["fused"]["gathered"].items()})
    outs = []
    for n in (net, ref):
        eng = RenderEngine(cfg, n, 2.0, 6.0, grid=box_grid(16), bbox=BBOX,
                           device="cpu", warmup_families=("full",))
        outs.append(eng.render_flat(sample_rays(48), "full")[0])
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    assert np.isfinite(outs[0]["rgb_map_f"]).all()


def test_precrop_and_ngp_refusals_use_jax_words(scene, tmp_path):
    """Precrop over a TP mesh and NGP with ``model_axis 2`` raise JAX's
    messages; the trainer routes a TP mesh through the GSPMD step."""
    from nerf_replication_tpu.train.ngp import fit_ngp as jax_fit_ngp

    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.parallel.mesh import Mesh
    from nerf_replication_tpu_torch.parallel.step import DPStep, TPStep
    from nerf_replication_tpu_torch.registry import load_attr
    from nerf_replication_tpu_torch.train.ngp import fit_ngp
    from nerf_replication_tpu_torch.train.trainer import (
        Trainer,
        refuse_tp_precrop,
    )

    import nerf_replication_tpu.train.trainer as jtr
    import inspect

    jsrc = inspect.getsource(jtr.Trainer._build_sharded_step)
    cfg = make_cfg(LEGO, _scene_opts(scene) + NET[:-2] + [
        "task_arg.precrop_iters", "5"])
    tp_mesh = Mesh(None, 0, 2, torch.device("cpu"), "gloo", model=2)
    with pytest.raises(NotImplementedError) as err:
        refuse_tp_precrop(cfg, tp_mesh)
    assert " ".join(str(err.value).split()) in " ".join(
        jsrc.replace('"\n', "").replace('"', "").split())
    refuse_tp_precrop(cfg, Mesh(None, 0, 2, torch.device("cpu"), "gloo"))
    net = make_network(cfg)
    loss = load_attr(cfg.loss_module, "make_loss", "NetworkWrapper")(cfg, net)
    with pytest.raises(NotImplementedError, match="precrop warm-up"):
        Trainer(cfg, net, loss, mesh=tp_mesh)
    cfg0 = make_cfg(LEGO, _scene_opts(scene) + NET)
    assert type(Trainer(cfg0, net, loss, mesh=tp_mesh)._dp) is TPStep
    assert type(Trainer(cfg0, net, loss, mesh=Mesh(
        None, 0, 2, torch.device("cpu"), "gloo"))._dp) is DPStep

    ngp = HASH[:-2] + ["task_arg.ngp_training", "true",
                       "parallel.model_axis", "2"]
    from nerf_replication_tpu.config import make_cfg as jax_make_cfg

    with pytest.raises(NotImplementedError) as jerr:
        jax_fit_ngp(jax_make_cfg(LEGO_HASH, _scene_opts(scene) + ngp))
    with pytest.raises(NotImplementedError) as err:
        fit_ngp(make_cfg(LEGO_HASH, _scene_opts(scene) + ngp), device="cpu")
    assert str(err.value) == str(jerr.value)


def test_two_rank_tp_fit_saves_and_resumes_in_one_process(scene, tmp_path):
    """``fit`` with ``parallel.model_axis 2`` on two ranks (the fused
    trunk): both ranks end with the same gathered weights and losses, the
    chief's checkpoint resumes in one process, which takes the next
    epoch's steps."""
    from nerf_replication_tpu_torch.train.trainer import fit

    out = str(tmp_path / "out")

    def opts(epochs, model):
        return _scene_opts(scene) + NET + [
            "network.nerf.fused_trunk", "true",
            "parallel.model_axis", str(model), "task_arg.N_rays", "32",
            "ep_iter", "4", "log_interval", "1", "eval_ep", "100",
            "save_ep", "1", "save_latest_ep", "1",
            "train.epoch", str(epochs), "exp_name", "tp",
            "trained_model_dir", os.path.join(out, "trained"),
            "trained_config_dir", os.path.join(out, "config"),
            "record_dir", os.path.join(out, "record"),
            "result_dir", os.path.join(out, "result")]

    r0, r1 = run_ranks("fit", 2, str(tmp_path / "job"),
                       {"cfg_file": LEGO, "opts": opts(1, 2)})
    assert r0["step"] == r1["step"] == 4
    assert r0["rows"] == r1["rows"]
    for k in r0["weights"]:
        np.testing.assert_array_equal(r0["weights"][k], r1["weights"][k])
    assert r1["writes"]["checkpoint"] == 0 < r0["writes"]["checkpoint"]
    state = fit(make_cfg(LEGO, opts(2, 1)), device="cpu",
                log=lambda s: None)
    assert state.step == 8 and state.tp is None
