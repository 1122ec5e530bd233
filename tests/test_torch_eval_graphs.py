"""The eval renders as CUDA graphs (``Renderer.aot_register_eval`` /
``aot_install``, ``NGPTrainer.aot_register_render``), on the CPU, and the
lego trainer's refusal of ``train.profile``.

A CPU has no graphs, so :class:`StubRegistry` captures an entry by running
it once and hands out a :class:`~nerf_replication_tpu_torch.compile.
CapturedFn` whose graph's ``replay()`` runs the registered function again
on the static inputs and writes its results into the static outputs (what a
replay does on the card). Against it:

* the entry names are the JAX package's for the same shapes
  (``eval_chunked_*``, ``eval_march_*``, ``ngp_render_*_cap*``);
* a replayed whole-image render equals the eager render bitwise on each
  route (chunked, per-ray, packed hierarchical, packed clipped; fused
  trunk, so K1/K3a's plain versions) and the JAX render within
  ``tests/test_torch_eval.py``'s tolerances (maps 1e-5, depth 1e-4; the
  chunked render 1e-3 / 1e-2), traversal stats and truncation exact;
* a batch whose bounds or ray count differ from an entry's does not replay
  it, and loading another grid drops the installed marches;
* an NGP overflow escalation registers the new cap's entry and never
  replays the outgrown one; the NGP ``gather`` eval registers nothing;
* ``Trainer.val`` and ``run --type evaluate`` replay what they captured;
* ``fit`` refuses ``train.profile``, as ``fit_ngp`` does.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_eval import MARCH, ROUTES, _grid
from test_torch_helpers import (
    BBOX,
    FAR,
    LEGO,
    NEAR,
    ROOT,
    both_cfgs,
    nets,
    sample_rays,
)

from nerf_replication_tpu.compile.registry import AOTRegistry as JaxRegistry
from nerf_replication_tpu.renderer import volume as jv
from nerf_replication_tpu_torch.compile import AOTRegistry, CapturedFn
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.renderer import volume as pv
from nerf_replication_tpu_torch.renderer.occupancy import save_occupancy_grid

LEGO_HASH = os.path.join(ROOT, "configs", "nerf", "lego_hash.yaml")
FUSED = ["network.nerf.fused_trunk", "true"]
# the eval routes of chip_smoke.py phase 7, and Trainer.val's chunked render
GRAPH_ROUTES = {"chunked": FUSED, "per_ray": ROUTES["per_ray_fused"],
                "packed_hier": ROUTES["packed_hier_fused"],
                "packed_clip": ROUTES["packed_clip_fused"]}


class StubGraph:
    """A CPU stand-in for ``torch.cuda.CUDAGraph``: ``replay()`` runs the
    captured function on the static inputs into the static outputs (in
    inference mode, where the serving engine's outputs were made)."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        with torch.inference_mode():
            for k, v in self.fn(*self.inputs).items():
                self.outputs[k].copy_(v)


class StubRegistry(AOTRegistry):
    """An enabled registry on the CPU whose captures are :class:`StubGraph`
    s: warm-up, then one "capture" run whose outputs become static."""

    def __init__(self):
        super().__init__(device=torch.device("cpu"), enabled=True)

    def _capture(self, entry):
        entry.fn(*entry.static_inputs)
        outputs = entry.fn(*entry.static_inputs)
        self.captures += 1
        entry.result = CapturedFn(
            entry.name, StubGraph(entry.fn, entry.static_inputs, outputs),
            entry.static_inputs, outputs, {}, "compiled")


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grid") / "occupancy_grid.npz")
    save_occupancy_grid(path, _grid(), BBOX, 1.0)
    return path


@pytest.fixture(scope="module")
def weights():
    return nets(seed=4)


def _renderers(weights, extra, grid_path):
    jnet, params, pnet = weights
    jcfg, pcfg = both_cfgs(MARCH + extra)
    jr, pr = jv.Renderer(jcfg, jnet), pv.Renderer(pcfg, pnet)
    if grid_path is not None:
        assert jr.load_occupancy_grid(grid_path)
        assert pr.load_occupancy_grid(grid_path)
    return params, jr, pr


def _view(renderer, rays, near=NEAR, far=FAR):
    """The whole-image render (copied: a replay's outputs are static) and
    the traversal stats."""
    with torch.no_grad():
        out = renderer.render_accelerated(
            {"rays": torch.from_numpy(rays), "near": near, "far": far})
    stats = {k: v for k, v in renderer.last_march_stats.items()
             if k != "sweep"}
    return {k: v.clone() for k, v in out.items()}, stats


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _hash_opts(extra=()):
    return [
        "network.xyz_encoder.type", "hashgrid",
        "network.xyz_encoder.num_levels", "4",
        "network.xyz_encoder.log2_hashmap_size", "10",
        "network.xyz_encoder.desired_resolution", "64",
        "network.xyz_encoder.bbox", "[[-1.5,-1.5,-1.5],[1.5,1.5,1.5]]",
        "network.nerf.W", "32", "network.nerf.D", "2",
        "network.nerf.skips", "[1]", "network.dir_encoder.freq", "2",
        "task_arg.render_step_size", "0.08", "task_arg.max_march_samples",
        "24", "task_arg.eval_render_step_size", "0.08",
        "task_arg.eval_max_march_samples", "24", *extra]


def test_entry_names_are_the_jax_names(weights, grid_file):
    """The renderer's chunked and march entries and NGP's render entry carry
    the JAX package's names for the same ray counts and caps."""
    params, jr, pr = _renderers(weights, ROUTES["packed_hier"], grid_file)
    for n in (45, 32, 7):
        jreg, preg = JaxRegistry(enabled=False), StubRegistry()
        jnames = jr.aot_register_eval(jreg, params, n, NEAR, FAR)
        assert pr.aot_register_eval(preg, n, NEAR, FAR) == jnames
        assert preg.names() == jreg.names() == jnames
        assert pr.aot_register_eval(preg, n, NEAR, FAR,
                                    chunked=False) == jnames[1:]

    from nerf_replication_tpu.train.ngp import NGPTrainer as JaxNGP
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer

    opts = ["task_arg.ngp_packed_march", "true", "task_arg.march_chunk_size",
            "32", "task_arg.ngp_grid_res", "16"]
    jnet, jparams, pnet = nets(extra=_hash_opts(opts))
    jcfg, pcfg = both_cfgs(_hash_opts(opts))
    jtr, ptr = JaxNGP(jcfg, jnet), NGPTrainer(pcfg, pnet)
    jtr.aot, ptr.aot = JaxRegistry(enabled=False), StubRegistry()
    jtr.aot_register_render(SimpleNamespace(
        params=jparams, grid_ema=jnp.full((16,) * 3, 2.0)), 45)
    ptr.aot_register_render(ptr.make_state("cpu"), 45)
    assert ptr.aot.names() == jtr.aot.names() == ["ngp_render_2x32_cap1024"]


@pytest.mark.parametrize("route", sorted(GRAPH_ROUTES))
def test_replayed_view_equals_eager_and_jax(weights, grid_file, route):
    """Eager, then registered, captured, installed and replayed on the same
    view and on a second one: bitwise the eager renders (maps, stats,
    truncation), within the eval tolerances of JAX's render."""
    chunked = route == "chunked"
    grid_path = None if chunked else grid_file
    params, jr, pr = _renderers(weights, GRAPH_ROUTES[route], grid_path)
    _, _, eager_r = _renderers(weights, GRAPH_ROUTES[route], grid_path)
    views = [sample_rays(45, seed=6), sample_rays(45, seed=9)]
    eager = [_view(eager_r, rays) for rays in views]
    reg = StubRegistry()
    names = pr.aot_register_eval(reg, 45, NEAR, FAR, chunked=chunked)
    assert len(names) == 1 and names[0].startswith(
        "eval_chunked" if chunked else "eval_march")
    reg.compile_all()
    assert pr.aot_install(reg) == 1 and reg.captures == 1
    for i, rays in enumerate(views):
        out, stats = _view(pr, rays)
        _equal(out, eager[i][0])
        _equal(stats, eager[i][1])
    assert reg.take(names[0]).replays == 2 and reg.captures == 1
    assert pr.report_truncation(log=lambda s: None) == \
        eager_r.report_truncation(log=lambda s: None)

    ref = jr.render_accelerated(params, {"rays": jnp.asarray(views[1]),
                                         "near": NEAR, "far": FAR})
    assert set(ref) == set(out)
    for k in ref:
        atol = (1e-3 if chunked else 1e-5) * (
            10 if k.startswith("depth") else 1)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=atol, err_msg=k)
    assert set(jr.last_march_stats) - {"sweep"} == set(stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(jr.last_march_stats[k]),
                                      err_msg=k)


def test_other_bounds_or_ray_count_do_not_replay(weights, grid_file):
    """An entry closes over its bounds and chunks: another far, another ray
    count or another grid renders eagerly (and equals a renderer that never
    captured); the installed chunked entry is not the march's."""
    _, _, pr = _renderers(weights, ROUTES["per_ray_fused"], grid_file)
    _, _, eager_r = _renderers(weights, ROUTES["per_ray_fused"], grid_file)
    reg = StubRegistry()
    names = pr.aot_register_eval(reg, 45, NEAR, FAR)
    reg.compile_all()
    assert pr.aot_install(reg) == 2
    rays = sample_rays(45, seed=6)
    # 40 rays pad into the entry's two 32-ray chunks as 45 do; 20 do not
    for n, far, replays in ((45, FAR - 0.5, 0), (20, FAR, 0), (40, FAR, 1)):
        _equal(_view(pr, rays[:n], far=far)[0],
               _view(eager_r, rays[:n], far=far)[0])
        assert [reg.take(n).replays for n in names] == [0, replays]
    _view(pr, rays)
    assert [reg.take(n).replays for n in names] == [0, 2]
    assert pr.load_occupancy_grid(grid_file)  # a new grid: marches dropped
    _view(pr, rays)
    assert reg.take(names[1]).replays == 2
    with torch.no_grad():
        pr.render_chunked({"rays": torch.from_numpy(rays), "near": NEAR,
                           "far": FAR})
    assert reg.take(names[0]).replays == 1


def _ngp(extra=()):
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer

    cfg = make_cfg(LEGO_HASH, _hash_opts([
        "task_arg.ngp_grid_res", "16", "task_arg.march_chunk_size", "32",
        *extra]))
    trainer = NGPTrainer(cfg, make_network(cfg))
    return trainer, trainer.make_state("cpu")


def _ngp_view(trainer, state, rays):
    with torch.no_grad():
        out = trainer.render_image(state, {"rays": torch.from_numpy(rays)})
    return {k: v.clone() for k, v in out.items()}


@pytest.mark.parametrize("packed", [False, True])
def test_ngp_val_replays_its_captured_render(packed):
    """``aot_register_render`` captures one entry before the views; every
    view (and a second val) replays it, bitwise the eager trainer, with no
    further capture."""
    extra = ["task_arg.ngp_packed_march", "true"] if packed else []
    eager, e_state = _ngp(extra)
    graphed, g_state = _ngp(extra)
    graphed.aot = StubRegistry()
    graphed.aot_register_render(g_state, 45)
    assert graphed.aot.captures == 1
    for seed in (6, 9, 6):
        rays = sample_rays(45, seed=seed)
        _equal(_ngp_view(graphed, g_state, rays),
               _ngp_view(eager, e_state, rays))
    (name,) = graphed.aot.names()
    assert graphed.aot.take(name).replays == 3 and graphed.aot.captures == 1


def test_ngp_escalation_registers_the_new_cap_and_drops_the_old():
    """A packed stream that overflows its cap doubles it and re-renders:
    each new cap captures its entry once, the outgrown entry is never
    replayed again, and a second view captures nothing."""
    extra = ["task_arg.ngp_packed_march", "true",
             "task_arg.ngp_packed_cap_avg_eval", "16"]
    eager, e_state = _ngp(extra)
    graphed, g_state = _ngp(extra)
    graphed.aot = StubRegistry()
    graphed.aot_register_render(g_state, 45)
    rays = sample_rays(45, seed=6)
    out = _ngp_view(graphed, g_state, rays)
    _equal(out, _ngp_view(eager, e_state, rays))
    names = graphed.aot.names()
    caps = [int(n.rsplit("cap", 1)[1]) for n in names]
    assert caps == [16 * 2 ** i for i in range(len(names))]
    assert caps[-1] == graphed.packed_cap_avg_eval == \
        eager.packed_cap_avg_eval
    assert graphed.aot.captures == len(names) > 1
    replays = [graphed.aot.take(n).replays for n in names]
    assert replays == [1] * len(names)
    _equal(_ngp_view(graphed, g_state, rays),
           _ngp_view(eager, e_state, rays))
    assert [graphed.aot.take(n).replays for n in names] == \
        replays[:-1] + [2]
    assert graphed.aot.captures == len(names)


def test_ngp_gather_eval_registers_nothing():
    """The ``gather`` eval route (K4; ``nonzero``) stays eager."""
    trainer, state = _ngp(["task_arg.march_fused", "gather",
                           "task_arg.march_coarse_block", "4"])
    trainer.aot = StubRegistry()
    trainer.aot_register_render(state, 45)
    out = _ngp_view(trainer, state, sample_rays(45, seed=6))
    assert trainer.aot.names() == [] and trainer.aot.captures == 0
    assert torch.isfinite(out["rgb_map_f"]).all()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from nerf_replication_tpu_torch.datasets.procedural import generate_scene

    root = str(tmp_path_factory.mktemp("scene_graphs"))
    generate_scene(root, "procedural", H=16, W=16, n_train=4, n_test=2)
    return root


def _scene_opts(root, out, extra=()):
    from test_torch_eval import _cli_opts

    return _cli_opts(root, out) + list(extra)


def test_trainer_val_replays_the_captured_view(scene, tmp_path):
    """``Trainer.aot_register_val`` captures the test view's chunked render
    (fused trunk); ``val`` replays it on both views and scores them as the
    eager ``val`` does."""
    from nerf_replication_tpu_torch.datasets import make_dataset
    from nerf_replication_tpu_torch.evaluators import make_evaluator
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train.loss import make_loss
    from nerf_replication_tpu_torch.train.trainer import (
        Trainer,
        make_train_state,
    )

    cfg = make_cfg(LEGO, _scene_opts(scene, str(tmp_path), FUSED))
    test_ds = make_dataset(cfg, "test")
    results = []
    for graphed in (False, True):
        net = make_network(cfg)
        trainer = Trainer(cfg, net, make_loss(cfg, net), make_evaluator(cfg))
        state = make_train_state(cfg, net, "cpu")
        if graphed:
            trainer.aot = StubRegistry()
            trainer.aot_register_val(test_ds)
            assert trainer.aot.names() == ["eval_chunked_1x256"]
        results.append(trainer.val(state, 0, test_ds, log=lambda s: None))
    assert results[0] == results[1] and np.isfinite(results[1]["psnr"])
    assert trainer.aot.take("eval_chunked_1x256").replays == 2
    assert trainer.aot.captures == 1


def test_run_evaluate_captures_the_route_it_renders(scene, tmp_path,
                                                    monkeypatch, capsys):
    """With a registry on the card (here the stub), ``run --type evaluate``
    registers only the march when the grid loads, captures it before the
    views, prints the ``compile:`` line, replays it on both views (no
    capture after the first) and scores as the eager run does."""
    import nerf_replication_tpu_torch.compile as compile_mod
    from nerf_replication_tpu_torch import occupancy_grid
    from nerf_replication_tpu_torch.run import run_evaluate
    from nerf_replication_tpu_torch.train.trainer import fit

    opts = _scene_opts(scene, str(tmp_path / "out"), FUSED)
    cfg = make_cfg(LEGO, opts)
    fit(cfg, device="cpu", log=lambda s: None)
    monkeypatch.chdir(tmp_path)
    assert occupancy_grid.main(["--cfg_file", LEGO, "--device", "cpu",
                                *opts]) == 0
    args = SimpleNamespace(cfg_file=LEGO, device="cpu")
    eager = run_evaluate(cfg, args)
    assert eager["compile"] is None
    monkeypatch.setattr(compile_mod, "registry_from_cfg",
                        lambda cfg, dev: StubRegistry())
    capsys.readouterr()
    graphed = run_evaluate(cfg, args)
    assert "compile: {" in capsys.readouterr().out
    st = graphed["compile"]
    assert st["entries"] == st["captures"] == 1 and not st["errors"]
    assert graphed["used_grid"] and graphed["n_images"] == 2
    for k in ("psnr", "ssim", "n_truncated", "march"):
        assert graphed[k] == eager[k], k
