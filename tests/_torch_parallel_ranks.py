"""Rank-side code of the multi-process port tests
(``tests/test_torch_parallel*.py``): ranks are gloo processes on the CPU,
started with the ``spawn`` method and joined through a ``FileStore`` under
the test's ``tmp_path`` (no TCP port to clash across xdist workers).

This module imports only torch, numpy and the port: a spawned child that
imported a test file would import JAX without the conftest's CPU pin. It is
not collected (its name does not start with ``test_``).

``run_ranks(job, world, tmp, payload)`` runs ``JOBS[job](rank, world,
payload)`` on every rank and returns the ranks' results (pickled to
``tmp``); a rank that raises fails the call with its traceback.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGO = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
LEGO_HASH = os.path.join(ROOT, "configs", "nerf", "lego_hash.yaml")
TIMEOUT_S = 240


def _entry(rank: int, world: int, tmp: str, job: str, payload) -> None:
    sys.path.insert(0, ROOT)
    torch.set_num_threads(2)
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        from nerf_replication_tpu_torch.parallel.mesh import multihost_init

        multihost_init(device="cpu",
                       init_method="file://" + os.path.join(tmp, "store"),
                       rank=rank, world_size=world, timeout_s=TIMEOUT_S)
        result = JOBS[job](rank, world, payload)
        with open(out, "wb") as f:
            pickle.dump({"ok": True, "result": result}, f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump({"ok": False, "error": traceback.format_exc()}, f)
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(job: str, world: int, tmp: str, payload=None) -> list:
    """Every rank's ``JOBS[job]`` result, in rank order."""
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    try:
        mp.start_processes(_entry, args=(world, tmp, job, payload),
                           nprocs=world, join=True, start_method="spawn")
    except Exception as exc:
        errors = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    res = pickle.load(f)
                if not res["ok"]:
                    errors.append(f"rank {r}:\n{res['error']}")
        raise RuntimeError("\n".join(errors) or str(exc)) from exc
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f)["result"])
    return results


# -- helpers ------------------------------------------------------------------

def cpu_mesh():
    from nerf_replication_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device="cpu")


def net_state(net) -> dict:
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def fit_job(rank, world, payload):
    """A fit from ``payload["opts"]`` on ``payload["cfg_file"]``: the step
    rows' (step, loss, psnr), the final weights (and grid), the files this
    rank saw written, and the SIGTERM rank / step when asked for."""
    import signal

    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.train.trainer import fit

    from nerf_replication_tpu_torch.train import ngp
    from nerf_replication_tpu_torch.train import trainer as tr

    rows = []  # (step, loss, psnr) of every step this rank took
    sig = payload.get("sigterm")  # (rank, step): SIGTERM after that step

    def after(step, stats):
        rows.append((step, float(stats["loss"]), float(stats["psnr"])))
        if sig and rank == sig[0] and step == sig[1]:
            os.kill(os.getpid(), signal.SIGTERM)

    orig, orig_ngp = tr.Trainer.step, ngp.NGPTrainer._one_step

    def step(self, state, *a, **k):
        state, stats = orig(self, state, *a, **k)
        after(state.step, stats)
        return state, stats

    def one_step(self, state, *a, **k):
        stats = orig_ngp(self, state, *a, **k)
        after(state.step, stats)
        return stats

    # what this rank writes: checkpoint files, scalar writers, telemetry
    from nerf_replication_tpu_torch.obs import emit
    from nerf_replication_tpu_torch.train import checkpoint, recorder

    writes = {"checkpoint": 0, "scalars": 0, "telemetry": 0}
    saved = (checkpoint._write, recorder._summary_writer, emit.Emitter.emit)

    def _write(*a, **k):
        writes["checkpoint"] += 1
        return saved[0](*a, **k)

    def _writer(*a, **k):
        writes["scalars"] += 1
        return saved[1](*a, **k)

    def _emit(self, kind, **fields):
        writes["telemetry"] += int(self.chief)
        return saved[2](self, kind, **fields)

    cfg = make_cfg(payload["cfg_file"], payload["opts"])
    tr.Trainer.step, ngp.NGPTrainer._one_step = step, one_step
    checkpoint._write, recorder._summary_writer = _write, _writer
    emit.Emitter.emit = _emit
    try:
        state = fit(cfg, device="cpu", log=lambda s: None)
    finally:
        tr.Trainer.step, ngp.NGPTrainer._one_step = orig, orig_ngp
        checkpoint._write, recorder._summary_writer = saved[:2]
        emit.Emitter.emit = saved[2]
    grid = getattr(state, "grid_ema", None)
    return {"rows": rows, "step": state.step, "writes": writes,
            "weights": {k: v.numpy() for k, v in
                        net_state(state.network).items()},
            "grid": None if grid is None else grid.numpy().copy()}


def main_job(rank, world, payload):
    """A CLI's ``main(argv)`` (``payload["module"]``: train, run or
    render_video) on this rank; its return code."""
    import importlib

    mod = importlib.import_module(
        f"nerf_replication_tpu_torch.{payload['module']}")
    if payload["module"] == "train":
        mod = importlib.import_module("nerf_replication_tpu_torch.train."
                                      "__main__")
    return mod.main(payload["argv"])


JOBS = {"fit": fit_job, "main": main_job}


# -- tests/test_torch_parallel.py: one job holding every rank-side check ---

def _port_net(cfg, weights: str):
    from nerf_replication_tpu_torch.models import make_network

    net = make_network(cfg)
    net.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    return net


def _as_mesh(rank, size):
    """Rank ``rank`` of a ``size``-rank mesh, no group (what the sharding
    helpers read), for the one-process emulations."""
    from nerf_replication_tpu_torch.parallel.mesh import Mesh

    return Mesh(None, rank, size, torch.device("cpu"), "gloo")


def _collectives(mesh):
    from nerf_replication_tpu_torch.parallel import collectives as c

    x = torch.from_numpy(np.random.default_rng(mesh.rank).normal(
        size=(4, 3)).astype(np.float32))
    obj = c.broadcast_from_chief({"rank": mesh.rank}, mesh)
    t = x.clone()
    c.broadcast_from_chief(t, mesh)
    tree = c.tree_pmean({"a": x, "b": x[0, :2].to(torch.float64)}, mesh)
    return {"x": x.numpy(), "psum": c.psum(x, mesh).numpy(),
            "pmean": c.pmean(x, mesh).numpy(),
            "pmax": c.pmax(x, mesh).numpy(),
            "gather": c.all_gather(x, mesh).numpy(),
            "gather_tiled": c.all_gather(x, mesh, tiled=True).numpy(),
            "bcast": t.numpy(), "bcast_obj": obj,
            "tree_a": tree["a"].numpy(), "tree_b": tree["b"].numpy(),
            "tree_b_dtype": str(tree["b"].dtype),
            "axis_index": c.axis_index(mesh),
            "counts": dict(c.COUNTS)}


def _lego_state(cfg, weights):
    from nerf_replication_tpu_torch.registry import load_attr
    from nerf_replication_tpu_torch.train.optim import make_optimizer
    from nerf_replication_tpu_torch.train.trainer import TrainState

    net = _port_net(cfg, weights)
    loss = load_attr(cfg.loss_module, "make_loss", "NetworkWrapper")(cfg, net)
    opt, sched = make_optimizer(cfg, net.parameters())
    return loss, TrainState(net, opt, sched, 0)


def _dp_vs_jax(mesh, p, case):
    """Two DP steps fed the rays JAX's shard ``mesh.rank`` drew (the
    sampler replaced): each step's loss and the weights after it."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.parallel.sharding import (
        shard_bank,
        shard_index_pool,
    )
    from nerf_replication_tpu_torch.parallel.step import build_dp_step
    from nerf_replication_tpu_torch.train import step_core

    c = p["dp_cases"][case]
    cfg = make_cfg(LEGO, c["opts"])
    loss, state = _lego_state(cfg, p["weights"])
    bank = [torch.from_numpy(a) for a in shard_bank(p["bank_rays"],
                                                    p["bank_rgbs"], mesh)]
    pool = None
    if c["pool"]:
        pool = torch.from_numpy(shard_index_pool(
            p["pool"], p["bank_rays"].shape[0], mesh))
    feed = iter(c["draws"][s][mesh.rank] for s in range(len(c["draws"])))
    seen = []

    def draw(gen, rays, rgbs, n, index_pool=None):
        seen.append((rays.shape[0], n, None if index_pool is None
                     else index_pool.numpy().copy()))
        r, g = next(feed)
        return torch.from_numpy(r), torch.from_numpy(g)

    step = build_dp_step(mesh, loss, p["n_global"], 2.0, 6.0)
    orig, step_core.sample_rays = step_core.sample_rays, draw
    out = []
    try:
        for _ in range(len(c["draws"])):
            state, stats = step(state, bank[0], bank[1], pool)
            out.append({"loss": float(stats["loss"]),
                        "weights": {k: v.numpy().copy() for k, v in
                                    state.network.state_dict().items()}})
    finally:
        step_core.sample_rays = orig
    return {"steps": out, "seen": seen}


def _lego_emulation(mesh, p, n_steps=2):
    """``n_steps`` DP steps with the port's own draws (precrop pool on)
    against their one-process emulation on rank 0: both ranks' streams,
    ``(g0 + g1) / 2``, clip + Adam."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets.sampling import step_generator
    from nerf_replication_tpu_torch.parallel.sharding import (
        shard_bank,
        shard_index_pool,
    )
    from nerf_replication_tpu_torch.parallel.step import build_dp_step
    from nerf_replication_tpu_torch.train.optim import (
        optimizer_step,
        set_lr,
    )
    from nerf_replication_tpu_torch.train.step_core import sampled_grad_step

    cfg = make_cfg(LEGO, p["dp_cases"]["pool"]["opts"])

    def inputs(m):
        b = [torch.from_numpy(a) for a in shard_bank(
            p["bank_rays"], p["bank_rgbs"], m)]
        pool = torch.from_numpy(shard_index_pool(
            p["pool"], p["bank_rays"].shape[0], m))
        return b, pool

    loss, state = _lego_state(cfg, p["weights"])
    step = build_dp_step(mesh, loss, p["n_global"], 2.0, 6.0)
    bank, pool = inputs(mesh)
    for _ in range(n_steps):
        state, stats = step(state, bank[0], bank[1], pool)
    res = {"weights": {k: v.numpy().copy() for k, v in
                       state.network.state_dict().items()},
           "loss": float(stats["loss"])}
    if mesh.rank != 0:
        return res
    eloss, emu = _lego_state(cfg, p["weights"])
    params = list(emu.network.parameters())
    for s in range(n_steps):
        grads = []
        for r in range(mesh.size):
            b, pl = inputs(_as_mesh(r, mesh.size))
            sampled_grad_step(eloss, params, b[0], b[1],
                              p["n_global"] // mesh.size, 2.0, 6.0,
                              step_generator(0, s, "cpu", r), index_pool=pl)
            grads.append([q.grad.clone() for q in params])
        for q, g0, g1 in zip(params, *grads):
            q.grad = (g0 + g1) / 2
        set_lr(emu.optimizer, emu.schedule, s)
        optimizer_step(emu.optimizer)
    res["emulated"] = {k: v.numpy().copy() for k, v in
                       emu.network.state_dict().items()}
    return res


def _ngp_emulation(mesh, p):
    """Two NGP DP steps (warm, then march) against their one-process
    emulation on rank 0; the emulated grid is the MAX of the ranks'
    candidates, each the single-card update from this rank's samples,
    cells and jitter."""
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.datasets.sampling import step_generator
    from nerf_replication_tpu_torch.parallel.sharding import shard_bank
    from nerf_replication_tpu_torch.train.ngp import NGPTrainer
    from nerf_replication_tpu_torch.train.optim import (
        optimizer_step,
        set_lr,
    )

    cfg = make_cfg(LEGO_HASH, p["ngp_opts"])

    def bank_of(m):
        return [torch.from_numpy(a) for a in shard_bank(
            p["bank_rays"], p["bank_rgbs"], m)]

    from nerf_replication_tpu_torch.models import make_network

    trainer = NGPTrainer(cfg, make_network(cfg), mesh=mesh)
    state = trainer.make_state("cpu")  # seeded: the emulation's init
    bank = bank_of(mesh)
    phases = []
    for _ in range(2):
        trainer.multi_step(state, bank[0], bank[1], 1)
        phases.append(trainer.last_burst_warm)
    res = {"weights": {k: v.numpy().copy() for k, v in
                       state.network.state_dict().items()},
           "grid": state.grid_ema.numpy().copy(), "phases": phases}
    if mesh.rank != 0:
        return res
    emu = NGPTrainer(cfg, make_network(cfg))
    emu.n_local = trainer.n_local
    st = emu.make_state("cpu")
    params = list(st.network.parameters())
    for s, warm in enumerate(phases):
        grads, outs, gens = [], [], []
        for r in range(mesh.size):
            b = bank_of(_as_mesh(r, mesh.size))
            emu._gen = step_generator(0, s, "cpu", r)
            _, out = emu._grad_part(st, b[0], b[1], warm, lambda i: None)
            grads.append([None if q.grad is None else q.grad.clone()
                          for q in params])
            outs.append({k: v.detach().clone() for k, v in out.items()})
            gens.append(emu._gen)
        for q, g0, g1 in zip(params, *grads):
            q.grad = None if g0 is None else (g0 + g1) / 2
        set_lr(st.optimizer, st.schedule, s)
        optimizer_step(st.optimizer)
        base = st.grid_ema.clone()
        cands = []
        for r in range(mesh.size):
            st.grid_ema.copy_(base)
            emu._gen = gens[r]
            emu._grid_part(st, outs[r])
            cands.append(st.grid_ema.clone())
        st.grid_ema.copy_(torch.maximum(*cands))
    res["emulated"] = {k: v.numpy().copy() for k, v in
                       st.network.state_dict().items()}
    res["emulated_grid"] = st.grid_ema.numpy().copy()
    return res


def _sequence(mesh, p):
    """The 16x16 view through the sequence-parallel renderer and march, and
    the sharded gate's refusal of other bounds."""
    from types import SimpleNamespace

    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.parallel.sequence import (
        build_sequence_parallel_march,
        build_sequence_parallel_renderer,
    )
    from nerf_replication_tpu_torch.renderer.gate import (
        BakedBoundsError,
        full_image_render_fn,
    )
    from nerf_replication_tpu_torch.renderer.volume import Renderer

    cfg = make_cfg(LEGO, p["seq_opts"])
    net = _port_net(cfg, p["weights"])
    renderer = Renderer(cfg, net)
    rays = torch.from_numpy(p["view_rays"])
    render = build_sequence_parallel_renderer(
        mesh, renderer._apply_fn(), renderer.eval_options, 2.0, 6.0,
        chunk_size=p["chunk"])
    march = build_sequence_parallel_march(
        mesh, renderer._apply_fn(), renderer.march_options, 2.0, 6.0,
        chunk_size=p["chunk"])
    with torch.no_grad():
        r_out = render(rays)
        m_out = march(rays, torch.from_numpy(p["grid"]),
                      torch.from_numpy(p["bbox"]))
    gate = full_image_render_fn(cfg, net, renderer,
                                SimpleNamespace(near=2.0, far=6.0))
    refused = False
    try:
        gate({"rays": rays, "near": 2.5, "far": 6.0})
    except BakedBoundsError:
        refused = True
    g_out = gate({"rays": rays, "near": 2.0, "far": 6.0})
    with torch.no_grad():
        one = renderer.render_chunked({"rays": rays, "near": 2.0,
                                       "far": 6.0})
    return {"render": {k: v.numpy() for k, v in r_out.items()},
            "one": {k: v.numpy() for k, v in one.items()},
            "march": {k: v.numpy() for k, v in m_out.items()},
            "gate_equal": all(torch.equal(g_out[k], r_out[k])
                              for k in r_out),
            "gate_sharded": gate.mesh is not None, "refused": refused}


def _mesh_rules(mesh):
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.parallel.mesh import (
        make_mesh,
        make_mesh_from_cfg,
    )

    out = {}
    for extra in (["parallel.data_axis", "1"], ["parallel.data_axis", "3"]):
        try:
            make_mesh_from_cfg(make_cfg(LEGO, extra), device="cpu")
            out[extra[1]] = None
        except ValueError as err:
            out[extra[1]] = str(err)
    m = make_mesh_from_cfg(make_cfg(LEGO, ["parallel.data_axis", "2"]),
                           device="cpu")
    out["mesh"] = (m.rank, m.size, m.backend, str(m.device))
    out["default"] = make_mesh(device="cpu").shape
    return out


def checks_job(rank, world, p):
    mesh = cpu_mesh()
    return {"collectives": _collectives(mesh),
            "dp_vs_jax": {case: _dp_vs_jax(mesh, p, case)
                          for case in p["dp_cases"]},
            "lego_emulation": _lego_emulation(mesh, p),
            "ngp_emulation": _ngp_emulation(mesh, p),
            "sequence": _sequence(mesh, p),
            "mesh_rules": _mesh_rules(mesh)}


JOBS["checks"] = checks_job
