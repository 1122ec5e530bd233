"""The port's compile registry (``nerf_replication_tpu_torch/compile``:
CUDA graphs) and what the captured steps rest on, on the CPU.

* ``registry_from_cfg``: None with ``compile.aot false``; on a CPU device a
  disabled registry whose ``take`` gives None (a CPU has no graphs); the
  summary carries the JAX registry's keys (mirrors
  ``tests/test_compile.py``). A capture that raises lands in the summary's
  errors and ``take`` gives None, as in JAX.
* ``artifact_key`` separates sources, flags, toolchain and extra tag (the
  JAX key separates name, signature and config); ``artifact_census`` counts
  a directory's kernel libraries.
* The launch-accounting helpers add a captured counter delta per replay.
* The trainer's reseeded generator draws bitwise what ``step_generator``
  makes for the same (seed, step), ``randint`` and ``rand`` both.
* A tensor lr filled per step gives Adam bitwise the float lr's steps (and
  the optax parity of ``tests/test_torch_train.py`` runs on that path).
* ``restored`` leaves the state as it was around a real step (a capture's
  warm-up).
* ``utils.numerics.cumprod`` (the compositing transmittances): the forward
  is ``torch.cumprod``'s, the gradient bitwise its on rows without a zero
  and within float32 rounding on rows with one, with no host read (which
  ``torch.cumprod``'s backward makes, and a captured step cannot).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_helpers import LEGO

from nerf_replication_tpu.compile import registry as jax_registry
from nerf_replication_tpu_torch.compile import (
    AOTRegistry,
    CapturedFn,
    artifact_census,
    artifact_key,
    artifact_path,
    default_artifact_dir,
    registry_from_cfg,
)
from nerf_replication_tpu_torch.compile import registry as reg_mod
from nerf_replication_tpu_torch.config import make_cfg


def test_registry_from_cfg_gates_on_aot_and_disables_on_the_cpu():
    assert registry_from_cfg(make_cfg(LEGO, ["compile.aot", "false"]),
                             "cpu") is None
    reg = registry_from_cfg(make_cfg(LEGO, []), "cpu")
    assert isinstance(reg, AOTRegistry) and not reg.enabled
    reg.register("f", lambda x: x * 2, (torch.ones(3),))
    reg.compile_all()
    assert reg.take("f") is None and reg.captures == 0
    assert reg.names() == ["f"]


def test_summary_has_the_jax_keys():
    jax_reg = jax_registry.AOTRegistry(enabled=False)
    reg = AOTRegistry(device=torch.device("cpu"), enabled=False)
    reg.register("f", lambda: None)
    assert set(reg.summary()) == set(jax_reg.summary())
    assert reg.summary() == {"entries": 1, "sources": {}, "wall_s": 0.0,
                             "errors": []}
    status = reg.status()
    assert status["captures"] == 0 and status["error_text"] == {}
    assert reg.warm_source() in ("disk", "compiled")


def test_a_failed_capture_is_recorded_and_take_gives_none():
    # a registry switched on where no card is: the capture raises
    reg = AOTRegistry(device=torch.device("cpu"), enabled=True)
    assert reg.take("never_registered") is None
    reg.register("bad", lambda: torch.ones(2))
    before = reg_mod.launch_snapshot()
    reg.compile_all()
    assert reg.take("bad") is None
    assert reg.summary()["errors"] == ["bad"]
    assert reg.captures == 0
    assert "bad" in reg.status()["error_text"]
    assert reg_mod.launch_snapshot() == before


def test_artifact_key_separates_sources_flags_toolchain_and_tag(tmp_path):
    a, b = tmp_path / "a.cu", tmp_path / "b.cuh"
    a.write_text("kernel a")
    b.write_text("header b")
    kw = {"flags": ("-O3",), "toolchain": "torch 2 cuda 12 sm_90"}
    key = artifact_key("k", [a, b], **kw)
    assert key == artifact_key("k", [a, b], **kw)
    assert key.startswith("k_") and len(key) == len("k_") + 16
    assert key != artifact_key("j", [a, b], **kw)
    assert key != artifact_key("k", [a, b], "tag", **kw)
    assert key != artifact_key("k", [a, b], flags=("-O2",),
                               toolchain=kw["toolchain"])
    assert key != artifact_key("k", [a, b], flags=kw["flags"],
                               toolchain="torch 2 cuda 12 sm_80")
    assert key != artifact_key("k", [a, b], flags=kw["flags"],
                               toolchain="torch 3 cuda 12 sm_90")
    b.write_text("header b, edited")
    assert key != artifact_key("k", [a, b], **kw)


def test_artifact_census_counts_kernel_libraries(tmp_path):
    d = str(tmp_path / "libs")
    assert artifact_census(d) == {"dir": d, "n_artifacts": 0, "bytes": 0}
    os.makedirs(d)
    with open(artifact_path(d, "k_0123456789abcdef"), "wb") as f:
        f.write(b"\0" * 10)
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("not a library")
    assert artifact_census(d) == {"dir": d, "n_artifacts": 1, "bytes": 10}
    assert default_artifact_dir().endswith(os.path.join("build",
                                                        "torch_kernels"))


def test_the_kernel_build_keys_libraries_by_artifact_key():
    from nerf_replication_tpu_torch.ops import kernels

    path = kernels._lib_path("fused_mlp")
    assert os.path.dirname(path) == default_artifact_dir()
    assert os.path.basename(path).startswith("libfused_mlp_")
    assert kernels.builds == 0  # no nvcc here: nothing was built


def test_launch_accounting_adds_the_captured_delta_per_replay():
    from nerf_replication_tpu_torch.ops import fused_mlp, hash_encode

    before = reg_mod.launch_snapshot()
    fused_mlp.LAUNCHES["fused_mlp_fwd"] += 2
    hash_encode.LAUNCHES["hash_encode_bwd"] += 1
    delta = reg_mod.launch_delta(before)
    assert delta == {("fused_mlp", "fused_mlp_fwd"): 2,
                     ("hash_encode", "hash_encode_bwd"): 1}
    reg_mod.add_launches(delta, times=-1)  # a capture launches nothing
    assert reg_mod.launch_snapshot() == before

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    fn = CapturedFn("step", Graph(), (), {"loss": 1}, delta, "disk")
    for _ in range(3):
        assert fn() == {"loss": 1}
    assert Graph.replays == 3 and fn.replays == 3
    after = reg_mod.launch_snapshot()
    assert after[("fused_mlp", "fused_mlp_fwd")] == \
        before[("fused_mlp", "fused_mlp_fwd")] + 6
    assert after[("hash_encode", "hash_encode_bwd")] == \
        before[("hash_encode", "hash_encode_bwd")] + 3
    reg_mod.add_launches(delta, times=-3)


def test_captured_fn_copies_inputs_into_its_static_tensors():
    static = torch.zeros(3)

    class Graph:
        def replay(self):
            out.copy_(static * 2)

    out = torch.zeros(3)
    fn = CapturedFn("f", Graph(), (static,), out, {}, "compiled")
    assert torch.equal(fn(torch.tensor([1.0, 2.0, 3.0])),
                       torch.tensor([2.0, 4.0, 6.0]))
    assert fn(static) is out  # the static tensor itself: no copy
    with pytest.raises(TypeError):
        fn()


@pytest.mark.parametrize("step", [0, 1, 7])
def test_reseeded_generator_draws_what_step_generator_draws(step):
    from nerf_replication_tpu_torch.datasets.sampling import (
        reseed,
        step_generator,
    )

    kept = torch.Generator()
    for _ in range(2):  # whatever the kept generator drew before
        torch.rand((5,), generator=kept)
        reseed(kept, 3, step)
        fresh = step_generator(3, step, "cpu")
        for gen_a, gen_b in ((kept, fresh),):
            a = (torch.randint(0, 1000, (64,), generator=gen_a),
                 torch.rand((16, 3), generator=gen_a))
            b = (torch.randint(0, 1000, (64,), generator=gen_b),
                 torch.rand((16, 3), generator=gen_b))
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_tensor_lr_adam_equals_float_lr_adam_bitwise():
    from nerf_replication_tpu_torch.train.optim import (
        capturable,
        make_optimizer,
        set_lr,
    )

    cfg = make_cfg(LEGO, ["train.scheduler.type", "multi_step",
                          "train.scheduler.milestones", "[0, 1, 2]",
                          "train.scheduler.gamma", "0.5", "ep_iter", "1"])
    rng = np.random.default_rng(0)
    p0 = torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))
    grads = [torch.from_numpy(rng.normal(size=(40,)).astype(np.float32))
             for _ in range(3)]
    p_t = torch.nn.Parameter(p0.clone())
    opt_t, sched = make_optimizer(cfg, [p_t])
    assert torch.is_tensor(opt_t.param_groups[0]["lr"])
    assert not capturable(opt_t)  # capturable only on the card
    p_f = torch.nn.Parameter(p0.clone())
    opt_f = torch.optim.Adam([p_f], lr=sched(0), eps=1e-8)
    lrs = []
    for count, g in enumerate(grads):
        for p, opt in ((p_t, opt_t), (p_f, opt_f)):
            p.grad = g.clone()
            lrs.append(set_lr(opt, sched, count))
            opt.step()
        assert torch.equal(p_t, p_f)
    assert lrs[0] > lrs[2] > lrs[4]  # the schedule moved between steps


def test_restored_puts_back_parameters_and_optimizer_state():
    from nerf_replication_tpu_torch.train.optim import make_optimizer
    from nerf_replication_tpu_torch.train.trainer import TrainState, restored

    cfg = make_cfg(LEGO, [])
    net = torch.nn.Linear(4, 3)
    opt, sched = make_optimizer(cfg, net.parameters())
    state = TrainState(net, opt, sched, 0)
    x = torch.ones(2, 4)

    def step():
        opt.zero_grad(set_to_none=True)
        net(x).sum().backward()
        opt.step()

    w0 = net.weight.detach().clone()
    with restored(state):
        step()  # a fresh optimizer makes its moments here
    assert torch.equal(net.weight, w0)
    for st in opt.state.values():
        assert all(float(v.abs().max()) == 0.0 for v in st.values())
    step()
    w1, m1 = net.weight.detach().clone(), opt.state[net.weight][
        "exp_avg"].clone()
    with restored(state):
        step()
    assert torch.equal(net.weight, w1)
    assert torch.equal(opt.state[net.weight]["exp_avg"], m1)


def test_device_scalar_fills_without_a_host_copy():
    from nerf_replication_tpu_torch.utils.platform import device_scalar

    t = device_scalar(0.1, torch.float32, "cpu")
    assert t.dim() == 0 and t.dtype == torch.float32
    assert float(t) == float(np.float32(0.1))
    src = torch.tensor(2.0, dtype=torch.float64)
    assert device_scalar(src, torch.float32, "cpu").dtype == torch.float32


def test_capturable_cumprod_matches_torch_cumprod_and_its_gradient():
    from nerf_replication_tpu_torch.utils.numerics import cumprod

    gen = torch.Generator().manual_seed(0)
    x = torch.rand((40, 12), generator=gen, dtype=torch.float64) + 0.1
    x[3, 4] = x[7, 0] = x[7, 5] = x[9, 11] = 0.0  # zeros, one row two
    g = torch.randn((40, 12), generator=gen, dtype=torch.float64)
    for dtype in (torch.float64, torch.float32):
        a = x.to(dtype).clone().requires_grad_(True)
        b = x.to(dtype).clone().requires_grad_(True)
        ya, yb = torch.cumprod(a, -1), cumprod(b)
        assert torch.equal(ya, yb)
        (ya * g.to(dtype)).sum().backward()
        (yb * g.to(dtype)).sum().backward()
        nz = (x != 0).all(-1)  # rows without a zero: the same formula
        assert torch.equal(a.grad[nz], b.grad[nz])
        tol = 1e-12 if dtype == torch.float64 else 1e-6  # another order
        assert float((a.grad - b.grad).abs().max()) <= tol
