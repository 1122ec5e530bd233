"""Port parity of config, registry and device seat, and the port's import
isolation: the PyTorch package (and chip_smoke.py) never import JAX, flax or
the JAX package."""

import os
import subprocess
import sys

import pytest
import torch

from test_torch_helpers import ROOT, both_cfgs

from nerf_replication_tpu_torch.registry import port_module_name, resolve_module
from nerf_replication_tpu_torch.utils.platform import resolve_device

SLICE = ["task_arg.march_coarse_block", "8", "task_arg.march_fused", "full"]


@pytest.mark.parametrize("cfg_name", ["lego.yaml", "lego_hash.yaml"])
def test_make_cfg_equals_jax_tree(cfg_name):
    """make_cfg(<config>, opts) builds exactly the JAX package's tree."""
    from nerf_replication_tpu.config import make_cfg as jax_make_cfg
    from nerf_replication_tpu_torch.config import make_cfg

    path = os.path.join(ROOT, "configs", "nerf", cfg_name)
    opts = SLICE + ["serve.buckets", "[4096]", "task_arg.N_rays", "256"]
    a = jax_make_cfg(path, opts).to_dict()
    b = make_cfg(path, opts).to_dict()
    assert a == b
    assert b["task_arg"]["march_fused"] == "full"


def test_march_options_match_jax():
    import dataclasses

    from nerf_replication_tpu.renderer.accelerated import MarchOptions as J
    from nerf_replication_tpu_torch.renderer.accelerated import MarchOptions

    jcfg, pcfg = both_cfgs(SLICE + ["task_arg.eval_max_march_samples", "96"])
    assert dataclasses.asdict(J.eval_from_cfg(jcfg)) == dataclasses.asdict(
        MarchOptions.eval_from_cfg(pcfg))


def test_registry_maps_config_modules_to_the_port():
    assert port_module_name("nerf_replication_tpu.models.nerf.network") == \
        "nerf_replication_tpu_torch.models.nerf.network"
    assert port_module_name("src.models.nerf.network") == \
        "nerf_replication_tpu_torch.models.nerf.network"
    assert port_module_name("src.datasets.nerf.blender") == \
        "nerf_replication_tpu_torch.datasets.blender"
    mod = resolve_module("nerf_replication_tpu.datasets.blender")
    assert mod.__name__ == "nerf_replication_tpu_torch.datasets.blender"
    # a role the port has no counterpart for names the missing module
    with pytest.raises(ImportError,
                       match="nerf_replication_tpu_torch.parallel.compat"):
        resolve_module("nerf_replication_tpu.parallel.compat")
    assert resolve_module("nerf_replication_tpu.analysis.sanitizer") \
        .__name__ == "nerf_replication_tpu_torch.analysis.sanitizer"
    assert resolve_module("nerf_replication_tpu.scale.mesh_dispatch") \
        .__name__ == "nerf_replication_tpu_torch.scale.mesh_dispatch"
    assert resolve_module("nerf_replication_tpu.scale.router").__name__ \
        == "nerf_replication_tpu_torch.scale.router"
    assert resolve_module("nerf_replication_tpu.fleet.registry").__name__ \
        == "nerf_replication_tpu_torch.fleet.registry"
    assert resolve_module("nerf_replication_tpu.models.img_fit.network") \
        .__name__ == "nerf_replication_tpu_torch.models.img_fit.network"
    assert resolve_module("nerf_replication_tpu.models.proposal").__name__ \
        == "nerf_replication_tpu_torch.models.proposal"


def test_device_seat_refuses_silent_cpu(monkeypatch):
    """cuda requested on a machine without it raises; cpu must be asked
    for by name; TF32 is pinned off."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("mps")


_ISOLATION = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import nerf_replication_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import runpy
runpy.run_path({smoke!r}, run_name="chip_smoke_import")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "nerf_replication_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
"""


def test_port_imports_no_jax():
    """A fresh interpreter importing every port module and chip_smoke.py
    ends with no jax, flax or nerf_replication_tpu module loaded."""
    code = _ISOLATION.format(root=ROOT,
                             smoke=os.path.join(ROOT, "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("[]")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and from a directory that holds only the script."""
    import shutil

    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != ROOT:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
        res = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120, cwd=cwd)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
