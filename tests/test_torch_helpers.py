"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py),
plus the test of the JAX → port weight conversion they all rely on.

Both packages are driven from the SAME inputs: one config file with the same
opts, JAX weights from ``init_params`` carried across with
``convert.params_from_jax``, rays and grids made with numpy from a seed.
Sizes are small (D=4, W=32, a 16³ grid, step 0.25) so the JAX side stays
fast on the CPU."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import torch  # noqa: E402

from nerf_replication_tpu.config import make_cfg as jax_make_cfg  # noqa: E402
from nerf_replication_tpu.models import make_network as jax_make_network  # noqa: E402
from nerf_replication_tpu.models.nerf.network import (  # noqa: E402
    init_params as jax_init_params,
)
from nerf_replication_tpu_torch.config import make_cfg  # noqa: E402
from nerf_replication_tpu_torch.convert import params_from_jax  # noqa: E402
from nerf_replication_tpu_torch.models import make_network  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEGO = os.path.join(ROOT, "configs", "nerf", "lego.yaml")
NEAR, FAR = 2.0, 6.0
SMALL_NET = [
    "network.nerf.W", "32",
    "network.nerf.D", "4",
    "network.nerf.skips", "[1]",
]


def both_cfgs(extra=()):
    """(JAX cfg, port cfg) from lego.yaml with the same opts."""
    opts = list(extra)
    return jax_make_cfg(LEGO, opts), make_cfg(LEGO, opts)


def jax_tree_numpy(params) -> dict:
    return jax.tree.map(np.asarray, params)


def nets(extra=SMALL_NET, seed=0):
    """(JAX network, JAX params, port network with the same weights)."""
    jcfg, pcfg = both_cfgs(extra)
    jnet = jax_make_network(jcfg)
    params = jax_init_params(jnet, jax.random.PRNGKey(seed))
    pnet = make_network(pcfg)
    pnet.load_state_dict(params_from_jax(jax_tree_numpy(params)), strict=True)
    return jnet, params, pnet


def sample_rays(n: int, seed: int = 7) -> np.ndarray:
    """Rays from (0, 0, 4) looking down -z with a spread (the JAX fused-march
    tests' bundle)."""
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [np.tile([0.0, 0.0, 4.0], (n, 1)),
         np.array([0.0, 0.0, -1.0]) + rng.normal(0, 0.15, (n, 3))],
        -1,
    ).astype(np.float32)


def box_grid(res: int = 16) -> np.ndarray:
    grid = np.zeros((res, res, res), bool)
    lo, hi = res // 4, 3 * res // 4
    grid[lo:hi, lo:hi, lo:hi] = True
    return grid


BBOX = np.asarray([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)


def test_params_from_jax_maps_every_leaf():
    """Every JAX kernel lands transposed in the port's state dict, the
    SplitDense kernels keep their c1 split, nothing is left over."""
    jnet, params, pnet = nets()
    tree = jax_tree_numpy(params)["params"]
    state = pnet.state_dict()
    n = 0
    for branch, layers in tree.items():
        for name, leaf in layers.items():
            w = state[f"{branch}.{name}.weight"].numpy()
            np.testing.assert_array_equal(w, leaf["kernel"].T)
            np.testing.assert_array_equal(
                state[f"{branch}.{name}.bias"].numpy(), leaf["bias"])
            n += 2
    assert n == len(state)
    # the skip layer (skips=[1] → pts_linear_2) is one [W, 63 + W] matrix
    assert tuple(state["fine.pts_linear_2.weight"].shape) == (32, 63 + 32)


def test_port_init_matches_flax_distribution():
    """init_params draws lecun-normal (truncated) kernels and zero biases:
    per-layer std ≈ 1/sqrt(fan_in) and |w| ≤ 2·std_trunc, like flax."""
    from nerf_replication_tpu_torch.models.nerf.network import init_params

    pnet = make_network(make_cfg(LEGO))
    init_params(pnet, torch.Generator().manual_seed(0))
    w = pnet.fine.pts_linear_1.weight.detach().numpy()
    assert abs(w.std() * np.sqrt(256) - 1.0) < 0.05
    assert np.abs(w).max() <= 2.0 / np.sqrt(256) / 0.87962566103423978 + 1e-6
    assert float(pnet.fine.pts_linear_1.bias.detach().abs().max()) == 0.0
    # the same seed gives the same weights
    again = make_network(make_cfg(LEGO))
    init_params(again, torch.Generator().manual_seed(0))
    assert torch.equal(again.fine.pts_linear_1.weight,
                       pnet.fine.pts_linear_1.weight)
