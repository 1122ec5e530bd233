"""The yardstick's counts reproduce the repository's kernel table (the
bounds of K1, K2 and K5 at the shapes it lists)."""

import json
import os

import pytest
import torch

from counts import mlp
from counts.peaks import bound_s, compute_peak
from reference import serve_march

from conftest import BENCH_DIR

K_ROWS = 65_573  # the kernel table's K1 / K2 rows


def _config(name):
    with open(os.path.join(BENCH_DIR, "configs", name + ".json")) as f:
        return json.load(f)


def test_lego_row_flops():
    widths = mlp.nerf_widths(_config("lego")["model_spec"])
    assert mlp.row_flops(*widths, padded=True) == 1_193_984  # 1.194 MFLOP
    assert mlp.row_flops(*widths) == 1_186_816


@pytest.mark.parametrize("dtype,kernel,ms", [
    ("bfloat16", "k1", 0.079), ("float32", "k1", 0.475),
    ("bfloat16", "k2", 1.028)])
def test_mlp_bounds(dtype, kernel, ms):
    widths = mlp.nerf_widths(_config("lego")["model_spec"])
    flops = mlp.row_flops(*widths, padded=True)
    fn = mlp.k1_bound_s if kernel == "k1" else mlp.k2_bound_s
    assert fn(K_ROWS, flops, dtype, 0) * 1e3 == pytest.approx(ms, rel=5e-3)


def test_k5_bound_on_the_table_inputs():
    si = pytest.importorskip("nerf_replication_tpu_torch.tools.slice_inputs")
    c = _config("lego")
    spec = dict(c["model_spec"], bbox=c["serve"]["bbox"])
    rays = torch.from_numpy(si.view_rays(30.0, 128))
    grid = torch.from_numpy(si.ball_grid(128, 0.46))
    samples = serve_march.count_samples(rays, grid, spec, c["serve"])
    flops = samples * mlp.row_flops(*mlp.nerf_widths(c["model_spec"]),
                                    padded=True)
    assert bound_s(flops, 0, compute_peak("float32")) * 1e3 == \
        pytest.approx(3.409, rel=2e-3)


def test_step_flops_count_forward_and_backward():
    spec = _config("lego")["model_spec"]
    rows = sum(mlp.nerf_rows_per_step(spec).values())
    assert rows == 4096 * (64 + 64 + 128)
    assert mlp.train_step_flops(rows, 10) == 3 * rows * 10
