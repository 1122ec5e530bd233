"""The port's correctly rounded float32 square root and 3-vector norm
(``utils/numerics.py``), held bitwise against numpy's IEEE results on
100,000 seeded values. (On some PyTorch CPU builds ``torch.sqrt`` on float32
differs from the IEEE root on ~14% of uniform values in [0.5, 2); the port's
plain versions go through these helpers so that they meet the JAX package
and the kernels' ``__fsqrt_rn`` bit for bit.) Also the blocked prefix sum
of the packed march (a 1-D CUDA ``torch.cumsum`` adds in an order that
varies run to run): exactly ``torch.cumsum`` on integer-valued floats,
within float64 rounding of it on random ones, at every length around its
row boundaries, one series or several; its card-side repeatability is in
``tests/test_torch_cuda_compile.py``."""

import numpy as np
import pytest
import torch

from nerf_replication_tpu_torch.utils.numerics import (
    norm3_rn,
    prefix_sum,
    sq_norm3,
    sqrt_rn,
)


def test_sqrt_rn_is_ieee_on_100k_values():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 2.0, 100_000).astype(np.float32)
    out = sqrt_rn(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.sqrt(x))
    # across the range: tiny, huge, subnormal, exact squares, 0 and inf
    wide = np.concatenate([
        np.exp2(rng.uniform(-140, 127, 100_000)).astype(np.float32),
        np.asarray([0.0, 1e-45, 4.0, 2.0**-126, np.inf], np.float32)])
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(wide)).numpy(),
                                  np.sqrt(wide))


def test_norm3_rn_is_the_ieee_left_to_right_norm():
    rng = np.random.default_rng(1)
    d = rng.normal(0, 1, (100_000, 3)).astype(np.float32)
    sq = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    t = torch.from_numpy(d)
    np.testing.assert_array_equal(sq_norm3(t).numpy(), sq)
    np.testing.assert_array_equal(norm3_rn(t).numpy(), np.sqrt(sq))
    np.testing.assert_array_equal(norm3_rn(t, keepdim=True).numpy(),
                                  np.sqrt(sq)[:, None])
    # leading axes: [..., 3]
    assert tuple(norm3_rn(t.reshape(100, 1000, 3)).shape) == (100, 1000)


def test_rounded_helpers_keep_their_gradients():
    d = torch.tensor([[3.0, 4.0, 12.0], [1.0, 2.0, 2.0]], requires_grad=True)
    n = norm3_rn(d)
    assert n.tolist() == [13.0, 3.0]
    n.sum().backward()
    torch.testing.assert_close(d.grad, d.detach() / n.detach()[:, None])


@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 2048, 4097, 786_432])
def test_blocked_prefix_sum_is_cumsum(n):
    """Rows of 1024 (at least two) plus the earlier rows' totals: exact on
    integers (every partial sum representable), within the float64 error
    bound of a sum of n terms of the sequential sum on random values;
    gradients as cumsum's; five series at once as each alone."""
    rng = np.random.default_rng(n)
    ints = torch.from_numpy(rng.integers(0, 1000, n).astype(np.float64))
    assert torch.equal(prefix_sum(ints), torch.cumsum(ints, 0))
    x = torch.from_numpy(rng.exponential(1.0, n)).requires_grad_(True)
    out = prefix_sum(x)
    ref = torch.cumsum(x.detach(), 0)
    assert out.shape == (n,)
    # two orders of n additions: each within (n − 1)·2^-53·Σx of the sum
    assert float((out.detach() - ref).abs().max()) <= \
        2 * n * 2.0 ** -53 * float(ref[-1])
    g = torch.from_numpy(rng.normal(size=n))
    (out * g).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               np.cumsum(g.numpy()[::-1])[::-1], rtol=1e-12,
                               atol=1e-12 * float(g.abs().sum()))
    # a [M, 5] stream's columns scanned as five series (a transposed view)
    cols = torch.from_numpy(rng.exponential(1.0, (n, 5)))
    many = prefix_sum(cols.t())
    assert many.shape == (5, n)
    for j in range(5):
        assert torch.equal(many[j], prefix_sum(cols[:, j]))
