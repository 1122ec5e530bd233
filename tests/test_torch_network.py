"""Port parity of the network layers: frequency encoder, coarse/fine NeRF
MLP (float32 and the bf16-compute clone), the fused spec / canonical weight
order and the plain MLP tile chain (``forward_tile``) against the JAX
``_forward_tile``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import SMALL_NET, nets

from nerf_replication_tpu.models.encoding.freq import (
    frequency_encoder as jax_freq,
)
from nerf_replication_tpu.ops.fused_mlp import (
    _forward_tile as jax_forward_tile,
    fused_spec_for as jax_spec_for,
)
from nerf_replication_tpu_torch.models.encoding import frequency_encoder
from nerf_replication_tpu_torch.ops.fused_mlp import (
    _pad_cols,
    forward_tile,
    fused_spec_for,
    pack_for_chain,
)


@pytest.fixture(scope="module")
def small():
    return nets()


@pytest.fixture(scope="module")
def lego():
    return nets(extra=())


def _pts(n, seed=0, scale=1.5):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("n_freqs", [4, 10])
def test_frequency_encoder_matches_jax(n_freqs):
    """Interleaved [x, sin f0, cos f0, ...] order, float32 atol 1e-6."""
    x = _pts(257, scale=1.6)
    jenc, jdim = jax_freq(3, n_freqs)
    penc, pdim = frequency_encoder(3, n_freqs)
    assert jdim == pdim == 3 * (1 + 2 * n_freqs)
    np.testing.assert_allclose(penc(torch.from_numpy(x)).numpy(),
                               np.asarray(jenc(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


def _net_inputs(n_rays=8, n_samples=5, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n_rays, n_samples, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, dirs


@pytest.mark.parametrize("model", ["coarse", "fine"])
@pytest.mark.parametrize("which", ["small", "lego"])
def test_network_f32_matches_flax(small, lego, model, which):
    """Coarse and fine raw outputs (f32), atol 1e-5."""
    jnet, params, pnet = small if which == "small" else lego
    pts, dirs = _net_inputs()
    ref = np.asarray(jnet.apply(params, jnp.asarray(pts), jnp.asarray(dirs),
                                model=model))
    with torch.no_grad():
        out = pnet(torch.from_numpy(pts), torch.from_numpy(dirs),
                   model=model).numpy()
    assert out.shape == ref.shape == (8, 5, 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_network_bf16_clone_matches_flax(lego):
    """bf16 compute (f32 params, f32 heads), atol 2e-2: the trunk's
    activations are rounded to bfloat16 after every layer (8-bit mantissa,
    relative step 2^-8), and the two frameworks round the bf16 products and
    bias sums at slightly different points, so single activations may land
    one bf16 step apart and the heads see that."""
    jnet, params, pnet = lego
    pts, dirs = _net_inputs(seed=2)
    ref = np.asarray(jnet.clone(compute_dtype=jnp.bfloat16).apply(
        params, jnp.asarray(pts), jnp.asarray(dirs), model="fine"))
    with torch.no_grad():
        out = pnet.clone(torch.bfloat16)(
            torch.from_numpy(pts), torch.from_numpy(dirs), model="fine")
    assert out.dtype == torch.float32  # the heads stay float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-2)
    # the clone shares parameters, it does not copy them
    assert pnet.clone(torch.bfloat16).fine.pts_linear_0.weight is \
        pnet.fine.pts_linear_0.weight


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flatten_params_matches_jax_order(lego, dtype):
    """FusedSpec padding (63→64, 27→32) and the canonical flattened order
    equal the JAX package's, tensor for tensor (exact, in the stream
    dtype; heads float32)."""
    jnet, params, pnet = lego
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jspec = jax_spec_for(jnet.clone(compute_dtype=jd))
    pspec = fused_spec_for(pnet.clone(td))
    assert (pspec.c_in_pad, pspec.c_views_pad) == (64, 32)
    assert (jspec.c_in_pad, jspec.c_views_pad) == (64, 32)
    jflat = jspec.flatten_params(params["params"]["fine"])
    pflat = [t.detach() for t in pspec.flatten_params(pnet.fine)]
    assert len(jflat) == len(pflat) == pspec.n_params()
    for i, (a, b) in enumerate(zip(jflat, pflat)):
        assert tuple(a.shape) == tuple(b.shape), i
        assert str(b.dtype).endswith(str(a.dtype)), (i, a.dtype, b.dtype)
        np.testing.assert_array_equal(
            np.asarray(a, np.float32), b.to(torch.float32).numpy(),
            err_msg=str(i))
    wmat, bias, heads = pack_for_chain(pspec, pflat)
    W, W2 = pspec.W, pspec.W2
    assert heads.numel() == W * 8 + 8 + W2 * 8 + 8
    assert wmat.dtype == td
    n_bias = sum(t.numel() for t in pflat if t.shape[0] == 1)
    n_mat = sum(t.numel() for t in pflat) - heads.numel() - n_bias + 16
    # float32 matrices as TF32 (hi, lo) pairs, bf16 ones as they are; the
    # biases (the heads' aside) as float32 in the flatten order
    assert wmat.numel() == n_mat * (2 if dtype == "float32" else 1)
    assert bias.numel() == n_bias - 16 and bias.dtype == torch.float32
    assert torch.equal(bias[:W], pflat[1].reshape(-1).float())


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-3)])
@pytest.mark.parametrize("which", ["small", "lego"])
def test_forward_tile_matches_jax(small, lego, which, dtype, atol):
    """The plain tile chain vs the JAX ``_forward_tile`` on encoded inputs.
    f32 atol 1e-5; bf16 2e-3 (operands rounded to bf16 at the same points,
    products accumulated in f32 in another order, so an activation may
    round to the neighbouring bf16 value)."""
    jnet, params, pnet = small if which == "small" else lego
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jspec = jax_spec_for(jnet.clone(compute_dtype=jd))
    pspec = fused_spec_for(pnet.clone(td))
    pts, dirs = _net_inputs(n_rays=64, n_samples=1, seed=3)
    x = pnet.xyz_encoder(torch.from_numpy(pts[:, 0]))
    v = pnet.dir_encoder(torch.from_numpy(dirs))
    x = _pad_cols(x, pspec.c_in_pad)
    v = _pad_cols(v, pspec.c_views_pad)
    ref, _ = jax_forward_tile(jspec, jnp.asarray(x.numpy()),
                              jnp.asarray(v.numpy()),
                              jspec.flatten_params(params["params"]["fine"]))
    with torch.no_grad():
        out = forward_tile(pspec, x, v, pspec.flatten_params(pnet.fine))
    assert out.shape == (64, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)
    # dead columns of raw8 are exact zeros (rgb 0-2 and sigma 3 are live)
    assert float(out[:, 4:].abs().max()) == 0.0


def test_fused_spec_gate_refuses_unsupported(small):
    """Same family gate as the JAX package: one skip, viewdirs, frequency
    encoders (a learnable hash grid is refused with a ValueError, as the
    JAX gate refuses it, and so is the tri-plane)."""
    from test_torch_helpers import both_cfgs

    from nerf_replication_tpu_torch.models import make_network

    _, pcfg = both_cfgs(SMALL_NET[:-2] + ["network.nerf.skips", "[1, 2]"])
    with pytest.raises(ValueError, match="exactly one skip"):
        fused_spec_for(make_network(pcfg))
    _, pcfg = both_cfgs(SMALL_NET + ["task_arg.use_viewdirs", "false"])
    with pytest.raises(ValueError, match="viewdirs"):
        fused_spec_for(make_network(pcfg))
    _, pcfg = both_cfgs(["network.xyz_encoder.type", "hashgrid",
                         "network.xyz_encoder.bbox",
                         "[[-1.5,-1.5,-1.5],[1.5,1.5,1.5]]",
                         "network.xyz_encoder.log2_hashmap_size", "10",
                         "network.xyz_encoder.num_levels", "2"])
    with pytest.raises(ValueError, match="learnable encoder"):
        fused_spec_for(make_network(pcfg))
    # the tri-plane encoder is learnable too
    _, pcfg = both_cfgs(["network.xyz_encoder.type", "triplane",
                         "network.xyz_encoder.log2_hashmap_size", "10",
                         "network.xyz_encoder.num_levels", "2"])
    with pytest.raises(ValueError, match="learnable encoder"):
        fused_spec_for(make_network(pcfg))
