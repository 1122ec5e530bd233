"""Port parity of the img_fit task (``models/img_fit/network.py``,
``datasets/img_fit.py``, ``train/loss_img_fit.py``, ``evaluators/img_fit.py``)
and of ``utils.image.resize_area``.

* The network from ``lego_view0.yaml`` at W 32 D 2 freq 4 carries the Flax
  parameters over (``backbone_i`` / ``rgb`` transposed) and maps uv to rgb
  in (0, 1) within 1e-6 of the jitted JAX network; the loss and its
  gradients within 1e-6 / 1e-5 of each gradient's max.
* ``resize_area`` against ``cv2.INTER_AREA`` at 0.5 and a non-integer
  ratio, uint8 and float32: bitwise. The dataset at ``input_ratio 0.5``
  equals JAX's bitwise.
* The chunked eval render, eager and through the CUDA-graph entry
  ``img_fit_apply_{n}x{chunk}`` (a CPU stand-in registry replays it), equal.
* ``fit`` on a 24 x 24 procedural view through the port's trainer: the last
  validation PSNR beats the flat-gray image's, ``metrics.json`` and
  ``vis/res.png`` written.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ROOT, jax_tree_numpy

from nerf_replication_tpu.config import make_cfg as jax_make_cfg
from nerf_replication_tpu.datasets.img_fit import Dataset as JaxDataset
from nerf_replication_tpu.models.img_fit.network import (
    init_params as jax_init_params,
    make_network as jax_make_network,
)
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.convert import params_from_jax
from nerf_replication_tpu_torch.datasets.img_fit import Dataset
from nerf_replication_tpu_torch.datasets.procedural import generate_scene
from nerf_replication_tpu_torch.models.img_fit.network import make_network
from nerf_replication_tpu_torch.utils.image import resize_area

CFG = os.path.join(ROOT, "configs", "img_fit", "lego_view0.yaml")
SMALL = ["network.W", "32", "network.D", "2", "network.uv_encoder.freq", "4"]


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene_imgfit"))
    generate_scene(root, scene="procedural", H=24, W=24, n_train=2, n_test=1)
    return root


def _pair(seed=0):
    jcfg, pcfg = jax_make_cfg(CFG, SMALL), make_cfg(CFG, SMALL)
    jnet = jax_make_network(jcfg)
    params = jax_init_params(jnet, jax.random.PRNGKey(seed))
    pnet = make_network(pcfg)
    pnet.load_state_dict(params_from_jax(jax_tree_numpy(params)), strict=True)
    return jnet, params, pnet


def test_network_and_loss_match_jax():
    from nerf_replication_tpu.train.loss_img_fit import ImgFitLoss as JLoss
    from nerf_replication_tpu_torch.train.loss_img_fit import ImgFitLoss

    jnet, params, pnet = _pair()
    rng = np.random.default_rng(0)
    uv = rng.random((3, 40, 2), np.float32)
    out_j = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(uv)))
    out_p = pnet(torch.from_numpy(uv)).detach().numpy()
    assert out_p.shape == (3, 40, 3)
    assert (out_p > 0).all() and (out_p < 1).all()
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=1e-6)

    rgb = rng.random((64, 3), np.float32)
    x = rng.random((64, 2), np.float32)
    jcfg, pcfg = jax_make_cfg(CFG, SMALL), make_cfg(CFG, SMALL)
    jl = JLoss(jcfg, jnet)

    def lf(p):
        return jl(p, {"rays": jnp.asarray(x), "rgbs": jnp.asarray(rgb)})[1]

    loss_j, g = jax.jit(jax.value_and_grad(lf))(params)
    _, loss_p, stats = ImgFitLoss(pcfg, pnet)(
        {"rays": torch.from_numpy(x), "rgbs": torch.from_numpy(rgb)})
    assert abs(float(loss_p.detach()) - float(loss_j)) <= 1e-6
    assert set(stats) == {"loss", "psnr"}
    loss_p.backward()
    for key, ref in params_from_jax(jax_tree_numpy(g)).items():
        got = dict(pnet.named_parameters())[key].grad.numpy()
        scale = max(float(np.abs(ref.numpy()).max()), 1e-30)
        assert float(np.abs(got - ref.numpy()).max()) <= 1e-5 * scale, key


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_area_is_bitwise_cv2(dtype):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    img = (rng.integers(0, 256, (48, 40, 3)).astype(np.uint8)
           if dtype == np.uint8 else rng.random((48, 40, 3), np.float32))
    for W, H in ((20, 24), (13, 17), (27, 31)):
        np.testing.assert_array_equal(
            resize_area(img, W, H),
            cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA))
    with pytest.raises(ValueError, match="downscales"):
        resize_area(img, 80, 96)


def test_dataset_matches_jax_at_half_ratio(scene_root):
    for ratio in (1.0, 0.5):
        j = JaxDataset(scene_root, "procedural", split="test", input_ratio=ratio)
        p = Dataset(scene_root, "procedural", split="test", input_ratio=ratio)
        assert (p.H, p.W) == (j.H, j.W)
        for a, b in zip(p.ray_bank(), j.ray_bank()):
            np.testing.assert_array_equal(a, b)
        assert p.image_batch(0)["meta"] == j.image_batch(0)["meta"]


def test_chunked_render_through_its_graph_entry():
    from test_torch_eval_graphs import StubRegistry

    from nerf_replication_tpu_torch.train.loss_img_fit import ImgFitRenderer

    _, _, pnet = _pair(seed=1)
    cfg = make_cfg(CFG, SMALL + ["task_arg.chunk_size", "128"])
    renderer = ImgFitRenderer(cfg, pnet)
    uv = torch.from_numpy(np.random.default_rng(2).random((300, 2),
                                                          np.float32))
    eager = renderer.render_chunked({"rays": uv})["rgb"].clone()
    with torch.no_grad():
        np.testing.assert_array_equal(eager.numpy(), pnet(uv).numpy())
    reg = StubRegistry()
    assert renderer.aot_register_eval(reg, 300) == ["img_fit_apply_3x128"]
    reg.compile_all()
    assert renderer.aot_install(reg) == 1
    graphed = renderer.render_chunked({"rays": uv})
    assert graphed["rgb"].shape == (300, 3)
    np.testing.assert_array_equal(graphed["rgb"].numpy(), eager.numpy())


def test_fit_beats_flat_gray(scene_root, tmp_path):
    from nerf_replication_tpu_torch.train.trainer import fit

    cfg = make_cfg(CFG, [
        "scene", "procedural",
        "train_dataset.data_root", scene_root,
        "test_dataset.data_root", scene_root,
        "test_dataset.input_ratio", "0.5",
        "task_arg.N_pixels", "256",
        "network.W", "32", "network.D", "2", "network.uv_encoder.freq", "4",
        "ep_iter", "50", "train.epoch", "4", "eval_ep", "4",
        "save_latest_ep", "100", "log_interval", "25",
        "result_dir", str(tmp_path / "result"),
        "trained_model_dir", str(tmp_path / "model"),
        "trained_config_dir", str(tmp_path / "config"),
        "record_dir", str(tmp_path / "record"),
    ])
    logs = []
    state = fit(cfg, log=logs.append, device="cpu")
    assert state.step == 200
    val = [line for line in logs if line.startswith("val epoch")]
    assert val, logs[-3:]
    psnr = float(val[-1].split("psnr:")[1].split()[0])
    gt = Dataset(scene_root, "procedural", split="test", input_ratio=0.5).img
    flat = -10 * np.log10(np.mean((gt - 0.5) ** 2))
    assert psnr > flat + 1.0, (psnr, flat)
    assert os.path.exists(os.path.join(cfg.result_dir, "metrics.json"))
    assert os.path.exists(os.path.join(cfg.result_dir, "vis", "res.png"))
