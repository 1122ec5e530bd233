"""Port parity of the light-stage data path (``datasets/light_stage.py``,
``generate_light_stage_capture``, ``datasets/latent.py``) and of training a
time-conditioned network on it.

* The port's generator writes JAX's ``annots.npy`` (image paths with
  ``.png`` where JAX writes ``.jpg``) and PNG pixels equal to the arrays
  the JAX generator hands Pillow.
* On one PNG capture (4 cameras x 3 frames, 32 x 32) the port's dataset
  equals JAX's: the 7-column ray bank and its colours bitwise, near / far /
  wbbox, and an eval image batch.
* Each OpenCV replacement against ``cv2``: erode/dilate band, convex hull
  fill and the INTER_NEAREST / INTER_AREA resizes bitwise; ``undistort``
  bitwise with zero distortion and within ``UNDISTORT_TOL`` (0.02 of the
  value range) otherwise.
* Three ``perturb 0`` Adam steps of the light-stage network (hash ⊕ latent,
  W 32 D 3, dynamic.yaml's lr 1e-2 but Adam eps 1e-6: see ``NET``) on fixed
  7-column batches of that bank against the JAX loss + optax step: each
  step's loss within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import ROOT, jax_tree_numpy

from nerf_replication_tpu.datasets import light_stage as jls
from nerf_replication_tpu.datasets.procedural import (
    generate_light_stage_capture as jax_generate,
)
from nerf_replication_tpu_torch.datasets import light_stage as pls
from nerf_replication_tpu_torch.datasets.procedural import (
    generate_light_stage_capture,
)

cv2 = pytest.importorskip("cv2")

N_CAMS, N_FRAMES, HW = 4, 3, 32
DYNAMIC = os.path.join(ROOT, "configs", "light_stage", "dynamic.yaml")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("light_stage_png"))
    return generate_light_stage_capture(root, n_cams=N_CAMS,
                                        n_frames=N_FRAMES, H=HW, W=HW)


def test_generator_matches_jax(capture, tmp_path, monkeypatch):
    """Same annots (but the image extension) and vertices; the PNG pixels
    are the arrays the JAX generator encodes (captured at Pillow)."""
    from PIL import Image

    from nerf_replication_tpu_torch.utils.image import read_png

    encoded = []
    real = Image.fromarray

    def spy(arr, *a, **k):
        encoded.append(np.array(arr))
        return real(arr, *a, **k)

    monkeypatch.setattr(Image, "fromarray", spy)
    jroot = jax_generate(str(tmp_path), n_cams=N_CAMS, n_frames=N_FRAMES,
                         H=HW, W=HW)
    ja = np.load(os.path.join(jroot, "annots.npy"), allow_pickle=True).item()
    pa = np.load(os.path.join(capture, "annots.npy"), allow_pickle=True).item()
    for k in ("K", "D", "R", "T"):
        np.testing.assert_array_equal(np.asarray(pa["cams"][k]),
                                      np.asarray(ja["cams"][k]))
    assert [[p.replace(".png", ".jpg") for p in f["ims"]] for f in pa["ims"]] \
        == [f["ims"] for f in ja["ims"]]
    for f in range(N_FRAMES):
        np.testing.assert_array_equal(
            np.load(os.path.join(capture, "new_vertices", f"{f}.npy")),
            np.load(os.path.join(jroot, "new_vertices", f"{f}.npy")))
    # Pillow saw (image, mask) per (frame, camera), in that order
    it = iter(encoded)
    for f in range(N_FRAMES):
        for c in range(N_CAMS):
            img, msk = next(it), next(it)
            rel = pa["ims"][f]["ims"][c]
            np.testing.assert_array_equal(
                read_png(os.path.join(capture, rel)), img)
            np.testing.assert_array_equal(read_png(os.path.join(
                capture, rel.replace("images", "mask"))), msk)


def test_dataset_matches_jax_on_a_png_capture(capture):
    jtr = jls.Dataset(data_root=capture, split="train")
    ptr = pls.Dataset(data_root=capture, split="train")
    assert ptr.rays.shape[1] == 7
    np.testing.assert_array_equal(ptr.rays, jtr.rays)
    np.testing.assert_array_equal(ptr.rgbs, jtr.rgbs)
    np.testing.assert_array_equal(ptr.wbbox, jtr.wbbox)
    assert (ptr.near, ptr.far, ptr.H, ptr.W) == (jtr.near, jtr.far, jtr.H,
                                                 jtr.W)
    jte = jls.Dataset(data_root=capture, split="test", cameras=(0, -1, 2))
    pte = pls.Dataset(data_root=capture, split="test", cameras=(0, -1, 2))
    assert len(pte) == len(jte)
    jb, pb = jte.image_batch(1), pte.image_batch(1)
    for k in ("rays", "rgbs", "mask", "wbounds"):
        np.testing.assert_array_equal(pb[k], jb[k])
    assert pb["meta"] == jb["meta"]


def test_input_ratio_half_matches_jax(capture):
    jd = jls.Dataset(data_root=capture, split="train", input_ratio=0.5)
    pd = pls.Dataset(data_root=capture, split="train", input_ratio=0.5)
    np.testing.assert_array_equal(pd.rays, jd.rays)
    np.testing.assert_array_equal(pd.rgbs, jd.rgbs)


def test_band_and_hull_fill_are_bitwise_cv2():
    rng = np.random.default_rng(1)
    for trial in range(400):
        h, w = (int(v) for v in rng.integers(8, 48, 2))
        m = (rng.random((h, w)) < rng.random()).astype(np.uint8)
        k = np.ones((5, 5), np.uint8)
        e, d = cv2.erode(m.copy(), k), cv2.dilate(m.copy(), k)
        ref = m.copy()
        ref[(d - e) == 1] = 100
        np.testing.assert_array_equal(pls.erode_dilate_band(m, 5), ref)
        n = int(rng.integers(3, 9))
        span = 20 if trial % 3 == 0 else 0  # vertices off the image too
        pts = np.stack([rng.integers(-span, w + span, n),
                        rng.integers(-span, h + span, n)], -1).astype(np.int32)
        ref = np.zeros((h, w), np.uint8)
        cv2.fillConvexPoly(ref, cv2.convexHull(pts.reshape(-1, 1, 2)), 1)
        got = pls.fill_convex_poly(np.zeros((h, w), np.uint8),
                                   pls.convex_hull(pts), 1)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resizes_are_bitwise_cv2(dtype):
    from nerf_replication_tpu_torch.utils.image import (
        resize_area,
        resize_nearest,
    )

    rng = np.random.default_rng(2)
    for h, w, c in ((48, 48, 3), (47, 53, 3), (40, 36, 4)):
        img = (rng.integers(0, 256, (h, w, c)).astype(np.uint8)
               if dtype == np.uint8 else rng.random((h, w, c), np.float32))
        for r in (0.5, 1 / 3, 0.3, 0.7):
            W, H = int(np.rint(w * r)), int(np.rint(h * r))
            ref = cv2.resize(img, None, fx=r, fy=r,
                             interpolation=cv2.INTER_AREA)
            np.testing.assert_array_equal(
                resize_area(img, W, H, fx=r, fy=r), ref)
            np.testing.assert_array_equal(
                resize_area(img, W, H),
                cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA))
            np.testing.assert_array_equal(
                resize_nearest(img, W, H, fx=r, fy=r),
                cv2.resize(img, None, fx=r, fy=r,
                           interpolation=cv2.INTER_NEAREST))


def test_undistort_against_cv2():
    rng = np.random.default_rng(3)
    K = np.array([[50.0, 0, 24], [0, 52.0, 23], [0, 0, 1]])
    img = rng.random((48, 48, 3)).astype(np.float32)
    u8 = (img * 255).astype(np.uint8)
    for a in (img, u8, u8[..., 0]):
        out = pls.undistort(a, K, np.zeros((5, 1)))
        np.testing.assert_array_equal(out, a)
        np.testing.assert_array_equal(cv2.undistort(a, K, np.zeros((5, 1))),
                                      a)
    ys, xs = np.mgrid[0:48, 0:48]
    smooth = (np.stack([np.sin(xs / 7.0), np.cos(ys / 5.0),
                        np.sin((xs + ys) / 9.0)], -1) * 0.5 + 0.5)
    smooth = smooth.astype(np.float32)
    for D in ([0.1, -0.05, 0.001, -0.002, 0.01], [-0.2, 0.1, 0, 0, 0]):
        D = np.asarray(D)
        err = np.abs(pls.undistort(smooth, K, D)
                     - cv2.undistort(smooth, K, D)).max()
        assert err <= pls.UNDISTORT_TOL
        s8 = (smooth * 255).astype(np.uint8)
        err8 = np.abs(pls.undistort(s8, K, D).astype(int)
                      - cv2.undistort(s8, K, D)).max()
        assert err8 <= pls.UNDISTORT_TOL * 255


def test_other_formats_need_pillow(tmp_path, monkeypatch):
    import builtins

    from nerf_replication_tpu_torch.utils.image import read_image

    path = str(tmp_path / "x.jpg")
    open(path, "wb").close()
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="x.jpg.*Pillow"):
        read_image(path)


def test_latent_dataset_matches_jax(tmp_path):
    from nerf_replication_tpu.datasets.latent import Dataset as JLatent
    from nerf_replication_tpu_torch.datasets.latent import Dataset as PLatent

    data = np.random.default_rng(4).normal(size=(10, 200))
    np.save(tmp_path / "lat.npy", data)
    j, p = JLatent(str(tmp_path), "lat"), PLatent(str(tmp_path), "lat")
    for a, b in zip(p.ray_bank(), j.ray_bank()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p[0], j[0]):
        np.testing.assert_array_equal(a, b)
    assert len(p) == len(j) == 10


NET = ["network.nerf.W", "32", "network.nerf.D", "3",
       "network.nerf.skips", "[1]",
       "network.xyz_encoder.num_frames", str(N_FRAMES),
       "network.xyz_encoder.num_levels", "4",
       "network.xyz_encoder.log2_hashmap_size", "12",
       "network.xyz_encoder.base_resolution", "4",
       "network.xyz_encoder.desired_resolution", "32",
       "task_arg.N_samples", "8", "task_arg.N_importance", "8",
       "task_arg.perturb", "0", "task_arg.raw_noise_std", "0",
       # dynamic.yaml's eps 1e-15 turns a float32 rounding difference in a
       # near-zero table gradient into a ±lr step (JAX's dtable is a
       # difference of sorted prefix sums): the two runs part after one
       # step (measured 1.5e-2 on the loss); at 1e-8, 1.05e-5 at step 3;
       # at 1e-6 they stay within 3e-7 for six steps
       "train.eps", "1e-6"]


def test_three_steps_match_the_jax_trainer(capture):
    from flax.training.train_state import TrainState

    from nerf_replication_tpu.config import make_cfg as jax_make_cfg
    from nerf_replication_tpu.models import make_network as jax_make_network
    from nerf_replication_tpu.models.nerf.network import (
        init_params as jax_init_params,
    )
    from nerf_replication_tpu.train.loss import NeRFLoss as JaxLoss
    from nerf_replication_tpu.train.optim import make_optimizer as jax_opt
    from nerf_replication_tpu_torch.config import make_cfg
    from nerf_replication_tpu_torch.convert import params_from_jax
    from nerf_replication_tpu_torch.models import make_network
    from nerf_replication_tpu_torch.train.loss import NeRFLoss
    from nerf_replication_tpu_torch.train.optim import (
        apply_update,
        make_optimizer,
    )

    jcfg, pcfg = jax_make_cfg(DYNAMIC, NET), make_cfg(DYNAMIC, NET)
    jnet = jax_make_network(jcfg)
    params = jax_init_params(jnet, jax.random.PRNGKey(0))
    pnet = make_network(pcfg)
    pnet.load_state_dict(params_from_jax(jax_tree_numpy(params)), strict=True)
    rays, rgbs = pls.Dataset(data_root=capture, split="train").ray_bank()
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, len(rays), 64) for _ in range(3)]
    near, far = float(pcfg.task_arg.near), float(pcfg.task_arg.far)

    jloss = JaxLoss(jcfg, jnet)
    tx, _ = jax_opt(jcfg)
    state = TrainState.create(apply_fn=jnet.apply, params=params["params"],
                              tx=tx)

    @jax.jit
    def step(state, r, c):
        def lf(p):
            return jloss({"params": p}, {"rays": r, "rgbs": c, "near": near,
                                         "far": far}, key=None,
                         train=True)[1]

        loss, g = jax.value_and_grad(lf)(state.params)
        return loss, state.apply_gradients(grads=g)

    ploss = NeRFLoss(pcfg, pnet)
    opt, sched = make_optimizer(pcfg, pnet.parameters())
    for count, idx in enumerate(batches):
        jl, state = step(state, jnp.asarray(rays[idx]), jnp.asarray(rgbs[idx]))
        opt.zero_grad()
        _, pl, _ = ploss({"rays": torch.from_numpy(rays[idx]),
                          "rgbs": torch.from_numpy(rgbs[idx]),
                          "near": near, "far": far}, gen=None, train=True)
        pl.backward()
        apply_update(opt, sched, count)
        assert abs(float(pl.detach()) - float(jl)) <= 1e-5, count
