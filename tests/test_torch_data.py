"""Port parity of the data path: the PNG codec, image metrics, the
procedural scene, the Blender dataset's ray bank and the on-device batch
draws.

* The port's PNG reader decodes the JAX package's imageio-written frames to
  the same pixels, and imageio decodes the port's PNGs to the same pixels
  (exact: PNG is lossless).
* The ray bank of a JAX-generated procedural scene is bitwise the JAX
  package's numpy bank builder's, and so is the precrop index pool.
* ``psnr``/``ssim`` equal the JAX package's (the same numpy code; rtol 1e-12).
* ``step_generator`` gives the same draws for the same (seed, step) and
  others for another step: the property a resumed run relies on.
"""

import io
import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from test_torch_helpers import LEGO

from nerf_replication_tpu.datasets.blender import Dataset as JaxDataset
from nerf_replication_tpu.datasets.procedural import (
    generate_scene as jax_generate_scene,
    render_view as jax_render_view,
)
from nerf_replication_tpu.utils import image as jax_image
from nerf_replication_tpu_torch.config import make_cfg
from nerf_replication_tpu_torch.datasets import make_camera, make_dataset
from nerf_replication_tpu_torch.datasets.blender import Dataset
from nerf_replication_tpu_torch.datasets.procedural import (
    ensure_scene,
    generate_scene,
    render_view,
)
from nerf_replication_tpu_torch.datasets.rays import pose_spherical
from nerf_replication_tpu_torch.datasets.sampling import (
    sample_rays,
    step_generator,
)
from nerf_replication_tpu_torch.utils import image as pimg


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_scene"))
    jax_generate_scene(root, "procedural", H=20, W=24, n_train=3, n_test=1)
    return root


@pytest.mark.parametrize("shape", [(7, 5), (9, 6, 3), (12, 11, 4)])
def test_png_roundtrip_against_imageio(shape, tmp_path):
    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    pimg.write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    buf = io.BytesIO()
    imageio.imwrite(buf, img, format="png")
    np.testing.assert_array_equal(pimg.decode_png(buf.getvalue()), img)
    assert pimg.png_size(path) == (shape[1], shape[0])


def test_png_reader_handles_every_row_filter():
    """PIL's adaptive filtering writes Sub/Up/Average/Paeth rows; the
    reader undoes each (a smooth image makes PIL pick them)."""
    from PIL import Image

    yy, xx = np.mgrid[0:40, 0:50]
    img = np.stack([(xx * 5) % 256, (yy * 3) % 256, (xx + yy) % 256,
                    255 - (xx * 2) % 256], -1).astype(np.uint8)
    seen = set()
    for mode, arr in (("RGBA", img), ("RGB", img[..., :3]),
                      ("L", img[..., 0])):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG", optimize=True)
        data = buf.getvalue()
        np.testing.assert_array_equal(pimg.decode_png(data), arr)
        idat = b"".join(b for k, b in pimg._read_chunks(data) if k == b"IDAT")
        import zlib

        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
        seen |= set(raw.reshape(40, -1)[:, 0].tolist())
    assert len(seen) >= 2


def test_png_reader_refuses_unsupported(tmp_path):
    img = np.zeros((4, 4, 2), np.uint8)  # gray + alpha
    buf = io.BytesIO()
    imageio.imwrite(buf, img, format="png")
    with pytest.raises(ValueError, match="unsupported"):
        pimg.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        pimg.decode_png(b"GIF89a" + bytes(40))


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (24, 20, 3))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    np.testing.assert_allclose(pimg.psnr(a, b), jax_image.psnr(a, b),
                               rtol=1e-12)
    np.testing.assert_allclose(pimg.ssim(a, b), jax_image.ssim(a, b),
                               rtol=1e-12)
    assert pimg.psnr(a, a) == float("inf")


def test_procedural_scene_matches_jax(jax_scene, tmp_path):
    """render_view is the JAX one; the port's scene files decode (with
    imageio) to the JAX scene's pixels and carry the same poses."""
    c2w = pose_spherical(30.0, -30.0, 4.0)
    np.testing.assert_array_equal(render_view(20, 24, 30.0, c2w),
                                  jax_render_view(20, 24, 30.0, c2w))
    root = str(tmp_path)
    generate_scene(root, "procedural", H=20, W=24, n_train=3, n_test=1)
    for split in ("train", "test"):
        with open(os.path.join(root, "procedural",
                               f"transforms_{split}.json")) as f:
            mine = json.load(f)
        with open(os.path.join(jax_scene, "procedural",
                               f"transforms_{split}.json")) as f:
            ref = json.load(f)
        assert mine == ref
        for frame in mine["frames"]:
            rel = frame["file_path"] + ".png"
            np.testing.assert_array_equal(
                imageio.imread(os.path.join(root, "procedural", rel)),
                imageio.imread(os.path.join(jax_scene, "procedural", rel)))


def test_ensure_scene_regenerates_a_stale_size(tmp_path):
    root = str(tmp_path)
    generate_scene(root, "procedural", H=8, W=8, n_train=2, n_test=1)
    ensure_scene(root, "procedural", H=12, W=10, n_train=2, n_test=1)
    assert pimg.png_size(os.path.join(root, "procedural", "train",
                                      "r_0.png")) == (10, 12)


def _cfg(root, extra=()):
    return make_cfg(LEGO, [
        "scene", "procedural", "train_dataset.data_root", root,
        "test_dataset.data_root", root, "train_dataset.H", "20",
        "train_dataset.W", "24", "test_dataset.H", "20", "test_dataset.W",
        "24", *extra])


def test_ray_bank_equals_jax_bitwise(jax_scene):
    """The port's Dataset on a JAX-written scene: the bank is bit for bit
    what the JAX package's numpy builder (``_build_ray_bank_numpy``) makes
    from the same frames and poses; poses, focal and the precrop pool equal
    the JAX Dataset's. The JAX Dataset itself uses its C++ builder where g++
    is present, which rounds ``R @ dir`` and the /255 differently from its
    own numpy builder: the banks then agree to 1e-7."""
    from nerf_replication_tpu.native import _build_ray_bank_numpy

    kw = dict(data_root=jax_scene, scene="procedural", split="train",
              cams=[0, -1, 1], H=20, W=24)
    ref = JaxDataset(**kw)
    mine = Dataset(**kw)
    frames = np.stack([imageio.imread(os.path.join(
        jax_scene, "procedural", "train", f"r_{k}.png")) for k in range(3)])
    rays, rgbs = _build_ray_bank_numpy(ref.poses, frames, ref.focal)
    for name, a, b in (("rays", mine.rays, rays), ("rgbs", mine.rgbs, rgbs),
                       ("poses", mine.poses, ref.poses)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(mine.rays, ref.rays, rtol=0, atol=1e-7)
    np.testing.assert_allclose(mine.rgbs, ref.rgbs, rtol=0, atol=1e-7)
    assert mine.focal == ref.focal and mine.n_images == ref.n_images == 3
    np.testing.assert_array_equal(mine.precrop_index_pool(0.5),
                                  ref.precrop_index_pool(0.5))
    b0, r0 = mine.image_batch(1), ref.image_batch(1)
    np.testing.assert_array_equal(b0["rays"], mine.rays[480:960])
    assert b0["meta"] == r0["meta"] and b0["near"] == r0["near"]


def test_dataset_factory_camera_and_checks(jax_scene):
    ds = make_dataset(_cfg(jax_scene), "test")
    assert len(ds) == 1 and ds.rays.shape == (20 * 24, 6)
    cam = make_camera(_cfg(jax_scene), "test")
    assert (cam.H, cam.W, cam.focal) == (20, 24, ds.focal)
    with pytest.raises(ValueError, match="config expects"):
        Dataset(jax_scene, "procedural", H=21, W=24)
    # input_ratio resizes each uint8 frame with INTER_AREA, as JAX does
    half = Dataset(jax_scene, "procedural", H=20, W=24, input_ratio=0.5)
    ref = JaxDataset(jax_scene, "procedural", H=20, W=24, input_ratio=0.5)
    assert (half.H, half.W, half.focal) == (ref.H, ref.W, ref.focal)
    np.testing.assert_allclose(half.rays, ref.rays, rtol=0, atol=1e-7)
    np.testing.assert_allclose(half.rgbs, ref.rgbs, rtol=0, atol=1e-7)


def test_step_generator_draws_are_resumable():
    rays = torch.arange(600, dtype=torch.float32).reshape(100, 6)
    rgbs = torch.arange(300, dtype=torch.float32).reshape(100, 3)
    a = sample_rays(step_generator(0, 7, "cpu"), rays, rgbs, 16)
    b = sample_rays(step_generator(0, 7, "cpu"), rays, rgbs, 16)
    c = sample_rays(step_generator(0, 8, "cpu"), rays, rgbs, 16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    pool = torch.tensor([3, 5, 9])
    r, _ = sample_rays(step_generator(1, 0, "cpu"), rays, rgbs, 32, pool)
    assert set((r[:, 0] / 6).long().tolist()) <= {3, 5, 9}
