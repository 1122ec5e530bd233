"""The port's baseline JPEG decoder (``utils/image.decode_jpeg``) against
Pillow's decodes of the committed fixtures (``tests/data/jpeg/``, made by
``nerf_replication_tpu_torch/tools/jpeg_fixtures.py``).

* Gates: bitwise on 4:4:4 and grayscale; elsewhere at most one level off
  with at least 99% of the samples exact (the decoder follows libjpeg's
  ISLOW IDCT, fancy upsampling and color tables, so these are bitwise
  too today).
* Progressive, arithmetic-coded, lossless and 12-bit files are refused
  with their SOF marker named.
* ``read_image`` picks PNG or JPEG by the magic bytes, not the name.
* The native Huffman decoder (``native/jpeg_scan.cpp``) gives the plain
  Python decoder's pixels.
* The decode imports neither Pillow nor OpenCV.
* The committed JPEG real capture loads through ``datasets/real.py`` to
  the arrays JAX's Pillow path gives.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from test_torch_helpers import ROOT

from nerf_replication_tpu_torch.utils.image import (
    decode_jpeg,
    jpeg_size,
    png_size,
    read_image,
    write_png,
)

DATA = os.path.join(ROOT, "tests", "data", "jpeg")
PILLOW = np.load(os.path.join(DATA, "pillow.npz"))
DECODED = [k for k in PILLOW.files if k != "progressive"]


def _gate(ours: np.ndarray, ref: np.ndarray, exact: bool, what: str):
    assert ours.shape == ref.shape and ours.dtype == np.uint8, what
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    if exact:
        np.testing.assert_array_equal(ours, ref, err_msg=what)
    else:
        assert diff.max() <= 1, (what, int(diff.max()))
        assert (diff == 0).mean() >= 0.99, (what, float((diff == 0).mean()))


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", DECODED)
def test_decoder_matches_pillow(name):
    ours = read_image(os.path.join(DATA, f"{name}.jpg"))
    exact = name.startswith(("rgb444", "gray"))
    _gate(ours, PILLOW[name], exact, name)
    assert jpeg_size(os.path.join(DATA, f"{name}.jpg")) == (
        ours.shape[1], ours.shape[0])


def test_refusals_name_the_marker():
    """Progressive (Pillow's) and arithmetic-coded files, and baseline
    files rewritten to lossless (SOF3) and to 12-bit samples, raise
    before any data is read, naming the marker."""
    cases = {"progressive.jpg": "SOF2 (0xFFC2, progressive)",
             "arithmetic.jpg": "SOF9 (0xFFC9, arithmetic-coded sequential)"}
    for name, label in cases.items():
        with pytest.raises(ValueError) as exc:
            read_image(os.path.join(DATA, name))
        assert label in str(exc.value) and name in str(exc.value)
    data = bytearray(_read("gray_q50.jpg"))
    sof = data.index(b"\xff\xc0")
    lossless = bytearray(data)
    lossless[sof + 1] = 0xC3
    with pytest.raises(ValueError, match=r"SOF3 \(0xFFC3, lossless\)"):
        decode_jpeg(bytes(lossless))
    deep = bytearray(data)
    deep[sof + 1] = 0xC1
    deep[sof + 4] = 12  # the precision byte
    with pytest.raises(ValueError, match="SOF1 .* 12-bit samples"):
        decode_jpeg(bytes(deep))


def test_read_image_dispatches_on_magic_bytes(tmp_path):
    """A JPEG named ``.png`` decodes as JPEG and a PNG named ``.jpg`` as
    PNG: the magic bytes decide."""
    jpeg_as_png = tmp_path / "frame.png"
    shutil.copy(os.path.join(DATA, "rgb420_q95.jpg"), jpeg_as_png)
    np.testing.assert_array_equal(read_image(str(jpeg_as_png)),
                                  PILLOW["rgb420_q95"])
    png_as_jpg = str(tmp_path / "frame.jpg")
    img = PILLOW["rgb444_q50"]
    write_png(png_as_jpg, img)
    np.testing.assert_array_equal(read_image(png_as_jpg), img)
    assert png_size(png_as_jpg) == (img.shape[1], img.shape[0])
    other = tmp_path / "frame.bmp"
    other.write_bytes(b"BM" + bytes(64))
    with pytest.raises(Exception):
        read_image(str(other))


def test_decode_imports_neither_pillow_nor_cv2():
    """Every fixture and the capture decode in a fresh interpreter that
    has not loaded PIL or cv2 afterwards."""
    code = (
        "import glob, os, sys\n"
        "from nerf_replication_tpu_torch.utils.image import read_image, "
        "read_gray\n"
        f"root = {DATA!r}\n"
        "names = [p for p in glob.glob(os.path.join(root, '*.jpg'))"
        " + glob.glob(os.path.join(root, 'capture', 'images', '*.jpg'))"
        " if not p.endswith(('progressive.jpg', 'arithmetic.jpg'))]\n"
        "for p in names:\n"
        "    read_image(p); read_gray(p)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('PIL', 'cv2')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(DECODED) + 16 + 1


def test_800px_frame_matches_pillow_digest():
    """The 800x800 4:2:0 frame (the one the card's host times) decodes to
    the SHA-256 of Pillow's decode."""
    import hashlib
    import json

    with open(os.path.join(DATA, "frame800.json")) as f:
        ref = json.load(f)
    ours = np.ascontiguousarray(read_image(os.path.join(DATA,
                                                        "frame800.jpg")))
    assert list(ours.shape) == ref["shape"] == [800, 800, 3]
    assert hashlib.sha256(ours.tobytes()).hexdigest() == ref["sha256"]


def test_native_scan_decoder_matches_the_plain_python_one():
    """``native/jpeg_scan.cpp`` (g++ is here) gives every fixture, the
    capture's frames and the 800x800 frame the pixels of the plain Python
    scan decoder, colour and luma; both refuse a cut-off scan alike."""
    import glob

    from nerf_replication_tpu_torch.native import native_available

    assert native_available("jpeg_scan")
    paths = [p for p in glob.glob(os.path.join(DATA, "*.jpg"))
             + glob.glob(os.path.join(DATA, "capture", "images", "*.jpg"))
             if not p.endswith(("progressive.jpg", "arithmetic.jpg"))]
    assert len(paths) == len(DECODED) + 16 + 1
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        for gray in (False, True):
            np.testing.assert_array_equal(
                decode_jpeg(data, path, gray), decode_jpeg(
                    data, path, gray, native=False), err_msg=path)
    data = _read("frame800.jpg")
    cut = data[:len(data) // 2] + b"\xff\xd9"
    for native in (True, False):
        with pytest.raises(ValueError, match="cut: JPEG entropy-coded "
                                             "data ends early"):
            decode_jpeg(cut, "cut", native=native)


def test_jpeg_capture_loads_like_jax():
    """The committed 16-frame JPEG capture (4:2:0, quality 95) through the
    port's ``datasets/real.py`` and JAX's (imageio → Pillow): the same
    rays, poses and sizes, colours within the decoder's gates."""
    from nerf_replication_tpu.datasets.real import Dataset as JaxDataset
    from nerf_replication_tpu_torch.datasets.real import Dataset

    ref = np.load(os.path.join(DATA, "capture", "pillow.npz"))
    assert len(ref.files) == 16
    for k in ref.files:
        _gate(read_image(os.path.join(DATA, "capture", "images",
                                      f"{k}.jpg")), ref[k], False, k)
    root, scene = os.path.split(DATA)
    for split in ("train", "test"):
        kw = dict(data_root=root, scene=scene + "/capture", split=split,
                  test_hold=4)
        j, p = JaxDataset(**kw), Dataset(**kw)
        for name in ("rays", "poses"):
            np.testing.assert_array_equal(getattr(p, name), getattr(j, name))
        assert (p.H, p.W, p.focal, p.n_images) == (j.H, j.W, j.focal,
                                                   j.n_images)
        levels = np.rint(np.asarray(p.rgbs) * 255) - np.rint(
            np.asarray(j.rgbs) * 255)
        assert np.abs(levels).max() <= 1
        assert (levels == 0).mean() >= 0.99
