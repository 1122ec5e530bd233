"""Make the JPEG fixtures under ``tests/data/jpeg/`` (a record of how they
were made; the tests read the committed files and never run this).

It needs Pillow, which the port's own machine lacks, so it is run once on
a machine that has it:

    python -m nerf_replication_tpu_torch.tools.jpeg_fixtures \
        [--out tests/data/jpeg]

* Small seeded images (smooth gradients, a disc, a hard edge, noise) at
  sizes that are not multiples of the MCU, saved by Pillow at 4:4:4,
  4:2:2 and 4:2:0, qualities 50 and 95, grayscale, with a restart
  interval; a progressive file; and an "arithmetic" file, a baseline one
  whose SOF0 marker is rewritten to SOF9 (Pillow writes no arithmetic
  coding: the decoder must refuse the marker before reading any data).
  ``pillow.npz`` holds Pillow's decode of each (key: the file's stem).
* ``capture/``: a 64x64 procedural scene (``datasets.procedural``) of 16
  frames, re-encoded 4:2:0 at quality 95, with one real-capture
  ``transforms.json`` naming the ``.jpg`` frames and Pillow's decodes in
  ``capture/pillow.npz``.
* ``frame800.jpg``: one 800x800 view of the procedural scene, 4:2:0 at
  quality 95 (the decode a frame is timed on); ``frame800.json`` holds the
  SHA-256 of Pillow's decode instead of the decode itself.

``--textured DIR`` writes instead three photo-like 800x800 frames whose
coded bits a real photo's match (145-540 KB; :func:`make_textured`), for
``tools/time_jpeg.py`` to time; they stay out of the fixtures' 200 KB.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import shutil
import tempfile

import numpy as np


def _image(seed: int, h: int, w: int, gray: bool = False) -> np.ndarray:
    """A seeded test picture: gradients, a disc, an edge and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 127 + 100 * np.sin(x / 7.0) * np.cos(y / 5.0)
    g = 255 * x / max(w - 1, 1)
    b = 255 * ((x - w / 2) ** 2 + (y - h / 2) ** 2 < (min(h, w) / 3) ** 2)
    img = np.stack([r, g, b], -1)
    img[:, w // 2:] = 255 - img[:, w // 2:]
    img += rng.normal(0, 2, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 1] if gray else img


# name -> (seed, height, width, gray, Pillow save options)
CASES = {
    "rgb444_q95": (1, 45, 61, False, {"quality": 95, "subsampling": 0}),
    "rgb444_q50": (2, 32, 40, False, {"quality": 50, "subsampling": 0}),
    "rgb422_q95": (3, 37, 53, False, {"quality": 95, "subsampling": 1}),
    "rgb422_q50": (4, 24, 33, False, {"quality": 50, "subsampling": 1}),
    "rgb420_q95": (5, 43, 57, False, {"quality": 95, "subsampling": 2}),
    "rgb420_q50": (6, 64, 48, False, {"quality": 50, "subsampling": 2}),
    "gray_q95": (7, 41, 59, True, {"quality": 95}),
    "gray_q50": (8, 16, 24, True, {"quality": 50}),
    "rgb420_restart": (9, 50, 70, False, {"quality": 90, "subsampling": 2,
                                          "restart_marker_blocks": 3}),
    "gray_restart": (10, 33, 47, True, {"quality": 80,
                                        "restart_marker_rows": 1}),
    "progressive": (11, 32, 32, False, {"quality": 90,
                                        "progressive": True}),
}


def _save(img: np.ndarray, **opts) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **opts)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def make_images(out: str) -> None:
    """The single images and their Pillow decodes."""
    os.makedirs(out, exist_ok=True)
    ref = {}
    for name, (seed, h, w, gray, opts) in CASES.items():
        data = _save(_image(seed, h, w, gray), **opts)
        with open(os.path.join(out, f"{name}.jpg"), "wb") as f:
            f.write(data)
        ref[name] = _pillow(data)
    data = bytearray(_save(_image(12, 16, 16), quality=90))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9  # SOF9: arithmetic-coded sequential
    with open(os.path.join(out, "arithmetic.jpg"), "wb") as f:
        f.write(bytes(data))
    np.savez_compressed(os.path.join(out, "pillow.npz"), **ref)


def make_capture(out: str, n_frames: int = 16, size: int = 64) -> None:
    """A JPEG real capture of a procedural scene, with its
    ``transforms.json`` and Pillow's decodes."""
    from PIL import Image

    from ..datasets.procedural import generate_scene, write_real_capture

    cap = os.path.join(out, "capture")
    with tempfile.TemporaryDirectory() as tmp:
        scene = generate_scene(tmp, H=size, W=size, n_train=n_frames - 4,
                               n_test=4)
        path = write_real_capture(scene)
        with open(path) as f:
            meta = json.load(f)
        if os.path.isdir(cap):
            shutil.rmtree(cap)
        os.makedirs(os.path.join(cap, "images"))
        ref = {}
        for i, fr in enumerate(meta["frames"]):
            with Image.open(os.path.join(scene, fr["file_path"])) as im:
                rgb = np.asarray(im.convert("RGB"))
            data = _save(rgb, quality=95, subsampling=2)
            rel = f"images/frame_{i:03d}.jpg"
            with open(os.path.join(cap, rel), "wb") as f:
                f.write(data)
            fr["file_path"] = rel
            ref[f"frame_{i:03d}"] = _pillow(data)
    with open(os.path.join(cap, "transforms.json"), "w") as f:
        json.dump(meta, f, indent=1)
    np.savez_compressed(os.path.join(cap, "pillow.npz"), **ref)


def make_frame800(out: str) -> None:
    """The 800x800 4:2:0 frame and the digest of Pillow's decode."""
    from PIL import Image

    from ..datasets.procedural import generate_scene

    with tempfile.TemporaryDirectory() as tmp:
        scene = generate_scene(tmp, H=800, W=800, n_train=1, n_test=1)
        with open(os.path.join(scene, "transforms_train.json")) as f:
            rel = json.load(f)["frames"][0]["file_path"]
        with Image.open(os.path.join(scene, rel + ".png")) as im:
            rgb = np.asarray(im.convert("RGB"))
    data = _save(rgb, quality=95, subsampling=2)
    with open(os.path.join(out, "frame800.jpg"), "wb") as f:
        f.write(data)
    ref = np.ascontiguousarray(_pillow(data))
    with open(os.path.join(out, "frame800.json"), "w") as f:
        json.dump({"shape": list(ref.shape),
                   "sha256": hashlib.sha256(ref.tobytes()).hexdigest()}, f)


# textured frame -> amplitude of its finest noise octave (levels)
TEXTURED = {"smooth": 0, "textured": 40, "busy": 120}


def make_textured(out: str, seed: int = 0) -> None:
    """Photo-like 800x800 frames, 4:2:0 at quality 95: four octaves of
    seeded noise (8² to 400² cells, bicubic), the finest at each of
    :data:`TEXTURED`'s amplitudes, so the scans hold ~145-540 KB of coded
    bits (the procedural ``frame800.jpg`` holds 31 KB); ``textured.json``
    the digests of Pillow's decodes. Too large for the committed fixtures:
    written where ``tools/time_jpeg.py`` times them."""
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    digests = {}
    for name, fine in TEXTURED.items():
        img = np.full((800, 800, 3), 128.0)
        for cells, amp in ((8, 60), (32, 40), (100, 30), (400, fine)):
            n = rng.normal(0, 1, (cells, cells, 3))
            n = ((n - n.min()) / (n.max() - n.min()) * 255).astype(np.uint8)
            up = np.asarray(Image.fromarray(n).resize((800, 800),
                                                      Image.BICUBIC), float)
            img += amp * (up - 127) / 64
        data = _save(np.clip(img, 0, 255).astype(np.uint8), quality=95,
                     subsampling=2)
        with open(os.path.join(out, f"{name}.jpg"), "wb") as f:
            f.write(data)
        ref = np.ascontiguousarray(_pillow(data))
        digests[name] = hashlib.sha256(ref.tobytes()).hexdigest()
    with open(os.path.join(out, "textured.json"), "w") as f:
        json.dump(digests, f, indent=1)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join("tests", "data", "jpeg"))
    p.add_argument("--textured", default=None, metavar="DIR",
                   help="write only the textured 800x800 timing frames "
                        "into DIR (not fixtures: keep DIR git-ignored)")
    args = p.parse_args(argv)
    if args.textured:
        make_textured(args.textured)
        return
    make_images(args.out)
    make_capture(args.out)
    make_frame800(args.out)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(args.out) for f in fs)
    print(f"wrote {args.out}: {total} bytes")


if __name__ == "__main__":
    main()
