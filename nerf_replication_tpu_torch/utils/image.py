"""Image metrics and PNG I/O (port of ``nerf_replication_tpu/utils/image.py``).

``psnr`` and ``ssim`` (Wang et al.: gaussian 11×11 window, sigma 1.5,
K1 = 0.01, K2 = 0.03, ``data_range`` 1) are the JAX package's, in numpy.

The JAX package reads and writes PNGs through imageio/PIL; the machine the
port runs on has neither, so this module carries a small PNG codec on the
standard library's ``zlib`` and numpy: 8-bit grayscale, RGB and RGBA,
non-interlaced, all five row filters on read (filter 0 on write). Anything
else (palettes, 16-bit, gray+alpha, interlacing) raises ``ValueError``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """-10·log10(mse) on float images in [0, 1]."""
    mse = float(np.mean((pred.astype(np.float64) - gt.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(-10.0 * np.log10(mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' gaussian filtering over the two leading axes."""
    from numpy.lib.stride_tricks import sliding_window_view

    w = k.size
    out = sliding_window_view(img, w, axis=0) @ k
    out = sliding_window_view(out, w, axis=1) @ k
    return out


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM; channels averaged. Inputs [H, W] or [H, W, C] floats."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        mu_x = _filter2d_sep(x, k)
        mu_y = _filter2d_sep(y, k)
        xx = _filter2d_sep(x * x, k) - mu_x**2
        yy = _filter2d_sep(y * y, k) - mu_y**2
        xy = _filter2d_sep(x * y, k) - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (xx + yy + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


# -- PNG codec -------------------------------------------------------------------

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) → PNG
    bytes (filter 0 on every row)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4):
        raise ValueError(f"encode_png takes [H, W(, 1|3|4)], got {img.shape}")
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _read_chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without IEND")


def _header(data: bytes) -> tuple[int, int, int]:
    """(width, height, channels) of a supported PNG, else ValueError."""
    kind, body = next(_read_chunks(data))
    if kind != b"IHDR" or len(body) != 13:
        raise ValueError("PNG does not start with IHDR")
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                         f"{color} (8-bit gray, RGB or RGBA only)")
    if comp != 0 or filt != 0 or interlace != 0:
        raise ValueError("unsupported PNG: interlaced or unknown method")
    return w, h, _CHANNELS[color]


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (types 0-4) → uint8 [h, stride]."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = np.empty(stride, np.int64)
            left = np.zeros(bpp, np.int64)
            up_left = np.zeros(bpp, np.int64)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    pred = _paeth(left, up, up_left)
                left = (line[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"unsupported PNG row filter {ftype}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 [H, W] (gray), [H, W, 3] or [H, W, 4]."""
    w, h, c = _header(data)
    idat = b"".join(body for kind, body in _read_chunks(data)
                    if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size != h * (w * c + 1):
        raise ValueError("PNG image data has the wrong size")
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_image(path: str) -> np.ndarray:
    """uint8 ``[H, W]`` or ``[H, W, C]`` pixels of an image file: PNG by the
    port's codec, anything else by Pillow when it is importable."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: no decoder for this format (the port decodes PNG; "
            "other formats need Pillow, which is not installed)") from None
    with Image.open(path) as im:
        return np.asarray(im)


def png_size(path: str) -> tuple[int, int]:
    """(width, height) from the header alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    w, h, _ = _header(head)
    return w, h


def write_png(path: str, img: np.ndarray):
    """Write a float [0,1] or uint8 image as PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(img))


# -- resizing (OpenCV's INTER_AREA and INTER_NEAREST) ----------------------------


def _area_tab(ssize: int, dsize: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: per destination index, the
    source indices and float32 weights of its cell, in OpenCV's order
    (``[dsize, slots]``, zero-weight padding)."""
    rows = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s1, s2 = int(np.ceil(fs1)), int(np.floor(fs2))
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, (s1 - fs1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            taps.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    slots = max(len(t) for t in rows)
    idx = np.zeros((dsize, slots), np.int64)
    w = np.zeros((dsize, slots), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], w[d, j] = s, np.float32(a)
    return idx, w


def _saturate(x: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.uint8:
        # cvRound: round half to even, then clamp
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return x.astype(dtype)


def _inv_scales(w, h, W, H, fx, fy):
    """OpenCV's source pixels per destination pixel: ``1 / fx`` when a
    factor is given, else ``1 / (W / w)``."""
    return (1.0 / (fx if fx else W / w)), (1.0 / (fy if fy else H / h))


def resize_area(img: np.ndarray, W: int, H: int, fx: float | None = None,
                fy: float | None = None) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)`` for a
    downscale (or the same size) of a uint8 or float32 image ``[h, w]`` or
    ``[h, w, c]``, in OpenCV's arithmetic: an integer ratio averages each
    block (``resizeAreaFast``: the block's sum in source order, times the
    float32 reciprocal of its area; uint8 sums in integers and rounds), any
    other ratio weights each source pixel by its overlap with the
    destination cell (``resizeArea``: float32 products and sums, row by row
    in OpenCV's order). ``fx``/``fy``: the factors of a ``cv2.resize(img,
    None, fx=..., fy=...)`` call, which set OpenCV's ratio (``W``/``H`` are
    then ``round(w·fx)``/``round(h·fy)``). An upscale raises ``ValueError``
    (OpenCV then interpolates bilinearly)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize_area takes uint8 or float32, got {img.dtype}")
    h, w = img.shape[:2]
    if (H, W) == (h, w):
        return img.copy()
    sx, sy = _inv_scales(w, h, W, H, fx, fy)
    if sx < 1 or sy < 1:
        raise ValueError(f"resize_area downscales only: {w}x{h} -> {W}x{H}")
    gray = img.ndim == 2
    src = img[..., None] if gray else img
    ix, iy = int(round(sx)), int(round(sy))
    if abs(sx - ix) < np.finfo(np.float64).eps and \
            abs(sy - iy) < np.finfo(np.float64).eps:
        out = _area_fast(src, W, H, ix, iy)
    else:
        out = _area_general(src, W, H, sx, sy)
    return out[..., 0] if gray else out


def _area_fast(src, W, H, ix, iy):
    """``resizeAreaFast``: block sums of ``iy x ix`` pixels (rows, then
    columns within a row, in groups of four as OpenCV adds them). A block
    cut by the image's right or bottom edge is the mean of its pixels
    inside (summed in order, divided by their count)."""
    h, w = src.shape[:2]
    h1, w1 = min(H, h // iy), min(W, w // ix)
    out = np.zeros((H, W, src.shape[2]), src.dtype)
    blk = src[:h1 * iy, :w1 * ix].reshape(h1, iy, w1, ix, -1)
    taps = [blk[:, r, :, c] for r in range(iy) for c in range(ix)]
    if src.dtype == np.uint8:
        total = sum(t.astype(np.int64) for t in taps)
        if ix == 2 and iy == 2:
            out[:h1, :w1] = ((total + 2) >> 2).astype(np.uint8)
        else:
            out[:h1, :w1] = _saturate(total.astype(np.float32)
                                      * np.float32(1.0 / (ix * iy)),
                                      np.uint8)
    elif ix == 2 and iy == 2 and src.shape[2] in (1, 4):
        # the vector path of 1- and 4-channel images adds by rows
        out[:h1, :w1] = ((taps[0] + taps[1]) + (taps[2] + taps[3])) \
            * np.float32(0.25)
    else:
        total = np.zeros(taps[0].shape, np.float32)
        k = 0
        while k + 4 <= len(taps):
            total = total + (((taps[k] + taps[k + 1]) + taps[k + 2])
                             + taps[k + 3])
            k += 4
        for t in taps[k:]:
            total = total + t
        out[:h1, :w1] = total * np.float32(1.0 / (ix * iy))
    acc = np.int64 if src.dtype == np.uint8 else np.float32
    for dy in range(H):
        for dx in range(W):
            if dy < h1 and dx < w1:
                continue
            sy0, sx0 = dy * iy, dx * ix
            if sy0 >= h or sx0 >= w:
                continue  # zero
            cell = src[sy0:sy0 + iy, sx0:sx0 + ix].reshape(-1, src.shape[2])
            total = np.zeros(src.shape[2], acc)
            for row in cell:
                total = total + row.astype(acc)
            mean = total.astype(np.float32) / np.float32(len(cell))
            out[dy, dx] = _saturate(mean, src.dtype)
    return out


def _area_general(src, W, H, sx, sy):
    """``resizeArea``: each source row's weighted taps summed into a
    float32 row buffer, the buffers of a destination row summed with their
    float32 row weights."""
    xi, xw = _area_tab(src.shape[1], W, sx)
    yi, yw = _area_tab(src.shape[0], H, sy)
    f = src.astype(np.float32)
    buf = np.zeros((src.shape[0], W, src.shape[2]), np.float32)
    for j in range(xi.shape[1]):
        buf = buf + f[:, xi[:, j]] * xw[None, :, j, None]
    acc = np.zeros((H, W, src.shape[2]), np.float32)
    for j in range(yi.shape[1]):
        acc = acc + buf[yi[:, j]] * yw[:, j, None, None]
    return _saturate(acc, src.dtype)


def resize_nearest(img: np.ndarray, W: int, H: int, fx: float | None = None,
                   fy: float | None = None) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)``: the
    source pixel ``floor(d · ratio)`` (float64), clipped to the edge
    (``fx``/``fy`` as for :func:`resize_area`)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    sx, sy = _inv_scales(w, h, W, H, fx, fy)
    xs = np.minimum(np.floor(np.arange(W) * sx).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(H) * sy).astype(np.int64), h - 1)
    return img[ys[:, None], xs[None, :]]
