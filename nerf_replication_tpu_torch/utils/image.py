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
