"""Image metrics, PNG I/O and a baseline JPEG decoder (port of
``nerf_replication_tpu/utils/image.py``).

``psnr`` and ``ssim`` (Wang et al.: gaussian 11×11 window, sigma 1.5,
K1 = 0.01, K2 = 0.03, ``data_range`` 1) are the JAX package's, in numpy.

The JAX package reads and writes images through imageio/PIL; the machine
the port runs on has neither, so this module carries its own codecs on the
standard library and numpy:

* PNG: 8-bit grayscale, RGB and RGBA, non-interlaced, all five row filters
  on read (filter 0 on write). Anything else (palettes, 16-bit,
  gray+alpha, interlacing) raises ``ValueError``.
* JPEG, decode only (:func:`decode_jpeg`): baseline sequential DCT (SOF0,
  and SOF1 with 8-bit samples), Huffman-coded; grayscale or YCbCr (RGB
  when an Adobe marker or the component ids say so); 4:4:4, 4:2:2 and
  4:2:0 sampling; restart intervals; any size. It follows libjpeg(-turbo)'s
  defaults, as Pillow decodes: the accurate integer IDCT (``JDCT_ISLOW``),
  "fancy" triangular upsampling of h2v1 / h2v2 chroma and the fixed-point
  YCbCr→RGB tables. Progressive, lossless, hierarchical, arithmetic-coded
  and 12-bit files raise ``ValueError`` naming their SOF marker.

:func:`read_image` picks the decoder by the file's magic bytes; any other
format goes to Pillow when it is importable.
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


_JPEG_MAGIC = b"\xff\xd8\xff"


def read_image(path: str) -> np.ndarray:
    """uint8 ``[H, W]`` or ``[H, W, C]`` pixels of an image file, as Pillow
    reads it: PNG and JPEG by the port's codecs (chosen by the file's
    magic bytes, not its extension), anything else by Pillow when it is
    importable."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_SIGNATURE):
        return decode_png(data)
    if data.startswith(_JPEG_MAGIC):
        return decode_jpeg(data, name=path)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: no decoder for this format (the port decodes PNG and "
            "baseline JPEG; other formats need Pillow, which is not "
            "installed)") from None
    with Image.open(path) as im:
        return np.asarray(im)


def read_gray(path: str) -> np.ndarray:
    """uint8 ``[H, W]`` grayscale of an image file: a YCbCr JPEG's luma
    plane (libjpeg's grayscale output), else the BT.601 luma of its RGB
    (libjpeg's fixed point: ``(19595 R + 38470 G + 7471 B + 2^15) >>
    16``). Raises ``OSError`` for a file that cannot be read."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_JPEG_MAGIC):
        return decode_jpeg(data, name=path, gray=True)
    img = read_image(path)
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.int64)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
             + 32768) >> 16).astype(np.uint8)


def png_size(path: str) -> tuple[int, int]:
    """(width, height) from the header alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    w, h, _ = _header(head)
    return w, h


def jpeg_size(path: str) -> tuple[int, int]:
    """(width, height) of a JPEG from its frame header alone."""
    with open(path, "rb") as f:
        data = f.read()
    for marker, payload, _ in _jpeg_segments(data, path):
        if _is_sof(marker):
            height, width, _ = _sof(marker, payload, path)
            return width, height
    raise ValueError(f"{path}: JPEG without a frame header")


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


# -- baseline JPEG decoder (libjpeg's ISLOW IDCT, fancy upsampling) -------------

# natural-order index of each zigzag position
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

_SOF_NAMES = {
    0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive",
    0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded "
    "progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless",
}


def _sof_label(marker: int) -> str:
    return (f"SOF{marker - 0xC0} (0xFF{marker:02X}, "
            f"{_SOF_NAMES.get(marker, 'unknown')})")


def _jpeg_segments(data: bytes, name: str):
    """Yield ``(marker, payload, end)`` for the header segments up to and
    including each SOS (``end``: the offset after the payload, where
    entropy-coded data starts)."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError(f"{name}: not a JPEG (no SOI marker)")
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: bad JPEG marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            break
        length = (data[pos] << 8) | data[pos + 1]
        payload = data[pos + 2:pos + length]
        pos += length
        yield marker, payload, pos
        if marker == 0xDA:
            pos = _skip_entropy(data, pos)
    raise ValueError(f"{name}: truncated JPEG (no EOI)")


def _skip_entropy(data: bytes, pos: int) -> int:
    """The offset of the first marker after entropy-coded data at
    ``pos`` (stuffed 0xFF00 and RSTn belong to the data)."""
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= len(data):
            return len(data)
        m = data[j + 1]
        if m == 0 or 0xD0 <= m <= 0xD7 or m == 0xFF:
            pos = j + 1 if m == 0xFF else j + 2
            continue
        return j


def _is_sof(marker: int) -> bool:
    return 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC)


def _sof(marker: int, p: bytes, name: str):
    """``(height, width, [(id, h, v, tq)])`` of a frame header the decoder
    reads; raises naming the marker for any other."""
    if marker not in (0xC0, 0xC1):
        raise ValueError(
            f"{name}: JPEG {_sof_label(marker)} is not read by the port's "
            "decoder (baseline / extended sequential Huffman, 8-bit)")
    if p[0] != 8:
        raise ValueError(
            f"{name}: JPEG {_sof_label(marker)} with {p[0]}-bit "
            "samples is not read by the port's decoder (8-bit only)")
    height = (p[1] << 8) | p[2]
    width = (p[3] << 8) | p[4]
    if height == 0 or width == 0:
        raise ValueError(f"{name}: JPEG with a zero size (a DNL marker) "
                         "is not read")
    return height, width, [(p[6 + 3 * i], p[7 + 3 * i] >> 4,
                            p[7 + 3 * i] & 15, p[8 + 3 * i])
                           for i in range(p[5])]


def _huffman_lut(counts, symbols) -> np.ndarray:
    """16-bit lookahead table (uint16 [65536]): entry ``(length << 8) |
    symbol`` for every 16-bit window starting with a code (0: no code)."""
    lut = np.zeros(65536, np.uint16)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            shift = 16 - length
            lut[code << shift:(code + 1) << shift] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut


def _entropy_data(data: bytes, pos: int):
    """Unstuffed entropy-coded bytes from ``pos``, split at RSTn markers:
    ``(segments, end)``."""
    segs = []
    cur = bytearray()
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= len(data):
            raise ValueError("truncated JPEG entropy-coded data")
        cur += data[pos:j]
        m = data[j + 1]
        if m == 0:
            cur.append(0xFF)
            pos = j + 2
        elif m == 0xFF:
            pos = j + 1
        elif 0xD0 <= m <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            pos = j + 2
        else:
            segs.append(bytes(cur))
            return segs, j


def _decode_scan(segs, comps, per_seg, mcus_x, mcus_y, name):
    """Huffman-decode one baseline scan into its components' coefficient
    planes, in Python: the plain version of ``native/jpeg_scan.cpp``.
    ``comps``: per scan component ``(dc_lut, ac_lut, h, v, bw, coef)``
    (uint16 tables; ``bw``: the component's stored blocks a row; ``h`` x
    ``v``: its blocks an MCU, 1 x 1 in a one-component scan; ``coef``: its
    int32 ``[blocks * 64]`` plane, natural order, written in place)."""
    zz = _ZIGZAG.tolist()
    n_mcus = mcus_x * mcus_y
    lists = [(c[0].tolist(), c[1].tolist(), *c[2:5], [], [])
             for c in comps]
    mcu = 0
    for seg in segs:
        # zeros past the end, as the native decoder reads them: one block
        # reads at most 64 codes of 31 bits past the check below
        d = seg + bytes(260)
        nbits = len(seg) * 8
        pos = 0
        preds = [0] * len(comps)
        for _ in range(min(per_seg, n_mcus - mcu)):
            my, mx = divmod(mcu, mcus_x)
            mcu += 1
            for ci, (dc_lut, ac_lut, h, v, bw, idx, val) in \
                    enumerate(lists):
                for by in range(v):
                    for bx in range(h):
                        base = ((my * v + by) * bw + mx * h + bx) * 64
                        # DC: a magnitude category, then its bits
                        i = pos >> 3
                        w = (d[i] << 16) | (d[i + 1] << 8) | d[i + 2]
                        e = dc_lut[(w >> (8 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError(_SCAN_ERRORS[1].format(name))
                        pos += e >> 8
                        s = e & 0xFF
                        diff = 0
                        if s:
                            i = pos >> 3
                            w = (d[i] << 16) | (d[i + 1] << 8) | d[i + 2]
                            diff = ((w >> (8 - (pos & 7))) & 0xFFFF) \
                                >> (16 - s)
                            pos += s
                            if diff < (1 << (s - 1)):
                                diff -= (1 << s) - 1
                        preds[ci] += diff
                        idx.append(base)
                        val.append(preds[ci])
                        # AC: (run, size) symbols to the end of block
                        k = 1
                        while k < 64:
                            i = pos >> 3
                            w = (d[i] << 16) | (d[i + 1] << 8) | d[i + 2]
                            e = ac_lut[(w >> (8 - (pos & 7))) & 0xFFFF]
                            if not e:
                                raise ValueError(
                                    _SCAN_ERRORS[1].format(name))
                            pos += e >> 8
                            rs = e & 0xFF
                            s = rs & 15
                            if s:
                                k += rs >> 4
                                i = pos >> 3
                                w = (d[i] << 16) | (d[i + 1] << 8) | d[i + 2]
                                a = ((w >> (8 - (pos & 7))) & 0xFFFF) \
                                    >> (16 - s)
                                pos += s
                                if a < (1 << (s - 1)):
                                    a -= (1 << s) - 1
                                if k < 64:
                                    idx.append(base + zz[k])
                                    val.append(a)
                                k += 1
                            elif rs == 0xF0:
                                k += 16
                            else:
                                break
                        if pos > nbits + 32:
                            raise ValueError(_SCAN_ERRORS[2].format(name))
    for c, (*_, idx, val) in zip(comps, lists):
        c[5][np.asarray(idx, np.int64)] = val


_SCAN_ERRORS = {1: "{}: bad Huffman code",
                2: "{}: JPEG entropy-coded data ends early"}


def _idct_pass(d, shift: int):
    """One 1-D pass of libjpeg's ``jpeg_idct_islow`` (CONST_BITS 13) over
    eight int64 arrays, descaled by ``shift`` with rounding."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    z1 = (d2 + d6) * 4433
    tmp2 = z1 + d6 * -15137
    tmp3 = z1 + d2 * 6270
    tmp0 = (d0 + d4) << 13
    tmp1 = (d0 - d4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d7, d5, d3, d1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0 = t0 * 2446
    t1 = t1 * 16819
    t2 = t2 * 25172
    t3 = t3 * 12299
    z1 = z1 * -7373
    z2 = z2 * -20995
    z3 = z3 * -16069 + z5
    z4 = z4 * -3196 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    r = 1 << (shift - 1)
    return [(tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift,
            (tmp12 + t1 + r) >> shift, (tmp13 + t0 + r) >> shift,
            (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
            (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift]


def _idct_range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by ``x & 1023``."""
    i = np.arange(1024)
    return np.where(i < 128, i + 128, np.where(
        i < 512, 255, np.where(i < 896, 0, i - 896))).astype(np.uint8)


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``[N, 64]`` natural-order coefficients x quant table -> ``[N, 8,
    8]`` uint8 samples: libjpeg's accurate integer IDCT (its zero-AC
    shortcuts give the same values), in numpy."""
    c = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)
    ws = np.stack(_idct_pass([c[:, k, :] for k in range(8)], 11), 1)
    out = np.stack(_idct_pass([ws[:, :, k] for k in range(8)], 18), 2)
    return _idct_range_table()[out & 1023]


def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """libjpeg's h2v1 fancy upsampling of ``[H, w]`` rows to ``[H, 2w]``
    (edge samples repeated)."""
    x = x.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out.astype(np.uint8)


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2 fancy (triangular) upsampling of ``[h, w]`` to
    ``[2h, 2w]`` (edge rows and columns repeated)."""
    x = x.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for r, near in ((0, up), (1, down)):
        s = 3 * x + near
        left = np.concatenate([s[:, :1], s[:, :-1]], 1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        out[r::2, 0::2] = (3 * s + left + 8) >> 4
        out[r::2, 1::2] = (3 * s + right + 7) >> 4
    return out.astype(np.uint8)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB (``jdcolor.c``, SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (91881 * x + half) >> 16
    cb_b = (116130 * x + half) >> 16
    cr_g = -46802 * x
    cb_g = -22554 * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _jpeg_layout(frame) -> dict:
    """Per component id ``(h, v, bw, bh, cw, ch, tq)``: its sampling
    factors, its stored blocks a row and a column (whole MCUs), its real
    width and height; plus ``"mcus"`` (MCUs a row, a column) and ``"max"``
    (the largest factors). A one-component frame has 1 x 1 factors and
    blocks of its own (libjpeg's rule)."""
    height, width, comps = frame
    if len(comps) == 1:
        comps = [(comps[0][0], 1, 1, comps[0][3])]
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    out = {"mcus": (mx, my), "max": (hmax, vmax)}
    for cid, h, v, tq in comps:
        out[cid] = (h, v, mx * h, my * v, -(-width * h // hmax),
                    -(-height * v // vmax), tq)
    return out


def decode_jpeg(data: bytes, name: str = "<jpeg>", gray: bool = False,
                native: bool = True) -> np.ndarray:
    """uint8 ``[H, W, 3]`` (``[H, W]`` for a one-component file) of a
    baseline JPEG, as Pillow decodes it (see the module docstring for the
    scope). ``gray``: the luma plane only, ``[H, W]``. The Huffman decode
    runs in ``native/jpeg_scan.cpp`` (built with ``g++`` at first use);
    ``native=False``, or a host without a compiler, runs its plain Python
    version, which gives the same coefficients."""
    from ..native import decode_jpeg_scan

    quant: dict = {}
    dc_luts: dict = {}
    ac_luts: dict = {}
    interval = 0
    frame = None
    adobe = jfif = None
    planes: dict = {}   # component id -> (int32 coefficients, quant)
    for marker, p, end in _jpeg_segments(data, name):
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(p):
                pq, tq = p[i] >> 4, p[i] & 15
                if pq:
                    q = np.frombuffer(p[i + 1:i + 129], ">u2").astype(
                        np.int64)
                    i += 129
                else:
                    q = np.frombuffer(p[i + 1:i + 65], np.uint8).astype(
                        np.int64)
                    i += 65
                nat = np.zeros(64, np.int64)
                nat[_ZIGZAG] = q
                quant[tq] = nat
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(p):
                tc, th = p[i] >> 4, p[i] & 15
                counts = list(p[i + 1:i + 17])
                total = sum(counts)
                syms = list(p[i + 17:i + 17 + total])
                (ac_luts if tc else dc_luts)[th] = _huffman_lut(counts,
                                                                syms)
                i += 17 + total
        elif marker == 0xDD:  # DRI
            interval = (p[0] << 8) | p[1]
        elif marker == 0xE0 and p[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and p[:5] == b"Adobe" and len(p) >= 12:
            adobe = p[11]
        elif _is_sof(marker):
            frame = _sof(marker, p, name)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame")
            ns = p[0]
            if p[1 + 2 * ns:4 + 2 * ns] != bytes([0, 63, 0]):
                raise ValueError(f"{name}: JPEG scan with spectral "
                                 "selection or approximation is not "
                                 "baseline")
            layout = _jpeg_layout(frame)
            scan = []
            for k in range(ns):
                cid, tables = p[1 + 2 * k], p[2 + 2 * k]
                h, v, bw, bh, cw, ch, tq = layout[cid]
                if cid not in planes:
                    if tq not in quant:
                        raise ValueError(f"{name}: JPEG without quant "
                                         f"table {tq}")
                    planes[cid] = (np.zeros(bw * bh * 64, np.int32),
                                   quant[tq].copy())
                if ns == 1:
                    # a one-component scan walks the component's own
                    # blocks, one an MCU
                    h = v = 1
                    mcus = (-(-cw // 8), -(-ch // 8))
                else:
                    mcus = layout["mcus"]
                scan.append((dc_luts[tables >> 4], ac_luts[tables & 15],
                             h, v, bw, planes[cid][0]))
            segs, _ = _entropy_data(data, end)
            n_mcus = mcus[0] * mcus[1]
            per_seg = interval or n_mcus
            if len(segs) != -(-n_mcus // per_seg):
                raise ValueError(
                    f"{name}: JPEG scan holds {len(segs)} restart "
                    f"intervals, expected {-(-n_mcus // per_seg)}")
            rc = (decode_jpeg_scan(segs, scan, per_seg, *mcus) if native
                  else None)
            if rc is None:
                _decode_scan(segs, scan, per_seg, mcus[0], mcus[1], name)
            elif rc:
                raise ValueError(_SCAN_ERRORS[rc].format(name))
    if frame is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    height, width, fcomps = frame
    if len(fcomps) not in (1, 3):
        raise ValueError(f"{name}: JPEG with {len(fcomps)} components is "
                         "not read (grayscale or YCbCr/RGB only)")
    layout = _jpeg_layout(frame)
    hmax, vmax = layout["max"]
    full = []
    for cid, *_ in fcomps[:1] if gray else fcomps:
        h, v, bw, bh, cw, ch, _ = layout[cid]
        coef, q = planes.get(cid, (np.zeros(bw * bh * 64, np.int32),
                                   np.ones(64, np.int64)))
        blocks = idct_islow(coef.reshape(-1, 64), q)
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)[:ch, :cw]
        if hmax % h or vmax % v or (hmax // h, vmax // v) not in (
                (1, 1), (2, 1), (2, 2)):
            raise ValueError(
                f"{name}: JPEG sampling {h}x{v} of {hmax}x{vmax} is not "
                "read (4:4:4, 4:2:2 and 4:2:0 only)")
        if (hmax // h, vmax // v) == (2, 2):
            plane = _fancy_h2v2(plane)
        elif (hmax // h, vmax // v) == (2, 1):
            plane = _fancy_h2(plane)
        full.append(plane[:height, :width])
    if len(full) == 1:
        return full[0]
    ids = tuple(c[0] for c in fcomps)
    rgb = adobe == 0 or (adobe is None and not jfif
                         and ids == (82, 71, 66))
    if rgb:
        return np.stack(full, -1)
    return _ycc_to_rgb(*full)
