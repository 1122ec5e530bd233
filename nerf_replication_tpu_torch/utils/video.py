"""Uncompressed RGB AVI, written and read with the standard library and
numpy.

The JAX package writes its 360° video as mp4 through OpenCV (an animated GIF
through imageio without an mp4 codec); the card's machine has neither, so
the port writes an AVI that needs no codec: a RIFF ``AVI `` file with one
video stream of 24-bit DIB frames (``BI_RGB``: BGR, rows top-down — a
negative ``biHeight`` — each padded to four bytes), an ``idx1`` index,
every frame a key frame. It is lossless: :func:`read_avi` gives back the
frames bit for bit, and so does ffmpeg (OpenCV's reader, in the tests).
"""

from __future__ import annotations

import os
import struct

import numpy as np


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    pad = b"\0" if len(data) % 2 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def _dib(frame: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB → the DIB's top-down BGR rows, 4-byte aligned."""
    h, w, _ = frame.shape
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = frame[:, :, ::-1].reshape(h, 3 * w)
    return rows.tobytes()


def write_avi(path: str, frames, fps: int = 30) -> str:
    """Write uint8 ``[H, W, 3]`` RGB frames (all one size) as ``path``."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("write_avi needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) for f in frames):
        raise ValueError(f"write_avi takes [H, W, 3] frames of one size; "
                         f"first {frames[0].shape}")
    size = ((3 * w + 3) & ~3) * h
    n = len(frames)
    avih = struct.pack("<14I", 1_000_000 // fps, size * fps, 0, 0x10, n, 0,
                       1, size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"\0\0\0\0", 0, 0, 0, 0,
                       1, fps, 0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, index, offset = [], [], 4
    for f in frames:
        c = _chunk(b"00db", _dib(f))
        index.append(struct.pack("<4sIII", b"00db", 0x10, offset, size))
        movi.append(c)
        offset += len(c)
    body = (b"AVI " + hdrl + _list(b"movi", b"".join(movi))
            + _chunk(b"idx1", b"".join(index)))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def _walk(data: bytes, pos: int, end: int):
    """(fourcc, list kind or None, body start, body end) of each chunk."""
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        start, stop = pos + 8, pos + 8 + size
        if fourcc == b"LIST":
            yield fourcc, data[start:start + 4], start + 4, stop
        else:
            yield fourcc, None, start, stop
        pos = stop + (size & 1)


def read_avi(path: str) -> tuple[list[np.ndarray], int]:
    """(uint8 [H, W, 3] RGB frames, fps) of a :func:`write_avi` file."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF AVI file")
    w = h = fps = None
    frames = []
    for fourcc, kind, start, stop in _walk(data, 12, len(data)):
        if kind == b"hdrl":
            for f2, k2, s2, e2 in _walk(data, start, stop):
                if k2 != b"strl":
                    continue
                for f3, _, s3, _ in _walk(data, s2, e2):
                    if f3 == b"strh":
                        fps = struct.unpack("<I", data[s3 + 24:s3 + 28])[0]
                    elif f3 == b"strf":
                        _, w, h, _, bits, comp = struct.unpack(
                            "<IiiHHI", data[s3:s3 + 20])
                        if bits != 24 or comp != 0:
                            raise ValueError(f"{path}: not 24-bit BI_RGB")
        elif kind == b"movi":
            stride = (3 * w + 3) & ~3
            for f2, _, s2, e2 in _walk(data, start, stop):
                if f2 == b"00db":
                    rows = np.frombuffer(data[s2:e2], np.uint8).reshape(
                        abs(h), stride)[:, :3 * w].reshape(abs(h), w, 3)
                    # a positive height is a bottom-up DIB
                    rows = rows[::-1] if h > 0 else rows
                    frames.append(rows[:, :, ::-1].copy())
    return frames, fps
