"""Time the port's JPEG decode of a few files, native and plain.

    python -m nerf_replication_tpu_torch.tools.time_jpeg FILE... \
        [--repeats 5] [--digests textured.json]

For each file: its bytes, the median seconds of ``utils/image.decode_jpeg``
with the native Huffman decoder (``native/jpeg_scan.cpp``, built once
before the timing) and with the plain Python one, and, given a digests
file (``tools/jpeg_fixtures.py --textured`` writes one, keyed by the
file's stem), whether the decode is Pillow's. Prints one JSON line a file,
then the host's name and CPU count. Host code only: no card is used.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import time

import numpy as np


def _median_s(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv=None) -> None:
    from ..native import native_available
    from ..utils.image import decode_jpeg

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("files", nargs="+")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--digests", default=None)
    args = p.parse_args(argv)
    digests = {}
    if args.digests:
        with open(args.digests) as f:
            digests = json.load(f)
    native = native_available("jpeg_scan")
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        img = np.ascontiguousarray(decode_jpeg(data, path))
        plain = decode_jpeg(data, path, native=False)
        stem = os.path.splitext(os.path.basename(path))[0]
        row = {"file": os.path.basename(path), "bytes": len(data),
               "shape": list(img.shape), "native": native,
               "native_s": _median_s(lambda: decode_jpeg(data, path),
                                     args.repeats),
               "plain_s": _median_s(lambda: decode_jpeg(
                   data, path, native=False), args.repeats),
               "native_equals_plain": bool(np.array_equal(img, plain))}
        if stem in digests:
            row["pillow_digest_equal"] = (
                hashlib.sha256(img.tobytes()).hexdigest() == digests[stem])
        print(json.dumps(row), flush=True)
    print(json.dumps({"host": platform.node(), "cpus": os.cpu_count(),
                      "repeats": args.repeats}))


if __name__ == "__main__":
    main()
