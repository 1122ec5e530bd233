"""What the built forward-chain kernels issue: per kernel of the K1/K3a and
K5 libraries, the count of warpgroup matrix products (``HGMMA``), bulk
copies (``UBLKCP``, the TMA engine) and mbarrier operations (``SYNCS``) in
their SASS.

    python -m nerf_replication_tpu_torch.tools.sass_check

Needs ``nvcc`` and ``cuobjdump`` (beside nvcc); builds the kernels if they
are not built. Prints one JSON line per kernel and fails when a kernel of
either library has no HGMMA or no bulk copy.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

LIBS = ("fused_mlp", "fused_march_full")
OPS = ("HGMMA", "UBLKCP", "SYNCS")


def _counts(sass: str) -> dict[str, dict[str, int]]:
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {op: 0 for op in OPS}
        elif name is not None:
            for op in OPS:
                if re.search(rf"\b{op}\b", line):
                    out[name][op] += 1
    return out


def main() -> int:
    from ..ops import kernels

    kernels.build_all()
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()),
                             "cuobjdump")
    ok = True
    for lib in LIBS:
        res = subprocess.run([cuobjdump, "-sass", kernels._lib_path(lib)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"cuobjdump failed on {lib}:\n{res.stderr}")
        for name, counts in _counts(res.stdout).items():
            good = counts["HGMMA"] > 0 and counts["UBLKCP"] > 0
            ok = ok and good
            print(json.dumps({"library": lib, "kernel": name, **counts}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
