"""What the built Hopper-chain kernels issue: per kernel of the K1/K3a, K5
and K2/K3b libraries, the count of warpgroup matrix products (``HGMMA``),
bulk copies (``UBLKCP``, the TMA engine) and mbarrier operations
(``SYNCS``) in their SASS.

    python -m nerf_replication_tpu_torch.tools.sass_check

Needs ``nvcc`` and ``cuobjdump`` (beside nvcc); builds the kernels if they
are not built. Prints one JSON line per kernel and fails when a gated
kernel has no HGMMA or no bulk copy: every kernel of the forward libraries,
and of ``fused_mlp_bwd`` the rows kernel K2a (``fused_mlp_bwd_rows_kernel``);
K2b and the reduce keep ``mma.sync`` and CUDA-core sums, and are reported
ungated.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

LIBS = ("fused_mlp", "fused_march_full", "fused_mlp_bwd")
OPS = ("HGMMA", "UBLKCP", "SYNCS")
# the kernels of each library held to HGMMA and UBLKCP (None: all of them)
GATED = {"fused_mlp_bwd": "fused_mlp_bwd_rows_kernel"}


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


def _gated(lib: str, kernel: str) -> bool:
    frag = GATED.get(lib)
    return frag is None or frag in kernel


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
        found = False
        for name, counts in _counts(res.stdout).items():
            gated = _gated(lib, name)
            good = counts["HGMMA"] > 0 and counts["UBLKCP"] > 0
            found = found or gated
            ok = ok and (good or not gated)
            print(json.dumps({"library": lib, "kernel": name, "gated": gated,
                              **counts}))
        ok = ok and found
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
