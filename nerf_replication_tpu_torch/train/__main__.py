"""Training entry point of the port (the counterpart of the root
``train.py``):

    python -m nerf_replication_tpu_torch.train --cfg_file configs/nerf/lego.yaml \
        --device cuda network.nerf.fused_trunk true network.nerf.fused_tile 512

builds everything from the YAML config plus ``key value`` overrides, resumes
from ``trained_model_dir`` when a checkpoint is there, and runs the epoch
loop with its save/eval cadence on one card. ``--device cpu`` runs the plain
PyTorch path on the CPU (small configurations only). ``--test`` (evaluation
only) comes with a later port slice.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..config import cfg_from_args, make_parser

    parser = make_parser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.test:
        raise NotImplementedError(
            "--test (evaluate a trained model) comes with a later port slice"
        )
    cfg = cfg_from_args(args)
    from .trainer import fit

    fit(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
