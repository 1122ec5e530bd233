"""Training entry point of the port (the counterpart of the root
``train.py``):

    python -m nerf_replication_tpu_torch.train --cfg_file configs/nerf/lego.yaml \
        --device cuda network.nerf.fused_trunk true network.nerf.fused_tile 512

builds everything from the YAML config plus ``key value`` overrides, resumes
from ``trained_model_dir`` when a checkpoint is there, and runs the epoch
loop with its save/eval cadence on one card. ``--device cpu`` runs the plain
PyTorch path on the CPU (small configurations only). ``--test`` evaluates the
trained model instead (``run.run_evaluate``: through the occupancy grid when
one is baked).

Data-parallel training runs the same entry under torchrun, one process a
rank:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m nerf_replication_tpu_torch.train --cfg_file configs/nerf/lego.yaml \
        network.nerf.fused_trunk true network.nerf.fused_tile 512

(the process group's backend is NCCL when every rank has a card, gloo when
ranks share one; ``task_arg.N_rays`` is the global batch). ``--test`` with
``eval.sharded true`` under torchrun renders each view over the ranks.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from ..config import cfg_from_args, make_parser

    parser = make_parser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cfg = cfg_from_args(args)
    if args.test:
        from ..run import run_evaluate

        run_evaluate(cfg, args)
        return 0
    from .trainer import fit

    fit(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
