"""Bake the occupancy grid for accelerated rendering (the port's counterpart
of the root ``occupancy_grid.py``):

    python -m nerf_replication_tpu_torch.occupancy_grid \\
        --cfg_file configs/nerf/lego.yaml --device cuda [key value ...]

loads the trained network (``trained_model_dir``), sweeps an R³ voxel grid of
the scene bbox (2×2×2 sub-samples per voxel) through the coarse density head,
thresholds it and saves the pyramid artifact to
``logs/<config_name>/occupancy_grid.npz`` (relative to the working
directory; the JAX package's layout and keys, so either package reads it).
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from .config import cfg_from_args, make_parser
    from .renderer.occupancy import (
        bake_occupancy_grid,
        default_grid_path,
        occupancy_stats,
        save_occupancy_grid,
    )
    from .train.checkpoint import load_trained_network
    from .utils.platform import resolve_device

    parser = make_parser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cfg = cfg_from_args(args)
    dev = resolve_device(args.device)

    network, _ = load_trained_network(cfg, dev)
    grid = bake_occupancy_grid(network, cfg, device=dev)
    stats = occupancy_stats(grid)
    print(f"grid {stats['shape']}: {stats['occupied']}/{stats['total']} "
          f"occupied ({stats['occupancy_pct']:.2f}%)")
    path = default_grid_path(args.cfg_file)
    save_occupancy_grid(path, grid, cfg.train_dataset.scene_bbox,
                        float(cfg.task_arg.occupancy_grid_threshold))
    print(f"Saving occupancy grid to: {path}")
    print("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
