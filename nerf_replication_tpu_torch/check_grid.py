"""Sanity-check a baked occupancy grid (the port's counterpart of the root
``check_grid.py``):

    python -m nerf_replication_tpu_torch.check_grid --cfg_file configs/nerf/lego.yaml

prints the grid's path, shape, dtype, occupancy and bbox. ``--visualize``
(a 3-D scatter plot) needs matplotlib, which the port does not depend on,
and raises.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from .config import make_parser
    from .renderer.occupancy import (
        default_grid_path,
        load_occupancy_pyramid,
        occupancy_stats,
    )

    parser = make_parser()
    parser.add_argument("--visualize", action="store_true", default=False)
    args = parser.parse_args(argv)
    if args.visualize:
        raise NotImplementedError(
            "check_grid --visualize draws with matplotlib, which the port "
            "does not depend on; the root check_grid.py plots the same grid"
        )
    path = default_grid_path(args.cfg_file)
    levels, bbox = load_occupancy_pyramid(path)  # checks the checksum
    grid = levels[0]
    stats = occupancy_stats(grid)
    print(f"grid: {path}")
    print(f"shape: {stats['shape']}  dtype: {grid.dtype}")
    print(f"occupied: {stats['occupied']}/{stats['total']} "
          f"({stats['occupancy_pct']:.2f}%)")
    print(f"bbox: {bbox.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
