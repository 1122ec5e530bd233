"""Inspect a COLMAP sparse model: counts, cameras, track/observation stats
(the port's counterpart of ``scripts/colmap_stats.py``, same flags, same
output).

A terminal summary of the reconstruction's health — per-camera
intrinsics, observation counts, track-length distribution, mean
reprojection error, scene extent:

    python -m nerf_replication_tpu_torch.tools.colmap_stats \
        data/scene/sparse [--json]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..utils.colmap import read_model


def model_stats(model_dir: str) -> dict:
    cameras, images, points = read_model(model_dir)
    stats: dict = {
        "model_dir": model_dir,
        "n_cameras": len(cameras),
        "n_images": len(images),
        "n_points3D": len(points),
        "cameras": [
            {
                "id": c.id,
                "model": c.model,
                "size": [c.width, c.height],
                "params": [float(p) for p in c.params],
            }
            for c in cameras.values()
        ],
    }
    # only TRIANGULATED observations count (point3D_id == -1 marks an
    # unmatched keypoint): this is the number that reconciles with the
    # sum of track lengths
    n_obs = [
        int(np.sum(np.asarray(im.point3D_ids) != -1))
        for im in images.values()
    ]
    if n_obs:
        stats["obs_per_image"] = {
            "mean": float(np.mean(n_obs)),
            "min": int(np.min(n_obs)),
            "max": int(np.max(n_obs)),
        }
    if points:
        tracks = np.array([len(p.image_ids) for p in points.values()])
        errors = np.array([p.error for p in points.values()])
        xyz = np.stack([p.xyz for p in points.values()])
        lo, hi = xyz.min(0), xyz.max(0)
        stats["track_length"] = {
            "mean": float(tracks.mean()),
            "median": float(np.median(tracks)),
            "max": int(tracks.max()),
        }
        stats["reprojection_error_px"] = {
            "mean": float(errors.mean()),
            "median": float(np.median(errors)),
        }
        stats["points_bbox"] = {
            "min": [float(v) for v in lo],
            "max": [float(v) for v in hi],
        }
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(
        description="summarize a COLMAP sparse model")
    p.add_argument("model_dir")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (one JSON object)")
    args = p.parse_args(argv)

    s = model_stats(args.model_dir)
    if args.json:
        print(json.dumps(s))
        return

    print(f"model: {s['model_dir']}")
    print(f"  cameras: {s['n_cameras']}  images: {s['n_images']}  "
          f"points3D: {s['n_points3D']}")
    for c in s["cameras"]:
        ps = " ".join(f"{v:.6g}" for v in c["params"])
        print(f"  camera {c['id']}: {c['model']} "
              f"{c['size'][0]}x{c['size'][1]}  [{ps}]")
    if "obs_per_image" in s:
        o = s["obs_per_image"]
        print(f"  observations/image: mean {o['mean']:.1f} "
              f"(min {o['min']}, max {o['max']})")
    if "track_length" in s:
        t, e = s["track_length"], s["reprojection_error_px"]
        print(f"  track length: mean {t['mean']:.2f}  "
              f"median {t['median']:.0f}  max {t['max']}")
        print(f"  reprojection error: mean {e['mean']:.3f} px  "
              f"median {e['median']:.3f} px")
        lo, hi = s["points_bbox"]["min"], s["points_bbox"]["max"]
        print("  points bbox: "
              f"[{lo[0]:.3g}, {lo[1]:.3g}, {lo[2]:.3g}] – "
              f"[{hi[0]:.3g}, {hi[1]:.3g}, {hi[2]:.3g}]")


if __name__ == "__main__":
    main()
