"""Render a 360° spiral video of a trained scene (the port's counterpart of
the root ``render_video.py``):

    python -m nerf_replication_tpu_torch.render_video \\
        --cfg_file configs/nerf/lego.yaml [--device cuda] [key value ...]

Cameras on a spherical spiral (θ sweeping 360°, φ = −30°, r = 4) for 240
frames (``task_arg.video_frames`` overrides), every frame rendered through
one warm serving-engine session (``serve.RenderEngine``) on the ``full``
family: with ``task_arg.accelerated_renderer`` and the baked grid
``logs/<cfg>/occupancy_grid.npz`` loaded, the engine's march route (kernel
K5 under ``march_fused full``), else its chunked volume route. Under
``compile.aot`` the route is captured as a CUDA graph during warm-up and
every frame replays it. The run opens ``<record_dir>/telemetry.jsonl``
before the engine warms up and emits one ``eval`` row (prefix ``video``)
with the frames, mean seconds a frame and fps, as the JAX CLI does.

The frames go to ``<result_dir>/video.avi``, an uncompressed RGB AVI
(``utils/video.py``): the JAX CLI writes mp4 through OpenCV or a GIF through
imageio, neither of which the card's machine has. ``eval.sharded`` (the
sequence-parallel render over several cards) comes with port slice 7.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

N_FRAMES = 240
FPS = 30
PHI_DEG = -30.0
RADIUS = 4.0


def spiral_poses(n_frames: int = N_FRAMES, phi_deg: float = PHI_DEG,
                 radius: float = RADIUS) -> list[np.ndarray]:
    """The spiral's camera-to-world matrices (θ from −180° in equal steps)."""
    from .datasets.rays import pose_spherical

    thetas = np.linspace(-180.0, 180.0, n_frames, endpoint=False)
    return [pose_spherical(float(t), phi_deg, radius) for t in thetas]


def spiral_frames(engine, H: int, W: int, focal: float,
                  n_frames: int = N_FRAMES, phi_deg: float = PHI_DEG,
                  radius: float = RADIUS) -> list[np.ndarray]:
    """The spiral as uint8 ``[H, W, 3]`` frames through ``engine``."""
    return [engine.render_view(c2w, H, W, focal)[0]
            for c2w in spiral_poses(n_frames, phi_deg, radius)]


def _camera(cfg):
    """The test split's camera (H, W, focal, near, far), read without the
    images where the dataset module has a ``Camera``."""
    from .datasets import make_camera, make_dataset

    try:
        return make_camera(cfg, "test")
    except AttributeError:
        return make_dataset(cfg, "test")


def video_engine(cfg, cfg_file: str | None = None, device="cuda"):
    """``(engine, camera)``: the checkpoint's network in a ``RenderEngine``
    warmed on the ``full`` family, with the baked grid when
    ``task_arg.accelerated_renderer`` is set and the grid file loads."""
    from .renderer.occupancy import default_grid_path, load_occupancy_pyramid
    from .serve import RenderEngine
    from .utils.platform import resolve_device
    from .utils.setup import load_trained_network

    dev = resolve_device(device)
    network, _ = load_trained_network(cfg, dev)
    grid = bbox = None
    if bool(cfg.task_arg.get("accelerated_renderer", False)) and cfg_file:
        path = default_grid_path(cfg_file)
        if os.path.exists(path):
            levels, bbox = load_occupancy_pyramid(path)
            grid = levels[0]
        else:
            print(f"occupancy grid not found at {path}; rendering through "
                  "the chunked volume route")
    cam = _camera(cfg)
    engine = RenderEngine(cfg, network, near=cam.near, far=cam.far,
                          grid=grid, bbox=bbox, device=dev,
                          warmup_families=("full",))
    return engine, cam


def render_360_video(cfg, args=None, device="cuda", engine=None) -> str:
    """Render the spiral, emit the ``eval`` row, write the AVI; returns its
    path. ``engine``: an engine (and camera) from :func:`video_engine`
    instead of a fresh one."""
    from .obs import init_run
    from .utils.video import write_avi

    if bool(cfg.get("eval", {}).get("sharded", False)):
        raise NotImplementedError(
            "eval.sharded: the sequence-parallel video render over several "
            "cards comes with port slice 7")
    # the stream opens before warm-up, so its captures are on the record
    emitter = init_run(cfg, component="render_video")
    if engine is None:
        engine = video_engine(cfg, getattr(args, "cfg_file", None), device)
    engine, cam = engine
    n_frames = int(cfg.task_arg.get("video_frames", N_FRAMES))
    t0 = time.perf_counter()
    frames = spiral_frames(engine, int(cam.H), int(cam.W), float(cam.focal),
                           n_frames=n_frames)
    wall = time.perf_counter() - t0
    fps = len(frames) / wall if wall else 0.0
    stats = engine.stats()
    print(f"rendered {len(frames)} frames at {fps:.2f} fps through route "
          f"{stats['route']} ({stats['captures']} captures, "
          f"{stats['n_truncated']} truncated rays)")
    emitter.emit("eval", prefix="video", metrics={}, n_images=len(frames),
                 mean_net_time_s=wall / len(frames) if frames else 0.0,
                 fps=fps)
    emitter.close()
    out_path = write_avi(os.path.join(cfg.result_dir, "video.avi"), frames,
                         FPS)
    print(f"video saved to {out_path}")
    return out_path


def main(argv=None) -> int:
    from .config import cfg_from_args, make_parser
    from .utils.setup import configure_runtime

    parser = make_parser()
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cfg = cfg_from_args(args)
    configure_runtime(cfg)
    render_360_video(cfg, args, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
