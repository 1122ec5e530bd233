"""HTTP render serving over the port's engine and micro-batcher.

    python -m nerf_replication_tpu_torch.serve --cfg_file configs/nerf/lego.yaml \\
        --device cuda task_arg.march_coarse_block 8 task_arg.march_fused full
    curl -s localhost:8008/render -d '{"theta": 40, "phi": -30, "radius": 4}'
    curl -s localhost:8008/stats

The port of ``serve.py``'s request surface (all JSON):

* ``POST /render`` — a spherical pose (``theta``/``phi``/``radius``) OR a
  ``c2w`` 3x4/4x4 matrix; optional ``H``/``W``/``focal`` override the test
  camera. Reply ``{h, w, tier, cache_hit, latency_ms, rgb_b64}``, where
  ``rgb_b64`` is the base64 of the raw uint8 [h, w, 3] buffer. A bad pose or
  out-of-bounds request → 400, a render timeout → 504, anything else → 500.
* ``GET /stats`` — engine counters (with the ``march`` block and kernel
  launch counts) plus the batcher's.
* ``GET /healthz`` — ``{"ok": true, "queue_depth": ...}`` while serving.

``--port 0`` binds an ephemeral port; the first line printed names it.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _resolve_pose(body: dict):
    """c2w matrix from a request body (spherical pose or explicit matrix)."""
    import numpy as np

    from ..datasets.rays import pose_spherical

    if "c2w" in body:
        c2w = np.asarray(body["c2w"], np.float32)
        if c2w.shape not in ((3, 4), (4, 4)):
            raise ValueError(f"c2w must be 3x4 or 4x4, got {c2w.shape}")
        return c2w
    try:
        return pose_spherical(
            float(body["theta"]), float(body.get("phi", -30.0)),
            float(body.get("radius", 4.0)),
        )
    except KeyError:
        raise ValueError(
            "request must carry either 'c2w' or a spherical pose "
            "('theta' [, 'phi', 'radius'])"
        ) from None


def render_pose(engine, batcher, body: dict) -> dict:
    """One request: pose -> cached or batch-rendered image -> JSON fields."""
    camera = dict(engine.default_camera or {"H": 400, "W": 400, "focal": 555.0})
    H = int(body.get("H", camera["H"]))
    W = int(body.get("W", camera["W"]))
    focal = float(body.get("focal", camera["focal"]))
    c2w = _resolve_pose(body)
    timeout = engine.options.request_timeout_s + 30.0
    via = None
    if batcher is not None:
        def via(rays, near, far):
            return batcher.submit(rays, near, far).result(timeout)
    t0 = time.perf_counter()
    image, info = engine.render_view(c2w, H, W, focal, via=via)
    return {
        "h": H,
        "w": W,
        "tier": info["tier"],
        "cache_hit": bool(info["cache_hit"]),
        "latency_ms": (time.perf_counter() - t0) * 1e3,
        "rgb_b64": base64.b64encode(image.tobytes()).decode("ascii"),
    }


def make_server(engine, batcher, host: str = "127.0.0.1",
                port: int = 8008) -> ThreadingHTTPServer:
    """A ready-to-serve ThreadingHTTPServer (port 0 = ephemeral)."""
    from .batcher import ServeTimeoutError

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply(200, {
                    "ok": True,
                    "queue_depth": batcher.queue_depth() if batcher else 0,
                })
            if self.path == "/stats":
                stats = engine.stats()
                if batcher is not None:
                    stats["batcher"] = batcher.stats()
                return self._reply(200, stats)
            return self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/render":
                return self._reply(404, {"error": f"no route {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                return self._reply(200, render_pose(engine, batcher, body))
            except (ServeTimeoutError, TimeoutError) as err:
                return self._reply(504, {"error": str(err) or "timed out"})
            except (ValueError, KeyError) as err:
                return self._reply(400, {"error": str(err)})
            except Exception as err:  # structured 500, never a traceback
                print(f"render failed: {type(err).__name__}: {err}",
                      file=sys.stderr)
                return self._reply(500, {"error": "internal error"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="NeRF render serving (PyTorch)")
    p.add_argument("--cfg_file", default="configs/nerf/lego.yaml")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", default=[], nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    from ..config import make_cfg
    from .batcher import MicroBatcher
    from .engine import engine_from_cfg

    cfg = make_cfg(args.cfg_file, args.opts or (), default_task="run")
    engine = engine_from_cfg(cfg, cfg_file=args.cfg_file, device=args.device)
    batcher = MicroBatcher(engine)
    server = make_server(engine, batcher, host=args.host, port=args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(device {engine.device}, route {engine.march_options.march_fused}, "
          f"buckets {list(engine.buckets)})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        batcher.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
