"""Real process fleet: spawn/ready/drain/replace for port serve children
(port of ``nerf_replication_tpu/scale/launcher.py``).

:class:`ProcessLauncher` spawns the children that
:class:`~.replica.ProcessReplica` talks to (heartbeat = ``GET /healthz``,
drain = ``POST /drain``):

* **port allocation** — bind an ephemeral socket, read the port, hand
  it to the child. The tiny close-to-bind race window is accepted: a
  collision surfaces as the child exiting during ready-wait, which the
  caller handles exactly like any other failed spawn;
* **spawn** — ``python -m nerf_replication_tpu_torch.serve --cfg_file
  <cfg> --host --port --device <device> <opts>`` with ``cwd`` at the repo
  root and ``SCALE_REPLICA_ID`` in the env. Every child resolves the
  same kernel-library store (``compile/artifacts.py``: keyed by sources,
  flags, toolchain and card, under the repo's ``build/``), so a child
  whose parent filled it runs no ``nvcc`` (``warm_source == "disk"``,
  ``total_compiles`` 0) — its start is a load, its warm-up and its
  CUDA-graph captures, not a build;
* **ready-wait** — poll the child's heartbeat until it answers (which
  flips the replica ``starting -> ready``) or the deadline passes; a
  child that exits early is reaped and reported with its exit code.
  Ready means warmed: the child's server binds only after its warm-up
  and captures, so its first routed request adds no capture, route build
  or ``nvcc`` run;
* **drain-before-retire** — ``retire`` delegates to the replica's
  ``drain`` (``POST /drain``, wait for the queue to empty, terminate);
* **kill + 1:1 replace** — the chaos shape: ``replace`` kills (or
  buries) a replica and spawns a fresh one on a fresh port.

The launcher is the supervisor's ``spawn_fn`` (it is callable with a
spawn index), so a real multi-process fleet runs through the same
router/supervisor/planner code as in-process replicas.
"""

from __future__ import annotations

import os
import socket
import sys
import time

from .replica import ProcessReplica

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


class LaunchError(RuntimeError):
    """A child failed to reach ready (exited early or timed out)."""


def allocate_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port the OS just proved free on ``host``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class ProcessLauncher:
    """Spawns port serve children wearing the ProcessReplica surface.

    ``cfg_file`` is the config every child boots from and ``opts`` its
    overrides (checkpoint, grid, fleet manifest ...); ``device`` is each
    child's ``--device`` (the card unless the caller asks for the CPU);
    ``env`` overlays the child environment; ``python`` is the
    interpreter the children run under; ``ready_timeout_s`` bounds the
    spawn-to-serving wait."""

    def __init__(self, cfg_file: str, *, host: str = "127.0.0.1",
                 python: str | None = None, env: dict | None = None,
                 cwd: str | None = None, ready_timeout_s: float = 120.0,
                 poll_s: float = 0.25, healthz_ttl_s: float = 0.5,
                 clock=time.monotonic, device: str = "cuda", opts=()):
        self.cfg_file = str(cfg_file)
        self.device = str(device)
        self.opts = [str(o) for o in opts]
        self.host = str(host)
        self.python = python or sys.executable
        self.env = dict(env or {})
        self.cwd = cwd or _REPO_ROOT
        self.ready_timeout_s = float(ready_timeout_s)
        self.poll_s = float(poll_s)
        self.healthz_ttl_s = float(healthz_ttl_s)
        self.clock = clock
        self._spawn_seq = 0
        self.replicas: list[ProcessReplica] = []
        self.n_spawned = 0
        self.n_replaced = 0
        self.n_retired = 0

    # the supervisor's spawn_fn signature
    def __call__(self, index: int) -> ProcessReplica:
        return self.spawn(index)

    def spawn(self, index: int | None = None) -> ProcessReplica:
        """Spawn one child and block until it serves (ready-wait on its
        heartbeat). Raises :class:`LaunchError` on early exit/timeout."""
        seq = self._spawn_seq if index is None else int(index)
        self._spawn_seq = max(self._spawn_seq, seq) + 1
        port = allocate_port(self.host)
        replica = ProcessReplica(
            f"proc{seq}", self.cfg_file, self.host, port,
            python=self.python, clock=self.clock,
            healthz_ttl_s=self.healthz_ttl_s, device=self.device,
            opts=self.opts,
        )
        replica.spawn(env=self.env, cwd=self.cwd)
        self.wait_ready(replica)
        self.replicas.append(replica)
        self.n_spawned += 1
        return replica

    def wait_ready(self, replica: ProcessReplica) -> None:
        deadline = self.clock() + self.ready_timeout_s
        last = ""
        while self.clock() < deadline:
            if replica.proc is not None and replica.proc.poll() is not None:
                raise LaunchError(
                    f"replica {replica.replica_id} exited during startup "
                    f"(code {replica.proc.returncode})")
            try:
                replica.heartbeat()  # first ok beat flips starting->ready
                return
            # graftlint: ok(swallow: startup polling — the child is not listening yet; the deadline below is the failure path)
            except Exception as exc:
                last = str(exc)
            time.sleep(self.poll_s)
        replica.kill()
        raise LaunchError(
            f"replica {replica.replica_id} not ready after "
            f"{self.ready_timeout_s:.0f}s ({last})")

    def retire(self, replica: ProcessReplica,
               timeout_s: float = 60.0) -> int:
        """Drain-before-retire one child; returns its in-flight failure
        count (the contract wants 0)."""
        failed = replica.drain(timeout_s=timeout_s)
        self.n_retired += 1
        return failed

    def replace(self, replica: ProcessReplica) -> ProcessReplica:
        """Kill (or bury) ``replica`` and spawn its 1:1 replacement on a
        fresh port."""
        if replica.proc is None or replica.proc.poll() is None:
            replica.kill()
        if replica.proc is not None:
            try:
                replica.proc.wait(timeout=10.0)
            # graftlint: ok(swallow: a zombie that outlives the wait still freed its port; the fresh spawn binds a new one)
            except Exception:
                pass
        fresh = self.spawn()
        self.n_replaced += 1
        return fresh

    def shutdown(self) -> None:
        """Kill every child still running (teardown)."""
        for replica in self.replicas:
            if replica.proc is not None and replica.proc.poll() is None:
                replica.kill()
        for replica in self.replicas:
            if replica.proc is not None:
                try:
                    replica.proc.wait(timeout=10.0)
                # graftlint: ok(swallow: teardown best-effort; an unkillable child is the OS's problem now)
                except Exception:
                    pass

    def stats(self) -> dict:
        return {
            "n_spawned": self.n_spawned,
            "n_replaced": self.n_replaced,
            "n_retired": self.n_retired,
            "alive": sum(1 for r in self.replicas
                         if r.proc is not None and r.proc.poll() is None),
        }
