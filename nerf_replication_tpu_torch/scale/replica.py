"""Replica runtime: one serving stack (engine + micro-batcher) behind
the front-door router (port of ``nerf_replication_tpu/scale/replica.py``).

Two concrete shapes share one duck-typed surface (``replica_id``,
``state``, ``submit``, ``load``, ``heartbeat``, ``drain``, ``kill``):

* :class:`InProcessReplica` — an engine + MicroBatcher in this process:
  real routes, real warm-start economics (a fresh engine that finds the
  shared kernel-library store reports ``warm_source == "disk"`` and
  ``total_compiles`` 0), without process plumbing in the way of
  measurement.
* :class:`ProcessReplica` — a port serve child process (``python -m
  nerf_replication_tpu_torch.serve``) reached over HTTP. The production
  shape: heartbeats are ``GET /healthz`` (which carries the replica block
  — warm source, ``total_compiles``, resident scenes, tracing health),
  drain is ``POST /drain``.

Lifecycle: ``starting -> ready -> draining -> retired``, with ``dead``
reachable from anywhere (missed heartbeats or a crash). Draining stops
NEW admissions at the router while everything already queued renders to
completion — retirement never fails an in-flight request.
"""

from __future__ import annotations

import time

from ..obs import get_emitter
from ..obs.metrics import get_metrics
from ..obs.trace import trace_headers


class ReplicaState:
    STARTING = "starting"
    READY = "ready"
    DRAINING = "draining"
    RETIRED = "retired"
    DEAD = "dead"


class ReplicaUnavailableError(RuntimeError):
    """The replica cannot accept this request (draining/retired/dead);
    the router fails over to another replica."""


def _emit_lifecycle(replica_id: str, event: str, **fields) -> None:
    get_emitter().emit("replica", replica=replica_id, event=event, **fields)
    get_metrics().counter("scale_replica_events_total", event=event)


class InProcessReplica:
    """One engine + batcher wearing the replica surface."""

    def __init__(self, replica_id: str, engine, batcher,
                 clock=time.monotonic, capacity=None):
        self.replica_id = str(replica_id)
        self.engine = engine
        self.batcher = batcher
        self.clock = clock
        # optional obs.capacity.CapacityLedger: per-scene heat accounting
        # on the submit path (one per replica)
        self.capacity = capacity
        self.state = ReplicaState.READY
        self.n_submitted = 0
        self.spawned_t = clock()
        stats = engine.stats()
        self.warm_source = stats.get("warm_source")
        self.warm_compiles = int(engine.total_compiles())
        _emit_lifecycle(
            self.replica_id, "ready",
            state=self.state,
            warm_source=self.warm_source or "",
            total_compiles=self.warm_compiles,
        )

    # -- serving --------------------------------------------------------------

    def accepting(self) -> bool:
        return self.state == ReplicaState.READY

    # the router passes the routed request's SpanContext explicitly
    # (InProcessReplica shares the router's process, so "propagation" is
    # an argument, not a header) — see Router.submit
    accepts_ctx = True

    # request shapes this replica serves: the router filters candidates
    # on this (a capability mismatch is not a failover — the replica is
    # healthy, it just doesn't speak that protocol)
    capabilities = ("rays",)

    def submit(self, rays, near, far, scene=None, tenant=None, ctx=None):
        """Enqueue on this replica's batcher (router-facing). Raises
        :class:`ReplicaUnavailableError` when not accepting, so the
        router's failover loop moves on without losing the request."""
        if not self.accepting():
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} is {self.state}"
            )
        self.n_submitted += 1
        if self.capacity is not None:
            self.capacity.note_request(scene or "default", len(rays))
        return self.batcher.submit(rays, near, far, scene=scene,
                                   tenant=tenant, ctx=ctx)

    def load(self) -> int:
        """Routing load signal: requests queued and not yet completed."""
        return self.batcher.queue_depth()

    def resident_scenes(self) -> list[str]:
        return self.engine.resident_scenes()

    # -- lifecycle ------------------------------------------------------------

    def heartbeat(self) -> dict:
        """The registration payload the router sweeps (pull model: one
        code path for in-process and HTTP replicas)."""
        if self.state == ReplicaState.DEAD:
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} is dead"
            )
        health = self.batcher.health()
        beat = {
            "replica": self.replica_id,
            "state": self.state,
            "ok": bool(health.get("ok")),
            "load": self.load(),
            "scenes": self.resident_scenes(),
            "warm_source": self.warm_source,
            "total_compiles": int(self.engine.total_compiles()),
        }
        # full residency state for the placement planner: staging-tier
        # ids plus byte watermarks/budgets straight off the ladder
        fleet = getattr(self.engine, "fleet", None)
        if fleet is not None:
            fs = fleet.stats()
            beat.update(
                staging=list(fs.get("staging", [])),
                hbm_bytes=int(fs.get("resident_bytes", 0)),
                staging_bytes=int(fs.get("staging_bytes", 0)),
                hbm_budget_bytes=int(fs.get("budget_bytes", 0)),
                staging_budget_bytes=int(fs.get("staging_budget_bytes", 0)),
                # model-parallel serving (scale.mesh_shape): the planner
                # packs 1/shards of each scene's bytes onto this replica
                param_shards=int(fs.get("param_shards", 1)),
            )
        return beat

    def drain(self, timeout_s: float = 60.0) -> int:
        """Render everything queued, then retire. Returns the number of
        in-flight requests that FAILED during the drain — the
        drain-before-retire contract wants exactly zero."""
        if self.state in (ReplicaState.RETIRED, ReplicaState.DEAD):
            return 0
        self.state = ReplicaState.DRAINING
        _emit_lifecycle(self.replica_id, "drain", state=self.state,
                        load=self.load())
        failures_before = (self.batcher.n_timeouts
                          + self.batcher.n_dispatch_errors
                          + self.batcher.n_scene_errors)
        if self.batcher._started:
            self.batcher.close(drain=True)
        else:
            # test/manual-drive batchers (start=False) drain synchronously
            deadline = self.clock() + timeout_s
            while self.batcher.queue_depth() and self.clock() < deadline:
                self.batcher.pump()
        failed = (self.batcher.n_timeouts
                  + self.batcher.n_dispatch_errors
                  + self.batcher.n_scene_errors) - failures_before
        self.state = ReplicaState.RETIRED
        _emit_lifecycle(self.replica_id, "retire", state=self.state,
                        n_ready=0, detail=f"drain_failed={failed}")
        return failed

    def kill(self) -> None:
        """Simulated process death (the chaos path): queued futures fail
        immediately, heartbeats start raising."""
        self.state = ReplicaState.DEAD
        _emit_lifecycle(self.replica_id, "dead", state=self.state)
        # close(drain=False) fails every queued future immediately —
        # with no worker thread it just never joins one
        self.batcher.close(drain=False)

    # -- fleet metrics --------------------------------------------------------

    def metrics_source_id(self) -> str:
        """In-process replicas all write the PROCESS registry — the fleet
        aggregator dedups scrapes on this id so N in-process replicas
        contribute one copy, not N."""
        return "process"

    def scrape_metrics(self) -> str:
        return get_metrics().render_prometheus()

    def stats(self) -> dict:
        return {
            "replica": self.replica_id,
            "state": self.state,
            "n_submitted": self.n_submitted,
            "warm_source": self.warm_source,
            "warm_compiles": self.warm_compiles,
            "total_compiles": int(self.engine.total_compiles()),
            "batcher": self.batcher.stats(),
        }


class ProcessReplica:
    """A port serve child process behind the same replica surface.

    Spawn-side only needs argv + environment: the child warms from the
    SHARED kernel-library store (``compile/artifacts.py``), so its
    start-to-serving time is a load and its captures, not an ``nvcc``
    run. ``submit`` is not implemented at the ray level — HTTP replicas
    serve whole poses via ``POST /render``; the router treats them as
    opaque capacity and routes pose requests. ``device`` is passed to the
    child as ``--device`` (the card unless the caller asks for the CPU);
    ``opts`` are config overrides appended to its argv."""

    # pose-only over HTTP: ray-level submit is the in-process surface
    capabilities = ("pose",)

    def __init__(self, replica_id: str, cfg_file: str, host: str,
                 port: int, python: str = "python",
                 clock=time.monotonic, healthz_ttl_s: float = 0.5,
                 device: str = "cuda", opts=()):
        self.replica_id = str(replica_id)
        self.cfg_file = cfg_file
        self.host = host
        self.port = int(port)
        self.python = python
        self.clock = clock
        self.device = str(device)
        self.opts = [str(o) for o in opts]
        # one /healthz snapshot serves every probe inside the TTL: the
        # router calls load() AND resident_scenes() per candidate per
        # dispatch, and two HTTP round trips per routing decision is
        # the probe tax this cache removes
        self.healthz_ttl_s = float(healthz_ttl_s)
        self._beat_t = -float("inf")
        self._beat_health: dict | None = None
        self.state = ReplicaState.STARTING
        self.proc = None
        self.n_submitted = 0

    def argv(self) -> list[str]:
        return [self.python, "-m", "nerf_replication_tpu_torch.serve",
                "--cfg_file", self.cfg_file, "--host", self.host,
                "--port", str(self.port), "--device", self.device,
                *self.opts]

    def spawn(self, env=None, cwd=None) -> None:
        import os
        import subprocess

        _emit_lifecycle(self.replica_id, "spawn", state=self.state)
        self.proc = subprocess.Popen(
            self.argv(), env={**os.environ, **(env or {}),
                              "SCALE_REPLICA_ID": self.replica_id},
            cwd=cwd,
        )

    def _get(self, path: str, timeout: float = 2.0) -> dict:
        import json
        import urllib.request

        # every fleet HTTP call carries the caller's span ctx (no-op
        # headers outside a traced request) — the child parents under it
        req = urllib.request.Request(
            f"http://{self.host}:{self.port}{path}",
            headers=trace_headers(),
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode())

    def accepting(self) -> bool:
        return self.state == ReplicaState.READY

    def _healthz(self, force: bool = False) -> dict:
        """The shared heartbeat snapshot. A fetch inside the TTL is
        free (cache hit); failures are never cached, so the
        unreachable→sentinel behavior of the probes is unchanged."""
        now = self.clock()
        if (not force and self._beat_health is not None
                and now - self._beat_t < self.healthz_ttl_s):
            return self._beat_health
        health = self._get("/healthz")
        self._beat_health = health
        self._beat_t = now
        return health

    def load(self) -> int:
        try:
            return int(self._healthz().get("queue_depth", 0))
        # graftlint: ok(swallow: routing probe; unreachable -> sentinel load, sweep owns the dead-marking)
        except Exception:
            return 1 << 30  # unreachable sorts last for routing

    def resident_scenes(self) -> list[str]:
        try:
            return list(self._healthz()
                        .get("replica", {}).get("scenes", []))
        # graftlint: ok(swallow: affinity hint only; empty set just loses the routing preference)
        except Exception:
            return []

    def heartbeat(self) -> dict:
        if self.proc is not None and self.proc.poll() is not None:
            self.state = ReplicaState.DEAD
            self._beat_health = None  # a dead child has no fresh beat
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} exited "
                f"(code {self.proc.returncode})"
            )
        try:
            health = self._healthz()
        except Exception as exc:
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} unreachable: {exc}"
            ) from exc
        if self.state == ReplicaState.STARTING:
            self.state = ReplicaState.READY
            _emit_lifecycle(self.replica_id, "ready", state=self.state)
        rep = health.get("replica", {})
        return {
            "replica": self.replica_id,
            "state": self.state,
            "ok": bool(health.get("ok")),
            "load": int(health.get("queue_depth", 0)),
            "scenes": list(rep.get("scenes", [])),
            "warm_source": rep.get("warm_source"),
            "total_compiles": int(rep.get("total_compiles", 0)),
            # full residency state for the placement planner (the
            # child's /healthz carries its ladder tiers + watermarks)
            "staging": list(rep.get("staging", [])),
            "hbm_bytes": int(rep.get("hbm_bytes", 0)),
            "staging_bytes": int(rep.get("staging_bytes", 0)),
            "hbm_budget_bytes": int(rep.get("hbm_budget_bytes", 0)),
            "staging_budget_bytes": int(rep.get("staging_budget_bytes", 0)),
            "param_shards": int(rep.get("param_shards", 1)),
            # tracing health rides the heartbeat for free (spans emitted,
            # sink drops, remote-parented count) — the child's /healthz
            "trace": dict(rep.get("trace", {})),
        }

    def submit(self, rays, near, far, scene=None, tenant=None):
        raise ReplicaUnavailableError(
            "ProcessReplica serves poses over HTTP (POST /render); "
            "ray-level submit is the in-process surface"
        )

    def render(self, body: dict, timeout_s: float = 30.0) -> dict:
        """``POST /render`` one pose request, stamping the caller's span
        ctx as the :data:`~..obs.trace.TRACE_HEADER` — the child's
        ``serve.request`` span parents under the router's dispatch span,
        which is what makes one routed request ONE trace."""
        import json
        import urllib.request

        if not self.accepting():
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} is {self.state}"
            )
        self.n_submitted += 1
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://{self.host}:{self.port}/render",
            data=data, method="POST",
            headers={"Content-Type": "application/json", **trace_headers()},
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return json.loads(r.read().decode())

    # -- fleet metrics --------------------------------------------------------

    def metrics_source_id(self) -> str:
        """Each child process owns its registry — scrape every one."""
        return self.replica_id

    def scrape_metrics(self, timeout: float = 2.0) -> str:
        """Raw ``GET /metrics`` text from the child (Prometheus
        exposition; exemplar suffixes included) for the fleet merge."""
        import urllib.request

        req = urllib.request.Request(
            f"http://{self.host}:{self.port}/metrics",
            headers=trace_headers(),
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read().decode()

    def drain(self, timeout_s: float = 60.0) -> int:
        """``POST /drain`` (the child renders everything queued), wait for
        an empty queue, then SIGTERM the child and wait for its exit.
        Returns the child's ``n_failed`` (JAX returns 0 whatever the
        child reports); an unreachable child counts nothing, as its queue
        is gone."""
        import json
        import urllib.request

        self.state = ReplicaState.DRAINING
        _emit_lifecycle(self.replica_id, "drain", state=self.state)
        failed = 0
        try:
            req = urllib.request.Request(
                f"http://{self.host}:{self.port}/drain", method="POST",
                headers=trace_headers(),
            )
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                failed = int(json.loads(r.read().decode()).get(
                    "n_failed", 0))
        # graftlint: ok(swallow: best-effort drain request; the wait-loop below is the authority)
        except Exception:
            pass  # the wait-loop below is the authority
        deadline = self.clock() + timeout_s
        while self.clock() < deadline:
            try:
                if int(self._get("/healthz").get("queue_depth", 0)) == 0:
                    break
            # graftlint: ok(swallow: unreachable mid-drain means the queue is gone; terminate below)
            except Exception:
                break
            time.sleep(0.2)
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30.0)
            # graftlint: ok(swallow: terminate timed out; the kill() IS the handling)
            except Exception:
                self.proc.kill()
                self.proc.wait()
        self.state = ReplicaState.RETIRED
        _emit_lifecycle(self.replica_id, "retire", state=self.state,
                        detail=f"drain_failed={failed}")
        return failed

    def kill(self) -> None:
        self.state = ReplicaState.DEAD
        _emit_lifecycle(self.replica_id, "dead", state=self.state)
        if self.proc is not None:
            self.proc.kill()
