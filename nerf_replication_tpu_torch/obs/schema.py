"""Versioned row schema for telemetry and bench JSONL files (port of
``nerf_replication_tpu/obs/schema.py``; ``run_meta`` also takes
``torch_version``, so the port's rows validate here as well).

One place declares what a row of ``telemetry.jsonl`` looks like, so the
emitter, the report CLI, and ``scripts/check_telemetry_schema.py`` can
never drift apart (the way the hand-rolled ``BENCH_*.jsonl`` shapes did —
three incompatible row families across ten scripts).

Telemetry rows share three stamped fields:

* ``v``    — schema version (``SCHEMA_VERSION``)
* ``kind`` — one of ``ROW_KINDS``
* ``t``    — unix seconds at emit time

plus the per-kind fields declared in ``ROW_KINDS`` below. Bench rows
(``BENCH_*.jsonl``, ``PROFILE_STEP.jsonl``, quality traces) predate the
schema and are validated structurally by :func:`validate_bench_row`.
"""

from __future__ import annotations

SCHEMA_VERSION = 1

_NUM = (int, float)
_OPT_NUM = (int, float, type(None))

# kind -> (required fields, optional fields); value = allowed types.
# dict/list values are shallow-checked (JSON-serializable containers).
ROW_KINDS: dict[str, tuple[dict, dict]] = {
    "run_meta": (
        {
            "run_id": (str,),
            "component": (str,),
            "config_hash": (str,),
            "process_index": _NUM,
            "process_count": _NUM,
            "device_count": _NUM,
            "local_device_count": _NUM,
            "platform": (str,),
        },
        {
            "task": (str,),
            "scene": (str,),
            "exp_name": (str,),
            "device_kind": (str,),
            "argv": (list,),
            "jax_version": (str,),
            "torch_version": (str,),   # the port's run_meta
        },
    ),
    "step": (
        {"step": _NUM},
        {
            "epoch": _NUM,
            "k": _NUM,                 # burst size the row covers
            "step_time_s": _NUM,       # per-step wall time (window median)
            "step_time_avg_s": _NUM,
            "data_time_s": _NUM,
            "dispatch_s": _NUM,        # host time to enqueue the burst
            "block_s": _NUM,           # device time waited at the sync point
            "lr": _NUM,
            "max_mem_mb": _OPT_NUM,
            "stats": (dict,),          # loss/psnr/... scalars
        },
    ),
    "epoch": (
        {"epoch": _NUM},
        {"steps": _NUM, "wall_s": _NUM, "steps_per_sec": _NUM},
    ),
    "eval": (
        {"metrics": (dict,)},
        {"step": _NUM, "epoch": _NUM, "prefix": (str,), "n_images": _NUM,
         "mean_net_time_s": _NUM, "fps": _NUM},
    ),
    "compile": (
        {"name": (str,), "n_compiles": _NUM, "wall_s": _NUM},
        # cap_old/cap_new: packed-eval stream cap escalation (train/ngp.py
        # render_image) — the rebuild rides a compile row so
        # `tlm_report --diff` flags an escalating run as a regression.
        # phase/skipped_reason: AOT pipeline markers (compile/artifacts.py)
        # — a serialization skip is visible, not silent
        {"call_index": _NUM, "steady_p50_s": _OPT_NUM, "step": _OPT_NUM,
         "cap_old": _NUM, "cap_new": _NUM,
         "phase": (str,), "skipped_reason": (str,)},
    ),
    "memory": (
        {"devices": (list,)},
        {"step": _NUM, "epoch": _NUM, "host_rss_bytes": _OPT_NUM},
    ),
    "heartbeat": (
        {"wall_s": _NUM},
        {"step": _NUM, "epoch": _NUM},
    ),
    # -- serving rows (nerf_replication_tpu/serve) ---------------------------
    # one per completed (or timed-out) render request: end-to-end latency,
    # the degradation tier it was served at, and whether the pose cache hit
    # tenant: which QoS tenant the request billed against (fleet/qos.py;
    # absent on tenant-less requests)
    "serve_request": (
        {"latency_s": _NUM, "n_rays": _NUM, "tier": (str,)},
        {"queue_s": _NUM, "status": (str,), "cache_hit": (bool, int),
         "n_buckets": _NUM, "bucket_rays": _NUM, "scene": (str,),
         "tenant": (str,)},
    ),
    # one per coalesced engine dispatch: how many requests/rays rode the
    # batch and how full the padded buckets were (occupancy = real/padded).
    # scene: which registry scene the batch rendered (multi-tenant serving;
    # absent on default-scene batches)
    "serve_batch": (
        {"n_requests": _NUM, "n_rays": _NUM, "occupancy": _NUM},
        {"tier": (str,), "render_s": _NUM, "queue_depth": _NUM,
         "bucket_rays": _NUM, "scene": (str,), "tenant": (str,)},
    ),
    # -- fleet rows (nerf_replication_tpu/fleet, docs/fleet.md) --------------
    # one per scene materialization onto the device: how it arrived
    # (source: cold = a request blocked on the disk load, prefetch = the
    # background thread had it ready, staging = re-promoted from the
    # host-RAM tier — a device_put, no disk walk, publish = a hot-update
    # swap), the REAL byte footprint charged against fleet.hbm_budget_mb,
    # and the residency set after commit. staging/staging_bytes: host-RAM
    # tier occupancy after commit (tiered ladder only, fleet/ladder.py)
    # total_bytes/param_shards: model-parallel serving (scale.mesh_shape
    # with M > 1) — ``bytes`` is then the per-device shard figure and
    # ``total_bytes`` the whole scene across its ``param_shards`` shards
    # (the two coincide and param_shards == 1 for replicated scenes)
    "scene_load": (
        {"scene": (str,), "bytes": _NUM, "source": (str,)},
        {"load_s": _NUM, "resident": _NUM, "resident_bytes": _NUM,
         "staging": _NUM, "staging_bytes": _NUM,
         "total_bytes": _NUM, "param_shards": _NUM},
    ),
    # one per eviction at either residency tier. reason: budget (one-level
    # manager, drop to admit), demoted (HBM -> host-RAM staging, the
    # arrays survive), lru (dropped with no staged copy / staging LRU),
    # ttl (staged copy expired), manual (operator evict). tier: which
    # tier lost the scene (hbm | staging; absent = hbm, pre-ladder rows)
    "scene_evict": (
        {"scene": (str,), "bytes": _NUM},
        {"reason": (str,), "resident": _NUM, "resident_bytes": _NUM,
         "tier": (str,), "staging": _NUM, "staging_bytes": _NUM},
    ),
    # one per ray-bank placement onto the data-parallel mesh
    # (parallel/sharding.py shard_bank): the bank truncates to a
    # mesh-divisible size, and the dropped-tail count rides a row — the
    # "no silent caps" rule. n_dropped == 0 rows are emitted too, so the
    # report can prove the cap never bit.
    "bank_shard": (
        {"n_rays": _NUM, "n_kept": _NUM, "n_dropped": _NUM},
        {"n_shards": _NUM},
    ),
    # one per load-shed decision: the backlog that triggered a degraded
    # tier (tenant: the per-tenant breaker forced the degrade, fleet/qos.py)
    "serve_shed": (
        {"tier": (str,), "queue_depth": _NUM},
        {"n_requests": _NUM, "n_rays": _NUM, "tenant": (str,)},
    ),
    # -- QoS rows (nerf_replication_tpu/fleet/qos.py) ------------------------
    # one per admission decision at the tenant token bucket: admit (tokens
    # remained) or deny (quota exhausted -> TenantQuotaError, HTTP 429).
    # quota_remaining is the bucket level AFTER the decision.
    "tenant_admit": (
        {"tenant": (str,), "decision": (str,)},
        {"quota_remaining": _NUM, "rate": _NUM, "burst": _NUM,
         "retry_after_s": _NUM},
    ),
    # one per scene hot-update attempt (fleet/publish.py): version N ->
    # N+1 swap with pinned-lease drain. status: ok | torn (checksum fail,
    # version N kept serving) | error. drain_ms: how long in-flight
    # leases on N held the swap.
    "scene_publish": (
        {"scene": (str,), "from_version": _NUM, "to_version": _NUM},
        {"drain_ms": _NUM, "bytes": _NUM, "status": (str,)},
    ),
    # -- traversal (renderer/packed_march.py hierarchical coarse-DDA) --------
    # one per eval image (or bench arm): rows entering the global sort vs
    # occupied rows surviving the fine test — the sweep-efficiency ratio
    # tlm_report summarizes and --diff gates against regression
    "march": (
        {"candidates_in": _NUM, "samples_out": _NUM},
        {"mode": (str,), "surface": (str,), "coarse_occ": _NUM,
         "fine_occ": _NUM, "overflow_frac": _NUM, "truncated": _NUM,
         "n_rays": _NUM, "step": _NUM},
    ),
    # -- learned sampling (renderer/sampling.py proposal resampler) ----------
    # one per validation pass / bench arm: the fine-MLP evaluations per ray
    # the active sampling mode costs (the budget the proposal network
    # exists to cut) next to the quality it bought. tlm_report summarizes
    # these and --diff gates on a grown fine-eval budget.
    "sample": (
        {"mode": (str,), "fine_evals_per_ray": _NUM},
        {"n_proposal": _NUM, "n_fine": _NUM, "psnr": _NUM, "step": _NUM,
         "surface": (str,), "loss_prop": _NUM, "rays_per_s": _NUM},
    ),
    # -- resilience rows (nerf_replication_tpu/resil) ------------------------
    # one per fault at a named fault point: injected (FaultPlan chaos) or
    # detected in the wild (checksum mismatch, torn dir, worker crash).
    # `fault` is the fault kind: io_error | truncate | latency | nan_loss |
    # kill | checksum | torn | crash
    "fault": (
        {"point": (str,), "fault": (str,)},
        {"path": (str,), "delay_s": _NUM, "hit": _NUM,
         "injected": (bool, int), "step": _NUM, "detail": (str,)},
    ),
    # one per retry decision at a load path (resil/retry.py): status is
    # retry (backing off), ok (recovered after >=1 failure), or exhausted
    # (gave up — the unrecovered-fault count tlm_report --diff gates on)
    "retry": (
        {"point": (str,), "attempt": _NUM, "status": (str,)},
        {"error": (str,), "backoff_s": _NUM, "wall_s": _NUM},
    ),
    # one per circuit-breaker state transition (resil/breaker.py): the
    # serve engine degrading through shed tiers / fast-failing under
    # repeated dispatch failures
    "breaker": (
        {"state": (str,)},
        {"point": (str,), "failures": _NUM, "consecutive": _NUM,
         "tier": (str,), "retry_after_s": _NUM},
    ),
    # -- tracing rows (nerf_replication_tpu/obs/trace.py) --------------------
    # one per finished span: a timed unit of work in the serve pipeline,
    # joinable into a per-request tree via (trace_id, parent_id). start_s
    # is on the tracer's clock (perf_counter), NOT unix time — only
    # differences and within-run ordering are meaningful. stage tags the
    # latency taxonomy (queue | acquire | load | dispatch | device |
    # scatter | route | failover); joined/source attribute prefetch joins
    # in fleet residency. remote_parent marks a span whose parent ctx was
    # restored from a Traceparent header (the cross-process join point —
    # trace_view --fleet resolves it in the merged file set, so it is not
    # an orphan); replica names the process that emitted the span.
    "span": (
        {"trace_id": (str,), "span_id": (str,), "name": (str,),
         "start_s": _NUM, "dur_s": _NUM},
        {"parent_id": (str, type(None)), "thread": (str,), "stage": (str,),
         "tier": (str,), "scene": (str, type(None)), "status": (str,),
         "tenant": (str, type(None)), "n_rays": _NUM, "n_requests": _NUM,
         "joined": (str,), "source": (str,), "family": (str,),
         "bucket": _NUM, "queue_depth": _NUM, "detail": (str,),
         "remote_parent": (bool, int), "replica": (str,)},
    ),
    # one per live-aggregation dump (obs/metrics.py snapshot()): the
    # counters/gauges/histograms behind GET /metrics, serialized for
    # offline diffing; slo is the /healthz attainment view at dump time
    "metrics_snapshot": (
        {"counters": (dict,), "gauges": (dict,), "histograms": (dict,)},
        {"slo": (dict,)},
    ),
    # -- scale-out rows (nerf_replication_tpu/scale, docs/scaleout.md) -------
    # one per replica lifecycle transition: spawn (supervisor asked for
    # capacity), ready (warm-up done — warm_source/total_compiles record
    # whether the shared artifact store made it a zero-build start),
    # drain (no new admissions; queued work rendering out), retire
    # (drain complete; detail carries the in-flight failure count, which
    # the drain-before-retire contract holds at 0), dead (crash or
    # missed heartbeats)
    "replica": (
        {"replica": (str,), "event": (str,)},
        {"state": (str,), "load": _NUM, "warm_source": (str,),
         "total_compiles": _NUM, "n_ready": _NUM, "scenes": (list,),
         "detail": (str,)},
    ),
    # one per NON-routine router event (steady-state dispatches ride
    # metrics counters, not rows): failover (a replica refused or died
    # mid-submit; n_candidates = remaining options), dead (marked by the
    # heartbeat sweep), drain (n_failed must be 0), no_replica (total
    # outage — every candidate gone)
    "router": (
        {"event": (str,)},
        {"replica": (str,), "scene": (str, type(None)),
         "n_candidates": _NUM, "load": _NUM, "n_failed": _NUM,
         "detail": (str,)},
    ),
    # one per supervisor evaluation window: the closed loop's reasoning
    # (action: out | in | replace | hold) against the SLO attainment and
    # tenant deny-rate signals, with the hysteresis streak that led to it.
    # evidence links the decision to what the loop saw: the attainment
    # series, per-replica queue depths, the deny rate, and exemplar trace
    # ids of SLO-missing requests (deep-checked by validate_row) — every
    # out/in must name its evidence, not just assert a miss.
    "scale_decision": (
        {"action": (str,), "reason": (str,), "n_replicas": _NUM},
        {"attainment": _OPT_NUM, "deny_rate": _NUM, "streak": _NUM,
         "replica": (str,), "evidence": (dict,)},
    ),
    # one per placement replan (scale/placement.py): the versioned
    # scene->replicas plan the router consults before passive affinity.
    # version bumps only when the assignment changes (identical inputs
    # => identical plan); moves_by_kind counts the ordered rebalance
    # deltas (publish | prefetch | demote); converged means the move
    # list is empty and convergence_s (present only on the plan that
    # closed it) is the wall time from first unconverged plan to here.
    # evidence carries the scene-heat snapshot the plan acted on
    # (deep-checked by validate_row).
    "placement_plan": (
        {"version": _NUM, "reason": (str,), "n_scenes": _NUM,
         "n_replicas": _NUM, "n_moves": _NUM, "moves_by_kind": (dict,),
         "converged": (bool,)},
        {"convergence_s": _NUM, "evidence": (dict,),
         # the router's cumulative planned/unplanned dispatch counters
         # at replan time — the unplanned share tlm_report gates on
         "planned_hits": _NUM, "unplanned": _NUM},
    ),
    # one per APPLIED placement move (the executor's write-back; the
    # move kind lives in "move" — "kind" is the row kind): prefetch/
    # demote ride the fleet ladder's tier transitions, publish rides
    # the scene publisher — never a raw evict of a pinned lease (a
    # pinned refusal lands here as ok=false, detail=pinned, and the
    # tlm_report --diff gate counts it).
    "placement_move": (
        {"version": _NUM, "move": (str,), "scene": (str,),
         "replica": (str,), "ok": (bool,)},
        {"detail": (str,)},
    ),
    # -- ops-intelligence rows (obs/alerts.py / obs/incidents.py /
    # obs/capacity.py, docs/observability.md) --------------------------------
    # one per alert state TRANSITION (firing | resolved), not per
    # evaluation: the burn-rate engine's multi-window verdict against one
    # signal (slo | deny | breaker | orphan_spans | staging_thrash).
    # burn_fast/burn_slow are the short/long-window burn rates at the
    # transition (burn-rate alerts only); value is the raw signal level
    # for direct-condition alerts. window_s names the SHORT window.
    "alert": (
        {"name": (str,), "state": (str,), "severity": (str,),
         "signal": (str,)},
        {"burn_fast": _OPT_NUM, "burn_slow": _OPT_NUM, "value": _OPT_NUM,
         "threshold": _NUM, "window_s": _NUM, "replica": (str,),
         "detail": (str,)},
    ),
    # one per incident lifecycle transition (open | mitigated | resolved):
    # the correlator's record that a timeline dump landed at `path`.
    # trigger: alert | flight_dump | fault. fault_points/trace_ids are
    # what the assembled timeline named (the chaos assertion's join keys).
    "incident": (
        {"incident_id": (str,), "status": (str,), "trigger": (str,)},
        {"alert": (str,), "severity": (str,), "n_events": _NUM,
         "fault_points": (list,), "trace_ids": (list,), "path": (str,),
         "opened_t": _NUM, "resolved_t": _OPT_NUM, "detail": (str,)},
    ),
    # one per capacity-ledger snapshot (obs/capacity.py): the per-scene
    # heat/byte accounting the placement planner replays. scenes maps
    # scene id -> {requests_per_s, rays_per_s, bytes, cold_loads,
    # repromotions}; device_share maps executable family -> device-time
    # share over the window; byte fields are the replica's HBM/staging
    # watermarks (current + peak-since-last-snapshot).
    "capacity_snapshot": (
        {"replica": (str,), "scenes": (dict,)},
        {"hbm_bytes": _NUM, "hbm_peak_bytes": _NUM, "staging_bytes": _NUM,
         "staging_peak_bytes": _NUM, "window_s": _NUM,
         "device_share": (dict,), "requests_per_s": _NUM,
         "rays_per_s": _NUM, "cold_loads": _NUM, "repromotions": _NUM},
    ),
    # -- static analysis (nerf_replication_tpu/analysis) ---------------------
    # one per scripts/graftlint.py run: finding counts split new-vs-baseline
    # so the report can watch the baseline shrink (and flag a lint gate
    # that started failing)
    "lint_run": (
        {"n_findings": _NUM, "n_new": _NUM, "n_baselined": _NUM,
         "duration_s": _NUM},
        {"rule_counts": (dict,), "n_files": _NUM, "exit_code": _NUM,
         "baseline_path": (str,), "rule_times_s": (dict,),
         "new_rule_counts": (dict,)},
    ),
    # one per runtime lock-order sanitizer teardown (analysis/sanitizer.py
    # LockOrderRecorder.emit): the observed per-thread acquisition DAG over
    # the instrumented fleet locks — acyclic=False carries the cycle the
    # static R10 rule would have had to prove
    "lock_order": (
        {"n_locks": _NUM, "n_edges": _NUM, "acyclic": (bool,)},
        {"n_threads": _NUM, "cycle": (list,), "locks": (list,),
         "source": (str,)},
    ),
}


def validate_row(row) -> list[str]:
    """Errors for one telemetry row (empty list = valid)."""
    if not isinstance(row, dict):
        return [f"row is {type(row).__name__}, not an object"]
    errors = []
    v = row.get("v")
    if not isinstance(v, int):
        errors.append("missing/non-int schema version field 'v'")
    elif v > SCHEMA_VERSION:
        errors.append(f"schema version {v} is newer than {SCHEMA_VERSION}")
    kind = row.get("kind")
    if kind not in ROW_KINDS:
        return errors + [f"unknown kind {kind!r}"]
    if not isinstance(row.get("t"), _NUM):
        errors.append("missing/non-numeric timestamp field 't'")
    required, optional = ROW_KINDS[kind]
    for field, types in required.items():
        if field not in row:
            errors.append(f"{kind}: missing required field {field!r}")
        elif not isinstance(row[field], types):
            errors.append(
                f"{kind}: field {field!r} is {type(row[field]).__name__}"
            )
    known = {"v", "kind", "t", *required, *optional}
    for field, value in row.items():
        if field not in known:
            errors.append(f"{kind}: unknown field {field!r}")
        elif field in optional and not isinstance(value, optional[field]):
            errors.append(
                f"{kind}: field {field!r} is {type(value).__name__}"
            )
    if kind == "span":
        errors += _validate_span_ctx(row)
    elif kind == "scale_decision" and isinstance(row.get("evidence"), dict):
        errors += _validate_evidence(row["evidence"])
    elif kind == "alert":
        if row.get("state") not in ("firing", "resolved"):
            errors.append(
                f"alert: state {row.get('state')!r} not in firing|resolved")
        if row.get("severity") not in ("page", "ticket"):
            errors.append(
                f"alert: severity {row.get('severity')!r} not in page|ticket")
    elif kind == "incident":
        if row.get("status") not in ("open", "mitigated", "resolved"):
            errors.append(f"incident: status {row.get('status')!r} not in "
                          "open|mitigated|resolved")
        if row.get("trigger") not in ("alert", "flight_dump", "fault"):
            errors.append(f"incident: trigger {row.get('trigger')!r} not in "
                          "alert|flight_dump|fault")
    elif kind == "placement_move":
        if row.get("move") not in ("publish", "prefetch", "demote"):
            errors.append(f"placement_move: move {row.get('move')!r} not "
                          "in publish|prefetch|demote")
    elif kind == "placement_plan" and isinstance(row.get("evidence"), dict):
        errors += _validate_placement_evidence(row["evidence"])
    elif kind == "lock_order":
        if row.get("acyclic") is False and not row.get("cycle"):
            errors.append(
                "lock_order: acyclic=false must name the observed cycle")
        if row.get("acyclic") is True and row.get("cycle"):
            errors.append(
                "lock_order: acyclic=true contradicts a non-empty cycle")
    return errors


def _validate_span_ctx(row: dict) -> list[str]:
    """Deep checks for the propagated span context: ids must stay
    alphanumeric (the Traceparent header joins them with a dash), and a
    remote-parented span must actually name its parent."""
    errors = []
    for field in ("trace_id", "span_id"):
        val = row.get(field)
        if isinstance(val, str) and not val.isalnum():
            errors.append(
                f"span: {field} {val!r} is not alphanumeric "
                "(breaks Traceparent propagation)"
            )
    if row.get("remote_parent") and not isinstance(row.get("parent_id"), str):
        errors.append("span: remote_parent set but parent_id missing")
    return errors


def _validate_evidence(ev: dict) -> list[str]:
    """Deep checks for a scale_decision evidence block (the shape the
    supervisor commits and docs/scaleout.md documents)."""
    errors = []
    series = ev.get("attainment_series")
    if not isinstance(series, list) or not all(
            isinstance(a, (*_NUM, type(None))) for a in series):
        errors.append("scale_decision: evidence.attainment_series must be "
                      "a list of numbers/nulls")
    depths = ev.get("queue_depths")
    if not isinstance(depths, dict) or not all(
            isinstance(k, str) and isinstance(v, _NUM)
            for k, v in (depths or {}).items()):
        errors.append("scale_decision: evidence.queue_depths must map "
                      "replica id -> depth")
    if not isinstance(ev.get("deny_rate"), _NUM):
        errors.append("scale_decision: evidence.deny_rate must be numeric")
    tids = ev.get("exemplar_trace_ids")
    if not isinstance(tids, list) or not all(
            isinstance(t, str) and t.isalnum() for t in tids):
        errors.append("scale_decision: evidence.exemplar_trace_ids must be "
                      "a list of alphanumeric trace ids")
    known = {"attainment_series", "queue_depths", "deny_rate",
             "exemplar_trace_ids", "window"}
    for field in ev:
        if field not in known:
            errors.append(
                f"scale_decision: unknown evidence field {field!r}")
    return errors


def _validate_placement_evidence(ev: dict) -> list[str]:
    """Deep checks for a placement_plan evidence block: the scene-heat
    snapshot the plan acted on (scene id -> windowed rates)."""
    errors = []
    heat = ev.get("scene_heat")
    if not isinstance(heat, dict) or not all(
            isinstance(k, str) and isinstance(v, dict)
            and all(isinstance(x, _NUM) for x in v.values())
            for k, v in (heat or {}).items()):
        errors.append("placement_plan: evidence.scene_heat must map "
                      "scene id -> {rate: number}")
    for field in ev:
        if field != "scene_heat":
            errors.append(
                f"placement_plan: unknown evidence field {field!r}")
    return errors


# -- bench rows (pre-schema JSONL: BENCH_*.jsonl, PROFILE_STEP.jsonl) --------
# Three row families grew across the bench scripts; each is keyed by its
# discriminator. A row must belong to exactly one family (or be an error
# row), so a script that drifts shape fails the checker instead of
# producing a fourth silent family.

_BENCH_FAMILIES: dict[str, tuple[str, ...]] = {
    # bench.py / bench_sweep.py / bench_hash_step.py headline rows
    "metric": ("value",),
    # bench_ngp.py A/B arm rows
    "arm": ("rays_per_sec",),
    # bench_hash.py / bench_primitives*.py kernel-shootout rows
    "impl": (),
    # profile_step.py cost-analysis / timing rows
    "section": (),
    "xla_flops_per_step": (),
    "s_per_step": (),
    # quality_run.py trace headers / samples / eval-fps rows
    "run_start": (),
    "t_s": ("step",),
    "eval_fps_path": ("fps",),
    # bench_hash_step.py / bench_primitives*.py per-stage rows
    "stage": (),
    # scale_check.py render-path / executable-census rows
    "path": (),
    "chunked_fns": (),
    # scripts/serve_bench.py summary rows (BENCH_SERVE.jsonl): one row per
    # closed/open-loop run of the serving load generator
    "serve_mode": ("n_requests", "p50_ms"),
    # scripts/bench_cold_start.py rows (BENCH_COLDSTART.jsonl): one row per
    # child process measuring start→first-step / start→first-response under
    # a cold vs warm compile cache. NOTE: these rows must not carry any
    # earlier discriminator key above (bench_family is first-match).
    "coldstart": ("mode", "wall_s"),
    # scripts/bench_traversal.py rows (BENCH_TRAVERSAL.jsonl): one row per
    # (traversal arm × occupancy regime) — flat vs hierarchical vs fused
    # (``--fused``, the ops/fused_march.py mega-kernel arm, which also
    # carries the modeled peak_intermediate_bytes ledger and its
    # speedup_vs_staged_x headline) candidate stream size and throughput.
    # NOTE: must not carry any earlier discriminator key (bench_family is
    # first-match), hence the traversal-specific field names.
    "traversal_mode": ("grid_occ", "candidates_per_ray", "rays_per_s"),
    # scripts/serve_bench.py --scenes/--churn rows (BENCH_FLEET.jsonl): one
    # row per multi-scene churn run — residency churn (evictions, prefetch
    # hit rate) next to the scene-switch latency penalty (p95 of requests
    # that switched scenes vs stayed on one). NOTE: must not carry any
    # earlier discriminator key (bench_family is first-match), hence
    # fleet_mode rather than reusing serve_mode.
    "fleet_mode": ("n_scenes", "evictions", "prefetch_hit_rate",
                   "p95_same_ms", "p95_switch_ms"),
    # scripts/bench_sampling.py rows (BENCH_SAMPLING.jsonl): one row per
    # sampling arm (coarse_fine baseline vs proposal resampler) trained to
    # the same budget on the same scene — PSNR at matched training next to
    # the fine-MLP eval budget and render throughput. NOTE: must not carry
    # any earlier discriminator key (bench_family is first-match), hence
    # sampling_mode rather than reusing arm/metric.
    "sampling_mode": ("fine_evals_per_ray", "rays_per_s", "psnr"),
    # scripts/serve_bench.py --tenants rows (BENCH_QOS.jsonl): one row per
    # multi-tenant open-loop run — the quiet tenant's p95 while a hot
    # tenant runs saturated under weighted fair batching, against its
    # solo-run p95, plus the residency-ladder re-promotion vs cold-load
    # split. NOTE: must not carry any earlier discriminator key
    # (bench_family is first-match), hence qos_mode and the qos-specific
    # field names.
    "qos_mode": ("tenants", "hot_share", "quiet_p95_ms", "quiet_solo_p95_ms"),
    # scripts/serve_bench.py --replicas rows (BENCH_SCALE.jsonl): one row
    # per multi-replica open-loop run through a full scale-out/scale-in
    # cycle — attainment sagging under single-replica overload, the
    # supervisor's spawn (the fresh replica's warm source and compile
    # count record the shared-artifact warm start), recovery, and the
    # drain-before-retire scale-in. NOTE: must not carry any earlier
    # discriminator key (bench_family is first-match), hence scale_mode
    # and the scale-specific field names.
    "scale_mode": ("replicas_peak", "attainment_low",
                   "attainment_recovered", "scale_outs", "scale_ins"),
    # scripts/serve_bench.py --replicas --placement rows
    # (BENCH_SCALE.jsonl): one row per placement-planned fleet run —
    # plan convergence (final version, move mix, convergence wall
    # time), the hot scene's achieved replication width vs target, the
    # budget check (replicas over their HBM+staging budget must be 0),
    # the unplanned-dispatch share, and the kill-repair outcome (failed
    # in-flight requests and steady-state recompiles, both held at 0).
    # NOTE: must not carry any earlier discriminator key (bench_family
    # is first-match), hence placement_mode and the placement-specific
    # field names.
    "placement_mode": ("plan_version", "hot_width_target",
                       "hot_width_achieved", "over_budget_replicas",
                       "unplanned_share", "kill_repair_failed"),
    # scripts/bench_traversal.py --mesh-shape rows (BENCH_TRAVERSAL.jsonl):
    # one row per (replicated | sharded) arm of the model-parallel serving
    # bench — rays/s through the mesh_jit path next to the MEASURED
    # per-device peak param bytes (max over each leaf's addressable
    # shards), with the sharded arm carrying its byte-reduction headline
    # vs the replicated baseline and the allclose check against the
    # single-device render. NOTE: must not carry any earlier
    # discriminator key (bench_family is first-match), hence shard_mode
    # and the shard-specific field names.
    "shard_mode": ("mesh_shape", "rays_per_s", "param_bytes_per_device",
                   "param_bytes_total"),
}


def bench_family(row: dict) -> str | None:
    """The family discriminator present in ``row`` (None if no match)."""
    for key in _BENCH_FAMILIES:
        if key in row:
            return key
    return None


def validate_bench_row(row) -> list[str]:
    """Structural errors for one bench/quality JSONL row."""
    if not isinstance(row, dict):
        return [f"row is {type(row).__name__}, not an object"]
    if not row:
        return ["empty row"]
    family = bench_family(row)
    if family is None:
        if "error" in row:  # bare failure rows are legal in every family
            return []
        return [
            "row matches no known bench family (expected one of "
            + ", ".join(sorted(_BENCH_FAMILIES)) + ", or an 'error' row)"
        ]
    if "error" in row:
        return []
    missing = [f for f in _BENCH_FAMILIES[family] if f not in row]
    if missing:
        return [f"family {family!r}: missing fields {missing}"]
    return []
