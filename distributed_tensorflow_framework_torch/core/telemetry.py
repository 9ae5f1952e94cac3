"""Structured telemetry: the ``dtf-telemetry/1`` JSONL event schema.

The port's copy of ``core/telemetry.py``: the same schema string,
reserved fields, event kinds and record shape, so the JAX package's
``scripts/analyze_trace.py`` and ``summarize_events`` read the port's
``events.jsonl`` unchanged; the readers here (``validate_event``,
``read_events``, ``summarize_events``, ``format_run_summary``,
``fmt_bytes``) are that file's, copied whole. The writer takes listeners
(``TelemetryWriter.add_listener``): the goodput ledger (core/goodput.py)
and the flight recorder (core/tracing.py) observe the stream through
them. In a gang of more than one every event carries the writer's
``process_id``.

The port emits the trainer's, the serving engines' and the checkpoint's
kinds, the recovery ladder's, the goodput ledger (``goodput``), memory
samples and the first step's memory analysis (``memory``), spans
(``span``) and the trace analyzer's ``trace_summary``. The kinds of the
fleet, the gang supervisor, elastic resharding, the bench and the
autotuner are defined because ``summarize_events`` reads them; nothing in
the port emits them yet (ROADMAP.md queue A items A15 and A17, and the
port's bench).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import uuid
from typing import Any, Iterator, Mapping

log = logging.getLogger("dtf_torch.telemetry")

SCHEMA_VERSION = 1
SCHEMA = f"dtf-telemetry/{SCHEMA_VERSION}"

# Reserved top-level fields of every event record. Everything else rides
# in ``extra`` (emit(**extra)).
RESERVED_FIELDS = (
    "schema", "run_id", "kind", "t", "step", "metrics", "phases",
    "throughput", "roofline", "collectives", "health", "extra",
)

KIND_TRAIN_STEP = "train_step"
KIND_EVAL = "eval"
KIND_HEALTH = "health"
KIND_FAILURE = "failure"
KIND_RUN_META = "run_meta"
# Checkpoint integrity and the async save pipeline (ckpt/checkpoint.py):
# a quarantined step, a restore that fell back past it, one event per
# committed save (loop-blocked vs submit-to-commit ms), and the restore
# gate's plan for the saved iterator state (data/shard.py).
KIND_CKPT_QUARANTINED = "ckpt_quarantined"
KIND_RESTORE_FALLBACK = "restore_fallback"
KIND_CKPT_SAVE = "ckpt_save"
KIND_DATA_STATE = "data_state"
# The sequence-packing census (data/packing.py), at each metrics fetch:
# ``metrics`` holds the cumulative real/padded tokens and
# packing_efficiency, goodput per padded token.
KIND_DATA_PACKING = "data_packing"
# Construction → first completed step, with the restored step.
KIND_STARTUP = "startup"
# This rank's slice of every global batch (data/shard.py:shard_plan).
KIND_DATA_SHARD = "data_shard"
# One per ZeRO-sharded run (optimizer.zero_sharding="shard_map",
# parallel/zero.py): the static shard/bucket plan — bucket count, shard
# (replica) count, per-shard elements, reduce-scatter vs all-gather wire
# bytes per step, the structural overlap bound (B-1)/B and its
# nominal-rate estimate of hidden milliseconds. Analytic from the plan;
# the measured bytes ride the train_step events' tally
# (zero_reduce_scatter / zero_all_gather).
KIND_ZERO_UPDATE = "zero_update"
# One per pipelined run (parallel/pipeline.py): the resolved pipeline
# schedule — name, stages/microbatches/virtual stages, analytic bubble
# fraction and peak activation residency — so a trace or step-time rollup
# can be read against the schedule that produced it. The per-step
# ``pipe_bubble_frac`` metric rides in ordinary train_step events.
KIND_PIPELINE = "pipeline_schedule"
# The in-process recovery ladder (train/anomaly.py) and the infeed
# watchdog (data/infeed.py).
KIND_ANOMALY = "anomaly_detected"
KIND_ROLLBACK = "rollback"
KIND_BATCH_SKIPPED = "batch_skipped"
KIND_INFEED_STALL = "infeed_stall"
# Serving SLO events (serve/engine.py): one per served request (queue
# wait + end-to-end latency), one per executed batch (real vs padded rows,
# compute time, queue depth left behind), periodic queue-depth gauges,
# p50/p90/p99 latency rollups, and the first execution of each (seq, rows)
# padding bucket (in the port that first call also builds the kernels).
KIND_SERVE_REQUEST = "serve_request"
KIND_SERVE_BATCH = "serve_batch"
KIND_SERVE_QUEUE = "serve_queue_depth"
KIND_SERVE_LATENCY = "serve_latency"
KIND_SERVE_RECOMPILE = "serve_bucket_recompile"
# One per applied live weight reload (serve/engine.py, serve/decode.py):
# old → new artifact digest and step, and the ms from the request to the
# swap.
KIND_SERVE_RELOAD = "serve_reload"
# Autoregressive decode (serve/decode.py): one KIND_DECODE_STEP per decode
# step (real vs padded rows — batch occupancy — plus step and per-token
# ms), and periodic + eviction-triggered KIND_KV_CACHE gauges of the paged
# pool (pages in use/free, active/waiting streams, cumulative
# preemptions).
KIND_DECODE_STEP = "decode_step"
KIND_KV_CACHE = "kv_cache"
# The analyzer's breakdown of a traced window (core/trace_analysis.py):
# window, busy and launch-gap ms, the categories' ms, the top ops.
KIND_TRACE_SUMMARY = "trace_summary"
# The goodput ledger (core/goodput.py): periodic and final classification
# of every wall-clock second into productive step time and overhead
# buckets; ``metrics`` holds wall_s and goodput_frac, ``extra.buckets``
# the seconds per bucket and ``extra.counters`` the tallies.
KIND_GOODPUT = "goodput"
# Device memory (core/memstats.py): periodic allocator samples
# (``torch.cuda.memory_stats``; host RSS on the CPU, ``extra.source_kind``
# says which) and the first train step's memory analysis in
# ``extra.analysis``.
KIND_MEMORY = "memory"
# One finished span (core/tracing.py): ``extra.trace``/``span``/``parent``
# ids, ``name``, start time and duration, the emitting ``service`` and its
# clock-offset estimate, so scripts/analyze_trace.py --spans stitches the
# processes' streams into one trace tree.
KIND_SPAN = "span"
# Read by summarize_events; emitted by parts not ported yet: the bench and
# its backend probe, the gang supervisor's attempts and crash-loop
# verdict, elastic resharding (ROADMAP.md A17), the fleet router's
# routing, ejection, scaling and admission (A15), the autotuner.
KIND_BENCH = "bench_result"
KIND_BENCH_PROBE = "backend_probe"
KIND_SUPERVISOR_ATTEMPT = "supervisor_attempt"
KIND_CRASH_LOOP = "crash_loop"
KIND_MESH_RESIZED = "mesh_resized"
KIND_CKPT_RESHARDED = "ckpt_resharded"
KIND_SERVE_ROUTE = "serve_route"
KIND_SERVE_EJECT = "serve_eject"
KIND_SCALE = "fleet_scale"
KIND_ADMISSION = "serve_admission"
KIND_AUTOTUNE_TRIAL = "autotune_trial"


def make_run_id() -> str:
    """Short, sortable, collision-safe run id: utc-time + random tail."""
    return time.strftime("%Y%m%dT%H%M%S", time.gmtime()) + "-" + uuid.uuid4().hex[:8]


def _to_scalar(v: Any) -> Any:
    if hasattr(v, "item"):
        try:
            return v.item()
        except (TypeError, ValueError, RuntimeError):
            return str(v)
    return v


# Metric-key routing: the trainer's fetched metrics dict mixes model
# metrics, StepTimer phases and ThroughputMeter rates. The writer splits
# them into their schema fields so readers never re-parse key names.
_PHASE_PREFIX, _PHASE_SUFFIX = "time_", "_ms"
_THROUGHPUT_KEYS = (
    "examples_per_sec", "examples_per_sec_per_chip",
    "images_per_sec", "images_per_sec_per_chip",
    "tokens_per_sec", "tokens_per_sec_per_chip",
    "real_tokens_per_sec", "docs_per_sec",
)


def split_metrics(values: Mapping[str, Any]) -> tuple[dict, dict, dict]:
    """Partition a flat metrics dict into (metrics, phases, throughput)."""
    metrics: dict[str, Any] = {}
    phases: dict[str, Any] = {}
    throughput: dict[str, Any] = {}
    for k, v in values.items():
        v = _to_scalar(v)
        if k.startswith(_PHASE_PREFIX) and k.endswith(_PHASE_SUFFIX):
            phases[k[len(_PHASE_PREFIX):-len(_PHASE_SUFFIX)]] = v
        elif k in _THROUGHPUT_KEYS:
            throughput[k] = v
        else:
            metrics[k] = v
    return metrics, phases, throughput


def make_event(
    kind: str,
    *,
    run_id: str,
    step: int | None = None,
    metrics: Mapping[str, Any] | None = None,
    phases: Mapping[str, Any] | None = None,
    throughput: Mapping[str, Any] | None = None,
    roofline: Mapping[str, Any] | None = None,
    collectives: Mapping[str, Any] | None = None,
    health: Mapping[str, Any] | None = None,
    t: float | None = None,
    **extra: Any,
) -> dict:
    """Build a schema-versioned event record (pure function; no I/O)."""
    ev: dict[str, Any] = {
        "schema": SCHEMA,
        "run_id": run_id,
        "kind": kind,
        "t": time.time() if t is None else t,
    }
    if step is not None:
        ev["step"] = int(step)
    for key, val in (
        ("metrics", metrics), ("phases", phases), ("throughput", throughput),
        ("roofline", roofline), ("collectives", collectives),
        ("health", health),
    ):
        if val is not None:
            ev[key] = {k: _to_scalar(v) for k, v in dict(val).items()}
    if extra:
        ev["extra"] = {k: _to_scalar(v) for k, v in extra.items()}
    return ev


def validate_event(ev: Mapping[str, Any]) -> list[str]:
    """Schema-conformance errors for one record ([] = valid)."""
    errors: list[str] = []
    if not isinstance(ev, Mapping):
        return [f"event is {type(ev).__name__}, not a mapping"]
    schema = ev.get("schema")
    if schema != SCHEMA:
        errors.append(f"schema={schema!r}, expected {SCHEMA!r}")
    for req in ("run_id", "kind", "t"):
        if req not in ev:
            errors.append(f"missing required field {req!r}")
    if "step" in ev and not isinstance(ev["step"], int):
        errors.append(f"step={ev['step']!r} is not an int")
    for key in ("metrics", "phases", "throughput", "roofline",
                "collectives", "health", "extra"):
        if key in ev and not isinstance(ev[key], Mapping):
            errors.append(f"field {key!r} is not a mapping")
    unknown = set(ev) - set(RESERVED_FIELDS)
    if unknown:
        errors.append(
            f"unknown top-level field(s) {sorted(unknown)} — new data "
            f"belongs under 'extra' (or bump SCHEMA_VERSION)"
        )
    return errors


class TelemetryWriter:
    """Append-only, line-buffered JSONL sink for schema events.

    ``path=None`` gives a no-op writer (``emit`` still returns the record
    and still calls the listeners). Thread-safe: the engine's batcher and
    reporter threads and the checkpoint's saver thread all emit; a lock
    around the append keeps every JSONL line whole.
    """

    def __init__(self, path: str | None, *, run_id: str | None = None,
                 process_id: int | None = None):
        self.run_id = run_id or make_run_id()
        # The rank, on every event of a gang of more than one.
        self.process_id = process_id
        self._fh = None
        self._lock = threading.Lock()
        self._listeners: list[Any] = []
        self.path = path
        if not path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", buffering=1)

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def add_listener(self, fn) -> None:
        """Call ``fn(event)`` on every emitted record, from the emitting
        thread, outside the append lock. The goodput ledger joins the
        saver thread's ``ckpt_save`` blocked ms this way, and the flight
        recorder keeps its ring. A listener must be fast; one that raises
        is logged and skipped."""
        self._listeners.append(fn)

    def emit(self, kind: str, **fields: Any) -> dict:
        """Build + append one event; returns the record."""
        if self.process_id is not None:
            fields.setdefault("process_id", self.process_id)
        ev = make_event(kind, run_id=self.run_id, **fields)
        line = json.dumps(ev, default=str) + "\n"
        with self._lock:
            if self._fh is not None:
                self._fh.write(line)
        for fn in self._listeners:
            try:
                fn(ev)
            except Exception:  # a broken observer must never lose the run
                log.exception("telemetry listener failed on kind=%s", kind)
        return ev

    def emit_run_meta(self, **describe: Any) -> dict:
        """The run's opening record: argv, config name, host — whatever
        identifies it. Emitted once so every later record can stay thin."""
        return self.emit(
            KIND_RUN_META,
            argv=" ".join(describe.pop("argv", [])) or None,
            host=socket.gethostname(),
            pid=os.getpid(),
            **describe,
        )

    def flush(self) -> None:
        """Push the buffered lines to disk (fsync): the graceful-preemption
        path calls it as soon as SIGTERM lands, so every record is durable
        even if a supervisor's SIGKILL follows before close()."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                try:
                    os.fsync(self._fh.fileno())
                except OSError:  # a pipe cannot fsync
                    pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_events(path: str, *, kind: str | None = None,
                strict: bool = True) -> Iterator[dict]:
    """Stream schema-checked events from a JSONL file.

    ``strict`` raises on a schema-invalid line (tests, tooling); False
    skips them with a warning (forensics over partially-corrupt files —
    e.g. a record truncated by a SIGKILL mid-write).
    """
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
                errors = validate_event(ev)
            except json.JSONDecodeError as e:
                ev, errors = None, [f"invalid json: {e}"]
            if errors:
                msg = f"{path}:{lineno}: {'; '.join(errors)}"
                if strict:
                    raise ValueError(msg)
                log.warning("skipping bad telemetry record %s", msg)
                continue
            if kind is None or ev["kind"] == kind:
                yield ev


# Kinds counted as recovery activity by summarize_events — the run-summary
# surface scripts/analyze_trace.py prints so "how rough was this run?" is
# answerable from the event stream alone.
RECOVERY_KINDS = (
    KIND_CKPT_QUARANTINED, KIND_RESTORE_FALLBACK,
    KIND_SUPERVISOR_ATTEMPT, KIND_CRASH_LOOP, KIND_FAILURE,
    KIND_ANOMALY, KIND_ROLLBACK, KIND_BATCH_SKIPPED, KIND_INFEED_STALL,
    KIND_MESH_RESIZED, KIND_CKPT_RESHARDED, KIND_DATA_STATE,
)


def summarize_events(path: str) -> dict:
    """Aggregate one events.jsonl into a run summary dict.

    Tolerant of torn tails (strict=False): the file is exactly what a
    SIGKILLed run leaves behind, and that is the run most worth
    summarizing. Returns event counts by kind, the step span, a
    ``ckpt_saves`` section (save count, async count, and loop-blocked vs
    total save milliseconds — the async-pipeline win is blocked ≪ total),
    a ``startups`` list (restart → first-step latency per process), a
    ``collectives`` section (the last per-step wire/logical byte tally and
    the resulting wire_compression ratio), and a
    ``recovery`` section: quarantined checkpoint steps, restore fallbacks
    (from → to), supervisor attempt classifications, preemptions, and any
    crash-loop verdict.
    """
    kinds: dict[str, int] = {}
    run_ids: list[str] = []
    first_step = last_step = None
    quarantined: list[dict] = []
    fallbacks: list[dict] = []
    attempts: dict[str, int] = {}
    preemptions = 0
    crash_loop: dict | None = None
    failures: list[dict] = []
    anomalies: list[dict] = []
    rollbacks: list[dict] = []
    batches_skipped = 0
    infeed_stalls = 0
    saves = {
        "count": 0, "async_count": 0,
        "blocked_ms_total": 0.0, "total_ms_total": 0.0,
        "blocked_ms_max": 0.0, "total_ms_max": 0.0,
    }
    startups: list[dict] = []
    pipeline: dict | None = None
    zero: dict | None = None
    step_rates: list[float] = []
    meta: dict | None = None
    evals = {"count": 0, "last_step": None}
    bench = {"count": 0, "workloads": []}
    bench_probes = 0
    trace_summaries = 0
    health_events: dict[str, int] = {}
    mesh_resizes: list[dict] = []
    ckpt_reshards: list[dict] = []
    serve = {
        "requests": 0, "rows": 0, "queue_wait_ms_total": 0.0,
        "batches": 0, "batch_rows": 0, "padded_rows": 0,
        "compute_ms_total": 0.0, "queue_depth_max": 0,
        "recompiles": [], "latency": None,
    }
    decode = {
        "steps": 0, "tokens": 0, "padded_rows": 0, "step_ms_total": 0.0,
        "occupancy_sum": 0.0, "evictions": 0, "pages_used_max": 0,
        "streams_waiting_max": 0, "kv_samples": 0,
    }
    fleet = {
        "requests": 0, "routed": {}, "retries": 0, "shed": 0,
        "deadline_exceeded": 0, "skew": None,
        "ejects": [], "readmits": 0, "restarts": 0, "reloads": [],
        # KIND_SCALE: the autoscaler's action ledger (serve/autoscale.py).
        "scaling": {"ups": 0, "downs": 0, "events": []},
        # KIND_ADMISSION + tenant-tagged KIND_SERVE_ROUTE: per-tenant
        # routed/shed/quota ledger with latency percentiles.
        "tenants": {},
    }
    tenant_latencies: dict[str, list[float]] = {}

    def _tenant(name: str) -> dict:
        led = fleet["tenants"].get(name)
        if led is None:
            led = {
                "routed": 0, "shed": 0, "quota_rejected": 0,
                "latency_ms": None,
            }
            fleet["tenants"][name] = led
        return led

    # Exactly-once data plane: the attempt's shard layout (last KIND_DATA_SHARD
    # wins — a refit re-emits it), the cumulative packing census (last
    # KIND_DATA_PACKING wins, counters are cumulative), and every restore-gate
    # verdict in order (KIND_DATA_STATE — part of the recovery story).
    data_shard: dict | None = None
    data_packing: dict | None = None
    data_restores: list[dict] = []
    last_collectives: dict | None = None
    # Per-attempt goodput rollups: one ledger per run_id (process); the
    # final rollup wins over periodic snapshots, else the last seen (a
    # SIGKILLed attempt never finalizes — its last periodic event is the
    # truth that survived).
    goodput_by_run: dict[str, dict] = {}
    memory = {
        "samples": 0, "sources": {},
        "peak_bytes_in_use": 0, "bytes_in_use_last": None,
        "analysis": None,
    }
    spans = {
        "count": 0, "traces": set(), "services": {}, "names": {},
        "errors": 0, "dur_ms_total": 0.0,
    }
    # KIND_AUTOTUNE_TRIAL ledger: trial decisions by status plus the
    # best goodput-weighted score the window produced.
    autotune = {
        "events": 0, "ran": 0, "pruned": 0, "failed": 0,
        "window_aborts": 0, "best": None,
    }
    for ev in read_events(path, strict=False):
        kind = ev["kind"]
        kinds[kind] = kinds.get(kind, 0) + 1
        if ev.get("collectives"):
            # Per-step collective byte tally (parallel/collectives.py);
            # static per compiled program, so the LAST one wins.
            last_collectives = dict(ev["collectives"])
        if ev.get("run_id") and ev["run_id"] not in run_ids:
            run_ids.append(ev["run_id"])
        step = ev.get("step")
        if isinstance(step, int):
            first_step = step if first_step is None else min(first_step, step)
            last_step = step if last_step is None else max(last_step, step)
        health = ev.get("health") or {}
        extra = ev.get("extra") or {}
        if kind == KIND_CKPT_QUARANTINED:
            quarantined.append({"step": step, "reason": health.get("reason")})
        elif kind == KIND_RESTORE_FALLBACK:
            fallbacks.append({
                "from_step": health.get("from_step"),
                "to_step": health.get("to_step"),
            })
        elif kind == KIND_SUPERVISOR_ATTEMPT:
            cls = str(extra.get("classification", "unknown"))
            attempts[cls] = attempts.get(cls, 0) + 1
        elif kind == KIND_CRASH_LOOP:
            crash_loop = dict(extra) or dict(health)
        elif kind == KIND_FAILURE:
            failures.append({"step": step, **health})
        elif kind == KIND_ANOMALY:
            anomalies.append({"step": step, "anomaly": health.get("anomaly"),
                              "metric": health.get("metric")})
        elif kind == KIND_ROLLBACK:
            rollbacks.append({
                "from_step": health.get("from_step"),
                "to_step": health.get("to_step"),
            })
        elif kind == KIND_BATCH_SKIPPED:
            batches_skipped += int(health.get("batches", 1) or 1)
        elif kind == KIND_INFEED_STALL:
            infeed_stalls += 1
        elif kind == KIND_CKPT_SAVE:
            m = ev.get("metrics") or {}
            blocked = float(m.get("ckpt_save_blocked_ms", 0.0))
            total = float(m.get("ckpt_save_total_ms", 0.0))
            saves["count"] += 1
            if extra.get("async_save"):
                saves["async_count"] += 1
            saves["blocked_ms_total"] += blocked
            saves["total_ms_total"] += total
            saves["blocked_ms_max"] = max(saves["blocked_ms_max"], blocked)
            saves["total_ms_max"] = max(saves["total_ms_max"], total)
        elif kind == KIND_STARTUP:
            startups.append({
                "step": step,
                "time_to_first_step_s": extra.get("time_to_first_step_s"),
                "restored_step": extra.get("restored_step"),
            })
        elif kind == KIND_PIPELINE:
            pipeline = dict(extra)
        elif kind == KIND_ZERO_UPDATE:
            zero = dict(extra)
        elif kind == KIND_RUN_META and meta is None:
            meta = {k: extra.get(k) for k in (
                "config_name", "model", "dataset", "mesh",
                "global_batch_size", "process_count") if k in extra}
        elif kind == KIND_EVAL:
            evals["count"] += 1
            if isinstance(step, int):
                evals["last_step"] = step
        elif kind == KIND_BENCH:
            bench["count"] += 1
            wl = extra.get("workload")
            if wl and wl not in bench["workloads"]:
                bench["workloads"].append(wl)
        elif kind == KIND_BENCH_PROBE:
            bench_probes += 1
        elif kind == KIND_TRACE_SUMMARY:
            trace_summaries += 1
        elif kind == KIND_HEALTH:
            name = str(health.get("event", "unknown"))
            health_events[name] = health_events.get(name, 0) + 1
        elif kind == KIND_MESH_RESIZED:
            mesh_resizes.append({
                "from_axes": extra.get("from_axes"),
                "to_axes": extra.get("to_axes"),
                "visible_devices": extra.get("visible_devices"),
            })
        elif kind == KIND_CKPT_RESHARDED:
            ckpt_reshards.append({
                "step": step,
                "from_axes": extra.get("from_axes"),
                "to_axes": extra.get("to_axes"),
                "leaf_count": extra.get("leaf_count"),
            })
        elif kind == KIND_SERVE_REQUEST:
            m = ev.get("metrics") or {}
            serve["requests"] += 1
            serve["rows"] += int(m.get("rows", 1) or 1)
            serve["queue_wait_ms_total"] += float(m.get("queue_wait_ms", 0.0))
        elif kind == KIND_SERVE_BATCH:
            m = ev.get("metrics") or {}
            serve["batches"] += 1
            serve["batch_rows"] += int(m.get("rows", 0) or 0)
            serve["padded_rows"] += int(m.get("padded_rows", 0) or 0)
            serve["compute_ms_total"] += float(m.get("compute_ms", 0.0))
            serve["queue_depth_max"] = max(
                serve["queue_depth_max"], int(m.get("queue_depth", 0) or 0))
        elif kind == KIND_SERVE_QUEUE:
            m = ev.get("metrics") or {}
            serve["queue_depth_max"] = max(
                serve["queue_depth_max"], int(m.get("queue_depth", 0) or 0))
        elif kind == KIND_SERVE_LATENCY:
            # Periodic rollups are cumulative over the run; the LAST one
            # (emitted at drain) wins.
            m = ev.get("metrics") or {}
            tp = ev.get("throughput") or {}
            serve["latency"] = {
                "p50_ms": m.get("p50_ms"), "p90_ms": m.get("p90_ms"),
                "p99_ms": m.get("p99_ms"), "count": m.get("count"),
                "requests_per_sec": tp.get("requests_per_sec"),
                "rows_per_sec": tp.get("rows_per_sec"),
            }
        elif kind == KIND_SERVE_RECOMPILE:
            m = ev.get("metrics") or {}
            serve["recompiles"].append({
                "bucket": extra.get("bucket"),
                "compile_ms": m.get("compile_ms"),
            })
        elif kind == KIND_DECODE_STEP:
            m = ev.get("metrics") or {}
            decode["steps"] += 1
            decode["tokens"] += int(m.get("rows", 0) or 0)
            decode["padded_rows"] += int(m.get("padded_rows", 0) or 0)
            decode["step_ms_total"] += float(m.get("step_ms", 0.0))
            decode["occupancy_sum"] += float(m.get("occupancy", 0.0))
        elif kind == KIND_KV_CACHE:
            m = ev.get("metrics") or {}
            decode["kv_samples"] += 1
            # evictions is a cumulative counter on the emitting engine —
            # the max across samples is the run total.
            decode["evictions"] = max(
                decode["evictions"], int(m.get("evictions", 0) or 0))
            decode["pages_used_max"] = max(
                decode["pages_used_max"], int(m.get("pages_used", 0) or 0))
            decode["streams_waiting_max"] = max(
                decode["streams_waiting_max"],
                int(m.get("streams_waiting", 0) or 0))
        elif kind == KIND_SERVE_ROUTE:
            m = ev.get("metrics") or {}
            fleet["requests"] += 1
            fleet["retries"] += int(m.get("retries", 0) or 0)
            if extra.get("shed"):
                fleet["shed"] += 1
            if extra.get("deadline_exceeded"):
                fleet["deadline_exceeded"] += 1
            rep = extra.get("replica")
            if rep is not None:
                rep = str(rep)
                fleet["routed"][rep] = fleet["routed"].get(rep, 0) + 1
            tenant = extra.get("tenant")
            if tenant is not None:
                led = _tenant(str(tenant))
                if extra.get("shed"):
                    led["shed"] += 1
                else:
                    led["routed"] += 1
                    lat = m.get("latency_ms")
                    if lat is not None:
                        tenant_latencies.setdefault(
                            str(tenant), []).append(float(lat))
        elif kind == KIND_ADMISSION:
            led = _tenant(str(extra.get("tenant", "default")))
            if str(extra.get("verdict")) == "quota":
                led["quota_rejected"] += 1
            else:
                led["shed"] += 1
        elif kind == KIND_SCALE:
            m = ev.get("metrics") or {}
            action = str(extra.get("action", ""))
            scaling = fleet["scaling"]
            if action == "up":
                scaling["ups"] += 1
            elif action == "down":
                scaling["downs"] += 1
            # Event order IS the scaling timeline — keep it.
            scaling["events"].append({
                "action": action,
                "reason": extra.get("reason"),
                "replica": extra.get("replica"),
                "from_replicas": extra.get("from_replicas"),
                "to_replicas": extra.get("to_replicas"),
                "pressure": m.get("pressure"),
            })
        elif kind == KIND_SERVE_EJECT:
            action = str(extra.get("action", "eject"))
            if action == "readmit":
                fleet["readmits"] += 1
            elif action == "restart":
                fleet["restarts"] += 1
            else:
                fleet["ejects"].append({
                    "replica": extra.get("replica"),
                    "reason": extra.get("reason"),
                })
        elif kind == KIND_SERVE_RELOAD:
            m = ev.get("metrics") or {}
            # Event order IS the rolling-reload timeline (one replica at
            # a time by design) — keep it, don't re-sort.
            fleet["reloads"].append({
                "replica": extra.get("replica"),
                "ok": bool(extra.get("ok")),
                "from_digest": extra.get("from_digest"),
                "to_digest": extra.get("to_digest"),
                "reload_ms": m.get("reload_ms"),
            })
        elif kind == KIND_DATA_SHARD:
            data_shard = dict(extra.get("shard") or {})
        elif kind == KIND_DATA_PACKING:
            m = ev.get("metrics") or {}
            data_packing = {
                "real_tokens": m.get("real_tokens"),
                "padded_tokens": m.get("padded_tokens"),
                "packing_efficiency": m.get("packing_efficiency"),
            }
        elif kind == KIND_DATA_STATE:
            plan = extra.get("plan") or {}
            data_restores.append({
                "step": step,
                "action": plan.get("action"),
                "from_processes": plan.get("from_processes"),
                "to_processes": plan.get("to_processes"),
                "watermark": plan.get("watermark"),
            })
        elif kind == KIND_AUTOTUNE_TRIAL:
            autotune["events"] += 1
            status = str(extra.get("status", ""))
            if status == "done":
                autotune["ran"] += 1
                score = extra.get("score")
                if isinstance(score, (int, float)) and (
                        autotune["best"] is None
                        or score > autotune["best"]["score"]):
                    autotune["best"] = {
                        "trial": extra.get("trial"), "score": score,
                        "unit": extra.get("unit"),
                    }
            elif status == "skipped":
                autotune["pruned"] += 1
            elif status == "failed":
                autotune["failed"] += 1
            elif status == "window_abort":
                autotune["window_aborts"] += 1
        elif kind == KIND_GOODPUT:
            m = ev.get("metrics") or {}
            snap = {
                "t0": extra.get("t0"),
                "wall_s": m.get("wall_s"),
                "goodput_frac": m.get("goodput_frac"),
                "buckets": dict(extra.get("buckets") or {}),
                "counters": dict(extra.get("counters") or {}),
                "final": bool(extra.get("final")),
            }
            prev = goodput_by_run.get(ev.get("run_id"))
            if prev is None or not prev["final"] or snap["final"]:
                goodput_by_run[ev.get("run_id")] = snap
        elif kind == KIND_MEMORY:
            m = ev.get("metrics") or {}
            memory["samples"] += 1
            src = str(extra.get("source", "unknown"))
            memory["sources"][src] = memory["sources"].get(src, 0) + 1
            if m.get("peak_bytes_in_use"):
                memory["peak_bytes_in_use"] = max(
                    int(memory["peak_bytes_in_use"]),
                    int(m["peak_bytes_in_use"]))
            if m.get("bytes_in_use") is not None:
                memory["bytes_in_use_last"] = int(m["bytes_in_use"])
            if extra.get("analysis"):
                memory["analysis"] = dict(extra["analysis"])
        elif kind == KIND_SPAN:
            m = ev.get("metrics") or {}
            spans["count"] += 1
            if extra.get("trace"):
                spans["traces"].add(str(extra["trace"]))
            svc = str(extra.get("service", "unknown"))
            spans["services"][svc] = spans["services"].get(svc, 0) + 1
            name = str(extra.get("name", "unknown"))
            spans["names"][name] = spans["names"].get(name, 0) + 1
            if str(extra.get("status", "ok")) != "ok":
                spans["errors"] += 1
            spans["dur_ms_total"] += float(m.get("dur_ms", 0.0) or 0.0)
        elif kind == KIND_TRAIN_STEP:
            m = ev.get("metrics") or {}
            if pipeline is not None and "pipe_bubble_frac" in m:
                pipeline["bubble_frac_logged"] = float(m["pipe_bubble_frac"])
            rate = (ev.get("throughput") or {}).get("examples_per_sec")
            if isinstance(rate, (int, float)):
                step_rates.append(float(rate))
        if health.get("event") == "graceful_preemption":
            preemptions += 1
    if pipeline is not None and step_rates:
        # Steady-state throughput: median over the back half of the
        # logged steps, past the compile/warmup ramp — the measured
        # number the analytic bubble_frac should explain.
        tail = sorted(step_rates[len(step_rates) // 2:])
        pipeline["steady_examples_per_sec"] = tail[len(tail) // 2]
    collectives = None
    if last_collectives:
        # Wire vs logical per-step bytes (CollectiveTally summary):
        # wire_compression > 1 means a narrow/quantized wire dtype
        # (parallel.collective_dtype) is actually shrinking the traffic.
        total = last_collectives.get("total_bytes")
        logical = last_collectives.get("total_logical_bytes", total)
        collectives = {
            "total_bytes": total,
            "total_logical_bytes": logical,
            "wire_compression": (
                round(float(logical) / float(total), 3)
                if total and logical is not None else None),
        }
    if fleet["routed"]:
        # Routing skew: hottest replica vs the uniform share. 1.0 is a
        # perfectly balanced fleet; ejections and stalls push it up.
        counts = list(fleet["routed"].values())
        mean = sum(counts) / len(counts)
        fleet["skew"] = round(max(counts) / mean, 3) if mean else None
    for tenant, lats in tenant_latencies.items():
        # Per-tenant latency percentiles over every routed request (the
        # event file is the reservoir; nearest-rank on the sorted list).
        lats.sort()
        n = len(lats)
        fleet["tenants"][tenant]["latency_ms"] = {
            p: round(lats[min(n - 1, int(q * n))], 3)
            for p, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))
        }
    goodput = None
    if goodput_by_run:
        # In-process accounting only: restart gaps BETWEEN attempts need
        # the per-attempt t0 intervals and supervisor classifications —
        # goodput.stitch_attempts() builds that cross-attempt table.
        buckets: dict[str, float] = {}
        counters: dict[str, int] = {}
        wall = productive = 0.0
        for snap in goodput_by_run.values():
            w = float(snap.get("wall_s") or 0.0)
            wall += w
            if snap.get("goodput_frac") is not None:
                productive += w * float(snap["goodput_frac"])
            for b, s in snap["buckets"].items():
                buckets[b] = buckets.get(b, 0.0) + float(s)
            for c, n in snap["counters"].items():
                counters[c] = counters.get(c, 0) + int(n)
        goodput = {
            "attempts": len(goodput_by_run),
            "wall_s": wall,
            "goodput_frac": (productive / wall) if wall else None,
            "buckets": buckets,
            "counters": counters,
        }
    return {
        "path": path,
        "run_ids": run_ids,
        "event_count": sum(kinds.values()),
        "kinds": kinds,
        "first_step": first_step,
        "last_step": last_step,
        "meta": meta,
        "evals": evals,
        "bench": bench,
        "bench_probes": bench_probes,
        "trace_summaries": trace_summaries,
        "health_events": health_events,
        "collectives": collectives,
        "ckpt_saves": saves,
        "startups": startups,
        "pipeline": pipeline,
        "zero": zero,
        "serve": (serve if (serve["requests"] or serve["batches"]
                            or serve["recompiles"]) else None),
        "decode": (decode if (decode["steps"] or decode["kv_samples"])
                   else None),
        "fleet": (fleet if (fleet["requests"] or fleet["ejects"]
                            or fleet["readmits"] or fleet["restarts"]
                            or fleet["reloads"] or fleet["tenants"]
                            or fleet["scaling"]["events"]) else None),
        "goodput": goodput,
        "autotune": (autotune if autotune["events"] else None),
        "data": ({"shard": data_shard, "packing": data_packing}
                 if (data_shard or data_packing) else None),
        "memory": (memory if memory["samples"] else None),
        "spans": ({
            "count": spans["count"],
            "traces": len(spans["traces"]),
            "services": spans["services"],
            "names": spans["names"],
            "errors": spans["errors"],
            "dur_ms_total": spans["dur_ms_total"],
        } if spans["count"] else None),
        "recovery": {
            "quarantined": quarantined,
            "restore_fallbacks": fallbacks,
            "supervisor_attempts": attempts,
            "graceful_preemptions": preemptions,
            "failures": failures,
            "crash_loop": crash_loop,
            "anomalies": anomalies,
            "rollbacks": rollbacks,
            "batches_skipped": batches_skipped,
            "infeed_stalls": infeed_stalls,
            "mesh_resizes": mesh_resizes,
            "ckpt_reshards": ckpt_reshards,
            "data_restores": data_restores,
        },
    }


def fmt_bytes(n: Any) -> str:
    """``3221225472`` -> ``3.00 GiB`` (human-scale HBM numbers)."""
    if not isinstance(n, (int, float)):
        return "?"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.2f} TiB"


def _fmt_axes(axes: dict | None) -> str:
    """``{'data': 8}`` -> ``{data:8}`` (size-1 axes elided)."""
    if not axes:
        return "{?}"
    parts = [f"{a}:{int(v)}" for a, v in axes.items() if int(v) != 1]
    return "{" + ", ".join(parts) + "}" if parts else "{1 device}"


def format_run_summary(summary: dict) -> str:
    """Human-readable rendering of ``summarize_events`` output."""
    lines = [f"run summary: {summary['path']}"]
    if summary["run_ids"]:
        lines.append(f"  run ids: {', '.join(summary['run_ids'])}")
    span = ""
    if summary["last_step"] is not None:  # KIND_TRAIN_STEP rollup
        span = f", steps {summary['first_step']}..{summary['last_step']}"
    lines.append(f"  {summary['event_count']} events{span}")
    lines.append(
        "  by kind: " + ", ".join(
            f"{k}={v}" for k, v in sorted(summary["kinds"].items())
        )
    )
    meta = summary.get("meta")
    if meta:  # first KIND_RUN_META event of the run
        lines.append(
            "  run: " + ", ".join(f"{k}={v}" for k, v in meta.items())
        )
    evals = summary.get("evals") or {}
    if evals.get("count"):  # KIND_EVAL rollup
        lines.append(
            f"  evals: {evals['count']} (last at step {evals['last_step']})"
        )
    bench = summary.get("bench") or {}
    if bench.get("count"):  # KIND_BENCH rollup
        wl = ", ".join(bench.get("workloads") or []) or "?"
        lines.append(f"  bench results: {bench['count']} ({wl})")
    if summary.get("bench_probes"):  # KIND_BENCH_PROBE rollup
        lines.append(f"  backend probes: {summary['bench_probes']}")
    if summary.get("trace_summaries"):  # KIND_TRACE_SUMMARY rollup
        lines.append(f"  trace summaries: {summary['trace_summaries']}")
    colls = summary.get("collectives")
    if colls and colls.get("total_bytes") is not None:
        comp = colls.get("wire_compression")
        lines.append(
            f"  collectives: {colls['total_bytes']:,} wire bytes/step"
            f" ({colls['total_logical_bytes']:,} logical"
            + (f", {comp:g}x compression" if comp else "") + ")"
        )
    if summary.get("health_events"):  # KIND_HEALTH rollup
        lines.append(
            "  health events: " + ", ".join(
                f"{k}={v}"
                for k, v in sorted(summary["health_events"].items())
            )
        )
    saves = summary.get("ckpt_saves") or {}
    if saves.get("count"):  # KIND_CKPT_SAVE rollup
        lines.append(
            "  checkpoint saves: {count} ({async_count} async), loop "
            "blocked {blocked:.0f} ms of {total:.0f} ms total "
            "(max {bmax:.0f}/{tmax:.0f} ms)".format(
                count=saves["count"], async_count=saves["async_count"],
                blocked=saves["blocked_ms_total"],
                total=saves["total_ms_total"],
                bmax=saves["blocked_ms_max"], tmax=saves["total_ms_max"],
            )
        )
    pipe = summary.get("pipeline")
    if pipe:  # KIND_PIPELINE rollup
        bits = [
            f"{pipe.get('schedule', '?')} "
            f"S={pipe.get('stages', '?')} M={pipe.get('microbatches', '?')}"
        ]
        if (pipe.get("virtual_stages") or 1) > 1:
            bits.append(f"v={pipe['virtual_stages']}")
        if pipe.get("bubble_frac") is not None:
            bits.append(f"bubble {float(pipe['bubble_frac']):.4f}")
        if pipe.get("peak_inflight") is not None:
            bits.append(f"residency {pipe['peak_inflight']:g} acts")
        if pipe.get("steady_examples_per_sec") is not None:
            bits.append(
                f"steady {float(pipe['steady_examples_per_sec']):.1f} ex/s")
        lines.append("  pipeline: " + ", ".join(bits))
    zero = summary.get("zero")
    if zero:  # KIND_ZERO_UPDATE rollup
        bits = [
            f"{zero.get('shards', '?')} shards, "
            f"{zero.get('buckets', '?')} buckets "
            f"({zero.get('bucket_mb', '?')} MiB, wire {zero.get('wire', '?')})"
        ]
        if zero.get("rs_wire_bytes") is not None:
            bits.append(
                f"RS {int(zero['rs_wire_bytes']):,} B + "
                f"AG {int(zero.get('ag_wire_bytes') or 0):,} B/step")
        if zero.get("overlap_frac_est") is not None:
            bits.append(
                f"overlap est {float(zero['overlap_frac_est']):.2f}"
                + (f" (~{float(zero['hidden_ms_est']):.2f} ms hidden)"
                   if zero.get("hidden_ms_est") is not None else ""))
        lines.append("  zero update sharding: " + ", ".join(bits))
    serve = summary.get("serve")
    if serve:  # KIND_SERVE_REQUEST / KIND_SERVE_BATCH rollup
        fill = (serve["batch_rows"] / serve["padded_rows"]
                if serve.get("padded_rows") else None)
        lines.append(
            f"  serving: {serve['requests']} requests ({serve['rows']} rows)"
            f" in {serve['batches']} batches"
            + (f", fill {fill:.2f}" if fill is not None else "")
            + f", queue depth max {serve['queue_depth_max']}"
        )
        lat = serve.get("latency")
        if lat and lat.get("p50_ms") is not None:  # KIND_SERVE_LATENCY
            rps = lat.get("requests_per_sec")
            lines.append(
                f"    latency: p50 {float(lat['p50_ms']):.1f} ms, "
                f"p90 {float(lat.get('p90_ms') or 0):.1f} ms, "
                f"p99 {float(lat['p99_ms']):.1f} ms over {lat.get('count')} "
                f"requests"
                + (f", {float(rps):.1f} req/s" if rps is not None else "")
            )
        if serve["queue_wait_ms_total"] or serve["compute_ms_total"]:
            lines.append(
                f"    queue wait {serve['queue_wait_ms_total']:.0f} ms vs "
                f"compute {serve['compute_ms_total']:.0f} ms (totals)"
            )
        if serve["recompiles"]:  # KIND_SERVE_RECOMPILE / KIND_SERVE_QUEUE
            buckets = ", ".join(
                str(r.get("bucket")) for r in serve["recompiles"])
            lines.append(
                f"    bucket recompiles: {len(serve['recompiles'])}"
                f" ({buckets})"
            )
    decode = summary.get("decode")
    if decode:  # KIND_DECODE_STEP rollup
        fill = (decode["tokens"] / decode["padded_rows"]
                if decode.get("padded_rows") else None)
        occ = (decode["occupancy_sum"] / decode["steps"]
               if decode["steps"] else None)
        per_tok = (decode["step_ms_total"] / decode["tokens"]
                   if decode["tokens"] else None)
        lines.append(
            f"  decode: {decode['tokens']} tokens in {decode['steps']} steps"
            + (f", fill {fill:.2f}" if fill is not None else "")
            + (f", occupancy {occ:.2f}" if occ is not None else "")
            + (f", {per_tok:.1f} ms/token" if per_tok is not None else "")
        )
        if decode["kv_samples"]:  # KIND_KV_CACHE rollup
            lines.append(
                f"    kv cache: peak {decode['pages_used_max']} pages in "
                f"use, evictions {decode['evictions']}, waiting max "
                f"{decode['streams_waiting_max']} "
                f"({decode['kv_samples']} samples)"
            )
    fleet = summary.get("fleet")
    if fleet:  # KIND_SERVE_ROUTE / KIND_SERVE_EJECT / KIND_SERVE_RELOAD
        routed = ", ".join(
            f"{r}={n}" for r, n in sorted(fleet["routed"].items()))
        lines.append(
            f"  fleet: {fleet['requests']} proxied"
            + (f" ({routed})" if routed else "")
            + f", retries {fleet['retries']}, shed {fleet['shed']}"
            + (f", deadline misses {fleet['deadline_exceeded']}"
               if fleet["deadline_exceeded"] else "")
            + (f", skew {float(fleet['skew']):.2f}"
               if fleet.get("skew") is not None else "")
        )
        if fleet["ejects"] or fleet["readmits"] or fleet["restarts"]:
            ej = ", ".join(
                f"{e.get('replica')}:{e.get('reason')}"
                for e in fleet["ejects"])
            lines.append(
                f"    ejections: {len(fleet['ejects'])}"
                + (f" ({ej})" if ej else "")
                + f", readmits {fleet['readmits']}"
                f", restarts {fleet['restarts']}"
            )
        for r in fleet["reloads"]:  # timeline, one line per replica step
            ms = r.get("reload_ms")
            lines.append(
                f"    reload {r.get('replica')}: "
                f"{str(r.get('from_digest'))[:8]}"
                f" -> {str(r.get('to_digest'))[:8]} "
                + ("ok" if r.get("ok") else "REJECTED")
                + (f" in {float(ms):.0f} ms" if ms is not None else "")
            )
        scaling = fleet.get("scaling") or {}
        if scaling.get("events"):  # KIND_SCALE rollup (serve/autoscale.py)
            timeline = ", ".join(
                f"{e.get('action')}->{e.get('to_replicas')}"
                + (f"@{float(e['pressure']):.2f}"
                   if e.get("pressure") is not None else "")
                for e in scaling["events"])
            lines.append(
                f"    scaling: {scaling.get('ups', 0)} up / "
                f"{scaling.get('downs', 0)} down ({timeline})"
            )
        # KIND_ADMISSION rollup: one ledger line per tenant, best class
        # first so the shed ordering is legible at a glance.
        for tenant, led in sorted((fleet.get("tenants") or {}).items()):
            lat = led.get("latency_ms") or {}
            lines.append(
                f"    tenant {tenant}: routed {led['routed']}"
                f", shed {led['shed']}"
                f", quota_rejected {led['quota_rejected']}"
                + (f", p50/p90/p99 {lat['p50']}/{lat['p90']}/{lat['p99']} ms"
                   if lat else "")
            )
    data = summary.get("data")
    if data:  # KIND_DATA_SHARD rollup (data/shard.py shard_plan)
        sh = data.get("shard")
        if sh:
            lines.append(
                f"  data shard: host {sh.get('process_index')}/"
                f"{sh.get('process_count')} reads "
                f"{sh.get('host_batch')} of {sh.get('global_batch')} "
                f"rows/batch ({sh.get('shard_mode', '?')} mode)"
            )
        pk = data.get("packing")
        if pk and pk.get("real_tokens") is not None:  # KIND_DATA_PACKING rollup
            eff = pk.get("packing_efficiency")
            lines.append(
                f"  packing: {int(pk['real_tokens']):,} real / "
                f"{int(pk.get('padded_tokens') or 0):,} padded tokens"
                + (f", efficiency {float(eff):.3f}" if eff is not None else "")
            )
    gp = summary.get("goodput")
    if gp:  # KIND_GOODPUT rollup (per-attempt ledgers summed)
        frac = gp.get("goodput_frac")
        lines.append(
            f"  goodput: "
            + (f"{100.0 * float(frac):.1f}%" if frac is not None else "?")
            + f" of {float(gp.get('wall_s') or 0):.1f} s wall over "
            f"{gp.get('attempts')} attempt(s)"
        )
        buckets = sorted((gp.get("buckets") or {}).items(),
                         key=lambda kv: -kv[1])
        if buckets:
            lines.append("    buckets: " + ", ".join(
                f"{b} {s:.1f}s" for b, s in buckets))
    spans = summary.get("spans")
    if spans:  # KIND_SPAN rollup (core/tracing.py trace spans)
        svcs = ", ".join(
            f"{k}={v}" for k, v in sorted(spans.get("services", {}).items()))
        lines.append(
            f"  spans: {spans['count']} across {spans['traces']} trace(s)"
            + (f" [{svcs}]" if svcs else "")
            + (f", {spans['errors']} error(s)" if spans.get("errors") else "")
        )
    at = summary.get("autotune")
    if at:  # KIND_AUTOTUNE_TRIAL rollup (the autotuner's trial ledger)
        lines.append(
            f"  autotune: {at['ran']} ran / {at['pruned']} pruned / "
            f"{at['failed']} failed"
            + (f", {at['window_aborts']} window abort(s)"
               if at.get("window_aborts") else "")
        )
        best = at.get("best")
        if best:
            lines.append(
                f"    best: {best.get('trial')} score {best.get('score')}"
                + (f" {best['unit']}" if best.get("unit") else "")
            )
    mem = summary.get("memory")
    if mem:  # KIND_MEMORY rollup
        srcs = ", ".join(
            f"{k}={v}" for k, v in sorted(mem.get("sources", {}).items()))
        peak = mem.get("peak_bytes_in_use")
        lines.append(
            f"  memory: {mem['samples']} sample(s)"
            + (f", peak {fmt_bytes(peak)}/chip in use" if peak else "")
            + (f" [{srcs}]" if srcs else "")
        )
        ana = mem.get("analysis")
        if ana:
            lines.append(
                "    compiled step: args {a} + temps {t} + output {o}"
                " (+ code {c})".format(
                    a=fmt_bytes(ana.get("argument_bytes")),
                    t=fmt_bytes(ana.get("temp_bytes")),
                    o=fmt_bytes(ana.get("output_bytes")),
                    c=fmt_bytes(ana.get("generated_code_bytes")),
                )
            )
    for s in summary.get("startups") or []:  # KIND_STARTUP rollup
        t = s.get("time_to_first_step_s")
        t_str = f"{t:.1f}s" if isinstance(t, (int, float)) else "?"
        lines.append(
            f"  startup: {t_str} to first step"
            + (f" (restored step {s['restored_step']})"
               if s.get("restored_step") is not None else " (fresh)")
        )
    rec = summary["recovery"]
    activity = (
        rec["quarantined"] or rec["restore_fallbacks"]
        or rec["supervisor_attempts"] or rec["graceful_preemptions"]
        or rec["failures"] or rec["crash_loop"]
        or rec.get("anomalies") or rec.get("rollbacks")
        or rec.get("batches_skipped") or rec.get("infeed_stalls")
        or rec.get("mesh_resizes") or rec.get("ckpt_reshards")
        or rec.get("data_restores")
    )
    if not activity:
        lines.append("  recovery activity: none")
        return "\n".join(lines)
    lines.append("  recovery activity:")
    for a in rec.get("anomalies") or []:  # KIND_ANOMALY rollup
        lines.append(
            f"    anomaly at step {a.get('step')}: "
            f"{a.get('anomaly', 'unknown')} ({a.get('metric')})"
        )
    for r in rec.get("rollbacks") or []:  # KIND_ROLLBACK rollup
        lines.append(
            f"    rollback: step {r['from_step']} -> {r['to_step']}"
        )
    if rec.get("batches_skipped"):  # KIND_BATCH_SKIPPED rollup
        lines.append(f"    batches skipped: {rec['batches_skipped']}")
    if rec.get("infeed_stalls"):  # KIND_INFEED_STALL rollup
        lines.append(f"    infeed stalls retried: {rec['infeed_stalls']}")
    for m in rec.get("mesh_resizes") or []:  # KIND_MESH_RESIZED
        lines.append(
            f"    mesh resized: {_fmt_axes(m.get('from_axes'))} -> "
            f"{_fmt_axes(m.get('to_axes'))} "
            f"({m.get('visible_devices', '?')} devices visible)"
        )
    for r in rec.get("ckpt_reshards") or []:  # KIND_CKPT_RESHARDED
        lines.append(
            f"    checkpoint resharded at step {r.get('step')}: "
            f"{_fmt_axes(r.get('from_axes'))} -> {_fmt_axes(r.get('to_axes'))}"
            f" ({r.get('leaf_count', '?')} leaves)"
        )
    for d in rec.get("data_restores") or []:  # KIND_DATA_STATE rollup
        action = d.get("action") or "resume"
        refit = (f" across {d['from_processes']} -> {d['to_processes']} hosts"
                 if d.get("from_processes") != d.get("to_processes") else "")
        lines.append(
            f"    data state restored at step {d.get('step')}: "
            f"{action}{refit}"
            + (f" (watermark {d['watermark']})"
               if d.get("watermark") else "")
        )
    for q in rec["quarantined"]:  # KIND_CKPT_QUARANTINED rollup
        lines.append(
            f"    quarantined checkpoint step {q['step']} ({q['reason']})"
        )
    for f in rec["restore_fallbacks"]:  # KIND_RESTORE_FALLBACK rollup
        lines.append(
            f"    restore fell back: step {f['from_step']} -> {f['to_step']}"
        )
    if rec["supervisor_attempts"]:  # KIND_SUPERVISOR_ATTEMPT rollup
        lines.append(
            "    supervisor attempts: " + ", ".join(
                f"{k}={v}"
                for k, v in sorted(rec["supervisor_attempts"].items())
            )
        )
    if rec["graceful_preemptions"]:
        lines.append(
            f"    graceful preemptions: {rec['graceful_preemptions']}"
        )
    for f in rec["failures"]:  # KIND_FAILURE rollup
        lines.append(f"    failure at step {f.get('step')}: "
                     f"{f.get('failure', 'unknown')}")
    if rec["crash_loop"]:  # KIND_CRASH_LOOP rollup
        lines.append(f"    CRASH LOOP: {json.dumps(rec['crash_loop'])}")
    return "\n".join(lines)
