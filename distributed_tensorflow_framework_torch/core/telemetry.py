"""Structured telemetry: the ``dtf-telemetry/1`` JSONL event schema.

The port's copy of the writer half of ``core/telemetry.py``: the same
schema string, reserved fields, event kinds and record shape, so
``scripts/analyze_trace.py`` reads the port's ``events.jsonl`` unchanged.
Only the kinds the port emits so far are defined here: the serve kinds;
the train-step, eval, failure, health, run-meta, startup and data-shard
kinds of the trainer; the checkpoint kinds (save, quarantine, restore
fallback, data state); the recovery-ladder kinds (anomaly, rollback,
skipped batches, infeed stall); the packing census; the ZeRO plan
(``zero_update``); and the live reload and the decode engine's step and
KV-pool gauges. The summary rollup of
``summarize_events`` is ROADMAP.md queue A item A16.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import uuid
from typing import Any, Mapping

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


class TelemetryWriter:
    """Append-only, line-buffered JSONL sink for schema events.

    ``path=None`` gives a no-op writer (``emit`` still returns the record).
    Thread-safe: the engine's batcher and reporter threads both emit; a
    lock around the append keeps every JSONL line whole.
    """

    def __init__(self, path: str | None, *, run_id: str | None = None,
                 process_id: int | None = None):
        self.run_id = run_id or make_run_id()
        # The rank, on every event of a gang of more than one.
        self.process_id = process_id
        self._fh = None
        self._lock = threading.Lock()
        self.path = path
        if not path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", buffering=1)

    def emit(self, kind: str, **fields: Any) -> dict:
        """Build + append one event; returns the record."""
        if self.process_id is not None:
            fields.setdefault("process_id", self.process_id)
        ev = make_event(kind, run_id=self.run_id, **fields)
        line = json.dumps(ev, default=str) + "\n"
        with self._lock:
            if self._fh is not None:
                self._fh.write(line)
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

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
