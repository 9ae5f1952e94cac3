"""Goodput ledger: classify every wall-clock second of a training run.

The port's copy of ``core/goodput.py``, the same buckets, counters,
events and stitching. A step's throughput describes only the seconds the
card was stepping; once rollbacks, infeed stalls, checkpoint-blocked time
and relaunches are in play, a run's goodput (the fraction of wall-clock
that became training progress) can be far below it. This module is the
accountant:

  * ``GoodputLedger`` lives in the Trainer, absorbs ``StepTimer`` phase
    totals (core/profiling.py) each metrics fetch, listens on the
    ``TelemetryWriter`` for ``ckpt_save`` blocked-ms emitted from the
    async saver thread, and classifies everything else by explicit
    ``add()``/``timed()`` calls. It emits periodic ``KIND_GOODPUT``
    events plus a ``final=True`` rollup at loop exit.
  * ``stitch_attempts`` joins the per-attempt ledgers of a supervised
    run (one ``run_id`` per process) into one cross-attempt table whose
    buckets — including the restart gaps BETWEEN attempts, classified
    from the sibling ``supervisor_events.jsonl`` — sum to the measured
    wall-clock span. Gang runs add a dimension: each worker's stream
    (``events.jsonl`` / ``events-p<i>.jsonl``) carries ``process_id``
    on its goodput events, and stitching a list of streams groups
    attempts by (run id, process id) into a ``per_host`` section whose
    every host-table still sums to that host's own measured span.
    ``format_goodput_table`` renders it (scripts/analyze_trace.py
    prints it per run directory).

Bucket definitions (seconds of host wall time; docs/OBSERVABILITY.md):

  step_compute   dispatch + backpressure phases: the loop was driving
                 the device (the PRODUCTIVE bucket)
  recompile      the first dispatch (in the port: the kernels' build
                 at first use) and the dispatch after a rollback
  infeed_wait    blocking on ``next(batch)`` — includes infeed-watchdog
                 retry sleeps, which fire inside the infeed phase
  metrics_fetch  device→host fetch of logged metrics
  ckpt_blocked   training thread blocked inside save() (joined from
                 ``ckpt_save`` events' ``ckpt_save_blocked_ms``)
  rollback       anomaly handling: snapshot restore + LR-rewarmup
                 rebuild inside ``_maybe_recover``
  startup        trainer construction → first loop iteration (restore +
                 input build; the first compile lands in ``recompile``)
  other          residual: wall since ledger start minus every bucket
                 above (hooks, logging, eval, exit barrier)
  restart_gap    stitch-time only: wall between one attempt's last
                 ledger event and the next attempt's start
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Iterator, Mapping

from distributed_tensorflow_framework_torch.core import telemetry

# StepTimer phase name -> ledger bucket.
PHASE_BUCKETS = {
    "dispatch": "step_compute",
    "backpressure": "step_compute",
    "compile": "recompile",
    "infeed": "infeed_wait",
    "metrics_fetch": "metrics_fetch",
}

PRODUCTIVE_BUCKETS = ("step_compute",)

# Display order for tables; unknown buckets append after these.
BUCKET_ORDER = (
    "step_compute", "recompile", "infeed_wait", "metrics_fetch",
    "ckpt_blocked", "rollback", "startup", "other", "restart_gap",
)


class GoodputLedger:
    """Per-process wall-clock accountant feeding ``KIND_GOODPUT``.

    Thread-safe: ``ckpt_save`` observations arrive from the async saver
    thread while the training thread absorbs phases. The ledger's clock
    starts at construction, or at ``t0_perf`` when given — the Trainer
    passes its ``__init__``-entry timestamp so the runtime/dataset build
    that precedes the telemetry writer's existence is INSIDE the
    ledger's wall (the ``startup`` bucket charges exactly that span;
    without the backdate those seconds would overflow the wall and the
    residual ``other`` would clamp dishonestly at zero).
    """

    def __init__(self, writer: telemetry.TelemetryWriter | None = None,
                 *, interval_s: float = 30.0, t0_perf: float | None = None,
                 process_id: int | None = None):
        self._writer = writer
        self._interval_s = float(interval_s)
        # Gang runs stamp the owning process id on every KIND_GOODPUT
        # event so stitch_attempts can group per host without joining
        # run_meta across files; single-process runs leave it off.
        self._process_id = process_id
        self._lock = threading.Lock()
        now = time.perf_counter()
        self._t0 = now if t0_perf is None else float(t0_perf)
        self.t0_wall = time.time() - (now - self._t0)
        self._buckets: dict[str, float] = {}
        self._counters: dict[str, int] = {}
        self._last_emit = self._t0
        if writer is not None:
            writer.add_listener(self._observe)

    # -- accumulation ----------------------------------------------------

    @property
    def wall_s(self) -> float:
        return time.perf_counter() - self._t0

    def add(self, bucket: str, seconds: float) -> None:
        if seconds <= 0.0:
            return
        with self._lock:
            self._buckets[bucket] = self._buckets.get(bucket, 0.0) + seconds

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    @contextlib.contextmanager
    def timed(self, bucket: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(bucket, time.perf_counter() - t0)

    def absorb_phases(self, totals: Mapping[str, float]) -> None:
        """Fold a ``StepTimer.totals`` dict in (call BEFORE its reset).

        Unknown phase names land in their own bucket rather than being
        dropped — a new phase must never silently vanish from the
        accounting.
        """
        for phase, seconds in totals.items():
            self.add(PHASE_BUCKETS.get(phase, phase), float(seconds))

    def _observe(self, ev: Mapping[str, Any]) -> None:
        """TelemetryWriter listener: join sibling streams in-process."""
        kind = ev.get("kind")
        if kind == telemetry.KIND_CKPT_SAVE:
            m = ev.get("metrics") or {}
            self.add("ckpt_blocked",
                     float(m.get("ckpt_save_blocked_ms", 0.0)) / 1e3)
            self.count("ckpt_saves")
        elif kind == telemetry.KIND_INFEED_STALL:
            # Stall time is already inside infeed_wait (the watchdog
            # retries within the infeed phase); only tally the incident.
            self.count("infeed_stalls")
        elif kind == telemetry.KIND_ROLLBACK:
            self.count("rollbacks")
        elif kind == telemetry.KIND_BATCH_SKIPPED:
            self.count("batches_skipped",
                       int((ev.get("health") or {}).get("batches", 1) or 1))
        elif kind == telemetry.KIND_SERVE_RECOMPILE:
            m = ev.get("metrics") or {}
            self.add("recompile", float(m.get("compile_ms", 0.0)) / 1e3)
            self.count("recompiles")
        elif kind == telemetry.KIND_DATA_STATE:
            # Restore-gate verdicts (data/shard.py): how many times this
            # attempt resumed a saved data stream, and how many of those
            # were N→M repartitions — the restart classification the
            # stitched cross-attempt ledger rolls up.
            self.count("data_restores")
            plan = (ev.get("extra") or {}).get("plan") or {}
            if plan.get("action") == "repartition":
                self.count("data_repartitions")

    # -- snapshots & emission --------------------------------------------

    def snapshot(self) -> dict:
        """Point-in-time ledger: buckets + residual ``other`` summing to
        ``wall_s``, and the productive fraction of that wall."""
        with self._lock:
            buckets = dict(self._buckets)
            counters = dict(self._counters)
        wall = self.wall_s
        other = wall - sum(buckets.values())
        buckets["other"] = max(0.0, other)
        productive = sum(buckets.get(b, 0.0) for b in PRODUCTIVE_BUCKETS)
        return {
            "wall_s": wall,
            "goodput_frac": (productive / wall) if wall > 0 else 0.0,
            "buckets": {b: round(s, 4) for b, s in buckets.items()},
            "counters": counters,
        }

    def _emit(self, step: int | None, final: bool) -> dict | None:
        if self._writer is None:
            return None
        snap = self.snapshot()
        extra: dict[str, Any] = {}
        if self._process_id is not None:
            extra["process_id"] = self._process_id
        return self._writer.emit(
            telemetry.KIND_GOODPUT,
            step=step,
            metrics={"wall_s": round(snap["wall_s"], 4),
                     "goodput_frac": round(snap["goodput_frac"], 4)},
            buckets=snap["buckets"],
            counters=snap["counters"],
            t0=self.t0_wall,
            final=final,
            **extra,
        )

    def maybe_emit(self, step: int | None = None) -> dict | None:
        """Periodic cumulative snapshot — cheap enough for every metrics
        fetch; a SIGKILLed attempt's last one is its ledger of record."""
        now = time.perf_counter()
        if now - self._last_emit < self._interval_s:
            return None
        self._last_emit = now
        return self._emit(step, final=False)

    def finalize(self, step: int | None = None) -> dict | None:
        """End-of-run rollup (``final=True`` supersedes periodic ones)."""
        return self._emit(step, final=True)


# -- cross-attempt stitching (read side) ---------------------------------


def _stitch_host(attempts: list[dict], classifications: list[str]) -> dict:
    """Stitch ONE host's time-ordered attempts: sum buckets/counters,
    classify the restart gaps between coverage windows, and close the
    books so buckets (gaps included) sum to that host's measured span."""
    buckets: dict[str, float] = {}
    counters: dict[str, int] = {}
    gaps: list[dict] = []
    for i, att in enumerate(attempts):
        for b, s in att["buckets"].items():
            buckets[b] = buckets.get(b, 0.0) + float(s)
        for c, n in att["counters"].items():
            counters[c] = counters.get(c, 0) + int(n)
        if i + 1 < len(attempts):
            gap = attempts[i + 1]["t0"] - (att["t0"] + att["wall_s"])
            cls = (classifications[i] if i < len(classifications)
                   else "unknown")
            gaps.append({"after_attempt": i + 1, "seconds": max(0.0, gap),
                         "classification": cls})
    restart_gap = sum(g["seconds"] for g in gaps)
    if restart_gap:
        buckets["restart_gap"] = restart_gap
    span = sum(a["wall_s"] for a in attempts) + restart_gap
    productive = sum(buckets.get(b, 0.0) for b in PRODUCTIVE_BUCKETS)
    return {
        "attempts": [
            {"run_id": a["run_id"], "wall_s": a["wall_s"],
             "goodput_frac": a["goodput_frac"], "final": a["final"]}
            for a in attempts
        ],
        "wall_s": span,
        "buckets": buckets,
        "counters": counters,
        "restart_gaps": gaps,
        "goodput_frac": (productive / span) if span > 0 else 0.0,
    }


def stitch_attempts(events_path,
                    supervisor_path: str | None = None) -> dict | None:
    """Join per-attempt ``KIND_GOODPUT`` ledgers into one run table.

    Each supervised attempt is a separate process with its own run_id
    and ledger; its last (preferably final) goodput event covers the
    interval ``[t0, t0 + wall_s]``. The wall between one attempt's
    coverage end and the next attempt's ``t0`` is the ``restart_gap`` —
    supervisor backoff + relaunch + the next process's pre-ledger
    import time — classified, when ``supervisor_events.jsonl`` sits
    next to the (first) events file, by the exit classification of the
    attempt that ended each gap.

    ``events_path`` may be a single path or a list of per-worker
    streams from a gang run (``events.jsonl`` plus the non-chief
    workers' ``events-p<i>.jsonl``). Snapshots are grouped by (run id,
    ``process_id`` extra); with more than one host the result gains a
    ``per_host`` section — one stitched table per process id, each
    summing to its OWN measured span, all sharing the gang-level gap
    classifications — while the top-level table stays the chief's
    timeline (host 0), keeping the single-stream shape. Returns None
    when no stream has goodput events (e.g. a serve log).
    """
    paths = [events_path] if isinstance(events_path, str) else list(events_path)
    if not paths:
        return None
    by_key: dict[tuple[int, str], dict] = {}
    for path in paths:
        for ev in telemetry.read_events(
                path, kind=telemetry.KIND_GOODPUT, strict=False):
            extra = ev.get("extra") or {}
            m = ev.get("metrics") or {}
            host = int(extra.get("process_id") or 0)
            snap = {
                "run_id": ev.get("run_id"),
                "process_id": host,
                "t0": float(extra.get("t0") or ev.get("t") or 0.0),
                "wall_s": float(m.get("wall_s") or 0.0),
                "goodput_frac": m.get("goodput_frac"),
                "buckets": dict(extra.get("buckets") or {}),
                "counters": dict(extra.get("counters") or {}),
                "final": bool(extra.get("final")),
            }
            key = (host, snap["run_id"])
            prev = by_key.get(key)
            if prev is None or not prev["final"] or snap["final"]:
                by_key[key] = snap
    if not by_key:
        return None

    classifications: list[str] = []
    if supervisor_path is None:
        supervisor_path = os.path.join(
            os.path.dirname(os.path.abspath(paths[0])),
            "supervisor_events.jsonl")
    if os.path.exists(supervisor_path):
        for ev in telemetry.read_events(
                supervisor_path, kind=telemetry.KIND_SUPERVISOR_ATTEMPT,
                strict=False):
            classifications.append(
                str((ev.get("extra") or {}).get("classification", "unknown")))

    by_host: dict[int, list[dict]] = {}
    for snap in by_key.values():
        by_host.setdefault(snap["process_id"], []).append(snap)
    stitched = {
        host: _stitch_host(sorted(atts, key=lambda s: s["t0"]),
                           classifications)
        for host, atts in by_host.items()
    }
    # The chief's timeline is the run's timeline: its attempts bound the
    # span the supervisor actually managed.
    primary = stitched[min(stitched)]
    out = dict(primary)
    out["supervisor_events"] = (supervisor_path
                                if os.path.exists(supervisor_path) else None)
    if len(stitched) > 1:
        out["per_host"] = {
            str(host): stitched[host] for host in sorted(stitched)
        }
    return out


def format_goodput_table(g: Mapping[str, Any]) -> str:
    """Render a stitched ledger: one row per bucket, % of measured wall
    (rows sum to ~100% by construction — ``other`` is the residual)."""
    span = float(g.get("wall_s") or 0.0)
    buckets = dict(g.get("buckets") or {})
    ordered = [b for b in BUCKET_ORDER if b in buckets]
    ordered += sorted(b for b in buckets if b not in BUCKET_ORDER)
    n_att = len(g.get("attempts") or [])
    lines = [
        f"goodput ledger: {n_att} attempt(s), "
        f"{span:.1f} s measured wall-clock",
        f"  {'bucket':<14} {'seconds':>10} {'%':>7}",
    ]
    for b in ordered:
        s = float(buckets[b])
        pct = 100.0 * s / span if span > 0 else 0.0
        lines.append(f"  {b:<14} {s:>10.2f} {pct:>6.1f}%")
    total = sum(float(buckets[b]) for b in ordered)
    total_pct = 100.0 * total / span if span > 0 else 0.0
    lines.append(f"  {'TOTAL':<14} {total:>10.2f} {total_pct:>6.1f}%")
    frac = g.get("goodput_frac")
    if frac is not None:
        lines.append(
            f"  goodput: {100.0 * float(frac):.1f}% of wall-clock was "
            f"productive step compute")
    for gap in g.get("restart_gaps") or []:
        lines.append(
            f"  restart gap after attempt {gap['after_attempt']}: "
            f"{gap['seconds']:.1f} s ({gap['classification']})")
    per_host = g.get("per_host") or {}
    for host in sorted(per_host, key=lambda h: int(h)):
        h = per_host[host]
        hf = h.get("goodput_frac")
        hg = sum(x["seconds"] for x in h.get("restart_gaps") or [])
        lines.append(
            f"  host {host}: {float(h.get('wall_s') or 0.0):.1f} s span, "
            f"{100.0 * float(hf or 0.0):.1f}% goodput, "
            f"{len(h.get('attempts') or [])} attempt(s), "
            f"{hg:.1f} s restart gap")
    return "\n".join(lines)
