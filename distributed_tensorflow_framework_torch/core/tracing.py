"""Distributed tracing and the flight recorder: the port's copy of
``core/tracing.py`` (stdlib only).

* **Spans** — ``(trace_id, span_id, parent_id)`` with wall and monotonic
  timestamps, emitted as ``KIND_SPAN`` telemetry events through the
  ordinary writer. ``Tracer.start(...)`` → ``Span.end(...)``; work
  measured before tracing (the engine's batch timestamps) is backfilled
  with ``Tracer.emit_span`` from raw monotonic readings.

* **Context propagation** — ``SpanContext`` encodes to the
  ``X-DTF-Trace`` HTTP header (client → server → engine) and the
  ``DTF_TRACE_CTX`` environment variable (a launcher → a worker), so a
  request or a supervised attempt hangs off one root span across
  processes. A malformed context parses to None (``safe_parse``) and the
  work runs untraced.

* **Clock model** — a process derives span wall times from one pair
  ``(wall0, mono0)`` sampled when its tracer is built. A context carries
  ``sent_at``, the sender's root-frame time at propagation, and
  ``Tracer.adopt`` estimates ``offset_s = local_now - sent_at`` (skew
  plus transmission delay). Spans carry the estimate; the JAX package's
  ``scripts/analyze_trace.py --spans`` subtracts it and clamps children
  into their parent's window. ``DTF_TRACE_SKEW_S`` injects a wall skew
  for tests of this model.

* **Flight recorder** — a bounded ring of recent telemetry events per
  process, attached as a ``TelemetryWriter`` listener. On a persistent
  anomaly, a graceful preemption or SIGUSR1 it dumps
  ``flightrec-<pid>.json`` (``dtf-flightrec/1``) with the ring and every
  still-open span.

The span names, event fields and dump keys are the JAX package's, so its
readers take the port's streams as they are.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import tempfile
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any

from distributed_tensorflow_framework_torch.core import telemetry

log = logging.getLogger("dtf_torch.tracing")

#: HTTP header carrying a serialized SpanContext (fleet → server → engine).
TRACE_HEADER = "X-DTF-Trace"
#: Env var carrying a serialized SpanContext (supervisor → worker).
TRACE_CTX_ENV = "DTF_TRACE_CTX"
#: Default directory for flight-recorder dumps + drill trace artifacts.
TRACE_DIR_ENV = "DTF_TRACE_DIR"
#: Injected wall-clock skew in seconds (clock-model tests only).
TRACE_SKEW_ENV = "DTF_TRACE_SKEW_S"

FLIGHTREC_SCHEMA = "dtf-flightrec/1"


class TraceContextError(ValueError):
    """A serialized trace context (header or env value) failed to parse.

    Raised by ``SpanContext.parse``; propagation call sites catch it (or
    use ``safe_parse``) and continue untraced — a malformed header must
    never fail the request it rode in on.
    """


def _new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def _new_span_id() -> str:
    return uuid.uuid4().hex[:8]


@dataclass(frozen=True)
class SpanContext:
    """The cross-process handle to a span: ids + a send-time clock sample.

    ``span_id`` may be ``""`` for a context that names a trace but no
    emitting span (a pure client like scripts/load_gen.py): spans adopted
    from such a context become roots of the reconstructed tree.
    ``sent_at`` is the sender's estimate of ROOT-frame wall seconds at
    propagation time — the receiving tracer's offset estimator needs it.
    """

    trace_id: str
    span_id: str = ""
    sent_at: float = 0.0

    def encode(self) -> str:
        return f"{self.trace_id}:{self.span_id}:{self.sent_at:.6f}"

    @classmethod
    def parse(cls, value: str) -> "SpanContext":
        parts = (value or "").strip().split(":")
        if len(parts) != 3 or not parts[0]:
            raise TraceContextError(
                f"trace context {value!r} is not 'trace_id:span_id:sent_at'")
        try:
            sent_at = float(parts[2])
        except ValueError as e:
            raise TraceContextError(
                f"trace context {value!r} has a non-numeric sent_at") from e
        return cls(trace_id=parts[0], span_id=parts[1], sent_at=sent_at)


def safe_parse(value: str | None) -> SpanContext | None:
    """``SpanContext.parse`` that answers None for missing/bad contexts."""
    if not value:
        return None
    try:
        return SpanContext.parse(value)
    except TraceContextError:
        log.warning("ignoring malformed trace context %r", value)
        return None


def fresh_context(now: float | None = None) -> SpanContext:
    """A brand-new trace with no emitting span — the pure-client root
    (scripts/load_gen.py stamps one per request)."""
    return SpanContext(
        trace_id=_new_trace_id(), span_id="",
        sent_at=time.time() if now is None else now)


def env_context(environ=None) -> SpanContext | None:
    """The DTF_TRACE_CTX context of this process, if a supervisor set one."""
    env = os.environ if environ is None else environ
    return safe_parse(env.get(TRACE_CTX_ENV))


class Span:
    """One in-flight span; ``end()`` emits it as a KIND_SPAN event."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "t0_mono", "attrs", "ended")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: str | None, name: str, t0_mono: float,
                 attrs: dict):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0_mono = t0_mono
        self.attrs = attrs
        self.ended = False

    def context(self) -> SpanContext:
        """Propagation handle for children of this span (header/env)."""
        return SpanContext(
            trace_id=self.trace_id, span_id=self.span_id,
            sent_at=self.tracer.root_frame_now())

    def end(self, status: str = "ok", **attrs: Any) -> dict:
        if self.ended:  # idempotent: crash paths may race the normal end
            return {}
        self.ended = True
        self.attrs.update(attrs)
        return self.tracer._emit(
            self, end_mono=time.monotonic(), status=status)

    def snapshot(self) -> dict:
        """Open-span record for flight-recorder dumps (never emitted)."""
        return {
            "trace": self.trace_id, "span": self.span_id,
            "parent": self.parent_id, "name": self.name,
            "service": self.tracer.service,
            "t_start": self.tracer.wall_of(self.t0_mono),
            "offset_s": self.tracer.offset_s,
            "attrs": dict(self.attrs), "open": True,
        }


class Tracer:
    """Per-process span factory bound to one TelemetryWriter.

    Span wall times derive from the construction-time ``(wall0, mono0)``
    pair (see module docstring); ``adopt()`` folds an incoming context
    into the per-process ``offset_s`` estimate that every emitted span
    carries for the analyzer's cross-stream stitching.
    """

    def __init__(self, writer: telemetry.TelemetryWriter | None = None,
                 *, service: str = "proc", skew_s: float | None = None):
        self.writer = writer
        self.service = service
        if skew_s is None:
            try:
                skew_s = float(os.environ.get(TRACE_SKEW_ENV, "0") or 0)
            except ValueError:
                skew_s = 0.0
        self.skew_s = skew_s
        self.mono0 = time.monotonic()
        self.wall0 = time.time() + skew_s
        self.offset_s = 0.0
        self._lock = threading.Lock()
        self._open: dict[str, Span] = {}

    # ------------------------------------------------------------- clock --
    def wall_of(self, mono: float) -> float:
        """This process's wall-clock reading for a monotonic instant."""
        return self.wall0 + (mono - self.mono0)

    def now(self) -> float:
        return self.wall_of(time.monotonic())

    def root_frame_now(self) -> float:
        """Local now mapped into the trace root's clock frame."""
        return self.now() - self.offset_s

    def adopt(self, ctx: SpanContext | None) -> None:
        """Estimate this process's clock offset from an incoming context:
        ``offset_s = local_now - ctx.sent_at`` (skew + transmission
        delay). Call it as close to receipt as possible — for HTTP the
        delay term is sub-millisecond; for env propagation it includes
        process startup and the analyzer's causal clamp absorbs it."""
        if ctx is None or not ctx.sent_at:
            return
        self.offset_s = self.now() - ctx.sent_at

    # ------------------------------------------------------------- spans --
    def start(self, name: str,
              parent: "Span | SpanContext | None" = None,
              **attrs: Any) -> Span:
        """Open a span. ``parent`` may be a local Span, a propagated
        SpanContext, or None (a fresh root trace)."""
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif isinstance(parent, SpanContext):
            trace_id = parent.trace_id
            parent_id = parent.span_id or None
        else:
            trace_id, parent_id = _new_trace_id(), None
        span = Span(self, trace_id, _new_span_id(), parent_id, name,
                    time.monotonic(), dict(attrs))
        with self._lock:
            self._open[span.span_id] = span
        return span

    def emit_span(self, name: str,
                  parent: "Span | SpanContext | None" = None, *,
                  start_mono: float, end_mono: float,
                  status: str = "ok", **attrs: Any) -> dict:
        """Backfill a span from raw monotonic readings already taken —
        the engine's enqueue/batch-form/compute timestamps predate
        tracing and are reused rather than re-measured."""
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif isinstance(parent, SpanContext):
            trace_id = parent.trace_id
            parent_id = parent.span_id or None
        else:
            trace_id, parent_id = _new_trace_id(), None
        span = Span(self, trace_id, _new_span_id(), parent_id, name,
                    start_mono, dict(attrs))
        span.ended = True
        return self._emit(span, end_mono=end_mono, status=status,
                          track=False)

    def open_spans(self) -> list[dict]:
        """Snapshots of every span started but not yet ended — the
        flight recorder includes them so a dump taken mid-request still
        shows the fault's ancestors."""
        with self._lock:
            return [s.snapshot() for s in self._open.values()]

    def _emit(self, span: Span, *, end_mono: float, status: str,
              track: bool = True) -> dict:
        if track:
            with self._lock:
                self._open.pop(span.span_id, None)
        t_start = self.wall_of(span.t0_mono)
        dur_ms = max(0.0, (end_mono - span.t0_mono) * 1e3)
        if self.writer is None:
            return {}
        return self.writer.emit(
            telemetry.KIND_SPAN,
            t=self.wall_of(end_mono),
            metrics={"dur_ms": dur_ms},
            trace=span.trace_id, span=span.span_id,
            parent=span.parent_id, name=span.name,
            service=self.service, status=status,
            t_start=t_start, offset_s=self.offset_s,
            attrs=span.attrs or None,
        )


class FlightRecorder:
    """Bounded in-memory ring of recent telemetry events (spans included).

    Attach with ``writer.add_listener(recorder.record)`` (or
    ``recorder.attach(writer)``); ``dump()`` writes the ring — plus any
    still-open spans the caller hands over — to ``flightrec-<pid>.json``
    so the fault's causal neighborhood survives even when the process is
    about to be SIGKILLed or its JSONL is torn.

    Triggers wired in the port: the trainer's anomaly escalation and
    graceful preemption (train/loop.py), and SIGUSR1 on demand in the
    trainer and the serving replica (cli/serve.py).
    """

    def __init__(self, capacity: int = 512, *, dump_dir: str | None = None,
                 tracer: Tracer | None = None):
        if capacity < 1:
            raise ValueError(f"flight recorder capacity must be >= 1, "
                             f"got {capacity}")
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self.dump_dir = dump_dir or None
        self.tracer = tracer
        self.dumps = 0
        self._writer: "telemetry.TelemetryWriter | None" = None

    def record(self, event: dict) -> None:
        """TelemetryWriter listener: must be fast, must not raise."""
        with self._lock:
            self._ring.append(event)

    def attach(self, writer: telemetry.TelemetryWriter) -> "FlightRecorder":
        writer.add_listener(self.record)
        # Remember the writer: its JSONL directory is the run's log dir,
        # which default_path() prefers over littering the cwd.
        if self._writer is None:
            self._writer = writer
        return self

    def default_path(self) -> str:
        """Dump location: explicit dump_dir → DTF_TRACE_DIR → the
        attached writer's log directory → the system temp dir. The
        writer fallback is what keeps `flightrec-*.json` out of the
        repo root when tests (or ad-hoc runs) never set the env var —
        the dump lands next to the run's own telemetry instead. A
        recorder with no directory clue at all (stderr-only writer,
        e.g. a supervisor run without checkpoint.directory) dumps to
        tempfile.gettempdir(): never the process cwd, which under
        pytest is the repo root."""
        base = self.dump_dir or os.environ.get(TRACE_DIR_ENV)
        if not base and self._writer is not None:
            writer_path = getattr(self._writer, "path", None)
            if writer_path:
                base = os.path.dirname(os.path.abspath(writer_path))
        return os.path.join(base or tempfile.gettempdir(),
                            f"flightrec-{os.getpid()}.json")

    def dump(self, reason: str, *, path: str | None = None,
             open_spans: list[dict] | None = None) -> str | None:
        """Write the ring to disk; returns the path (None on failure —
        dumping is forensics, it must never take down the process)."""
        path = path or self.default_path()
        if open_spans is None and self.tracer is not None:
            open_spans = self.tracer.open_spans()
        with self._lock:
            events = list(self._ring)
        doc = {
            "schema": FLIGHTREC_SCHEMA,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "reason": reason,
            "t": time.time(),
            "event_count": len(events),
            "events": events,
            "open_spans": open_spans or [],
        }
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(doc, fh, default=str)
                fh.write("\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except OSError:
            log.exception("flight recorder dump to %s failed", path)
            return None
        self.dumps += 1
        log.warning("flight recorder dumped %d event(s) to %s (%s)",
                    len(events), path, reason)
        return path

    def install_sigusr1(self) -> bool:
        """SIGUSR1 → dump (main thread only; returns False elsewhere)."""

        def _handler(signum, frame):
            self.dump("SIGUSR1")

        try:
            signal.signal(signal.SIGUSR1, _handler)
            return True
        except (ValueError, OSError):  # non-main thread / exotic platform
            return False
