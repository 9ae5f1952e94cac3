"""Standing batched-inference engine with SLO telemetry.

Port of ``serve/engine.py``. Requests of arbitrary row count (and, for
the mlm task, sequence length) arrive at a queue, and a batcher thread
decides when a batch is worth launching:

  * admission — launch when ``serve.max_batch_size`` rows are waiting OR
    the oldest request has waited ``serve.max_wait_ms``, whichever comes
    first;
  * padding buckets — sequences pad up to the next ``serve.seq_buckets``
    entry and row counts to a power-of-two ladder, so the engine runs a
    bounded set of shapes (the flash-attention kernel's length guard then
    holds for every batch: each bucket is a multiple of 128 or below it);
  * placement — one replica of the model is placed on each serving
    device once, in eval mode (an image model on its artifact's BatchNorm
    statistics, channels_last on the card as the trainer lays it out);
  * data parallelism — ``serve.data`` devices (:func:`serving_devices`,
    the JAX package's ``serving_mesh``; or an explicit ``devices`` list)
    each take a contiguous equal shard of the padded batch, as the JAX
    engine shards the batch dimension over ``data``: every shard is
    launched before the first wait (on CUDA each replica on a stream of
    its own), and the outputs are gathered in row order. The row ladder
    holds multiples of the device count, so every batch divides;
  * live reload — :meth:`InferenceEngine.request_reload` verifies and
    places a new artifact on every replica on the caller's thread and the
    batcher swaps it in between batches, so a reloaded engine answers as a
    cold one on the new artifact would.

Everything observable rides core/telemetry.py with the JAX engine's
event kinds. A request that arrives with a trace context
(``X-DTF-Trace``, parsed by server.py) gets the spans ``engine.queue``,
``engine.batch`` and ``engine.compute`` in its trace, backfilled from
the batch's timestamps; the replica's one tracer is shared with the
server. The reporter thread samples device memory (core/memstats.py) at
its cadence, and ``memory_snapshot``/``goodput_snapshot`` feed
``/healthz``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from distributed_tensorflow_framework_torch.core import (
    memstats,
    telemetry,
    tracing,
)
from distributed_tensorflow_framework_torch.core.config import ServeConfig
from distributed_tensorflow_framework_torch.core.device import resolve_device
from distributed_tensorflow_framework_torch.core.mesh import MeshSizeError
from distributed_tensorflow_framework_torch.core.metrics import (
    PercentileReservoir,
)
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.serve.export import (
    Artifact,
    load_artifact,
)
from distributed_tensorflow_framework_torch.train.step import model_inputs

log = logging.getLogger(__name__)


class ServeError(RuntimeError):
    """Base for serving-path request errors (server.py maps subclasses to
    HTTP statuses; everything else is a 500)."""


class ServeReporterError(RuntimeError):
    """The telemetry reporter thread died. Stored by the reporter and
    re-raised on :meth:`InferenceEngine.drain` — a silent telemetry outage
    must not read as a healthy engine."""

    def __init__(self, cause: BaseException):
        super().__init__(
            f"serve reporter thread failed: {type(cause).__name__}: {cause}")
        self.__cause__ = cause


class ReloadError(ServeError):
    """Live weight reload rejected — tampered/unverified artifact, an
    incompatible model config or input spec, or a reload already in
    flight. The engine keeps serving the OLD weights; rejection is never
    an outage (server.py maps this to HTTP 409)."""


class OversizeRequestError(ServeError):
    """Request has more rows than ``serve.max_batch_size`` — it could
    never be admitted whole. Split it client-side or raise the knob."""


class SequenceTooLongError(ServeError):
    """Sequence exceeds the largest padding bucket (or the artifact's
    fixed length when no buckets are configured)."""


class QueueFullError(ServeError):
    """Backpressure: ``serve.queue_capacity`` requests already queued.
    The caller should retry with backoff (server.py returns 503)."""


class EngineClosedError(ServeError):
    """Submitted after drain began, or the request was still queued when
    the drain timeout expired."""


def pick_bucket(value: int, buckets: list[int]) -> int:
    """Smallest bucket >= value (buckets ascending). ValueError past the
    last bucket — the caller owns the typed error."""
    if not buckets:
        raise ValueError(
            f"empty bucket ladder — no bucket can hold {value}")
    for b in buckets:
        if value <= b:
            return int(b)
    raise ValueError(f"{value} exceeds largest bucket {buckets[-1]}")


def batch_buckets(max_batch_size: int, dp: int) -> list[int]:
    """Row-count padding ladder: dp, 2*dp, 4*dp, ... capped at
    max_batch_size rounded up to a dp multiple."""
    cap = -(-int(max_batch_size) // dp) * dp
    out, b = [], dp
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


def serving_devices(data: int,
                    device: str | torch.device = "cuda") -> list[torch.device]:
    """The serving devices, the counterpart of the JAX package's
    ``serving_mesh``: the first ``data`` devices of ``device``'s kind. 0
    and -1 mean every visible device: ``torch.cuda.device_count()`` on
    CUDA, one on the CPU. More than are visible raises MeshSizeError, as
    there. One device is ``device`` itself (so ``cuda:1`` stays itself);
    more are ``cuda:0`` … ``cuda:n-1``."""
    device = resolve_device(device)
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    n = visible if data in (0, -1) else int(data)
    if n > visible:
        raise MeshSizeError({"data": n}, n, visible)
    if n == 1:
        return [device]
    return [torch.device("cuda", i) for i in range(n)]


def resolve_devices(devices, data: int,
                    device: str | torch.device) -> list[torch.device]:
    """An engine's devices: ``devices`` when given (it may repeat a
    device, as the tests' stand-in for the JAX package's virtual CPU
    devices does), else :func:`serving_devices` of ``data``."""
    if devices is None:
        return serving_devices(data, device)
    out = [resolve_device(d) for d in devices]
    if not out:
        raise ValueError("devices must name at least one device")
    return out


def _on_stream(stream):
    """``torch.cuda.stream(stream)``, or no change for None (the CPU, or
    one replica on the device's current stream)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(
        stream)


@dataclass
class _Request:
    inputs: dict[str, np.ndarray]
    rows: int
    seq_len: int  # 0 for classification
    future: Future = field(default_factory=Future)
    t_enqueue: float = field(default_factory=time.monotonic)
    # Incoming trace context (tracing.SpanContext): queue wait, batch
    # membership and compute become spans in the request's trace tree.
    trace: Any = None


class InferenceEngine:
    """Standing engine over a loaded :class:`~serve.export.Artifact`.

    Callers block in :meth:`predict`; one batcher thread forms and runs
    batches (so device work is serial, and every kernel launch and its
    count come from that thread); one reporter thread emits periodic
    queue-depth/latency telemetry. ``devices`` takes the place of the JAX
    engine's ``mesh=``: one replica a listed device. Without it the
    engine serves on :func:`serving_devices` of ``serve.data`` and
    ``device``, which defaults to CUDA and raises when it is absent;
    tests pass ``device="cpu"``.
    """

    def __init__(self, artifact: Artifact, serve_cfg: ServeConfig, *,
                 device: str | torch.device = "cuda", devices=None,
                 telemetry_writer=None, trace_enabled: bool = True):
        self.devices = resolve_devices(devices, serve_cfg.data, device)
        self.device = self.devices[0]
        self.dp = len(self.devices)
        self.artifact = artifact
        self.cfg = serve_cfg
        self._tw = telemetry_writer
        self.task = artifact.task
        self.row_buckets = batch_buckets(serve_cfg.max_batch_size, self.dp)
        self.max_rows = self.row_buckets[-1]
        if self.task == "mlm":
            fixed = int(artifact.input_spec["input_ids"]["shape"][0])
            self.seq_buckets = ([int(b) for b in serve_cfg.seq_buckets]
                                or [fixed])
        else:
            self.seq_buckets = []
        # One placement at startup; every batch reuses these weights. On
        # CUDA above one replica each replica runs on a stream of its own,
        # so that two on one card overlap.
        self.replicas = self._place_replicas(artifact)
        self._streams = [
            torch.cuda.Stream(d) if d.type == "cuda" and self.dp > 1
            else None for d in self.devices]
        self._used: set[tuple] = set()

        self._cond = threading.Condition()
        self._queue: deque[_Request] = deque()
        self._stop_reporting = threading.Event()
        self._state = "running"  # running | draining | closed
        # Staged live reload: (artifact, placed replicas, future,
        # t_requested), applied by the batcher BETWEEN batches.
        self._pending_reload: tuple | None = None
        self._reloads = 0
        self._replica_label = os.environ.get("DTF_REPLICA_ID", "engine")
        # One tracer per replica process (server.py shares it);
        # ``trace.enabled`` gates emission.
        self.tracer = tracing.Tracer(
            telemetry_writer if trace_enabled else None,
            service=self._replica_label)
        self._t_start = time.monotonic()
        self._latency = PercentileReservoir()
        self._requests = 0
        self._rows = 0
        self._batches = 0
        self._batch_rows = 0
        self._padded_rows = 0
        self._queue_wait_ms = 0.0
        self._compute_ms = 0.0
        # Device memory: sampled by the reporter thread every
        # report_interval_s, snapshot on /healthz (each device once).
        self._mem = memstats.MemoryMonitor(
            telemetry_writer, interval_s=serve_cfg.report_interval_s,
            source="serve", devices=self.devices)
        self._reporter_error: ServeReporterError | None = None
        self._batcher = threading.Thread(
            target=self._batch_loop, name="dtf-serve-batcher", daemon=True)
        self._batcher.start()
        self._reporter = threading.Thread(
            target=self._report_loop, name="dtf-serve-reporter", daemon=True)
        self._reporter.start()
        log.info(
            "engine up: task=%s step=%d dp=%d devices=%s row_buckets=%s "
            "seq_buckets=%s", self.task, artifact.step, self.dp,
            [str(d) for d in self.devices], self.row_buckets,
            self.seq_buckets)

    @property
    def model(self) -> torch.nn.Module:
        """The first replica (every replica holds the same weights)."""
        return self.replicas[0]

    def _place_replicas(self, artifact: Artifact) -> list[torch.nn.Module]:
        """The artifact's model on every serving device, one replica each,
        in eval mode, an image model with the channels of its input spec
        (the same placement for cold start and live reload — parity by
        construction). No two replicas share a tensor; each card is
        synchronised after, so that a replica's stream never reads
        weights whose copy is still in flight."""
        channels = (None if artifact.task == "mlm"
                    else int(artifact.input_spec["image"]["shape"][-1]))
        replicas = []
        for device in self.devices:
            model = get_model(artifact.model_config, device=device,
                              in_channels=channels)
            model.load_state_dict(artifact.state_dict)
            replicas.append(model)
        for device in dict.fromkeys(self.devices):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return replicas

    # ------------------------------------------------------- validation

    def _validate(self, inputs: dict[str, Any]) -> _Request:
        spec = self.artifact.input_spec
        unknown = set(inputs) - set(spec) - {"segment_ids"}
        if unknown:
            raise ServeError(
                f"unknown input key(s) {sorted(unknown)} — this artifact "
                f"takes {sorted(spec)}")
        arrays: dict[str, np.ndarray] = {}
        for key, info in spec.items():
            row_ndim = len(info["shape"])
            if key not in inputs:
                if key == "attention_mask":
                    continue  # synthesized below
                raise ServeError(f"missing required input {key!r}")
            arr = np.asarray(inputs[key], dtype=np.dtype(info["dtype"]))
            if arr.ndim == row_ndim:  # single row without the batch dim
                arr = arr[None]
            if arr.ndim != row_ndim + 1:
                raise ServeError(
                    f"input {key!r} has shape {arr.shape}, expected "
                    f"(rows, {', '.join(map(str, info['shape']))})")
            arrays[key] = arr
        if self.task == "mlm":
            rows, seq = self._validate_mlm(inputs, arrays)
        else:
            rows = arrays["image"].shape[0]
            want = tuple(spec["image"]["shape"])
            if arrays["image"].shape[1:] != want:
                raise ServeError(
                    f"image rows have shape {arrays['image'].shape[1:]}, "
                    f"artifact expects {want}")
            seq = 0
        if rows < 1:
            raise ServeError("request has zero rows")
        if rows > self.max_rows:
            raise OversizeRequestError(
                f"request has {rows} rows but serve.max_batch_size="
                f"{self.cfg.max_batch_size} (padded cap {self.max_rows}) — "
                f"split the request or raise the knob")
        return _Request(inputs=arrays, rows=rows, seq_len=seq)

    def _validate_mlm(self, inputs: dict[str, Any],
                      arrays: dict[str, np.ndarray]) -> tuple[int, int]:
        ids = arrays["input_ids"]
        rows, seq = ids.shape
        if "attention_mask" not in arrays:
            arrays["attention_mask"] = np.ones_like(ids)
        if arrays["attention_mask"].shape != ids.shape:
            raise ServeError(
                f"attention_mask shape {arrays['attention_mask'].shape} "
                f"!= input_ids shape {ids.shape}")
        if "segment_ids" in inputs:
            seg = np.asarray(inputs["segment_ids"], dtype=np.int32)
            arrays["segment_ids"] = seg[None] if seg.ndim == 1 else seg
            if arrays["segment_ids"].shape != ids.shape:
                raise ServeError(
                    f"segment_ids shape {arrays['segment_ids'].shape} != "
                    f"input_ids shape {ids.shape}")
        vocab = self.artifact.vocab_size
        if ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise ServeError(
                f"input_ids must lie in [0, {vocab}), got "
                f"[{ids.min()}, {ids.max()}]")
        if seq > self.seq_buckets[-1]:
            raise SequenceTooLongError(
                f"sequence length {seq} exceeds the largest padding "
                f"bucket {self.seq_buckets[-1]} (serve.seq_buckets="
                f"{self.seq_buckets}) — truncate or add a bucket")
        return rows, seq

    # ------------------------------------------------------- public API

    def submit(self, inputs: dict[str, Any],
               trace: "tracing.SpanContext | None" = None) -> Future:
        """Validate + enqueue; returns a Future resolving to the per-row
        logits (np.ndarray, request rows and length only)."""
        req = self._validate(inputs)
        req.trace = trace
        with self._cond:
            if self._state != "running":
                raise EngineClosedError(
                    f"engine is {self._state} — not accepting requests")
            if len(self._queue) >= self.cfg.queue_capacity:
                raise QueueFullError(
                    f"queue at capacity ({self.cfg.queue_capacity}) — "
                    f"retry with backoff")
            self._queue.append(req)
            self._cond.notify_all()
        return req.future

    def predict(self, inputs: dict[str, Any],
                timeout: float | None = None,
                trace: "tracing.SpanContext | None" = None) -> np.ndarray:
        return self.submit(inputs, trace=trace).result(timeout)

    def request_reload(self, artifact_dir: str) -> Future:
        """Stage a live weight swap; the batcher applies it BETWEEN
        batches, so in-flight requests finish on the old weights and the
        next batch runs the new ones — zero downtime.

        Manifest verification (serve/export.load_artifact) and placement
        on every replica's device happen HERE, on the calling thread: a tampered or
        incompatible artifact raises :class:`ReloadError` without the
        batcher ever seeing it, and the old weights keep serving. The new
        model is built as a cold engine builds its own (same model config
        is enforced), so reloaded responses are bitwise what a cold engine
        on the new artifact would produce.
        """
        try:
            art = load_artifact(artifact_dir)
        except (ValueError, OSError) as e:
            raise ReloadError(
                f"reload rejected, still serving step "
                f"{self.artifact.step}: {e}") from e
        if art.task != self.task:
            raise ReloadError(
                f"reload rejected: artifact task {art.task!r} != serving "
                f"task {self.task!r}")
        if art.model_config != self.artifact.model_config:
            raise ReloadError(
                "reload rejected: model config differs from the serving "
                "artifact — a fleet swaps weights, not architectures")
        if art.input_spec != self.artifact.input_spec:
            raise ReloadError(
                "reload rejected: input spec differs from the serving "
                "artifact")
        t0 = time.monotonic()
        replicas = self._place_replicas(art)
        fut: Future = Future()
        with self._cond:
            if self._state != "running":
                raise EngineClosedError(
                    f"engine is {self._state} — not accepting reloads")
            if self._pending_reload is not None:
                raise ReloadError(
                    "reload rejected: another reload is already staged")
            self._pending_reload = (art, replicas, fut, t0)
            self._cond.notify_all()
        return fut

    def reload(self, artifact_dir: str,
               timeout: float | None = 60.0) -> dict[str, Any]:
        """Synchronous :meth:`request_reload` (server.py's POST /reload)."""
        return self.request_reload(artifact_dir).result(timeout)

    def artifact_info(self) -> dict[str, Any]:
        """Digest self-report for /healthz: the artifact this engine is
        ACTUALLY serving."""
        with self._cond:
            art = self.artifact
            reloads = self._reloads
        return {
            "step": art.step,
            "param_spec_digest": art.param_spec_digest,
            "content_digest": art.version_digest,
            "reloads": reloads,
        }

    def stats(self) -> dict[str, Any]:
        """Point-in-time counters for healthz."""
        with self._cond:
            depth = len(self._queue)
        return {
            "state": self._state,
            "device": str(self.device),
            "uptime_s": time.monotonic() - self._t_start,
            "requests": self._requests,
            "rows": self._rows,
            "batches": self._batches,
            "batch_rows": self._batch_rows,
            "padded_rows": self._padded_rows,
            "queue_depth": depth,
            "queue_wait_ms_total": self._queue_wait_ms,
            "compute_ms_total": self._compute_ms,
            "latency": self._latency.summary(),
            "row_buckets": self.row_buckets,
            "seq_buckets": self.seq_buckets,
            "used_buckets": sorted(str(k) for k in self._used),
        }

    def goodput_snapshot(self) -> dict[str, Any]:
        """Serve-side goodput: the fraction of engine uptime the batcher
        spent computing, and the request-seconds lost to queueing."""
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        return {
            "uptime_s": elapsed,
            "compute_ms_total": self._compute_ms,
            "queue_wait_ms_total": self._queue_wait_ms,
            "compute_frac": (self._compute_ms / 1e3) / elapsed,
        }

    def memory_snapshot(self) -> dict[str, Any]:
        """Live device-memory view (no telemetry emission) for /healthz."""
        return self._mem.snapshot()

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admission, serve everything already queued, stop threads.
        Returns True when the queue fully drained within ``timeout``;
        leftover requests fail with EngineClosedError."""
        with self._cond:
            if self._state == "closed":
                return True
            self._state = "draining"
            self._cond.notify_all()
        self._batcher.join(timeout)
        drained = not self._batcher.is_alive()
        with self._cond:
            self._state = "closed"
            leftovers, self._queue = list(self._queue), deque()
            pending, self._pending_reload = self._pending_reload, None
            self._cond.notify_all()
        for req in leftovers:
            req.future.set_exception(EngineClosedError(
                "engine drain timed out before this request was served"))
        if pending is not None:
            pending[2].set_exception(EngineClosedError(
                "engine drained before the staged reload applied"))
        self._stop_reporting.set()
        self._reporter.join(max(1.0, self.cfg.report_interval_s))
        self._emit_latency()  # final cumulative rollup — last one wins
        log.info("engine drained: %d requests in %d batches, %d undrained",
                 self._requests, self._batches, len(leftovers))
        with self._cond:
            reporter_error, self._reporter_error = self._reporter_error, None
        if reporter_error is not None:
            raise reporter_error
        return drained and not leftovers

    # ---------------------------------------------------------- batcher

    def _take_batch(self) -> list[_Request] | None:
        """Block until a batch is worth launching (admission rule) or the
        engine is told to finish; None means exit the loop."""
        with self._cond:
            while not self._queue:
                if self._state != "running":
                    return None
                if self._pending_reload is not None:
                    return []  # wake the loop so the swap applies now
                self._cond.wait(0.1)
            deadline = self._queue[0].t_enqueue + self.cfg.max_wait_ms / 1e3
            while (self._state == "running"
                   and sum(r.rows for r in self._queue) < self.max_rows):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            batch, rows = [], 0
            while self._queue and rows + self._queue[0].rows <= self.max_rows:
                req = self._queue.popleft()
                batch.append(req)
                rows += req.rows
            return batch

    def _assemble(self, batch: list[_Request]) -> tuple[dict, tuple, int]:
        """Pad requests into one fixed (row_bucket, seq_bucket) host
        batch.

        Sequence padding is zeros with mask 0; filler rows replicate row 0
        (a real row keeps the padded batch numerically unremarkable). Their
        outputs are sliced off before any future resolves.
        """
        rows = sum(r.rows for r in batch)
        row_bucket = pick_bucket(rows, self.row_buckets)
        if self.task == "mlm":
            seq_bucket = max(pick_bucket(r.seq_len, self.seq_buckets)
                             for r in batch)
            keys = ["input_ids", "attention_mask"]
            if any("segment_ids" in r.inputs for r in batch):
                keys.append("segment_ids")
            cols = {k: [] for k in keys}
            for r in batch:
                for k in keys:
                    arr = r.inputs.get(k)
                    if arr is None:  # segment_ids absent for this request
                        arr = np.zeros((r.rows, r.seq_len), np.int32)
                    pad = seq_bucket - arr.shape[1]
                    if pad:
                        arr = np.pad(arr, ((0, 0), (0, pad)))
                    cols[k].append(arr)
            host = {k: np.concatenate(v) for k, v in cols.items()}
        else:
            seq_bucket = 0
            host = {"image": np.concatenate([r.inputs["image"]
                                             for r in batch])}
        fill = row_bucket - rows
        if fill:
            host = {k: np.concatenate([v, np.repeat(v[:1], fill, axis=0)])
                    for k, v in host.items()}
        return host, (seq_bucket, row_bucket), rows

    def _forward(self, host: dict[str, np.ndarray],
                 row_bucket: int) -> np.ndarray:
        """The padded batch's logits: ``dp`` contiguous equal shards, shard
        i on replica i (image rows as NHWC f32), every shard launched
        before the first wait, each copied into its rows of one host
        array."""
        shard = row_bucket // self.dp
        launched = []
        with torch.inference_mode():
            for i, (model, device, stream) in enumerate(
                    zip(self.replicas, self.devices, self._streams)):
                with _on_stream(stream):
                    placed = {k: torch.from_numpy(
                                  v[i * shard:(i + 1) * shard]).to(
                                  device, torch.float32 if k == "image"
                                  else torch.int64)
                              for k, v in host.items()}
                    logits = model(*model_inputs(self.task, placed))
                    if isinstance(logits, dict):  # MoE: beside the aux
                        logits = logits["logits"]
                launched.append(logits)
            out = torch.empty((row_bucket, *launched[0].shape[1:]),
                              dtype=launched[0].dtype)
            for i, (logits, stream) in enumerate(
                    zip(launched, self._streams)):
                with _on_stream(stream):  # waits for the shard
                    out[i * shard:(i + 1) * shard].copy_(logits)
        return out.numpy()

    def _run_batch(self, batch: list[_Request]) -> None:
        with self._cond:
            depth = len(self._queue)
        t_form = time.monotonic()
        host, key, rows = self._assemble(batch)
        first_use = key not in self._used
        t0 = time.monotonic()
        logits = self._forward(host, key[1])
        t_done = time.monotonic()
        compute_ms = (t_done - t0) * 1e3
        if first_use:
            # First run of a bucket: on the card it includes building the
            # kernels, the port's counterpart of the JAX engine's compile.
            self._used.add(key)
            label = (f"rows{key[1]}" if self.task != "mlm"
                     else f"seq{key[0]}xrows{key[1]}")
            if self._tw:
                self._tw.emit(
                    telemetry.KIND_SERVE_RECOMPILE,
                    metrics={"compile_ms": compute_ms}, bucket=label)
            log.info("first run of bucket %s in %.0f ms", label, compute_ms)
        row_bucket = key[1]
        self._batches += 1
        self._batch_rows += rows
        self._padded_rows += row_bucket
        self._compute_ms += compute_ms
        if self._tw:
            self._tw.emit(
                telemetry.KIND_SERVE_BATCH,
                metrics={"rows": rows, "padded_rows": row_bucket,
                         "compute_ms": compute_ms, "queue_depth": depth})
        offset = 0
        for req in batch:
            out = logits[offset:offset + req.rows]
            if self.task == "mlm":  # strip the seq padding too
                out = out[:, :req.seq_len]
            offset += req.rows
            wait_ms = (t_form - req.t_enqueue) * 1e3
            latency_ms = (time.monotonic() - req.t_enqueue) * 1e3
            self._requests += 1
            self._rows += req.rows
            self._queue_wait_ms += wait_ms
            self._latency.add(latency_ms)
            if self._tw:
                self._tw.emit(
                    telemetry.KIND_SERVE_REQUEST,
                    metrics={"rows": req.rows, "queue_wait_ms": wait_ms,
                             "latency_ms": latency_ms})
            if req.trace is not None:
                self._emit_spans(req, t_form, t0, t_done, first_use,
                                 rows=rows, padded_rows=row_bucket,
                                 queue_depth=depth)
            req.future.set_result(out)

    def _emit_spans(self, req: _Request, t_form: float, t0: float,
                    t_done: float, first_use: bool, **batch_attrs) -> None:
        """Backfill the request's spans from the timestamps already
        taken: its queue wait, its membership in the padded batch, and
        the batch's device compute under the batch span."""
        self.tracer.emit_span("engine.queue", req.trace,
                              start_mono=req.t_enqueue, end_mono=t_form,
                              rows=req.rows)
        bev = self.tracer.emit_span("engine.batch", req.trace,
                                    start_mono=t_form, end_mono=t_done,
                                    batch=self._batches, **batch_attrs)
        bspan = (bev.get("extra") or {}).get("span")
        self.tracer.emit_span(
            "engine.compute",
            tracing.SpanContext(req.trace.trace_id, bspan or "")
            if req.trace.trace_id else req.trace,
            start_mono=t0, end_mono=t_done, first_use=first_use)

    def _apply_pending_reload(self) -> None:
        """Batcher-thread half of the reload: swap the verified, already
        placed replicas in one locked assignment between batches."""
        with self._cond:
            pending, self._pending_reload = self._pending_reload, None
        if pending is None:
            return
        art, replicas, fut, t0 = pending
        old = self.artifact
        with self._cond:
            self.artifact = art
            self.replicas = replicas
            self._reloads += 1
        reload_ms = (time.monotonic() - t0) * 1e3
        result = {
            "from_step": old.step, "to_step": art.step,
            "from_digest": old.version_digest,
            "to_digest": art.version_digest,
            "reload_ms": reload_ms,
        }
        if self._tw:
            self._tw.emit(
                telemetry.KIND_SERVE_RELOAD,
                metrics={"reload_ms": reload_ms},
                replica=self._replica_label, ok=True,
                from_digest=old.version_digest,
                to_digest=art.version_digest,
                from_step=old.step, to_step=art.step)
        log.info("live reload: step %d -> %d, digest %s -> %s (%.0f ms)",
                 old.step, art.step, old.version_digest[:8],
                 art.version_digest[:8], reload_ms)
        fut.set_result(result)

    def _batch_loop(self) -> None:
        while True:
            self._apply_pending_reload()
            batch = self._take_batch()
            if batch is None:
                return
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # noqa: BLE001 — engine must outlive a bad batch
                log.exception("batch of %d request(s) failed", len(batch))
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    # --------------------------------------------------------- reporter

    def _emit_latency(self) -> None:
        if not self._tw or not self._latency.count:
            return
        s = self._latency.summary()
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        self._tw.emit(
            telemetry.KIND_SERVE_LATENCY,
            metrics={"p50_ms": s["p50"], "p90_ms": s["p90"],
                     "p99_ms": s["p99"], "count": s["count"]},
            throughput={"requests_per_sec": self._requests / elapsed,
                        "rows_per_sec": self._rows / elapsed})

    def _report_loop(self) -> None:
        try:
            while not self._stop_reporting.wait(self.cfg.report_interval_s):
                with self._cond:
                    depth = len(self._queue)
                if self._tw:
                    self._tw.emit(telemetry.KIND_SERVE_QUEUE,
                                  metrics={"queue_depth": depth})
                    self._mem.sample()
                self._emit_latency()
        except BaseException as e:  # surface on drain(), never just stderr
            log.error("serve reporter thread failed", exc_info=True)
            with self._cond:
                if self._reporter_error is None:
                    self._reporter_error = ServeReporterError(e)
