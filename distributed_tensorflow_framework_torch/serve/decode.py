"""Autoregressive decode engine: paged KV cache + continuous batching.

Port of ``serve/decode.py``. Token-by-token generation is a throughput
problem before it is anything else: a static batch idles the device
whenever streams finish at different lengths, so the scheduler here
rebuilds the in-flight batch EVERY token — finished slots refill from the
queue immediately (continuous batching) instead of at batch boundaries
(the ``decode.scheduler="static"`` A/B control arm).

Memory is the other half. Per-stream KV state lives in a paged,
block-allocated device pool (one ``(pages, slot, hidden)`` plane per layer
and tensor): a stream holds just the pages its current length needs, pages
recycle the moment a stream finishes, and under pressure the
newest-admitted stream is preempted back to the queue (its pages freed,
its progress kept — re-prefill resumes it without re-emitting a token).
``decode.kv_dtype="int8"`` stores pages through the blockwise int8 codec
(parallel/quantization.py), a quarter of the bytes per stream plus one f32
scale a block, at a bounded per-token logit cost.

The forwards are the f32 decode walk of models/bert.py as plain functions
on tensors (:func:`prefill` and :func:`decode_step`) that update the pool
in place (the JAX package donates it). Page tables pad to a power-of-two
page ladder and row counts to the row ladder, so the step runs a fixed
grid of shapes |page buckets| x (|row ladder| + |prompt buckets|); each
shape's first run is telemetered (KIND_SERVE_RECOMPILE, the JAX engine's
compile event). Every step rides KIND_DECODE_STEP (occupancy, per-token
ms) and the pool rides KIND_KV_CACHE (pages in use/free, evictions), with
the JAX package's field names, so its ``summarize_events`` rolls them up.
Page 0 is scratch: filler rows and page-table padding point at it, so
they are inert.

On a serving mesh of ``dp`` devices the row ladder holds multiples of
``dp``, as the JAX engine's. The JAX engine replicates the pool and the
parameters over the mesh and splits nothing, so every device computes
every row; the port runs the step on the first device alone, with the
same ladder and the same tokens (a redundant copy computes nothing new).
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from distributed_tensorflow_framework_torch.core import telemetry
from distributed_tensorflow_framework_torch.core.config import (
    DecodeConfig,
    ServeConfig,
)
from distributed_tensorflow_framework_torch.models import (
    decode_support_reason,
)
from distributed_tensorflow_framework_torch.models.bert import (
    bert_decode_layers,
    bert_decode_logits,
    causal_prefill_attention,
    decode_params,
    paged_decode_attention,
)
from distributed_tensorflow_framework_torch.parallel.quantization import (
    DEFAULT_BLOCK_SIZE,
    dequantize_blockwise,
    quantize_blockwise,
)
from distributed_tensorflow_framework_torch.serve.engine import (
    EngineClosedError,
    QueueFullError,
    ReloadError,
    ServeError,
    batch_buckets,
    pick_bucket,
    resolve_devices,
)
from distributed_tensorflow_framework_torch.serve.export import (
    Artifact,
    load_artifact,
)

log = logging.getLogger(__name__)


class DecodeError(ServeError):
    """Base for autoregressive-decode request errors (server.py maps
    subclasses onto HTTP statuses; an unknown decode failure is a 500)."""


class CacheFullError(DecodeError):
    """The stream could never fit: prompt + max_new_tokens needs more KV
    pages than the pool owns (``decode.num_pages - 1`` allocatable; page 0
    is reserved scratch). Shorten the stream or grow the pool — transient
    pressure is absorbed by queueing and eviction, never by this error."""


class StreamTooLongError(DecodeError):
    """prompt + max_new_tokens exceeds ``decode.max_len`` (itself capped
    at model.max_seq_len — positions past it have no embedding row)."""


class DecodeClosedError(EngineClosedError):
    """Stream submitted after decode drain began, or still queued/active
    when the drain timeout expired."""


class DecodeSchedulerError(RuntimeError):
    """The decode scheduler thread died. Active and queued streams fail
    with the cause, and :meth:`DecodeEngine.drain` re-raises — a dead
    scheduler must not read as a healthy engine."""

    def __init__(self, cause: BaseException):
        super().__init__(
            f"decode scheduler thread failed: "
            f"{type(cause).__name__}: {cause}")
        self.__cause__ = cause


# ------------------------------------------------------------ page math


def pages_for(tokens: int, page_size: int) -> int:
    """KV pages covering ``tokens`` positions (ceil; at least one)."""
    return max(1, -(-int(tokens) // int(page_size)))


def page_table_buckets(max_len: int, page_size: int,
                       explicit=None) -> list[int]:
    """Page-table width ladder: powers of two capped at a max-length
    stream's page count — the decode twin of engine.batch_buckets. An
    explicit ladder is extended to cover max_len: a max-length stream must
    always have a bucket."""
    cap = pages_for(max_len, page_size)
    if explicit:
        out = sorted(int(b) for b in explicit)
        if out[-1] < cap:
            out.append(cap)
        return out
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


def kv_block_size(hidden: int) -> int:
    """Block length for int8 KV pages: the quantization block must divide
    the per-token hidden vector so no scale straddles two tokens."""
    return DEFAULT_BLOCK_SIZE if hidden % DEFAULT_BLOCK_SIZE == 0 else hidden


def make_kv_pool(num_layers: int, num_pages: int, page_size: int,
                 hidden: int, kv_dtype: str,
                 device=None) -> dict[str, torch.Tensor]:
    """The device KV pool: one ``(pages, slot, hidden)`` plane per layer
    and tensor. int8 pools carry blockwise scales alongside the payload;
    zero-init scales are 1.0 so an unwritten slot dequantizes to finite
    zeros."""
    shape = (num_layers, num_pages, page_size, hidden)
    if kv_dtype == "int8":
        block = kv_block_size(hidden)
        sshape = (num_layers, num_pages, page_size, hidden // block)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones(sshape, device=device),
                "v_scale": torch.ones(sshape, device=device)}
    return {"k": torch.zeros(shape, device=device),
            "v": torch.zeros(shape, device=device)}


def _quant_pages(x, block):
    """(..., H) f32 -> (int8 payload same shape, (..., H//block) scales)."""
    q, scales = quantize_blockwise(x.reshape(-1), block)
    return (q.reshape(x.shape),
            scales.reshape(*x.shape[:-1], x.shape[-1] // block))


def _dequant_pages(q, scales, block):
    return dequantize_blockwise(q.reshape(-1), scales.reshape(-1),
                                block).reshape(q.shape)


def _write(pool: dict, name: str, index: tuple, x, kv_dtype: str) -> None:
    """``pool[name][index] = x`` (f32 (..., H)), through the codec on an
    int8 pool."""
    if kv_dtype == "int8":
        q, scales = _quant_pages(x, kv_block_size(x.shape[-1]))
        pool[name][index] = q
        pool[f"{name}_scale"][index] = scales
    else:
        pool[name][index] = x


def _gather(pool: dict, name: str, layer: int, page_table, kv_dtype: str):
    """Layer ``layer``'s pages of ``page_table`` (R, P) as (R, P·page, H)
    f32."""
    pages = pool[name][layer][page_table]
    if kv_dtype == "int8":
        pages = _dequant_pages(pages, pool[f"{name}_scale"][layer][page_table],
                               kv_block_size(pages.shape[-1]))
    return pages.reshape(page_table.shape[0], -1, pages.shape[-1])


# ------------------------------------------------------------ forwards


@torch.inference_mode()
def prefill(params: dict, pool: dict, ids, length, page_table, *,
            num_heads: int, page_size: int, kv_dtype: str):
    """One causal forward over a single prompt (B=1) that writes every
    layer's K/V into the stream's pages (in place) and returns the
    next-token logits (V,). ids (1, S) int64; length (1,) int64;
    page_table (P,) int64. The real tokens (<= length) always fit the
    allocated pages; rows past ``P·page_size`` are prompt padding whose K/V
    no position ever attends, and the padded table entries point at
    scratch page 0, so padding only ever writes there."""
    s = ids.shape[1]
    cap = page_table.shape[0] * page_size

    def attend(i, q, k, v):
        for name, x in (("k", k[0]), ("v", v[0])):
            x = x[:cap]
            if cap > s:
                x = torch.nn.functional.pad(x, (0, 0, 0, cap - s))
            _write(pool, name, (i, page_table),
                   x.reshape(-1, page_size, x.shape[-1]), kv_dtype)
        return causal_prefill_attention(q, k, v, length, num_heads)

    positions = torch.arange(s, device=ids.device)[None, :]
    x = bert_decode_layers(params, ids, positions, attend)
    return bert_decode_logits(params, x[0, length[0] - 1])


@torch.inference_mode()
def decode_step(params: dict, pool: dict, ids, positions, page_table, *,
                num_heads: int, page_size: int, kv_dtype: str):
    """One token for every in-flight row: write the token's K/V through
    the page table (in place), gather the row's pages, and attend with a
    live-position mask. ids/positions (R,) int64; page_table (R, P)
    int64; returns the logits (R, V). Filler rows carry an all-zero page
    table (scratch page 0): their writes land on scratch, and real rows
    only ever gather scratch at masked positions, so padding is bitwise
    inert."""
    slot = positions // page_size
    page_ids = torch.gather(page_table, 1, slot[:, None])[:, 0]
    off = positions % page_size

    def attend(i, q, k, v):
        _write(pool, "k", (i, page_ids, off), k[:, 0], kv_dtype)
        _write(pool, "v", (i, page_ids, off), v[:, 0], kv_dtype)
        ctx = paged_decode_attention(
            q[:, 0], _gather(pool, "k", i, page_table, kv_dtype),
            _gather(pool, "v", i, page_table, kv_dtype), positions,
            num_heads)
        return ctx[:, None]

    x = bert_decode_layers(params, ids[:, None], positions[:, None], attend)
    return bert_decode_logits(params, x[:, 0])


# ----------------------------------------------------------- page pool


class PagePool:
    """Host-side allocator over the device pool's page ids. Page 0 is
    reserved scratch (filler rows and page-table padding point at it), so
    ``num_pages - 1`` pages are allocatable. Alloc is all-or-nothing:
    a partial grant would deadlock two streams each holding half of what
    the other needs."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self.capacity = self.num_pages - 1
        self._lock = threading.Lock()
        self._free: deque[int] = deque(range(1, self.num_pages))

    def alloc(self, n: int = 1) -> list[int] | None:
        """n page ids, or None if fewer than n are free."""
        with self._lock:
            if len(self._free) < n:
                return None
            return [self._free.popleft() for _ in range(n)]

    def free(self, pages) -> None:
        with self._lock:
            self._free.extend(pages)

    def available(self) -> int:
        with self._lock:
            return len(self._free)


# -------------------------------------------------------------- stream


class DecodeStream:
    """One autoregressive stream: the handle :meth:`DecodeEngine.submit`
    returns. Token events arrive on a Queue (the server's NDJSON writer
    and tests iterate :meth:`events`); :attr:`future` resolves to the
    completion summary. All mutation happens on the scheduler thread;
    clients only ever read through the queue/future."""

    def __init__(self, prompt: list[int], max_new: int,
                 eos_id: int | None, return_logits: bool):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.return_logits = bool(return_logits)
        # prompt + generated so far; an evicted stream re-prefills over
        # exactly this list, so no token is ever produced twice.
        self.tokens: list[int] = list(self.prompt)
        self.generated: list[int] = []
        self.pages: list[int] = []
        self.slot = -1
        self.admissions = 0  # 1 + times an eviction re-admitted it
        self.t_submit = time.monotonic()
        self.t_admit = 0.0
        self.t_first: float | None = None
        self.future: Future = Future()
        self._events: queue_mod.Queue = queue_mod.Queue()
        # Tokens staged by the scheduler but not yet handed to the
        # consumer queue (decode.stream_interval batching). Only the
        # scheduler thread touches it.
        self._buf: list[dict[str, Any]] = []

    # -- scheduler side ---------------------------------------------

    def emit_token(self, token: int, logits=None) -> None:
        idx = len(self.generated)
        self.generated.append(int(token))
        self.tokens.append(int(token))
        if self.t_first is None:
            self.t_first = time.monotonic()
        payload: dict[str, Any] = {"token": int(token), "index": idx}
        if logits is not None:
            payload["logits"] = logits
        self._buf.append(payload)

    def flush_events(self) -> None:
        """Hand buffered tokens to the consumer as ONE queue item: one
        wakeup per burst instead of per token. The engine calls this on
        a stream's first token, every ``stream_interval`` steps, and at
        finish/failure, so nothing is ever stranded in the buffer."""
        if self._buf:
            batch, self._buf = self._buf, []
            self._events.put(("batch", batch))

    def finish(self, reason: str) -> None:
        summary = {
            "tokens": list(self.generated),
            "prompt_len": len(self.prompt),
            "finish": reason,
            "admissions": self.admissions,
            "ttft_ms": ((self.t_first - self.t_submit) * 1e3
                        if self.t_first is not None else None),
        }
        self.flush_events()
        self._events.put(("done", summary))
        self.future.set_result(summary)

    def fail(self, exc: BaseException) -> None:
        self.flush_events()
        self._events.put(("error", exc))
        if not self.future.done():
            self.future.set_exception(exc)

    # -- client side ------------------------------------------------

    def events(self, timeout: float | None = None):
        """Yield ("token", payload) events, ending with ("done",
        summary); an engine-side failure re-raises here."""
        while True:
            kind, payload = self._events.get(timeout=timeout)
            if kind == "error":
                raise payload
            if kind == "batch":
                for item in payload:
                    yield "token", item
                continue
            yield kind, payload
            if kind == "done":
                return

    def pending(self) -> int:
        """Events already emitted but not yet consumed (approximate —
        the scheduler appends concurrently)."""
        return self._events.qsize()

    def result(self, timeout: float | None = None) -> dict[str, Any]:
        return self.future.result(timeout)


# -------------------------------------------------------------- engine


class DecodeEngine:
    """Continuous-batching decode engine over a loaded
    :class:`~serve.export.Artifact` (mlm task, dense bert family).
    ``devices`` takes the place of the JAX engine's ``mesh=`` (without it,
    ``serving_devices`` of ``serve.data`` and ``device``, default CUDA,
    which raises when CUDA is absent unless ``device="cpu"``): their count
    sets the row ladder, and the step runs on the first.

    Thread layout: callers enqueue streams in :meth:`submit`; ONE
    scheduler thread owns admission, paging, eviction, the prefill/decode
    calls and reload swaps, so device order is trivially serial and
    per-stream state needs no fine-grained locking.
    """

    def __init__(self, artifact: Artifact, decode_cfg: DecodeConfig,
                 serve_cfg: ServeConfig, *,
                 device: str | torch.device = "cuda", devices=None,
                 telemetry_writer=None):
        if artifact.task != "mlm":
            raise DecodeError(
                f"decode serves the mlm task, not {artifact.task!r}")
        reason = decode_support_reason(artifact.model_config)
        if reason:
            raise DecodeError(f"decode unsupported: {reason}")
        self.devices = resolve_devices(devices, serve_cfg.data, device)
        self.device = self.devices[0]
        self.dp = len(self.devices)
        self.artifact = artifact
        self.cfg = decode_cfg
        self.serve_cfg = serve_cfg
        self._tw = telemetry_writer
        mc = artifact.model_config
        self.hidden = int(mc.hidden_size)
        self.num_heads = int(mc.num_heads)
        self.num_layers = int(mc.num_layers)
        self.max_len = int(decode_cfg.max_len or mc.max_seq_len)
        self.page_size = int(decode_cfg.page_size)
        self.kv_dtype = decode_cfg.kv_dtype
        self.row_buckets = batch_buckets(decode_cfg.max_streams, self.dp)
        self.max_rows = self.row_buckets[-1]
        self.page_buckets = page_table_buckets(
            self.max_len, self.page_size, decode_cfg.page_buckets)
        self.prompt_buckets = ([int(b) for b in decode_cfg.prompt_buckets]
                               or [self.max_len])
        if self.prompt_buckets[-1] < self.max_len:
            # An evicted stream re-prefills over prompt + generated, so
            # the prompt ladder must reach max_len.
            self.prompt_buckets.append(self.max_len)
        self.pool = PagePool(decode_cfg.num_pages)
        self._params = self._place_params(artifact)
        self._pool = make_kv_pool(self.num_layers, decode_cfg.num_pages,
                                  self.page_size, self.hidden, self.kv_dtype,
                                  device=self.device)
        self._fwd = dict(num_heads=self.num_heads, page_size=self.page_size,
                         kv_dtype=self.kv_dtype)
        self._compiled: set[tuple] = set()

        self._cond = threading.Condition()
        self._queue: deque[DecodeStream] = deque()
        self._slots: list[DecodeStream | None] = [None] * self.max_rows
        self._state = "running"  # running | draining | closed
        self._pending_reload: tuple | None = None
        self._reloads = 0
        self._replica_label = os.environ.get("DTF_REPLICA_ID", "engine")
        self._t_start = time.monotonic()
        self._streams = 0
        self._streams_done = 0
        self._tokens = 0
        self._steps = 0
        self._step_ms = 0.0
        self._prefills = 0
        self._prefill_ms = 0.0
        self._occupancy = 0
        self._evictions = 0
        self._last_kv = 0.0
        self._scheduler_error: DecodeSchedulerError | None = None
        self._scheduler = threading.Thread(
            target=self._schedule_loop, name="dtf-decode-scheduler",
            daemon=True)
        self._scheduler.start()
        log.info(
            "decode engine up: step=%d dp=%d device=%s scheduler=%s kv=%s "
            "pages=%dx%d rows=%s page_buckets=%s prompt_buckets=%s "
            "max_len=%d", artifact.step, self.dp, self.device,
            decode_cfg.scheduler,
            self.kv_dtype, decode_cfg.num_pages, self.page_size,
            self.row_buckets, self.page_buckets, self.prompt_buckets,
            self.max_len)

    # ------------------------------------------------------ public API

    def submit(self, prompt, *, max_new_tokens: int | None = None,
               eos_id: int | None = None,
               return_logits: bool = False) -> DecodeStream:
        """Validate + enqueue one stream; tokens arrive on the returned
        stream's event queue as the scheduler produces them."""
        toks = [int(t) for t in (prompt or [])]
        if not toks:
            raise DecodeError("empty prompt — decode needs >= 1 token")
        vocab = self.artifact.vocab_size
        if min(toks) < 0 or max(toks) >= vocab:
            raise DecodeError(f"prompt ids must lie in [0, {vocab})")
        max_new = int(max_new_tokens or self.cfg.max_new_tokens)
        if max_new < 1:
            raise DecodeError("max_new_tokens must be >= 1")
        if len(toks) + max_new > self.max_len:
            raise StreamTooLongError(
                f"prompt ({len(toks)}) + max_new_tokens ({max_new}) "
                f"exceeds decode.max_len={self.max_len} — truncate the "
                f"prompt or raise the knob")
        need = pages_for(len(toks) + max_new - 1, self.page_size)
        if need > self.pool.capacity:
            raise CacheFullError(
                f"stream needs {need} KV pages but the pool has "
                f"{self.pool.capacity} allocatable (decode.num_pages="
                f"{self.cfg.num_pages}, page 0 reserved scratch) — "
                f"shorten the stream or grow decode.num_pages")
        stream = DecodeStream(toks, max_new, eos_id, return_logits)
        with self._cond:
            if self._state != "running":
                raise DecodeClosedError(
                    f"decode engine is {self._state} — not accepting "
                    f"streams")
            if len(self._queue) >= self.serve_cfg.queue_capacity:
                raise QueueFullError(
                    f"decode queue at capacity "
                    f"({self.serve_cfg.queue_capacity}) — retry with "
                    f"backoff")
            err = self._scheduler_error
            if err is not None:
                raise err
            self._queue.append(stream)
            self._streams += 1
            self._cond.notify_all()
        return stream

    def generate(self, prompt, *, max_new_tokens: int | None = None,
                 eos_id: int | None = None, return_logits: bool = False,
                 timeout: float | None = None) -> dict[str, Any]:
        """Synchronous :meth:`submit` — the completion summary."""
        return self.submit(
            prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            return_logits=return_logits).result(timeout)

    def request_reload(self, artifact_dir: str) -> Future:
        """Stage a live weight swap. The scheduler stops admitting, lets
        every in-flight stream run to completion on the OLD weights
        (drain, never kill), swaps in one locked assignment, then resumes
        admission — queued streams decode on the new weights. Validation
        and placement on the device happen here on the calling thread, so
        a bad artifact raises :class:`~serve.engine.ReloadError` without
        the scheduler ever seeing it."""
        try:
            art = load_artifact(artifact_dir)
        except (ValueError, OSError) as e:
            raise ReloadError(
                f"decode reload rejected, still serving step "
                f"{self.artifact.step}: {e}") from e
        if art.task != "mlm":
            raise ReloadError(
                f"decode reload rejected: artifact task {art.task!r} != "
                f"serving task 'mlm'")
        if art.model_config != self.artifact.model_config:
            raise ReloadError(
                "decode reload rejected: model config differs from the "
                "serving artifact — a fleet swaps weights, not "
                "architectures")
        params = self._place_params(art)
        fut: Future = Future()
        with self._cond:
            if self._state != "running":
                raise DecodeClosedError(
                    f"decode engine is {self._state} — not accepting "
                    f"reloads")
            if self._pending_reload is not None:
                raise ReloadError(
                    "decode reload rejected: another reload is already "
                    "staged")
            self._pending_reload = (art, params, fut, time.monotonic())
            self._cond.notify_all()
        return fut

    def reload(self, artifact_dir: str,
               timeout: float | None = 60.0) -> dict[str, Any]:
        """Synchronous :meth:`request_reload` (server.py POST /reload)."""
        return self.request_reload(artifact_dir).result(timeout)

    def stats(self) -> dict[str, Any]:
        """Point-in-time decode counters for /healthz."""
        with self._cond:
            waiting = len(self._queue)
            active = sum(1 for s in self._slots if s is not None)
            snap = dict(
                state=self._state, streams=self._streams,
                streams_done=self._streams_done, tokens=self._tokens,
                steps=self._steps, step_ms_total=self._step_ms,
                prefills=self._prefills,
                prefill_ms_total=self._prefill_ms,
                evictions=self._evictions, reloads=self._reloads,
                occupancy_rows=self._occupancy)
        free = self.pool.available()
        snap.update({
            "streams_active": active,
            "streams_waiting": waiting,
            "scheduler": self.cfg.scheduler,
            "kv_dtype": self.kv_dtype,
            "device": str(self.device),
            "tokens_per_sec": self._tokens / max(
                time.monotonic() - self._t_start, 1e-9),
            "avg_occupancy": (snap["occupancy_rows"]
                              / max(1, snap["steps"]) / self.max_rows),
            "pages": {"total": self.pool.num_pages,
                      "allocatable": self.pool.capacity,
                      "free": free, "used": self.pool.capacity - free,
                      "page_size": self.page_size},
            "row_buckets": self.row_buckets,
            "page_buckets": self.page_buckets,
            "prompt_buckets": self.prompt_buckets,
            "max_len": self.max_len,
            "compiled_buckets": sorted(str(k) for k in self._compiled),
        })
        return snap

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admission, finish every queued and in-flight stream, stop
        the scheduler. Returns True when everything completed within
        ``timeout``; leftovers fail with DecodeClosedError rather than
        hanging their clients."""
        with self._cond:
            if self._state == "closed":
                return True
            self._state = "draining"
            self._cond.notify_all()
        self._scheduler.join(timeout)
        drained = not self._scheduler.is_alive()
        with self._cond:
            self._state = "closed"
            leftovers = list(self._queue)
            self._queue.clear()
            leftovers += [s for s in self._slots if s is not None]
            self._slots = [None] * self.max_rows
            pending, self._pending_reload = self._pending_reload, None
            err, self._scheduler_error = self._scheduler_error, None
            self._cond.notify_all()
        for s in leftovers:
            s.fail(DecodeClosedError(
                "decode drain timed out before this stream finished"))
        if pending is not None:
            pending[2].set_exception(DecodeClosedError(
                "decode engine drained before the staged reload applied"))
        self._emit_kv(event="drain")
        log.info("decode engine drained: %d streams, %d tokens, "
                 "%d evictions, %d undrained",
                 self._streams_done, self._tokens, self._evictions,
                 len(leftovers))
        if err is not None:
            raise err
        return drained and not leftovers

    # ------------------------------------------------------- scheduler

    def _place_params(self, artifact: Artifact) -> dict:
        """Serving layout of an artifact's tensors on the device
        (models/bert.decode_params). Used at construction AND on every
        live reload so the two paths can never diverge in layout."""
        return decode_params(artifact.state_dict, self.device)

    def _active_locked(self) -> bool:
        return any(s is not None for s in self._slots)

    def _schedule_loop(self) -> None:
        try:
            while self._tick():
                pass
        except BaseException as e:  # funnel: surface on drain()/submit()
            log.error("decode scheduler thread failed", exc_info=True)
            err = DecodeSchedulerError(e)
            with self._cond:
                self._scheduler_error = err
                victims = [s for s in self._slots if s is not None]
                victims += list(self._queue)
                self._queue.clear()
                self._slots = [None] * self.max_rows
            for s in victims:
                s.fail(err)

    def _tick(self) -> bool:
        with self._cond:
            while (not self._queue and not self._active_locked()
                   and self._pending_reload is None):
                if self._state != "running":
                    return False
                self._cond.wait(0.05)
        self._maybe_apply_reload()
        self._admit()
        active = [s for s in self._slots if s is not None]
        if active:
            self._step(active)
        self._maybe_emit_kv()
        return True

    def _admit(self) -> None:
        with self._cond:
            if (self.cfg.scheduler == "static" and self._active_locked()):
                return  # static A/B arm: join at batch boundary only
        while True:
            with self._cond:
                if self._pending_reload is not None:
                    return  # reload staged: drain actives before swap
                if not self._queue:
                    return
                free_slots = [i for i, s in enumerate(self._slots)
                              if s is None]
                if not free_slots:
                    return
                stream = self._queue[0]
                need = pages_for(len(stream.tokens), self.page_size)
                # One page of headroom per active stream keeps admission
                # from starving rows that will cross a page boundary on
                # the very next token (eviction thrash).
                headroom = sum(1 for s in self._slots if s is not None)
                if self.pool.available() < need + headroom:
                    return
                pages = self.pool.alloc(need)
                if pages is None:
                    return
                self._queue.popleft()
                slot = free_slots[0]
                stream.pages = pages
                stream.slot = slot
                stream.admissions += 1
                stream.t_admit = time.monotonic()
                self._slots[slot] = stream
            self._prefill_stream(stream)

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device, torch.int64)

    def _prefill_stream(self, stream: DecodeStream) -> None:
        n = len(stream.tokens)
        seq_bucket = pick_bucket(n, self.prompt_buckets)
        page_bucket = pick_bucket(len(stream.pages), self.page_buckets)
        ids = np.zeros((1, seq_bucket), np.int64)
        ids[0, :n] = stream.tokens
        table = np.zeros((page_bucket,), np.int64)
        table[:len(stream.pages)] = stream.pages
        key = ("prefill", seq_bucket, page_bucket)
        first = key not in self._compiled
        t0 = time.monotonic()
        logits = prefill(self._params, self._pool, self._tensor(ids),
                         self._tensor(np.asarray([n])), self._tensor(table),
                         **self._fwd)
        logits = logits.cpu().numpy()  # waits for the device
        ms = (time.monotonic() - t0) * 1e3
        with self._cond:
            self._prefills += 1
            self._prefill_ms += ms
        if first:
            self._note_compiled(key, ms)
        self._finish_token(stream, logits)

    def _step(self, active: list[DecodeStream]) -> None:
        # Grow each row's page list to cover the position it writes this
        # step; under pressure, preempt the newest-admitted other stream.
        for s in list(active):
            if s not in active:
                continue  # evicted earlier in this very loop
            if s.slot < 0:
                active.remove(s)
                continue
            need = pages_for(len(s.tokens), self.page_size)
            while len(s.pages) < need:
                got = self.pool.alloc(1)
                if got is not None:
                    s.pages.extend(got)
                    continue
                victim = self._evict_for(s)
                if victim is None:
                    # Unreachable: submit-time capacity check guarantees
                    # a solo page-holder always fits. Fail loud, not hang.
                    raise RuntimeError(
                        "KV pool exhausted with no evictable stream")
                if victim in active:
                    active.remove(victim)
        if not active:
            return
        rows = active
        r_bucket = pick_bucket(len(rows), self.row_buckets)
        p_bucket = max(pick_bucket(len(s.pages), self.page_buckets)
                       for s in rows)
        ids = np.zeros((r_bucket,), np.int64)
        positions = np.zeros((r_bucket,), np.int64)
        table = np.zeros((r_bucket, p_bucket), np.int64)
        for r, s in enumerate(rows):
            ids[r] = s.tokens[-1]
            positions[r] = len(s.tokens) - 1
            table[r, :len(s.pages)] = s.pages
        key = ("decode", r_bucket, p_bucket)
        first = key not in self._compiled
        t0 = time.monotonic()
        logits = decode_step(self._params, self._pool, self._tensor(ids),
                             self._tensor(positions), self._tensor(table),
                             **self._fwd)
        logits = logits.cpu().numpy()  # waits for the device
        ms = (time.monotonic() - t0) * 1e3
        if first:
            self._note_compiled(key, ms)
        with self._cond:
            self._steps += 1
            self._step_ms += ms
            self._occupancy += len(rows)
        if self._tw:
            self._tw.emit(
                telemetry.KIND_DECODE_STEP,
                metrics={"rows": len(rows), "padded_rows": r_bucket,
                         "step_ms": ms,
                         "per_token_ms": ms / len(rows),
                         "occupancy": len(rows) / self.max_rows})
        for r, s in enumerate(rows):
            self._finish_token(s, logits[r])

    def _finish_token(self, stream: DecodeStream, logits_row) -> None:
        token = int(np.argmax(logits_row))
        pages: list[int] = []
        with self._cond:
            stream.emit_token(
                token,
                logits=(np.array(logits_row, np.float32)
                        if stream.return_logits else None))
            # First token flushes immediately (TTFT); after that the
            # buffer drains every stream_interval tokens, i.e. every
            # stream_interval steps, since a stream lands at most one
            # token per step. finish()/fail() flush the remainder.
            if (len(stream.generated) == 1
                    or len(stream._buf) >= self.cfg.stream_interval):
                stream.flush_events()
            self._tokens += 1
            hit_eos = (stream.eos_id is not None
                       and token == stream.eos_id)
            done = hit_eos or len(stream.generated) >= stream.max_new
            if done:
                if stream.slot >= 0:
                    self._slots[stream.slot] = None
                stream.slot = -1
                pages, stream.pages = stream.pages, []
                self._streams_done += 1
        if done:
            self.pool.free(pages)
            stream.finish("eos" if hit_eos else "length")
            with self._cond:
                self._cond.notify_all()

    def _evict_for(self, needy: DecodeStream) -> DecodeStream | None:
        """Preempt the newest-admitted OTHER stream: free its pages and
        requeue it at the FRONT — it re-prefills over prompt + everything
        generated so far, so no token is re-emitted and its next token
        simply continues the stream. Newest-first preserves progress for
        the oldest stream, which by the submit-time capacity check can
        always finish solo."""
        with self._cond:
            candidates = [s for s in self._slots
                          if s is not None and s is not needy]
            if not candidates:
                return None
            victim = max(candidates, key=lambda s: s.t_admit)
            self._slots[victim.slot] = None
            victim.slot = -1
            pages, victim.pages = victim.pages, []
            self._queue.appendleft(victim)
            self._evictions += 1
        self.pool.free(pages)
        self._emit_kv(event="evict")
        return victim

    def _maybe_apply_reload(self) -> None:
        with self._cond:
            if self._pending_reload is None or self._active_locked():
                return  # actives finish on the old weights first
            pending, self._pending_reload = self._pending_reload, None
        art, params, fut, t0 = pending
        old = self.artifact
        with self._cond:
            self.artifact = art
            self._params = params
            self._reloads += 1
        reload_ms = (time.monotonic() - t0) * 1e3
        if self._tw:
            self._tw.emit(
                telemetry.KIND_SERVE_RELOAD,
                metrics={"reload_ms": reload_ms},
                replica=self._replica_label, ok=True, engine="decode",
                from_digest=old.version_digest,
                to_digest=art.version_digest,
                from_step=old.step, to_step=art.step)
        log.info("decode live reload: step %d -> %d (%.0f ms, drained)",
                 old.step, art.step, reload_ms)
        fut.set_result({
            "from_step": old.step, "to_step": art.step,
            "from_digest": old.version_digest,
            "to_digest": art.version_digest,
            "reload_ms": reload_ms,
        })

    # ------------------------------------------------------- telemetry

    def _note_compiled(self, key: tuple, ms: float) -> None:
        """First run of a (kind, bucket, bucket) shape: on the card it
        includes the allocator's first growth, the port's counterpart of
        the JAX engine's compile."""
        self._compiled.add(key)
        kind, a, b = key
        label = (f"prefill:seq{a}xpages{b}" if kind == "prefill"
                 else f"decode:rows{a}xpages{b}")
        if self._tw:
            self._tw.emit(telemetry.KIND_SERVE_RECOMPILE,
                          metrics={"compile_ms": ms}, bucket=label)
        log.info("decode first run of bucket %s in %.0f ms", label, ms)

    def _maybe_emit_kv(self) -> None:
        now = time.monotonic()
        if now - self._last_kv < self.serve_cfg.report_interval_s:
            return
        self._last_kv = now
        self._emit_kv()

    def _emit_kv(self, event: str = "sample") -> None:
        if not self._tw:
            return
        with self._cond:
            waiting = len(self._queue)
            active = sum(1 for s in self._slots if s is not None)
            evictions = self._evictions
        free = self.pool.available()
        self._tw.emit(
            telemetry.KIND_KV_CACHE,
            metrics={"pages_used": self.pool.capacity - free,
                     "pages_free": free,
                     "streams_active": active,
                     "streams_waiting": waiting,
                     "evictions": evictions},
            event=event)
