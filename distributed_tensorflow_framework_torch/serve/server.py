"""Stdlib-only HTTP front end for the inference engine.

Port of ``serve/server.py``: one ThreadingHTTPServer (a worker thread per
connection, each blocking in ``engine.predict`` while the batcher
coalesces across them — that blocking IS the dynamic batching window):

  * ``POST /predict`` — ``{"inputs": {...}}`` in, ``{"outputs": [...]}``
    out. Validation and oversize/too-long → 400, backpressure and draining
    → 503 (retryable), anything else → 500.
  * ``POST /generate`` — ``{"prompt": [ids...], ...}`` in, a chunked
    NDJSON stream out: one ``{"token", "index"}`` line per generated
    token as the decode engine (serve/decode.py) produces it, then one
    ``{"done": true, ...}`` summary line. 404 without a decode engine.
  * ``POST /reload`` — ``{"artifact_dir": ...}``: live weight swap via
    the engine's between-batches reload (then the decode engine's, which
    drains its streams first). Verification failure → 409 with the old
    weights still serving.
  * ``GET /healthz`` — liveness, the artifact's input spec, the engine
    counters, the digest of the artifact actually being served, the
    device memory (core/memstats.py) and the engine's goodput, and the
    decode engine's counters.

A ``/predict`` with an ``X-DTF-Trace`` header (core/tracing.py) adopts
the sender's clock sample and runs under a ``serve.request`` span that is
the parent of the engine's spans; a malformed header is logged and the
request served untraced.

SIGTERM drains: stop admission, finish every queued request within
``serve.drain_timeout_s``, then return from ``serve_forever``.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from distributed_tensorflow_framework_torch.core import telemetry, tracing
from distributed_tensorflow_framework_torch.core.config import ServeConfig
from distributed_tensorflow_framework_torch.serve.decode import (
    CacheFullError,
    StreamTooLongError,
)
from distributed_tensorflow_framework_torch.serve.engine import (
    EngineClosedError,
    InferenceEngine,
    OversizeRequestError,
    QueueFullError,
    ReloadError,
    SequenceTooLongError,
    ServeError,
)

log = logging.getLogger(__name__)

_MAX_BODY = 64 * 1024 * 1024  # refuse absurd request bodies outright


class ServeDrainError(RuntimeError):
    """The signal-triggered drain thread failed. Stored by the drain thread
    and re-raised when :meth:`ServingServer.serve_forever` returns, so a
    drain failure never leaves ``serve_forever`` blocked with the error
    lost to a daemon thread's stderr."""

    def __init__(self, cause: BaseException):
        super().__init__(
            f"serve drain failed: {type(cause).__name__}: {cause}")
        self.__cause__ = cause


class ServingServer:
    """Engine + ThreadingHTTPServer, owning the drain choreography."""

    def __init__(self, engine: InferenceEngine, serve_cfg: ServeConfig, *,
                 decode_engine=None, telemetry_writer=None):
        self.engine = engine
        # Optional serve/decode.DecodeEngine (decode.enabled + mlm task):
        # adds the streaming POST /generate route.
        self.decode_engine = decode_engine
        self.cfg = serve_cfg
        self._tw = telemetry_writer
        self._draining = threading.Event()
        self._done = threading.Event()
        self._drain_error: ServeDrainError | None = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                log.debug("%s %s", self.address_string(), fmt % args)

            def _reply(self, status: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/healthz":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                outer.handle_healthz(self)

            def do_POST(self):
                if self.path == "/predict":
                    outer.handle_predict(self)
                elif self.path == "/generate":
                    outer.handle_generate(self)
                elif self.path == "/reload":
                    outer.handle_reload(self)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

        class Server(ThreadingHTTPServer):
            # The socketserver default accept backlog of 5 drops
            # connections under concurrent load — size it to the engine's
            # admission bound instead.
            request_queue_size = max(128, serve_cfg.queue_capacity)

        # Port 0 asks the OS for an ephemeral port; cli/serve.py writes
        # the RESOLVED endpoint to endpoint.json so tooling can find it.
        self.httpd = Server((serve_cfg.host, serve_cfg.port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]

    # ------------------------------------------------------------ routes

    def handle_predict(self, handler) -> None:
        # An incoming X-DTF-Trace: adopt the sender's clock sample, open
        # the request span, and hand its context to the engine so the
        # queue/batch/compute spans chain under it.
        ctx = tracing.safe_parse(handler.headers.get(tracing.TRACE_HEADER))
        span = None
        if ctx is not None:
            self.engine.tracer.adopt(ctx)
            span = self.engine.tracer.start("serve.request", ctx)
        sent: dict[str, int] = {}

        def reply(status: int, payload: dict) -> None:
            sent["status"] = status
            handler._reply(status, payload)

        try:
            if self._draining.is_set():
                reply(503, {"error": "draining", "retryable": True})
                return
            length = int(handler.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                reply(400, {"error": f"bad Content-Length {length}"})
                return
            payload = json.loads(handler.rfile.read(length))
            inputs = payload.get("inputs")
            if not isinstance(inputs, dict):
                reply(400, {"error": "body must be {\"inputs\": {...}}"})
                return
            outputs = np.asarray(self.engine.predict(
                inputs, timeout=self.cfg.drain_timeout_s,
                trace=span.context() if span is not None else None))
            reply(200, {
                "outputs": outputs.tolist(),
                "rows": int(outputs.shape[0]),
                "step": self.engine.artifact.step,
            })
        except (OversizeRequestError, SequenceTooLongError) as e:
            reply(400, {"error": str(e)})
        except (QueueFullError, EngineClosedError) as e:
            reply(503, {"error": str(e), "retryable": True})
        except ServeError as e:
            reply(400, {"error": str(e)})
        except json.JSONDecodeError as e:
            reply(400, {"error": f"invalid JSON: {e}"})
        except Exception as e:  # noqa: BLE001 — server must outlive a bad request
            log.exception("predict failed")
            reply(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            if span is not None:
                status = sent.get("status", 500)
                span.end(status="ok" if status < 400 else f"http_{status}",
                         http_status=status)

    @staticmethod
    def _write_chunk(handler, data: bytes, flush: bool = True) -> None:
        """One HTTP/1.1 chunked-transfer frame — a token event must
        reach the client the moment it exists. ``flush=False`` lets the
        generate loop coalesce a burst of already-queued frames into one
        syscall; the burst's LAST frame always flushes."""
        handler.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        if flush:
            handler.wfile.flush()

    @staticmethod
    def _end_chunks(handler) -> None:
        handler.wfile.write(b"0\r\n\r\n")
        handler.wfile.flush()

    def handle_generate(self, handler) -> None:
        """``POST /generate {"prompt": [ids...], ...}`` — streamed
        autoregressive decode. The reply is chunked NDJSON: one
        ``{"token": ..., "index": ...}`` line per generated token as the
        continuous batcher produces it, closed by one ``{"done": true,
        ...summary}`` line. Submit-time errors map like /predict
        (too-long/never-fits → 400, backpressure/draining → 503
        retryable); a mid-stream failure becomes an ``{"error": ...}``
        line because the 200 status is already on the wire."""
        if self.decode_engine is None:
            handler._reply(404, {
                "error": "decode disabled — set decode.enabled=true and "
                         "serve an mlm artifact"})
            return
        try:
            if self._draining.is_set():
                handler._reply(503, {"error": "draining", "retryable": True})
                return
            length = int(handler.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                handler._reply(400, {"error": f"bad Content-Length {length}"})
                return
            payload = json.loads(handler.rfile.read(length))
            prompt = payload.get("prompt")
            if not isinstance(prompt, list) or not prompt:
                handler._reply(400, {
                    "error": "body must be {\"prompt\": [token ids...]}"})
                return
            stream = self.decode_engine.submit(
                prompt,
                max_new_tokens=payload.get("max_new_tokens"),
                eos_id=payload.get("eos_id"),
                return_logits=bool(payload.get("return_logits")))
        except (StreamTooLongError, CacheFullError) as e:
            # Neither gets better on retry: the stream as requested can
            # never be admitted.
            handler._reply(400, {"error": str(e)})
            return
        except (QueueFullError, EngineClosedError) as e:
            handler._reply(503, {"error": str(e), "retryable": True})
            return
        except ServeError as e:
            handler._reply(400, {"error": str(e)})
            return
        except json.JSONDecodeError as e:
            handler._reply(400, {"error": f"invalid JSON: {e}"})
            return
        except Exception as e:  # noqa: BLE001 — server must outlive a bad request
            log.exception("generate submit failed")
            handler._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.send_header("X-DTF-Step",
                            str(self.decode_engine.artifact.step))
        handler.end_headers()
        try:
            for kind, ev in stream.events(timeout=self.cfg.drain_timeout_s):
                if kind == "token":
                    if "logits" in ev:
                        line = json.dumps(
                            dict(ev, logits=ev["logits"].tolist()))
                    else:
                        # Hand-rolled frame for the hot path: one frame
                        # per generated token.
                        line = ('{"token":%d,"index":%d}'
                                % (ev["token"], ev["index"]))
                else:
                    line = json.dumps({"done": True, **ev})
                self._write_chunk(handler, (line + "\n").encode(),
                                  flush=stream.pending() == 0)
            self._end_chunks(handler)
        except Exception as e:  # noqa: BLE001 — status already on the wire
            log.warning("generate stream aborted: %s: %s",
                        type(e).__name__, e)
            try:
                self._write_chunk(handler, (json.dumps(
                    {"error": f"{type(e).__name__}: {e}",
                     "retryable": isinstance(e, EngineClosedError)})
                    + "\n").encode())
                self._end_chunks(handler)
            except OSError:
                pass  # client already gone

    def handle_reload(self, handler) -> None:
        """``POST /reload {"artifact_dir": ...}`` — live weight swap.

        Not idempotent: a rejected reload (tamper, mismatch) is 409 with
        the engine still on the old weights.
        """
        if self._draining.is_set():
            handler._reply(503, {"error": "draining", "retryable": True})
            return
        try:
            length = int(handler.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                handler._reply(400, {"error": f"bad Content-Length {length}"})
                return
            payload = json.loads(handler.rfile.read(length))
            artifact_dir = payload.get("artifact_dir")
            if not isinstance(artifact_dir, str) or not artifact_dir:
                handler._reply(
                    400, {"error": "body must be {\"artifact_dir\": ...}"})
                return
            result = self.engine.reload(
                artifact_dir, timeout=self.cfg.drain_timeout_s)
            if self.decode_engine is not None:
                # Same artifact, second engine: the decode swap blocks
                # until its in-flight streams finish on the old weights,
                # so give it the full drain budget. A decode-side
                # rejection is the same 409 contract — but the
                # single-shot engine already swapped, so say so.
                try:
                    decode_result = self.decode_engine.reload(
                        artifact_dir, timeout=self.cfg.drain_timeout_s)
                except ReloadError as e:
                    raise ReloadError(
                        f"decode engine rejected the reload (single-shot "
                        f"engine already swapped): {e}") from e
                result = {**result, "decode": decode_result}
            handler._reply(200, {"reloaded": True, **result})
        except ReloadError as e:
            handler._reply(409, {"error": str(e), "reloaded": False})
        except EngineClosedError as e:
            handler._reply(503, {"error": str(e), "retryable": True})
        except json.JSONDecodeError as e:
            handler._reply(400, {"error": f"invalid JSON: {e}"})
        except Exception as e:  # noqa: BLE001 — server must outlive a bad request
            log.exception("reload failed")
            handler._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def handle_healthz(self, handler) -> None:
        status = 503 if self._draining.is_set() else 200
        art = self.engine.artifact
        handler._reply(status, {
            "status": "draining" if status == 503 else "ok",
            "task": art.task,
            "model": art.model_config.name,
            "step": art.step,
            "vocab_size": art.vocab_size,
            "input_spec": art.input_spec,
            # Which weights am I ACTUALLY serving.
            "artifact": self.engine.artifact_info(),
            "engine": self.engine.stats(),
            # Live device memory and goodput: a load generator diffs them
            # across a window.
            "memory": self.engine.memory_snapshot(),
            "goodput": self.engine.goodput_snapshot(),
            # KV-cache occupancy + stream counters when the decode path
            # is enabled (None otherwise).
            "decode": (self.decode_engine.stats()
                       if self.decode_engine is not None else None),
        })

    # ------------------------------------------------------------- drain

    def shutdown(self, reason: str = "shutdown") -> bool:
        """Stop admission → drain the engine → stop the HTTP loop.
        Idempotent; safe from any thread. Returns the engine's
        drained-clean verdict."""
        if self._draining.is_set():
            self._done.wait(self.cfg.drain_timeout_s)
            return True
        self._draining.set()
        log.info("drain started (%s): refusing new requests, %d queued",
                 reason, self.engine.stats()["queue_depth"])
        drained = self.engine.drain(self.cfg.drain_timeout_s)
        if self.decode_engine is not None:
            # Streams still get their remaining tokens during the drain
            # window — a deploy must not truncate mid-generation.
            drained = self.decode_engine.drain(
                self.cfg.drain_timeout_s) and drained
        if self._tw:
            self._tw.emit(
                telemetry.KIND_HEALTH,
                health={"event": "serve_drain", "reason": reason,
                        "clean": drained})
        self.httpd.shutdown()
        log.info("drain complete (clean=%s)", drained)
        self._done.set()
        return drained

    def install_sigterm_drain(self) -> None:
        """SIGTERM/SIGINT → graceful drain. Must be called from the main
        thread (signal module requirement); the handler only spawns the
        drain thread."""

        def _drain():
            try:
                self.shutdown("sigterm")
            except BaseException as e:  # noqa: BLE001 — surface, don't hang
                log.error("sigterm drain failed", exc_info=True)
                self._drain_error = ServeDrainError(e)
                self._done.set()
                self.httpd.shutdown()

        def _on_term(signum, frame):
            del signum, frame
            threading.Thread(
                target=_drain, name="dtf-serve-drain", daemon=True).start()

        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)

    def serve_forever(self) -> None:
        """Block until shutdown() (or SIGTERM via the installed handler)."""
        log.info("serving on http://%s:%d (predict, generate, reload, "
                 "healthz)", self.host, self.port)
        self.httpd.serve_forever()
        self.httpd.server_close()
        if self._draining.is_set():
            # A signal-triggered drain stops this loop from its own daemon
            # thread and finishes after; the process must not exit first.
            self._done.wait(self.cfg.drain_timeout_s)
        if self._drain_error is not None:
            raise self._drain_error
