"""Stdlib-only HTTP front end for the inference engine.

Port of ``serve/server.py``: one ThreadingHTTPServer (a worker thread per
connection, each blocking in ``engine.predict`` while the batcher
coalesces across them — that blocking IS the dynamic batching window):

  * ``POST /predict`` — ``{"inputs": {...}}`` in, ``{"outputs": [...]}``
    out. Validation and oversize/too-long → 400, backpressure and draining
    → 503 (retryable), anything else → 500.
  * ``GET /healthz`` — liveness, the artifact's input spec and the engine
    counters.
  * ``POST /generate`` and ``POST /reload`` answer 404 naming the
    ROADMAP.md item that ports them.

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

from distributed_tensorflow_framework_torch.core import telemetry
from distributed_tensorflow_framework_torch.core.config import ServeConfig
from distributed_tensorflow_framework_torch.serve.engine import (
    EngineClosedError,
    InferenceEngine,
    OversizeRequestError,
    QueueFullError,
    SequenceTooLongError,
    ServeError,
)

log = logging.getLogger(__name__)

_MAX_BODY = 64 * 1024 * 1024  # refuse absurd request bodies outright
_NOT_PORTED = {
    "/generate": "autoregressive decode is not ported yet — ROADMAP.md "
                 "queue A item A15",
    "/reload": "live weight reload is not ported yet — ROADMAP.md queue A "
               "item A15",
}


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
                 telemetry_writer=None):
        self.engine = engine
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
                else:
                    self._reply(404, {"error": _NOT_PORTED.get(
                        self.path, f"no route {self.path}")})

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
        try:
            if self._draining.is_set():
                handler._reply(503, {"error": "draining", "retryable": True})
                return
            length = int(handler.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                handler._reply(400, {"error": f"bad Content-Length {length}"})
                return
            payload = json.loads(handler.rfile.read(length))
            inputs = payload.get("inputs")
            if not isinstance(inputs, dict):
                handler._reply(
                    400, {"error": "body must be {\"inputs\": {...}}"})
                return
            outputs = np.asarray(self.engine.predict(
                inputs, timeout=self.cfg.drain_timeout_s))
            handler._reply(200, {
                "outputs": outputs.tolist(),
                "rows": int(outputs.shape[0]),
                "step": self.engine.artifact.step,
            })
        except (OversizeRequestError, SequenceTooLongError) as e:
            handler._reply(400, {"error": str(e)})
        except (QueueFullError, EngineClosedError) as e:
            handler._reply(503, {"error": str(e), "retryable": True})
        except ServeError as e:
            handler._reply(400, {"error": str(e)})
        except json.JSONDecodeError as e:
            handler._reply(400, {"error": f"invalid JSON: {e}"})
        except Exception as e:  # noqa: BLE001 — server must outlive a bad request
            log.exception("predict failed")
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
            "artifact": {"step": art.step,
                         "param_spec_digest": art.param_spec_digest,
                         "content_digest": art.version_digest},
            "engine": self.engine.stats(),
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
        log.info("serving on http://%s:%d (predict, healthz)",
                 self.host, self.port)
        self.httpd.serve_forever()
        self.httpd.server_close()
        if self._draining.is_set():
            # A signal-triggered drain stops this loop from its own daemon
            # thread and finishes after; the process must not exit first.
            self._done.wait(self.cfg.drain_timeout_s)
        if self._drain_error is not None:
            raise self._drain_error
