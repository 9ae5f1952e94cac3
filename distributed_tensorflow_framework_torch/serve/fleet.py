"""Health-aware fleet router: N replica engines behind one front door.

The port's copy of ``serve/fleet.py``. One replica process
(``cli/serve.py``) dies with every request it holds; the fleet treats a
replica's failure as the normal case: a stdlib ThreadingHTTPServer proxies
``POST /predict`` (and the session-pinned ``POST /generate``) across N
replica subprocesses and keeps the client whole while replicas die,
stall, or swap weights underneath it.

  * routing — the least-loaded admitted replica, scored by the live
    ``queue_depth`` each replica publishes on ``/healthz`` plus the
    router's own in-flight count.
  * hedged retries — every proxied request carries an end-to-end
    deadline (``serve.fleet_deadline_s``) and a per-attempt cap
    (``serve.fleet_attempt_timeout_s``); an attempt that has not answered
    inside the cap is abandoned and re-issued on a DIFFERENT replica with
    doubling backoff, at most ``serve.fleet_retries`` times. Only the
    idempotent ``POST /predict`` is retried; a 4xx is returned as it is.
  * circuit breaker — ``serve.fleet_eject_failures`` consecutive failures
    or a ``/healthz`` older than ``serve.fleet_healthz_stale_s`` eject a
    replica; the background prober readmits it on its first healthy
    answer.
  * supervision — a dead subprocess is restarted with core/supervision.py's
    ``backoff_seconds`` and a ``CrashLoopBreaker`` keyed on (rc, requests
    served, artifact step), so a replica that dies the same way twice
    without serving anything is left down. A replica that cannot reach
    its device exits nonzero at start-up, so the breaker stops it; nothing
    here falls back to another device.
  * shedding — when every admitted replica is saturated the router
    answers 503 + ``Retry-After`` (``serve.fleet_shed_retry_after_s``).
  * rolling reload — ``POST /reload {"artifact_dir"}`` walks the fleet one
    replica at a time: drain, reload (the engine's manifest-verified swap
    between batches), probe (``/healthz`` must report the NEW digest),
    readmit. A rejected reload aborts the roll. ``count`` and ``digest``
    scope the roll to part of the fleet; ``X-DTF-Model: <digest prefix>``
    pins a request to the replicas serving that artifact.
  * autoscaling — with ``serve.fleet_autoscale`` the prober tick feeds a
    pressure snapshot to serve/autoscale.py's policy: scale-up spawns one
    replica through the supervised launch path, scale-down retires the
    newest admitted replica through the drain path, within
    ``fleet_min_replicas``/``fleet_max_replicas`` and
    ``fleet_scale_cooldown_s``.
  * multi-tenant QoS — ``X-DTF-Tenant`` names a tenant whose class
    (``high``/``default``/``batch``) decides how much per-replica queue
    headroom it must leave free (``serve.tenant_priority_reserve``);
    per-tenant token buckets (``serve.tenant_quota_rps``) answer 429 +
    Retry-After before a replica slot is claimed.

Chaos drills ride core/faults.py: ``kill_replica``, ``stall_replica``,
``spike`` and ``tenant_stampede`` fire at the prober's ``fleet_chaos``
point, ``corrupt_reload`` at ``fleet_reload``. Telemetry: KIND_SERVE_ROUTE,
KIND_SERVE_EJECT, KIND_SERVE_RELOAD, KIND_SCALE and KIND_ADMISSION; a
client's ``X-DTF-Trace`` becomes a ``router.request`` span with a
``fleet.attempt`` child per try and ``fleet.backoff`` between them.

Stdlib only: the router imports no torch (the replicas own the device),
so it fronts any replica that speaks the HTTP contract.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import signal
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from distributed_tensorflow_framework_torch.core import (
    faults,
    supervision,
    telemetry,
    tracing,
)
from distributed_tensorflow_framework_torch.core.config import ServeConfig
from distributed_tensorflow_framework_torch.serve import autoscale

log = logging.getLogger(__name__)

_MAX_BODY = 64 * 1024 * 1024  # refuse absurd request bodies outright

# Client-facing QoS and multiplexing headers.
TENANT_HEADER = "X-DTF-Tenant"
MODEL_HEADER = "X-DTF-Model"
# Decode-session affinity: a generation session's KV pages live on ONE
# replica, so every /generate carrying the same X-DTF-Session value must
# land there.
SESSION_HEADER = "X-DTF-Session"


class FleetError(RuntimeError):
    """Base for fleet-router failures (typed so the CLI can map them to
    exit codes and the handler to HTTP statuses)."""


class ReplicaLaunchError(FleetError):
    """The replica launcher failed to produce a live subprocess."""


class FleetProberError(FleetError):
    """The background prober thread died. Stored by the prober and
    re-raised when the router exits — a silent prober outage would stop
    ejection/readmission/restart while routing blindly continues."""

    def __init__(self, cause: BaseException):
        super().__init__(
            f"fleet prober thread failed: {type(cause).__name__}: {cause}")
        self.__cause__ = cause


class FleetDrainError(FleetError):
    """The signal-triggered drain thread failed. Stored and re-raised
    from :meth:`FleetRouter.serve_forever` so the failure surfaces on
    the owning thread instead of a daemon thread's stderr."""

    def __init__(self, cause: BaseException):
        super().__init__(
            f"fleet drain failed: {type(cause).__name__}: {cause}")
        self.__cause__ = cause


@dataclass
class Replica:
    """One fronted engine and its circuit-breaker bookkeeping. All
    mutable fields are written under the router lock (or by the prober
    before the router starts)."""

    index: int
    url: str = ""
    proc: Any = None  # subprocess.Popen when launcher-managed
    endpoint_path: str = ""  # resolved lazily after (re)launch
    state: str = "ejected"  # admitted | ejected | draining | dead | retired
    give_up: bool = False  # crash-loop verdict or restart budget spent
    # Scale-down lifecycle: retiring = drain in progress (claim skips
    # it, supervision must NOT restart it); retired = drained + gone.
    retiring: bool = False
    retire_deadline: float = 0.0
    inflight: int = 0
    routed: int = 0
    consecutive_failures: int = 0
    restarts: int = 0
    next_restart_t: float = 0.0
    stalled_until: float = 0.0
    last_health: dict = field(default_factory=dict)
    last_health_t: float = 0.0
    breaker: supervision.CrashLoopBreaker = field(
        default_factory=lambda: supervision.CrashLoopBreaker(threshold=2))

    @property
    def label(self) -> str:
        return f"r{self.index}"

    def artifact_info(self) -> dict:
        return dict(self.last_health.get("artifact") or {})


def _http_json(url: str, *, data: bytes | None = None,
               timeout: float = 5.0,
               headers: dict[str, str] | None = None) -> tuple[int, dict]:
    """One HTTP exchange; transport failures (refused, reset, timed out,
    or a reply cut short when the replica dies while it writes it) come
    back as status 0 so callers treat them like any 5xx. ``headers`` adds
    to the defaults (trace propagation rides X-DTF-Trace here). The JAX
    package's copy lets ``http.client.IncompleteRead`` through, so a
    replica killed mid-reply costs its client a 500 there; here the
    attempt is retried like any other transport failure."""
    req = urllib.request.Request(
        url, data=data, method="POST" if data is not None else "GET",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read() or b"{}")
        except (ValueError, OSError, http.client.HTTPException):
            return e.code, {}
    except (urllib.error.URLError, OSError, ValueError,
            http.client.HTTPException) as e:
        return 0, {"error": f"{type(e).__name__}: {e}"}


def read_endpoint(path: str) -> str:
    """The replica URL from a cli/serve.py endpoint.json, or '' while
    the file is absent/torn (the replica is still booting)."""
    try:
        with open(path) as fh:
            record = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return ""
    url = record.get("url") if isinstance(record, dict) else None
    return url if isinstance(url, str) else ""


class FleetRouter:
    """The health-aware router over registered replicas.

    Thread layout: ThreadingHTTPServer worker threads block in
    :meth:`_proxy_predict`; one prober thread owns the replica
    lifecycle (health polls, eject/readmit, chaos faults, restarts);
    the rolling reload runs on the POST /reload handler thread. Shared
    counters and every Replica field are guarded by ``self._lock``.
    """

    def __init__(self, serve_cfg: ServeConfig, *, telemetry_writer=None,
                 launcher: Callable[[int], tuple[Any, str]] | None = None,
                 trace_enabled: bool = True,
                 flight_recorder: "tracing.FlightRecorder | None" = None):
        self.cfg = serve_cfg
        self._tw = telemetry_writer
        # Router-side tracing: a client's X-DTF-Trace becomes a
        # router.request span with one fleet.attempt child per hedged
        # try; each attempt's context rides the header to the replica.
        self.tracer = tracing.Tracer(
            telemetry_writer if trace_enabled else None, service="router")
        # Flight recorder (cli/fleet.py attaches it to the writer): the
        # prober dumps it when it observes a replica die, so the fault's
        # causal neighborhood survives even a torn replica JSONL.
        self.flightrec = flight_recorder
        if flight_recorder is not None and flight_recorder.tracer is None:
            flight_recorder.tracer = self.tracer
        # launcher(index) -> (Popen, endpoint_json_path). It must spawn
        # WITHOUT blocking on readiness — the prober resolves the
        # endpoint and readmits once /healthz answers, so one booting
        # replica never starves the health checks of the others.
        self._launcher = launcher
        self._lock = threading.Lock()
        self._replicas: list[Replica] = []
        self._draining = threading.Event()
        self._done = threading.Event()
        self._stop = threading.Event()
        self._serving = threading.Event()
        self._drain_error: FleetDrainError | None = None
        self._prober_error: FleetProberError | None = None
        self._rolling = False
        self._tick_count = 0
        self._chaos_armed = False
        self._chaos_tick = 0
        self._requests = 0
        self._retries_total = 0
        self._shed = 0
        self._deadline_exceeded = 0
        self._reload_rolls = 0
        # Decode-session affinity map (session id → replica index),
        # written under the router lock. Entries are dropped when the
        # pinned replica leaves the routable set for good (dead /
        # retired / ejected) so a later request repins cleanly.
        self._sessions: dict[str, int] = {}
        self._generate_streams = 0
        self._affinity_misses = 0
        # Multi-tenant QoS: per-tenant router ledger (routed / shed /
        # quota_rejected, exposed on /healthz) + the token buckets.
        self._tenants: dict[str, dict] = {}
        self._quotas = autoscale.TenantQuotas(
            serve_cfg.tenant_quota_rps, serve_cfg.tenant_quota_burst)
        # Chaos windows (core/faults.py spike / tenant_stampede): while
        # open they inject synthetic per-replica load — spike into the
        # autoscaler's pressure signal only, stampede into the claim
        # path too (saturating every unreserved queue slot).
        self._spike_until = 0.0
        self._spike_load = 0.0
        self._stampede_until = 0.0
        # Autoscaler (serve/autoscale.py): policy object + action ledger.
        self._autoscaler = (
            autoscale.Autoscaler(
                min_replicas=serve_cfg.fleet_min_replicas,
                max_replicas=serve_cfg.fleet_max_replicas,
                up_threshold=serve_cfg.fleet_scale_up_threshold,
                down_threshold=serve_cfg.fleet_scale_down_threshold,
                cooldown_s=serve_cfg.fleet_scale_cooldown_s,
            ) if serve_cfg.fleet_autoscale else None)
        self._scale_ups = 0
        self._scale_downs = 0
        self._shed_seen = 0  # shed counter at the last autoscale look
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                log.debug("%s %s", self.address_string(), fmt % args)

            def _reply(self, status: int, payload: dict,
                       headers: dict | None = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
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
            # Same accept-backlog sizing rationale as serve/server.py.
            request_queue_size = max(128, serve_cfg.queue_capacity)

        self.httpd = Server((serve_cfg.host, serve_cfg.port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._prober = threading.Thread(
            target=self._probe_loop, name="dtf-fleet-prober", daemon=True)

    # ------------------------------------------------------ registration

    def add_replica(self, *, url: str = "", proc: Any = None,
                    endpoint_path: str = "",
                    admitted: bool = False) -> Replica:
        """Register one replica. With ``admitted`` (externally managed,
        already known healthy — tests) it routes immediately; otherwise
        it starts ejected and earns admission from the prober."""
        with self._lock:
            rep = Replica(index=len(self._replicas), url=url, proc=proc,
                          endpoint_path=endpoint_path)
            if admitted:
                rep.state = "admitted"
                rep.last_health_t = time.monotonic()
            self._replicas.append(rep)
        return rep

    def spawn_replicas(self, count: int | None = None) -> None:
        """Launch ``count`` (default ``serve.fleet_replicas``) replicas
        through the launcher; they join the routable set as the prober
        sees them answer /healthz."""
        if self._launcher is None:
            raise ReplicaLaunchError(
                "no launcher configured — register replicas via "
                "add_replica(url=...) instead")
        n = int(count if count is not None else self.cfg.fleet_replicas)
        for _ in range(n):
            with self._lock:
                index = len(self._replicas)
            try:
                proc, endpoint_path = self._launcher(index)
            except Exception as e:
                raise ReplicaLaunchError(
                    f"replica r{index} failed to launch: {e}") from e
            self.add_replica(proc=proc, endpoint_path=endpoint_path)

    def start(self) -> None:
        """Start the background prober (idempotent-unsafe: call once)."""
        self._prober.start()

    def wait_ready(self, *, min_replicas: int | None = None,
                   timeout: float = 180.0) -> bool:
        """Block until ``min_replicas`` (default: all registered) are
        admitted, or the timeout passes. False = not ready (callers
        decide whether a partial fleet is acceptable)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                want = (len(self._replicas) if min_replicas is None
                        else int(min_replicas))
                up = sum(1 for r in self._replicas if r.state == "admitted")
            if up >= want:
                return True
            time.sleep(0.1)
        return False

    # ----------------------------------------------------------- routing

    def _stampede_load(self, now: float) -> int:
        """Synthetic per-replica load while a tenant_stampede window is
        open: batch-class traffic has filled every queue slot except the
        priority reserve, so only classes with reserved headroom route.
        Caller holds the lock."""
        if now >= self._stampede_until:
            return 0
        return max(0, self.cfg.queue_capacity
                   - max(1, self.cfg.tenant_priority_reserve))

    def _claim_replica(self, exclude: set[int], *, priority: int = 0,
                       digest: str | None = None) -> Replica | None:
        """Pick the least-loaded admitted replica (live healthz queue
        depth + router in-flight) and claim an in-flight slot on it.
        None = nothing routable (all ejected, excluded, stalled, or
        saturated for this priority class).

        QoS: a class ``priority`` steps below high may only claim a
        replica whose load leaves ``priority * tenant_priority_reserve``
        queue slots free — under exact-capacity load that sheds batch
        strictly before default before high. ``digest`` pins the claim
        to replicas serving a matching artifact (cross-model
        multiplexing via the X-DTF-Model header)."""
        now = time.monotonic()
        allowed = (self.cfg.queue_capacity
                   - priority * self.cfg.tenant_priority_reserve)
        with self._lock:
            synthetic = self._stampede_load(now)
            best: Replica | None = None
            best_key: tuple | None = None
            for rep in self._replicas:
                if rep.state != "admitted" or rep.index in exclude:
                    continue
                if rep.stalled_until > now:
                    continue  # known-wedged: don't feed it requests
                if digest:
                    rep_digest = str((rep.last_health.get("artifact") or {})
                                     .get("content_digest") or "")
                    if not rep_digest.startswith(digest):
                        continue  # serving a different model
                engine = rep.last_health.get("engine") or {}
                try:
                    depth = int(engine.get("queue_depth") or 0)
                except (TypeError, ValueError):
                    depth = 0
                load = depth + rep.inflight + synthetic
                if load >= allowed:
                    continue  # saturated for this class: shed, not queue
                # Tie-break equal load by total routed so sequential
                # traffic still round-robins instead of pinning r0.
                key = (load, rep.routed)
                if best is None or key < best_key:
                    best, best_key = rep, key
            if best is not None:
                best.inflight += 1
            return best

    def _release_replica(self, rep: Replica) -> None:
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)

    def _record_success(self, rep: Replica) -> None:
        with self._lock:
            rep.consecutive_failures = 0
            rep.routed += 1

    def _record_failure(self, rep: Replica, reason: str) -> None:
        with self._lock:
            rep.consecutive_failures += 1
            eject = (rep.state == "admitted" and rep.consecutive_failures
                     >= self.cfg.fleet_eject_failures)
            if eject:
                rep.state = "ejected"
        if eject:
            self._emit_eject(rep, action="eject", reason=reason)

    def _emit_eject(self, rep: Replica, *, action: str, reason: str,
                    **extra: Any) -> None:
        log.warning("fleet: %s %s (%s)", action, rep.label, reason)
        if self._tw:
            self._tw.emit(telemetry.KIND_SERVE_EJECT, replica=rep.label,
                          action=action, reason=reason, **extra)

    def _proxy_predict(
            self, body: bytes,
            client_ctx: "tracing.SpanContext | None" = None,
            *, priority: int = 0, tenant: str | None = None,
            model_digest: str | None = None,
    ) -> tuple[int, dict, Replica | None, dict]:
        """Deadline-bounded, hedged proxying of one idempotent /predict.

        Each attempt gets ``min(remaining deadline, attempt timeout)``;
        a failed or abandoned attempt retries on a DIFFERENT replica
        after a doubling backoff. When every admitted replica has been
        tried, reuse beats refusal (one survivor still serves a
        3-replica fleet with two down).

        With a client trace context, the whole exchange becomes one
        ``router.request`` span with a ``fleet.attempt`` child per try
        (and ``fleet.backoff`` children for the sleeps between); each
        attempt's own context rides ``X-DTF-Trace`` to the replica, so a
        hedged retry yields ONE tree: failed attempt and winning attempt
        side by side under the same root."""
        cfg = self.cfg
        tr = self.tracer
        root = None
        if client_ctx is not None:
            tr.adopt(client_ctx)
            root = tr.start("router.request", client_ctx)
        t0 = time.monotonic()
        deadline = t0 + cfg.fleet_deadline_s
        backoff = cfg.fleet_retry_backoff_ms / 1e3
        tried: set[int] = set()
        attempts = 0
        shed = deadline_exceeded = False
        status, payload = 0, {"error": "no admitted replica"}
        served_by: Replica | None = None
        while attempts <= cfg.fleet_retries:
            rep = self._claim_replica(
                tried, priority=priority, digest=model_digest)
            if rep is None and tried:
                rep = self._claim_replica(
                    set(), priority=priority, digest=model_digest)
            if rep is None:
                shed = True
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._release_replica(rep)
                deadline_exceeded = True
                break
            attempts += 1
            aspan = (tr.start("fleet.attempt", root, replica=rep.label,
                              attempt=attempts)
                     if root is not None else None)
            headers = ({tracing.TRACE_HEADER: aspan.context().encode()}
                       if aspan is not None else None)
            try:
                status, payload = _http_json(
                    rep.url + "/predict", data=body,
                    timeout=min(remaining, cfg.fleet_attempt_timeout_s),
                    headers=headers)
            finally:
                self._release_replica(rep)
            if status == 200:
                if aspan is not None:
                    aspan.end(status="ok", http_status=status)
                served_by = rep
                self._record_success(rep)
                break
            if 400 <= status < 500:
                # Deterministic request error — the replica is fine and
                # another replica would answer identically.
                if aspan is not None:
                    aspan.end(status=f"http_{status}", http_status=status)
                served_by = rep
                break
            if aspan is not None:
                aspan.end(status="error", http_status=status,
                          error=str(payload.get("error") or "")[:200])
            self._record_failure(rep, f"predict failed (status {status})")
            tried.add(rep.index)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                deadline_exceeded = True
                break
            if attempts <= cfg.fleet_retries:
                sleep_s = min(backoff, remaining, 1.0)
                bspan = (tr.start("fleet.backoff", root,
                                  after_attempt=attempts, backoff_s=sleep_s)
                         if root is not None else None)
                time.sleep(sleep_s)
                if bspan is not None:
                    bspan.end()
                backoff *= 2
        retries = max(0, attempts - 1)
        latency_ms = (time.monotonic() - t0) * 1e3
        with self._lock:
            self._requests += 1
            self._retries_total += retries
            if shed:
                self._shed += 1
            if deadline_exceeded:
                self._deadline_exceeded += 1
            if tenant is not None and not shed:
                led = self._tenants.setdefault(
                    tenant,
                    {"routed": 0, "shed": 0, "quota_rejected": 0})
                led["routed"] += 1
        if root is not None:
            root.end(
                status="ok" if status == 200 else (
                    "shed" if shed else
                    "deadline" if deadline_exceeded and status != 200
                    else f"status_{status}"),
                retries=retries, shed=shed,
                deadline_exceeded=deadline_exceeded,
                replica=served_by.label if served_by else None)
        if self._tw:
            # Sheds carry no tenant here: the KIND_ADMISSION event
            # handle_predict emits owns the per-tenant shed ledger, so
            # the run summary never double-counts one rejection.
            self._tw.emit(
                telemetry.KIND_SERVE_ROUTE,
                metrics={"latency_ms": latency_ms, "retries": retries,
                         "status": status},
                replica=served_by.label if served_by else None,
                shed=shed, deadline_exceeded=deadline_exceeded,
                tenant=None if shed else tenant,
                trace=client_ctx.trace_id if client_ctx else None)
        info = {"shed": shed, "deadline_exceeded": deadline_exceeded,
                "retries": retries}
        return status, payload, served_by, info

    # ------------------------------------------------------------ routes

    def _emit_admission(self, tenant: str, priority: int, verdict: str,
                        retry_after_s: float) -> None:
        """Record one router-level rejection (quota 429 or shed 503) in
        the per-tenant ledger and as a KIND_ADMISSION event."""
        with self._lock:
            led = self._tenants.setdefault(
                tenant, {"routed": 0, "shed": 0, "quota_rejected": 0})
            led["quota_rejected" if verdict == "quota" else "shed"] += 1
        if self._tw:
            self._tw.emit(
                telemetry.KIND_ADMISSION,
                tenant=tenant, priority=priority, verdict=verdict,
                retry_after_s=retry_after_s)

    def handle_predict(self, handler) -> None:
        if self._draining.is_set():
            handler._reply(503, {"error": "draining", "retryable": True})
            return
        try:
            length = int(handler.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                handler._reply(400, {"error": f"bad Content-Length {length}"})
                return
            body = handler.rfile.read(length)
            client_ctx = tracing.safe_parse(
                handler.headers.get(tracing.TRACE_HEADER))
            tenant = (handler.headers.get(TENANT_HEADER)
                      or self.cfg.tenant_default_class)
            priority = autoscale.priority_of(
                tenant, default_class=self.cfg.tenant_default_class)
            model_digest = handler.headers.get(MODEL_HEADER) or None
            # Admission control BEFORE any replica slot is claimed: a
            # tenant over its token bucket gets 429 + an honest
            # Retry-After (seconds until the next token refills).
            verdict = self._quotas.admit(tenant)
            if not verdict.ok:
                retry_after = max(0.05, verdict.retry_after_s)
                self._emit_admission(tenant, priority, "quota", retry_after)
                handler._reply(
                    429,
                    {"error": f"tenant {tenant!r} over quota "
                              f"({self.cfg.tenant_quota_rps:g} rps)",
                     "retryable": True, "tenant": tenant},
                    headers={"Retry-After": f"{retry_after:.3f}"})
                return
            status, payload, served_by, info = self._proxy_predict(
                body, client_ctx, priority=priority, tenant=tenant,
                model_digest=model_digest)
            if info["shed"]:
                self._emit_admission(
                    tenant, priority, "shed",
                    self.cfg.fleet_shed_retry_after_s)
                handler._reply(
                    503,
                    {"error": "fleet saturated or no replica admitted — "
                              "retry after backoff",
                     "retryable": True, "shed": True, "tenant": tenant},
                    headers={"Retry-After":
                             f"{self.cfg.fleet_shed_retry_after_s:g}"})
                return
            if status == 0 and not info["deadline_exceeded"]:
                handler._reply(
                    503,
                    {"error": f"every attempt failed after "
                              f"{info['retries']} retries",
                     "retryable": True},
                    headers={"Retry-After":
                             f"{self.cfg.fleet_shed_retry_after_s:g}"})
                return
            if info["deadline_exceeded"] and status != 200:
                handler._reply(
                    503,
                    {"error": f"deadline {self.cfg.fleet_deadline_s:g}s "
                              f"exceeded after {info['retries']} retries",
                     "retryable": True},
                    headers={"Retry-After":
                             f"{self.cfg.fleet_shed_retry_after_s:g}"})
                return
            headers = ({"X-DTF-Replica": served_by.label}
                       if served_by is not None else None)
            handler._reply(status, payload, headers=headers)
        except Exception as e:  # noqa: BLE001 — router must outlive a bad request
            log.exception("proxy predict failed")
            handler._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def _claim_for_session(
            self, session: str | None) -> tuple[Replica | None, float | None]:
        """Claim the replica a decode session is pinned to.

        Returns ``(replica, None)`` on success, ``(None, retry_after_s)``
        when the pinned replica is mid-drain (rolling reload: its KV
        pages survive the drain, so the honest answer is "come back in a
        moment", not a silent repin that loses the session's cache), and
        ``(None, None)`` when nothing is routable. A pinned replica that
        is dead/ejected/retired has already lost the session's pages —
        repin silently to a fresh claim."""
        now = time.monotonic()
        if session:
            with self._lock:
                pinned = self._sessions.get(session)
                if pinned is not None and pinned < len(self._replicas):
                    rep = self._replicas[pinned]
                    if rep.state == "draining":
                        self._affinity_misses += 1
                        return None, self.cfg.fleet_shed_retry_after_s
                    if (rep.state == "admitted" and not rep.give_up
                            and rep.stalled_until <= now):
                        rep.inflight += 1
                        return rep, None
                    self._sessions.pop(session, None)
        rep = self._claim_replica(set())
        if rep is not None and session:
            with self._lock:
                self._sessions[session] = rep.index
        return rep, None

    def handle_generate(self, handler) -> None:
        """Proxy one streamed ``/generate`` to a session-pinned replica.

        Unlike /predict this is NOT hedged or retried: a generation
        stream is stateful (KV pages on one replica) and not idempotent
        once tokens start flowing, so a mid-stream transport failure
        surfaces to the client instead of silently restarting the
        stream elsewhere. 409 + Retry-After = the session's replica is
        draining for a rolling reload; retry the same session after the
        pause and it lands back on the reloaded replica."""
        if self._draining.is_set():
            handler._reply(503, {"error": "draining", "retryable": True})
            return
        try:
            length = int(handler.headers.get("Content-Length", 0))
            if length <= 0 or length > _MAX_BODY:
                handler._reply(400, {"error": f"bad Content-Length {length}"})
                return
            body = handler.rfile.read(length)
            session = handler.headers.get(SESSION_HEADER) or None
            rep, retry_after = self._claim_for_session(session)
            if retry_after is not None:
                handler._reply(
                    409,
                    {"error": f"session {session!r} is pinned to a "
                              f"replica that is draining for a reload — "
                              f"retry unchanged",
                     "retryable": True, "session": session},
                    headers={"Retry-After": f"{retry_after:g}"})
                return
            if rep is None:
                handler._reply(
                    503,
                    {"error": "no admitted replica for generate",
                     "retryable": True, "shed": True},
                    headers={"Retry-After":
                             f"{self.cfg.fleet_shed_retry_after_s:g}"})
                return
        except Exception as e:  # noqa: BLE001 — router must outlive a bad request
            log.exception("generate claim failed")
            handler._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        t0 = time.monotonic()
        status = 0
        try:
            req = urllib.request.Request(
                rep.url + "/generate", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                resp = urllib.request.urlopen(
                    req, timeout=self.cfg.fleet_deadline_s)
            except urllib.error.HTTPError as e:
                # Submit-time rejection (400/503/...) — relay verbatim;
                # a 4xx is the request's fault, not the replica's.
                status = e.code
                try:
                    payload = json.loads(e.read() or b"{}")
                except (ValueError, OSError, http.client.HTTPException):
                    payload = {"error": f"replica status {e.code}"}
                if status >= 500:
                    self._record_failure(
                        rep, f"generate failed (status {status})")
                handler._reply(status, payload,
                               headers={"X-DTF-Replica": rep.label})
                return
            with resp:
                status = resp.status
                handler.send_response(status)
                handler.send_header(
                    "Content-Type",
                    resp.headers.get("Content-Type",
                                     "application/x-ndjson"))
                handler.send_header("Transfer-Encoding", "chunked")
                handler.send_header("X-DTF-Replica", rep.label)
                handler.end_headers()
                # http.client undoes the replica's chunking; readline
                # re-streams each NDJSON event the moment it arrives.
                for line in resp:
                    handler.wfile.write(
                        f"{len(line):X}\r\n".encode() + line + b"\r\n")
                    handler.wfile.flush()
                handler.wfile.write(b"0\r\n\r\n")
                handler.wfile.flush()
            self._record_success(rep)
        except (urllib.error.URLError, OSError, ValueError,
                http.client.HTTPException) as e:
            self._record_failure(rep, f"generate failed ({type(e).__name__})")
            if status == 0:
                # Nothing on the wire yet — a clean retryable error.
                try:
                    handler._reply(
                        503, {"error": f"{type(e).__name__}: {e}",
                              "retryable": True},
                        headers={"Retry-After":
                                 f"{self.cfg.fleet_shed_retry_after_s:g}"})
                except OSError:
                    pass
            else:
                log.warning("generate stream to %s aborted mid-flight: "
                            "%s: %s", rep.label, type(e).__name__, e)
        finally:
            self._release_replica(rep)
            with self._lock:
                self._requests += 1
                self._generate_streams += 1
            if self._tw:
                self._tw.emit(
                    telemetry.KIND_SERVE_ROUTE,
                    metrics={"latency_ms": (time.monotonic() - t0) * 1e3,
                             "retries": 0, "status": status},
                    replica=rep.label, shed=False,
                    deadline_exceeded=False, tenant=None, trace=None)

    def handle_reload(self, handler) -> None:
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
            count = payload.get("count")
            if count is not None and (
                    not isinstance(count, int) or count < 1):
                handler._reply(
                    400, {"error": f"count must be a positive int, "
                                   f"got {count!r}"})
                return
            digest = payload.get("digest")
            if digest is not None and (
                    not isinstance(digest, str) or not digest):
                handler._reply(
                    400, {"error": "digest must be a non-empty string "
                                   "(content_digest prefix)"})
                return
            results, ok = self.rolling_reload(
                artifact_dir, count=count, only_digest=digest)
            handler._reply(200 if ok else 409,
                           {"reloaded": ok, "replicas": results})
        except FleetError as e:
            handler._reply(409, {"error": str(e), "reloaded": False})
        except json.JSONDecodeError as e:
            handler._reply(400, {"error": f"invalid JSON: {e}"})
        except Exception as e:  # noqa: BLE001 — router must outlive a bad request
            log.exception("rolling reload failed")
            handler._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def handle_healthz(self, handler) -> None:
        status = 503 if self._draining.is_set() else 200
        handler._reply(status, self.fleet_healthz())

    def fleet_healthz(self) -> dict:
        """The router's /healthz payload: per-replica lifecycle + router
        counters, plus the spec passthrough load_gen needs to synthesize
        traffic (task/input_spec from any replica that reported one) and
        an aggregate engine-counter view for healthz-delta accounting."""
        with self._lock:
            reps = []
            base: dict = {}
            engine_agg: dict[str, float] = {}
            for rep in self._replicas:
                health = rep.last_health
                if health.get("input_spec") and not base:
                    base = health
                engine = health.get("engine") or {}
                for key, value in engine.items():
                    if isinstance(value, (int, float)) and not isinstance(
                            value, bool):
                        engine_agg[key] = engine_agg.get(key, 0) + value
                reps.append({
                    "replica": rep.label,
                    "url": rep.url,
                    "state": rep.state,
                    "give_up": rep.give_up,
                    "inflight": rep.inflight,
                    "routed": rep.routed,
                    "consecutive_failures": rep.consecutive_failures,
                    "restarts": rep.restarts,
                    "queue_depth": (rep.last_health.get("engine") or {}
                                    ).get("queue_depth"),
                    "artifact": rep.artifact_info(),
                    "step": rep.last_health.get("step"),
                })
            router = {
                "requests": self._requests,
                "retries": self._retries_total,
                "generate_streams": self._generate_streams,
                "sessions": len(self._sessions),
                "affinity_misses": self._affinity_misses,
                "shed": self._shed,
                "deadline_exceeded": self._deadline_exceeded,
                "reload_rolls": self._reload_rolls,
                "ticks": self._tick_count,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
            }
            tenants = {t: dict(led) for t, led in self._tenants.items()}
            # Per-model rollup: the live traffic weights of a
            # multiplexed fleet (replica allocation per content_digest).
            models: dict[str, dict] = {}
            for rep in self._replicas:
                if rep.state == "retired":
                    continue
                dg = (rep.last_health.get("artifact") or {}).get(
                    "content_digest")
                if not dg:
                    continue
                m = models.setdefault(
                    str(dg), {"replicas": 0, "routed": 0})
                m["replicas"] += 1
                m["routed"] += rep.routed
            asc = self._autoscaler
            autoscale_view = ({
                "enabled": True,
                "min_replicas": asc.min_replicas,
                "max_replicas": asc.max_replicas,
                "pressure": round(asc.last_pressure, 4),
            } if asc is not None else {"enabled": False})
        admitted = sum(1 for r in reps if r["state"] == "admitted")
        return {
            "status": "draining" if self._draining.is_set() else "ok",
            "role": "fleet",
            "task": base.get("task"),
            "model": base.get("model"),
            "step": base.get("step"),
            "vocab_size": base.get("vocab_size"),
            "input_spec": base.get("input_spec"),
            "engine": {"state": "running", **engine_agg},
            "fleet": {"replicas": reps, "router": router,
                      "admitted": admitted,
                      "tenants": tenants, "models": models,
                      "autoscale": autoscale_view},
        }

    # ----------------------------------------------------------- reload

    def rolling_reload(self, artifact_dir: str, *, count: int | None = None,
                       only_digest: str | None = None
                       ) -> tuple[list[dict], bool]:
        """Zero-downtime deploy: drain → reload → probe → readmit, one
        replica at a time. The first rejected reload ABORTS the roll —
        a tampered/incompatible artifact must never spread past the
        replica that refused it (every replica keeps serving weights
        that passed verification either way).

        ``count`` caps how many replicas roll and ``only_digest`` scopes
        the roll to replicas currently serving a matching artifact —
        together they move part of the fleet to a new model while the
        rest keeps serving the old one (the multiplexing deploy: the
        per-model traffic weight IS the replica allocation, readable
        from the healthz ``models`` rollup)."""
        with self._lock:
            if self._rolling:
                raise FleetError("a rolling reload is already in progress")
            self._rolling = True
            self._reload_rolls += 1
        try:
            for fault in faults.fire("fleet_reload"):
                if fault.kind == "corrupt_reload":
                    faults.corrupt_checkpoint_dir(artifact_dir)
            with self._lock:
                targets = [r for r in self._replicas]
            results: list[dict] = []
            ok = True
            rolled = 0
            for rep in targets:
                if count is not None and rolled >= count:
                    break
                with self._lock:
                    skip = rep.state not in ("admitted", "ejected")
                    rep_digest = str((rep.last_health.get("artifact") or {})
                                     .get("content_digest") or "")
                if only_digest and not rep_digest.startswith(only_digest):
                    continue  # serving a different model: not in scope
                if skip:
                    results.append({"replica": rep.label, "ok": False,
                                    "skipped": True, "state": rep.state})
                    continue
                result = self._reload_replica(rep, artifact_dir)
                results.append(result)
                rolled += 1
                if not result["ok"]:
                    ok = False
                    break
            return results, ok
        finally:
            with self._lock:
                self._rolling = False

    def _reload_replica(self, rep: Replica, artifact_dir: str) -> dict:
        cfg = self.cfg
        t0 = time.monotonic()
        from_digest = rep.artifact_info().get("content_digest")
        with self._lock:
            prev_state, rep.state = rep.state, "draining"
        # Drain: the claim loop no longer picks this replica; wait out
        # the requests it already carries (bounded by the drain budget).
        drain_deadline = time.monotonic() + cfg.drain_timeout_s
        while time.monotonic() < drain_deadline:
            with self._lock:
                if rep.inflight == 0:
                    break
            time.sleep(0.05)
        status, payload = _http_json(
            rep.url + "/reload",
            data=json.dumps({"artifact_dir": artifact_dir}).encode(),
            timeout=cfg.drain_timeout_s + cfg.fleet_attempt_timeout_s)
        ok = status == 200 and bool(payload.get("reloaded"))
        to_digest = payload.get("to_digest")
        if ok:
            # Probe: trust /healthz, not the reload response — readmit
            # only once the replica self-reports the NEW digest.
            probe_deadline = time.monotonic() + cfg.drain_timeout_s
            confirmed = False
            while time.monotonic() < probe_deadline:
                hstatus, health = _http_json(
                    rep.url + "/healthz",
                    timeout=max(1.0, cfg.fleet_attempt_timeout_s / 2))
                if (hstatus == 200 and (health.get("artifact") or {}).get(
                        "content_digest") == to_digest):
                    with self._lock:
                        rep.last_health = health
                        rep.last_health_t = time.monotonic()
                    confirmed = True
                    break
                time.sleep(min(0.2, cfg.fleet_probe_interval_s))
            ok = confirmed
        with self._lock:
            # A rejected reload (409: tamper, mismatch) leaves a HEALTHY
            # replica on its old weights — readmit it. A transport-dead
            # one goes back to its previous state for the breaker to
            # handle.
            rep.state = ("admitted" if ok or status == 409 else prev_state)
        reload_ms = (time.monotonic() - t0) * 1e3
        result = {
            "replica": rep.label, "ok": ok, "status": status,
            "from_digest": from_digest, "to_digest": to_digest,
            "reload_ms": reload_ms,
            "error": None if ok else payload.get("error"),
        }
        log.info("rolling reload %s: ok=%s status=%d (%.0f ms)",
                 rep.label, ok, status, reload_ms)
        if self._tw:
            self._tw.emit(
                telemetry.KIND_SERVE_RELOAD,
                metrics={"reload_ms": reload_ms},
                replica=rep.label, ok=ok,
                from_digest=from_digest, to_digest=to_digest)
        return result

    # ----------------------------------------------------------- prober

    def _apply_chaos(self, fault) -> None:
        """Execute a fleet_chaos fault against its target replica (the
        drill harness: kill = SIGKILL the child, stall = SIGSTOP it for
        fault.seconds — alive, port open, answering nothing). The
        traffic-shaped kinds (spike / tenant_stampede) target the
        ROUTER itself: they open a synthetic-load window instead of
        touching a subprocess."""
        if fault.kind == "spike":
            log.warning("chaos: traffic spike +%.0f req/replica for %.0fs",
                        fault.factor or 0.0, fault.seconds or 0.0)
            with self._lock:
                self._spike_until = time.monotonic() + (fault.seconds or 0.0)
                self._spike_load = float(fault.factor or 0.0)
            return
        if fault.kind == "tenant_stampede":
            log.warning("chaos: tenant stampede for %.0fs (batch-class "
                        "load saturates unreserved queue slots)",
                        fault.seconds or 0.0)
            with self._lock:
                self._stampede_until = (time.monotonic()
                                        + (fault.seconds or 0.0))
            return
        with self._lock:
            target = (self._replicas[fault.replica]
                      if fault.replica is not None
                      and 0 <= fault.replica < len(self._replicas) else None)
        if target is None or target.proc is None:
            log.warning("chaos fault %s has no launcher-managed target — "
                        "skipped", fault.fault_id)
            return
        if fault.kind == "kill_replica":
            log.warning("chaos: SIGKILL %s (pid %d)",
                        target.label, target.proc.pid)
            target.proc.kill()
        elif fault.kind == "stall_replica":
            log.warning("chaos: SIGSTOP %s (pid %d) for %.0fs",
                        target.label, target.proc.pid, fault.seconds or 0)
            try:
                os.kill(target.proc.pid, signal.SIGSTOP)
            except ProcessLookupError:
                return
            with self._lock:
                target.stalled_until = (time.monotonic()
                                        + (fault.seconds or 0.0))

    def _resume_stalls(self, now: float) -> None:
        with self._lock:
            due = [r for r in self._replicas
                   if r.stalled_until and now >= r.stalled_until]
            for rep in due:
                rep.stalled_until = 0.0
        for rep in due:
            if rep.proc is not None:
                try:
                    os.kill(rep.proc.pid, signal.SIGCONT)
                except ProcessLookupError:
                    pass

    def _check_process(self, rep: Replica, now: float) -> None:
        """Dead-child detection + the supervision restart policy."""
        if rep.proc is None or rep.proc.poll() is None:
            return
        with self._lock:
            if rep.state == "dead":
                return
            if rep.retiring or rep.state == "retired":
                # A scale-down victim exiting is the PLAN, not a death:
                # supervision must not restart what autoscaling drained.
                return
            rep.state = "dead"
            rep.consecutive_failures = 0
            routed, artifact_step = rep.routed, rep.artifact_info().get("step")
        rc = rep.proc.returncode
        # Same verdict machinery as the training supervisor: identical
        # rc with no serving progress twice in a row = deterministic.
        stop = rep.breaker.record(
            rc=rc, last_step=routed, ckpt_step=artifact_step,
            transient=rc in (-signal.SIGKILL, -signal.SIGTERM))
        budget_spent = rep.restarts >= self.cfg.fleet_max_restarts
        with self._lock:
            rep.give_up = stop or budget_spent or self._launcher is None
            rep.next_restart_t = now + supervision.backoff_seconds(
                rep.restarts + 1, base=max(0.5, self.cfg.fleet_probe_interval_s),
                cap=30.0)
        self._emit_eject(
            rep, action="eject", reason=f"dead (rc={rc})",
            give_up=rep.give_up, crash_loop=bool(stop),
            restarts=rep.restarts)
        if self.flightrec is not None:
            # Forensics at the moment of observation: the ring holds the
            # route/attempt/eject events (spans included) leading up to
            # the death, plus every router span still open.
            self.flightrec.dump(f"replica {rep.label} dead (rc={rc})",
                                open_spans=self.tracer.open_spans())

    def _restart_due(self, now: float) -> None:
        with self._lock:
            due = [r for r in self._replicas
                   if r.state == "dead" and not r.give_up
                   and now >= r.next_restart_t]
        for rep in due:
            try:
                proc, endpoint_path = self._launcher(rep.index)
            except Exception as e:  # noqa: BLE001 — keep supervising the rest
                log.error("restart of %s failed: %s", rep.label, e)
                with self._lock:
                    rep.restarts += 1
                    rep.give_up = rep.restarts >= self.cfg.fleet_max_restarts
                    rep.next_restart_t = now + supervision.backoff_seconds(
                        rep.restarts + 1,
                        base=max(0.5, self.cfg.fleet_probe_interval_s),
                        cap=30.0)
                continue
            with self._lock:
                rep.proc = proc
                rep.endpoint_path = endpoint_path
                rep.url = ""
                rep.last_health = {}
                rep.restarts += 1
                rep.state = "ejected"  # earns admission via the prober
            self._emit_eject(rep, action="restart",
                             reason="supervised relaunch",
                             restarts=rep.restarts)

    def _probe_replica(self, rep: Replica, now: float) -> None:
        """Health poll + circuit-breaker transitions for one replica."""
        with self._lock:
            state = rep.state
            stalled = rep.stalled_until > now
        if state in ("dead", "draining", "retired") or stalled:
            return
        if not rep.url and rep.endpoint_path:
            url = read_endpoint(rep.endpoint_path)
            if not url:
                return  # still booting
            with self._lock:
                rep.url = url
        if not rep.url:
            return
        timeout = max(0.5, min(2.0, self.cfg.fleet_healthz_stale_s / 3))
        status, payload = _http_json(rep.url + "/healthz", timeout=timeout)
        if status == 200:
            with self._lock:
                rep.last_health = payload
                rep.last_health_t = now
                rep.consecutive_failures = 0
                readmit = state == "ejected"
                if readmit:
                    rep.state = "admitted"
            if readmit:
                self._emit_eject(rep, action="readmit",
                                 reason="healthz recovered")
            return
        self._record_failure(rep, f"healthz failed (status {status})")
        with self._lock:
            stale = (rep.state == "admitted" and rep.last_health_t
                     and now - rep.last_health_t
                     > self.cfg.fleet_healthz_stale_s)
            if stale:
                rep.state = "ejected"
        if stale:
            self._emit_eject(rep, action="eject", reason="stale healthz")

    def _tick(self) -> None:
        with self._lock:
            self._tick_count += 1
            # The chaos clock arms only once every registered replica has
            # come up (admitted, or given up) — `kill_replica:N:T` then
            # means "T ticks after the fleet was ready", deterministic
            # relative to the drill's load instead of racing replica boot.
            if not self._chaos_armed and self._replicas and all(
                    r.state in ("admitted", "retired") or r.give_up
                    for r in self._replicas):
                self._chaos_armed = True
            if self._chaos_armed:
                self._chaos_tick += 1
            chaos_tick = self._chaos_tick if self._chaos_armed else None
        if chaos_tick is not None:
            for fault in faults.fire("fleet_chaos", step=chaos_tick):
                self._apply_chaos(fault)
        now = time.monotonic()
        self._resume_stalls(now)
        with self._lock:
            replicas = list(self._replicas)
        for rep in replicas:
            self._check_process(rep, now)
            self._probe_replica(rep, time.monotonic())
        self._restart_due(time.monotonic())
        self._advance_retirements(time.monotonic())
        self._autoscale_tick(time.monotonic())

    # ------------------------------------------------------- autoscaling

    def _advance_retirements(self, now: float) -> None:
        """Finish scale-down drains: once a retiring replica's in-flight
        hits zero (or its drain budget expires), SIGTERM it — the
        replica's own graceful drain flushes telemetry — and mark it
        retired so neither routing nor supervision ever touches it
        again."""
        with self._lock:
            due = [r for r in self._replicas
                   if r.retiring and r.state == "draining"
                   and (r.inflight == 0 or now >= r.retire_deadline)]
            for rep in due:
                rep.state = "retired"
        for rep in due:
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.terminate()
            log.info("fleet autoscale: %s retired (drained)", rep.label)

    def _emit_scale(self, decision: "autoscale.ScaleDecision",
                    replica_label: str | None) -> None:
        log.warning("fleet autoscale: scale %s -> %d replicas (%s)",
                    decision.action, decision.to_replicas, decision.reason)
        if self._tw:
            self._tw.emit(
                telemetry.KIND_SCALE,
                metrics={"pressure": decision.pressure},
                action=decision.action, reason=decision.reason,
                replica=replica_label,
                from_replicas=decision.from_replicas,
                to_replicas=decision.to_replicas)

    def _autoscale_tick(self, now: float) -> None:
        """One control-loop iteration: snapshot under the lock, let the
        pure policy decide, actuate at most one action. Scale-up goes
        through the SAME launcher path supervised restarts use;
        scale-down marks the newest admitted replica retiring and lets
        :meth:`_advance_retirements` finish the drain across ticks."""
        asc = self._autoscaler
        if asc is None:
            return
        with self._lock:
            synthetic = self._stampede_load(now) + (
                self._spike_load if now < self._spike_until else 0.0)
            admitted = booting = draining = give_up = alive = 0
            load = 0.0
            for rep in self._replicas:
                if rep.give_up:
                    give_up += 1
                    continue
                if rep.state == "retired":
                    continue
                if rep.retiring:
                    draining += 1
                    continue
                alive += 1
                if rep.state == "admitted":
                    admitted += 1
                    engine = rep.last_health.get("engine") or {}
                    try:
                        depth = int(engine.get("queue_depth") or 0)
                    except (TypeError, ValueError):
                        depth = 0
                    load += depth + rep.inflight + synthetic
                else:
                    # Spawned/restarting but not yet admitted: it fills
                    # a hole already — judging pressure now would
                    # double-spawn for the same gap.
                    booting += 1
            shed_delta = self._shed - self._shed_seen
            self._shed_seen = self._shed
            snap = autoscale.FleetSnapshot(
                admitted=admitted, alive=alive, booting=booting,
                draining=draining, give_up=give_up, load=load,
                capacity=self.cfg.queue_capacity, shed_delta=shed_delta)
        decision = asc.decide(snap, now)
        if decision is None:
            return
        if decision.action == "up":
            if self._launcher is None:
                log.warning("fleet autoscale: scale-up wanted (%s) but no "
                            "launcher is configured — skipped",
                            decision.reason)
                return
            with self._lock:
                index = len(self._replicas)
            try:
                proc, endpoint_path = self._launcher(index)
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                log.error("fleet autoscale: spawn of r%d failed: %s",
                          index, e)
                return
            rep = self.add_replica(proc=proc, endpoint_path=endpoint_path)
            with self._lock:
                self._scale_ups += 1
            self._emit_scale(decision, rep.label)
            return
        # decision.action == "down": retire the newest admitted replica
        # (LIFO keeps the original fixed fleet as the stable core).
        with self._lock:
            victims = [r for r in self._replicas
                       if r.state == "admitted" and not r.retiring]
            if not victims:
                return
            victim = max(victims, key=lambda r: r.index)
            victim.state = "draining"
            victim.retiring = True
            victim.retire_deadline = now + self.cfg.drain_timeout_s
            self._scale_downs += 1
        self._emit_scale(decision, victim.label)

    def _probe_loop(self) -> None:
        try:
            while not self._stop.wait(self.cfg.fleet_probe_interval_s):
                self._tick()
        except BaseException as e:  # surface on exit, never just stderr
            log.error("fleet prober thread failed", exc_info=True)
            with self._lock:
                if self._prober_error is None:
                    self._prober_error = FleetProberError(e)

    # ------------------------------------------------------------- drain

    def shutdown(self, reason: str = "shutdown") -> bool:
        """Stop admission → stop the prober → SIGTERM every replica
        (their own graceful drain finishes queued work) → stop the HTTP
        loop. Idempotent; safe from any thread."""
        if self._draining.is_set():
            self._done.wait(self.cfg.drain_timeout_s)
            return True
        self._draining.set()
        self._stop.set()
        if self._prober.is_alive():
            self._prober.join(max(2.0, 4 * self.cfg.fleet_probe_interval_s))
        log.info("fleet drain started (%s)", reason)
        with self._lock:
            procs = [(r.label, r.proc) for r in self._replicas
                     if r.proc is not None and r.proc.poll() is None]
        clean = True
        for _, proc in procs:
            proc.terminate()  # SIGTERM → the replica's graceful drain
        deadline = time.monotonic() + self.cfg.drain_timeout_s
        for label, proc in procs:
            remaining = max(0.1, deadline - time.monotonic())
            try:
                proc.wait(remaining)
            except Exception:  # noqa: BLE001 — subprocess.TimeoutExpired et al.
                log.warning("replica %s did not drain in time — SIGKILL",
                            label)
                proc.kill()
                clean = False
        if self._tw:
            self._tw.emit(
                telemetry.KIND_HEALTH,
                health={"event": "fleet_drain", "reason": reason,
                        "clean": clean})
        # stdlib BaseServer.shutdown() blocks on an event that only
        # serve_forever() sets — never call it when the loop never ran
        # (e.g. a startup abort before serve_forever).
        if self._serving.is_set():
            self.httpd.shutdown()
        self._done.set()
        log.info("fleet drain complete (clean=%s)", clean)
        return clean

    def install_sigterm_drain(self) -> None:
        """SIGTERM → graceful fleet drain (same contract as the single
        engine and the trainer: supervisors treat drain-exit-0 as
        success)."""

        def _drain():
            try:
                self.shutdown("sigterm")
            except BaseException as e:  # noqa: BLE001 — surface, don't hang
                log.error("sigterm fleet drain failed", exc_info=True)
                self._drain_error = FleetDrainError(e)
                self._done.set()
                if self._serving.is_set():
                    self.httpd.shutdown()

        def _on_term(signum, frame):
            del signum, frame
            threading.Thread(
                target=_drain, name="dtf-fleet-drain", daemon=True).start()

        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)

    def serve_forever(self) -> None:
        """Block until shutdown() (or SIGTERM via the installed
        handler); re-raise stored drain/prober failures."""
        log.info("fleet router on http://%s:%d fronting %d replica(s)",
                 self.host, self.port, len(self._replicas))
        if not self._draining.is_set():
            self._serving.set()
            self.httpd.serve_forever()
        self.httpd.server_close()
        if self._drain_error is not None:
            raise self._drain_error
        with self._lock:
            prober_error = self._prober_error
        if prober_error is not None:
            raise prober_error
