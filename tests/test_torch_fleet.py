"""The port's fleet router (serve/fleet.py) held to the JAX package's on
the same stub replicas and the same request scripts.

Each test runs its script twice, once against a JAX ``FleetRouter`` and
once against the port's, each over fresh stubs (tests/test_fleet.py's
``StubReplica``, imported): the observations (statuses, ``X-DTF-Replica``
where the choice is deterministic, ``Retry-After``, ``fleet_healthz``
with its counters, the ``fleet`` section of each package's
``summarize_events`` over each router's events.jsonl, span trees) must be
equal, and the port's must show what tests/test_fleet.py asserts of the
JAX router: retry on another replica, eject and readmit, shedding, the
rolling reload in order and its abort, concurrent rolls refused, 4xx
pass-through, session affinity with its 409 while the pinned replica
drains (tests/test_decode.py's ``test_fleet_session_affinity_409`` over a
streaming stub), the flight recorder's dump when a replica dies, and the
telemetry rollups. Timings (latencies, reload milliseconds) are left out
of the comparison. The router imports no torch.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from distributed_tensorflow_framework_torch.core import config as pconfig
from distributed_tensorflow_framework_torch.core import faults as pfaults
from distributed_tensorflow_framework_torch.core import telemetry as ptel
from distributed_tensorflow_framework_torch.core import tracing as ptracing
from distributed_tensorflow_framework_torch.serve import autoscale as pasc
from distributed_tensorflow_framework_torch.serve import fleet as pfleet
from distributed_tensorflow_framework_tpu.core import config as jconfig
from distributed_tensorflow_framework_tpu.core import faults as jfaults
from distributed_tensorflow_framework_tpu.core import telemetry as jtel
from distributed_tensorflow_framework_tpu.core import tracing as jtracing
from distributed_tensorflow_framework_tpu.serve import autoscale as jasc
from distributed_tensorflow_framework_tpu.serve import fleet as jfleet
from tests.test_fleet import StubReplica

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", fleet=jfleet, autoscale=jasc, faults=jfaults,
        telemetry=jtel, tracing=jtracing, ServeConfig=jconfig.ServeConfig),
    "port": types.SimpleNamespace(
        name="port", fleet=pfleet, autoscale=pasc, faults=pfaults,
        telemetry=ptel, tracing=ptracing, ServeConfig=pconfig.ServeConfig),
}
KNOBS = {"port": 0, "fleet_probe_interval_s": 0.1, "fleet_retries": 2,
         "fleet_retry_backoff_ms": 5.0, "fleet_eject_failures": 2,
         "fleet_deadline_s": 10.0, "fleet_attempt_timeout_s": 5.0,
         "fleet_healthz_stale_s": 2.0}
BODY = {"inputs": {"image": [[1.0]]}}
# Timing fields: measured, so never compared across the packages.
TIMINGS = {"latency_ms", "reload_ms", "url", "t", "dur_ms", "t_start",
           "t_end", "wall", "span", "parent", "trace"}


@pytest.fixture(autouse=True)
def _clean_plans():
    yield
    pfaults.install(pfaults.FaultPlan())
    jfaults.install(jfaults.FaultPlan())


class Fleet:
    """A router of one package over ``stubs`` (fresh ones of ``stub``
    when a count), served on a thread unless ``serve`` is False, and
    everything to stop afterwards. ``learned`` injects what the prober
    would have learned from each stub's /healthz (its digest and queue
    depth), so that claims are decided without a polling thread."""

    def __init__(self, pkg, stubs=2, *, stub=StubReplica, start=False,
                 serve=True, learned=False, writer_path=None, launcher=None,
                 flight_recorder=None, **knobs):
        self.pkg = pkg
        self.stubs = ([stub() for _ in range(stubs)]
                      if isinstance(stubs, int) else stubs)
        self.writer = (pkg.telemetry.TelemetryWriter(str(writer_path))
                       if writer_path else None)
        self.router = pkg.fleet.FleetRouter(
            pkg.ServeConfig(**{**KNOBS, **knobs}),
            telemetry_writer=self.writer, launcher=launcher,
            flight_recorder=flight_recorder)
        for s in self.stubs:
            rep = self.router.add_replica(url=s.url, admitted=True)
            if learned:
                with self.router._lock:
                    rep.last_health = {
                        "artifact": {"content_digest": s.digest},
                        "engine": {"queue_depth": s.queue_depth}}
        self.thread = None
        if serve:
            self.thread = threading.Thread(target=self.router.serve_forever,
                                           daemon=True)
            self.thread.start()
        if start:
            self.router.start()
        self.url = f"http://{self.router.host}:{self.router.port}"

    def close(self):
        self.router.shutdown("test teardown")
        if self.thread is not None:
            self.thread.join(10)
        else:
            self.router.httpd.server_close()
        for s in self.stubs:
            s.close()
        if self.writer is not None:
            self.writer.close()


def post(url, payload=BODY, path="/predict", headers=None, timeout=20.0):
    body = json.dumps(payload).encode() if payload is not None else b""
    req = urllib.request.Request(
        url + path, data=body,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def strip(tree):
    """``tree`` without its timing fields (TIMINGS), for comparison."""
    if isinstance(tree, dict):
        return {k: strip(v) for k, v in tree.items() if k not in TIMINGS}
    if isinstance(tree, (list, tuple)):
        return [strip(v) for v in tree]
    return tree


def routed_view(resp):
    status, payload, headers = resp
    return (status, payload.get("retryable"), payload.get("shed"),
            headers.get("X-DTF-Replica"), headers.get("Retry-After"))


def both(scenario, *args, **kwargs):
    """Run ``scenario(pkg, ...)`` for each package; the port's result,
    after asserting it equals the JAX package's."""
    out = {name: scenario(pkg, *args, **kwargs) for name, pkg in PKGS.items()}
    assert strip(out["port"]) == strip(out["jax"])
    return out["port"]


# ----------------------------------------------------------- routing


def _balance(pkg, tmp_path):
    fleet = Fleet(pkg, writer_path=tmp_path / f"{pkg.name}.jsonl")
    try:
        replies = [routed_view(post(fleet.url)) for _ in range(8)]
        health = fleet.router.fleet_healthz()
    finally:
        fleet.close()
    summary = pkg.telemetry.summarize_events(str(tmp_path /
                                                 f"{pkg.name}.jsonl"))
    return {"replies": replies, "health": health, "fleet": summary["fleet"]}


def test_routes_and_balances(tmp_path):
    out = both(_balance, tmp_path)
    # Equal-load ties round-robin, in the same order in both packages.
    assert [r[3] for r in out["replies"]] == ["r0", "r1"] * 4
    assert all(r[0] == 200 for r in out["replies"])
    router = out["health"]["fleet"]["router"]
    assert router["requests"] == 8 and router["shed"] == 0
    assert {r["replica"]: r["routed"]
            for r in out["health"]["fleet"]["replicas"]} == {"r0": 4,
                                                              "r1": 4}
    assert out["fleet"]["routed"] == {"r0": 4, "r1": 4}


def _retry(pkg):
    fleet = Fleet(pkg)
    fleet.stubs[0].fail = True
    try:
        replies = [routed_view(post(fleet.url)) for _ in range(6)]
        health = fleet.router.fleet_healthz()
    finally:
        fleet.close()
    return {"replies": replies, "health": health}


def test_retry_lands_on_different_replica():
    out = both(_retry)
    assert [r[:1] + r[3:4] for r in out["replies"]] == [(200, "r1")] * 6
    assert out["health"]["fleet"]["router"]["retries"] >= 1
    states = {r["replica"]: r["state"]
              for r in out["health"]["fleet"]["replicas"]}
    assert states["r0"] == "ejected"


def _eject_readmit(pkg):
    fleet = Fleet(pkg, start=True)
    fleet.stubs[0].down = True

    def state_of(index):
        return fleet.router.fleet_healthz()["fleet"]["replicas"][index][
            "state"]

    def wait_for(state):
        deadline = time.monotonic() + 10
        while state_of(0) != state and time.monotonic() < deadline:
            time.sleep(0.05)
        return state_of(0)

    try:
        ejected = wait_for("ejected")
        fleet.stubs[0].down = False  # heals: the prober must readmit
        readmitted = wait_for("admitted")
    finally:
        fleet.close()
    return [ejected, readmitted]


def test_eject_then_readmit_via_prober():
    assert both(_eject_readmit) == ["ejected", "admitted"]


def _shed(pkg):
    fleet = Fleet(pkg, 1, fleet_shed_retry_after_s=2.5)
    try:
        with fleet.router._lock:
            fleet.router._replicas[0].state = "ejected"
        reply = post(fleet.url)
        shed = fleet.router.fleet_healthz()["fleet"]["router"]["shed"]
    finally:
        fleet.close()
    return {"reply": routed_view(reply), "error": reply[1]["error"],
            "shed": shed}


def test_sheds_with_retry_after_when_nothing_admitted():
    out = both(_shed)
    assert out["reply"] == (503, True, True, None, "2.5")
    assert out["shed"] == 1


def _four_xx(pkg):
    fleet = Fleet(pkg)
    try:
        req = urllib.request.Request(
            fleet.url + "/predict", data=b"",
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=10)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        unknown = post(fleet.url, path="/nowhere")[0]
        retries = fleet.router.fleet_healthz()["fleet"]["router"]["retries"]
    finally:
        fleet.close()
    return [code, unknown, retries]


def test_4xx_passes_through_without_retry():
    assert both(_four_xx) == [400, 404, 0]


class BadRequestStub(StubReplica):
    """A replica that refuses every /predict with a 400, as a replica
    refuses a malformed request."""

    def __init__(self):
        super().__init__()
        handler = self.httpd.RequestHandlerClass
        do_post = handler.do_POST

        def refusing(h):
            if h.path == "/predict":
                n = int(h.headers.get("Content-Length", 0))
                h.rfile.read(n)
                h._reply(400, {"error": "bad inputs"})
            else:
                do_post(h)

        handler.do_POST = refusing


def _replica_4xx(pkg):
    fleet = Fleet(pkg, stub=BadRequestStub)
    try:
        reply = post(fleet.url)
        router = fleet.router.fleet_healthz()["fleet"]["router"]
        predicts = [s.predicts for s in fleet.stubs]
    finally:
        fleet.close()
    return {"reply": routed_view(reply), "payload": reply[1],
            "retries": router["retries"], "predicts": predicts}


def test_replica_4xx_is_returned_as_it_is():
    out = both(_replica_4xx)
    assert out["reply"][0] == 400 and out["payload"] == {
        "error": "bad inputs"}
    assert out["retries"] == 0


class TornStub(StubReplica):
    """A replica that dies while it writes its ``/predict`` reply: the
    headers promise a body, half of it arrives, the connection closes."""

    def __init__(self):
        super().__init__()
        handler = self.httpd.RequestHandlerClass
        do_post = handler.do_POST

        def torn(h):
            if h.path != "/predict":
                do_post(h)
                return
            h.rfile.read(int(h.headers.get("Content-Length", 0)))
            body = json.dumps({"outputs": [[0.0] * 64]}).encode()
            h.send_response(200)
            h.send_header("Content-Type", "application/json")
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body[:len(body) // 2])
            h.wfile.flush()
            h.close_connection = True

        handler.do_POST = torn


def test_reply_cut_short_by_a_dying_replica_is_retried():
    """A deliberate difference: the JAX router lets the torn reply's
    ``http.client.IncompleteRead`` escape as a 500 to the client (what a
    replica killed mid-reply does under traffic); the port's treats it as
    a transport failure and retries on the other replica."""
    out = {}
    for name, pkg in PKGS.items():
        fleet = Fleet(pkg)
        torn = TornStub()
        fleet.stubs.append(torn)
        with fleet.router._lock:
            fleet.router._replicas[0].url = torn.url
        try:
            out[name] = routed_view(post(fleet.url))
        finally:
            fleet.close()
    assert out["port"][0] == 200 and out["port"][3] == "r1"
    assert out["jax"][0] == 500


# ------------------------------------------------------------ reload


def _roll(pkg, reject_first=False):
    fleet = Fleet(pkg)
    fleet.stubs[0].reject_reload = reject_first
    try:
        results, ok = fleet.router.rolling_reload("v2")
        health = fleet.router.fleet_healthz()
        after = routed_view(post(fleet.url))
        reloads = [s.reloads for s in fleet.stubs]
    finally:
        fleet.close()
    return {"results": results, "ok": ok, "health": health, "after": after,
            "reloads": reloads}


def test_rolling_reload_walks_fleet_in_order():
    out = both(_roll)
    assert out["ok"] is True
    assert [r["replica"] for r in out["results"]] == ["r0", "r1"]
    assert all(r["ok"] and r["to_digest"] == "digest-v2"
               for r in out["results"])
    assert out["reloads"] == [1, 1]
    for rep in out["health"]["fleet"]["replicas"]:
        assert rep["state"] == "admitted"
        assert rep["artifact"]["content_digest"] == "digest-v2"


def test_rejected_reload_aborts_roll():
    out = both(_roll, reject_first=True)
    assert out["ok"] is False
    assert [(r["replica"], r["status"]) for r in out["results"]] == [
        ("r0", 409)]
    assert out["reloads"] == [0, 0]
    assert out["health"]["fleet"]["replicas"][0]["state"] == "admitted"
    assert out["after"][0] == 200


def _concurrent(pkg):
    fleet = Fleet(pkg)
    try:
        with fleet.router._lock:
            fleet.router._rolling = True
        try:
            fleet.router.rolling_reload("v2")
            raised = None
        except pkg.fleet.FleetError as e:
            raised = str(e)
        refused = post(fleet.url, {"artifact_dir": "v2"}, path="/reload")
        with fleet.router._lock:
            fleet.router._rolling = False
    finally:
        fleet.close()
    return [raised, refused[0], refused[1]]


def test_concurrent_rolls_are_refused():
    raised, status, payload = both(_concurrent)
    assert "already in progress" in raised
    assert status == 409 and payload["reloaded"] is False


RELOAD_BODIES = [{}, {"artifact_dir": ""}, {"artifact_dir": "v2", "count": 0},
                 {"artifact_dir": "v2", "count": "1"},
                 {"artifact_dir": "v2", "digest": ""},
                 {"artifact_dir": "v2", "count": 1}]


def _reload_route(pkg):
    fleet = Fleet(pkg)
    try:
        out = [post(fleet.url, body, path="/reload")[:2]
               for body in RELOAD_BODIES]
        garbage = urllib.request.Request(
            fleet.url + "/reload", data=b"{nope",
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(garbage, timeout=10)
        except urllib.error.HTTPError as e:
            out.append((e.code, "invalid JSON" in json.loads(e.read())[
                "error"]))
    finally:
        fleet.close()
    return out


def test_reload_route_validates_its_body_as_jax():
    out = both(_reload_route)
    assert [s for s, *_ in out] == [400, 400, 400, 400, 400, 200, 400]
    assert [r["replica"] for r in out[5][1]["replicas"]] == ["r0"]


# ------------------------------------------------------ registration


def _no_launcher(pkg):
    fleet = Fleet(pkg)
    try:
        with pytest.raises(pkg.fleet.ReplicaLaunchError) as err:
            fleet.router.spawn_replicas(1)
    finally:
        fleet.close()
    return str(err.value)


def test_spawn_replicas_requires_launcher():
    assert "no launcher" in both(_no_launcher)


def _endpoint(pkg, tmp_path):
    path = tmp_path / f"{pkg.name}-endpoint.json"
    out = [pkg.fleet.read_endpoint(str(path))]
    path.write_text("{not json")
    out.append(pkg.fleet.read_endpoint(str(path)))
    path.write_text(json.dumps({"url": "http://127.0.0.1:9"}))
    out.append(pkg.fleet.read_endpoint(str(path)))
    path.write_text(json.dumps(["http://127.0.0.1:9"]))
    out.append(pkg.fleet.read_endpoint(str(path)))
    return out


def test_read_endpoint_tolerates_absent_and_torn_files(tmp_path):
    assert both(_endpoint, tmp_path) == ["", "", "http://127.0.0.1:9", ""]


def test_headers_and_errors_are_the_jax_packages():
    for name in ("TENANT_HEADER", "MODEL_HEADER", "SESSION_HEADER"):
        assert getattr(pfleet, name) == getattr(jfleet, name)
    for name in ("FleetError", "ReplicaLaunchError", "FleetProberError",
                 "FleetDrainError"):
        assert issubclass(getattr(pfleet, name), RuntimeError)
    cause = OSError("boom")
    assert str(pfleet.FleetProberError(cause)) == str(
        jfleet.FleetProberError(cause))
    assert str(pfleet.FleetDrainError(cause)) == str(
        jfleet.FleetDrainError(cause))
    assert [f.name for f in dataclasses.fields(pfleet.Replica)] == [
        f.name for f in dataclasses.fields(jfleet.Replica)]


# ------------------------------------------- supervision and chaos


class FakeProc:
    """A launcher-spawned child that has exited with ``rc``."""

    def __init__(self, rc=None, pid=999999):
        self.returncode = rc
        self.pid = pid
        self.killed = self.terminated = False

    def poll(self):
        return self.returncode

    def kill(self):
        self.killed = True
        self.returncode = -9

    def terminate(self):
        self.terminated = True

    def wait(self, timeout=None):
        return self.returncode


def _death(pkg, tmp_path):
    d = tmp_path / pkg.name
    d.mkdir()
    events = d / "events.jsonl"
    launched = []

    def launcher(index):
        launched.append(index)
        return FakeProc(), str(d / f"r{index}.json")

    writer = pkg.telemetry.TelemetryWriter(str(events))
    recorder = pkg.tracing.FlightRecorder(64, dump_dir=str(d)).attach(writer)
    router = pkg.fleet.FleetRouter(
        pkg.ServeConfig(**{**KNOBS, "fleet_max_restarts": 3}),
        telemetry_writer=writer, launcher=launcher,
        flight_recorder=recorder)
    stub = StubReplica()
    try:
        rep = router.add_replica(url=stub.url, proc=FakeProc(), admitted=True)
        pkg.faults.install("kill_replica:0:2")
        router._tick()  # arms the chaos clock: tick 1
        router._tick()  # tick 2: the kill fires, the prober sees the death
        killed, state_dead = rep.proc.killed, rep.state
        with router._lock:
            rep.next_restart_t = 0.0
        router._restart_due(time.monotonic())
        state_restarted = rep.state
        dumps = sorted(p.name for p in d.glob("flightrec-*.json"))
        with open(d / dumps[0]) as fh:
            dump = json.load(fh)
        health = router.fleet_healthz()
    finally:
        router.shutdown("test")
        router.httpd.server_close()
        stub.close()
        writer.close()
        pkg.faults.install(pkg.faults.FaultPlan())
    summary = pkg.telemetry.summarize_events(str(events))
    return {"killed": killed, "dead": state_dead,
            "restarted": state_restarted, "launched": launched,
            "reason": dump["reason"], "restarts": health["fleet"]["replicas"][
                0]["restarts"],
            "ejects": summary["fleet"]["ejects"],
            "fleet_restarts": summary["fleet"]["restarts"]}


def test_kill_replica_then_supervised_restart_and_dump(tmp_path):
    out = both(_death, tmp_path)
    assert out["killed"] and out["dead"] == "dead"
    assert out["restarted"] == "ejected" and out["launched"] == [0]
    assert out["reason"] == "replica r0 dead (rc=-9)"
    assert out["restarts"] == 1 and out["fleet_restarts"] == 1
    assert out["ejects"] == [{"replica": "r0", "reason": "dead (rc=-9)"}]


def _crash_loop(pkg):
    router = pkg.fleet.FleetRouter(pkg.ServeConfig(**KNOBS),
                                   launcher=lambda i: (FakeProc(rc=1), ""))
    try:
        rep = router.add_replica(proc=FakeProc(rc=1))
        verdicts = []
        for _ in range(3):
            router._check_process(rep, time.monotonic())
            verdicts.append((rep.state, rep.give_up))
            with router._lock:
                rep.next_restart_t = 0.0
            router._restart_due(time.monotonic())
    finally:
        router.shutdown("test")
        router.httpd.server_close()
    return verdicts


def test_crash_loop_breaker_gives_up_on_a_replica_that_cannot_start():
    """A replica that exits 1 at start-up (no device, a kernel that does
    not build) twice with nothing served is left down."""
    assert both(_crash_loop) == [("dead", False), ("dead", True),
                                 ("dead", True)]


def _proc_state(pid, stopped: bool):
    """The child's state once it is (or is no longer) stopped: a signal
    lands a moment after ``kill`` returns."""
    deadline = time.monotonic() + 10
    while True:
        with open(f"/proc/{pid}/stat") as fh:
            state = fh.read().rsplit(")", 1)[1].split()[0]
        if (state == "T") == stopped or time.monotonic() > deadline:
            return state
        time.sleep(0.01)


def _stall(pkg):
    """stall_replica through ``_apply_chaos`` on a live child standing in
    for r1's process: SIGSTOPped, skipped by every claim while stalled,
    SIGCONTed by ``_resume_stalls`` once due, routed again."""
    fleet = Fleet(pkg)
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(120)"])
    try:
        rep = fleet.router._replicas[1]
        rep.proc = child
        fleet.router._apply_chaos(
            pkg.faults.FaultPlan.parse("stall_replica:1:30s").faults[0])
        stopped = _proc_state(child.pid, True)
        during = [routed_view(post(fleet.url))[3] for _ in range(3)]
        with fleet.router._lock:
            rep.stalled_until = time.monotonic() - 1.0  # due now
        fleet.router._resume_stalls(time.monotonic())
        resumed = _proc_state(child.pid, False)
        after = [routed_view(post(fleet.url))[3] for _ in range(2)]
    finally:
        child.kill()
        child.wait()
        fleet.close()
    return [stopped, during, resumed, after, rep.stalled_until]


def test_stalled_replica_is_routed_around():
    stopped, during, resumed, after, until = both(_stall)
    assert stopped == "T" and resumed != "T" and until == 0.0
    assert during == ["r0"] * 3 and "r1" in after


# ------------------------------------------------------- sessions


class GenerateStub(StubReplica):
    """A replica whose ``/generate`` streams two NDJSON tokens and a done
    line, chunked, as the decode server does."""

    def __init__(self):
        super().__init__()
        handler = self.httpd.RequestHandlerClass
        do_post = handler.do_POST

        def generate(h):
            if h.path != "/generate":
                do_post(h)
                return
            n = int(h.headers.get("Content-Length", 0))
            h.rfile.read(n)
            h.send_response(200)
            h.send_header("Content-Type", "application/x-ndjson")
            h.send_header("Transfer-Encoding", "chunked")
            h.end_headers()
            for line in ({"token": 5, "index": 0}, {"token": 6, "index": 1},
                         {"done": True, "tokens": 2}):
                data = json.dumps(line).encode() + b"\n"
                h.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            h.wfile.write(b"0\r\n\r\n")

        handler.do_POST = generate


def post_generate(host, port, body, headers=None, timeout=30):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/generate", json.dumps(body).encode(),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        lines = [json.loads(line) for line in resp.read().splitlines()
                 if line.strip()]
        return resp.status, dict(resp.headers), lines
    finally:
        conn.close()


def _affinity(pkg):
    fleet = Fleet(pkg, 1, stub=GenerateStub)
    rep = fleet.router._replicas[0]
    r, body = fleet.router, {"prompt": [5, 6], "max_new_tokens": 2}
    hdr = {pkg.fleet.SESSION_HEADER: "sess-a"}
    out = []
    try:
        for state in ("admitted", "draining", "admitted", "dead"):
            rep.state = state
            status, headers, lines = post_generate(r.host, r.port, body, hdr)
            out.append((status, headers.get("X-DTF-Replica"),
                        headers.get("Retry-After"), lines[-1],
                        dict(r._sessions)))
        counters = {k: r.fleet_healthz()["fleet"]["router"][k] for k in (
            "generate_streams", "sessions", "affinity_misses")}
    finally:
        fleet.close()
    return out, counters


def test_fleet_session_affinity_409():
    out, counters = both(_affinity)
    assert [o[0] for o in out] == [200, 409, 200, 503]
    assert out[0][1] == "r0" and out[0][3]["done"] is True
    assert out[0][4] == {"sess-a": 0}
    assert float(out[1][2]) > 0 and out[1][3]["retryable"] is True
    assert "sess-a" not in out[3][4]  # the pin of a dead replica is dropped
    assert counters == {"generate_streams": 2, "sessions": 0,
                        "affinity_misses": 1}


# --------------------------------------------------------- tracing


def _traced(pkg, tmp_path):
    events = tmp_path / f"{pkg.name}-trace.jsonl"
    fleet = Fleet(pkg, writer_path=events)
    fleet.stubs[0].fail = True
    try:
        ctx = pkg.tracing.fresh_context()
        reply = post(fleet.url, headers={
            pkg.tracing.TRACE_HEADER: ctx.encode()})
    finally:
        fleet.close()
    spans = [e["extra"] for e in pkg.telemetry.read_events(
        str(events), kind=pkg.telemetry.KIND_SPAN)]
    by_id = {s["span"]: s for s in spans}
    tree = sorted((by_id.get(s["parent"], {}).get("name", ""), s["name"],
                   s["status"], s["trace"] == ctx.trace_id) for s in spans)
    return {"reply": routed_view(reply), "tree": tree}


def test_hedged_retry_is_one_trace_tree(tmp_path):
    out = both(_traced, tmp_path)
    assert out["reply"][0] == 200 and out["reply"][3] == "r1"
    assert out["tree"] == [
        ("", "router.request", "ok", True),
        ("router.request", "fleet.attempt", "error", True),
        ("router.request", "fleet.attempt", "ok", True),
        ("router.request", "fleet.backoff", "ok", True)]


# ------------------------------------------------------- telemetry


def _rollup(pkg, tmp_path):
    events = str(tmp_path / f"{pkg.name}-rollup.jsonl")
    writer = pkg.telemetry.TelemetryWriter(events)
    kinds = pkg.telemetry
    for replica, retries in (("r0", 0), ("r1", 1), ("r0", 0), ("r2", 2)):
        writer.emit(kinds.KIND_SERVE_ROUTE,
                    metrics={"latency_ms": 5.0, "retries": retries,
                             "status": 200},
                    replica=replica, shed=False, deadline_exceeded=False)
    writer.emit(kinds.KIND_SERVE_ROUTE,
                metrics={"latency_ms": 1.0, "retries": 0, "status": 503},
                replica=None, shed=True, deadline_exceeded=False)
    writer.emit(kinds.KIND_SERVE_EJECT, replica="r1", action="eject",
                reason="dead (rc=-9)")
    writer.emit(kinds.KIND_SERVE_EJECT, replica="r1", action="restart",
                reason="supervised relaunch")
    writer.emit(kinds.KIND_SERVE_EJECT, replica="r1", action="readmit",
                reason="healthz recovered")
    writer.emit(kinds.KIND_SERVE_RELOAD, metrics={"reload_ms": 120.0},
                replica="r0", ok=True, from_digest="aaaa1111",
                to_digest="bbbb2222")
    writer.emit(kinds.KIND_SERVE_RELOAD, metrics={"reload_ms": 15.0},
                replica="r1", ok=False, from_digest="aaaa1111",
                to_digest=None)
    writer.close()
    summary = pkg.telemetry.summarize_events(events)
    return {"fleet": summary["fleet"],
            "text": [line for line in pkg.telemetry.format_run_summary(
                summary).splitlines()[1:] if "fleet" in line
                or "reload" in line]}


def test_fleet_telemetry_rollup(tmp_path):
    out = both(_rollup, tmp_path)
    fleet = out["fleet"]
    assert fleet["requests"] == 5 and fleet["retries"] == 3
    assert fleet["routed"] == {"r0": 2, "r1": 1, "r2": 1}
    assert fleet["shed"] == 1 and fleet["readmits"] == 1
    assert fleet["restarts"] == 1
    assert fleet["ejects"] == [{"replica": "r1", "reason": "dead (rc=-9)"}]
    assert [r["ok"] for r in fleet["reloads"]] == [True, False]
    text = "\n".join(out["text"])
    assert "fleet: 5 proxied" in text and "REJECTED" in text


def _no_fleet(pkg, tmp_path):
    events = str(tmp_path / f"{pkg.name}-train.jsonl")
    writer = pkg.telemetry.TelemetryWriter(events)
    writer.emit(pkg.telemetry.KIND_TRAIN_STEP, step=1, metrics={"loss": 1.0})
    writer.close()
    summary = pkg.telemetry.summarize_events(events)
    return [summary["fleet"],
            "fleet:" in pkg.telemetry.format_run_summary(summary)]


def test_runs_without_fleet_events_have_no_fleet_section(tmp_path):
    assert both(_no_fleet, tmp_path) == [None, False]


def _mixed(pkg, tmp_path):
    """A script touching every router counter: routed, retried, shed,
    rolled, and a 429."""
    events = tmp_path / f"{pkg.name}-mixed.jsonl"
    fleet = Fleet(pkg, writer_path=events, tenant_quota_rps=0.001,
                  tenant_quota_burst=2)
    try:
        replies = [post(fleet.url, headers={"X-DTF-Tenant": t})
                   for t in ("high", "batch", "high", "high")]
        fleet.stubs[0].fail = True
        replies.append(post(fleet.url, headers={"X-DTF-Tenant": "batch"}))
        # The 429's Retry-After is the time to the next token: whole
        # seconds compare, its milliseconds follow the clock.
        replies = [routed_view(r)[:4] + (
            r[2].get("Retry-After") and round(float(r[2]["Retry-After"])),)
            for r in replies]
        fleet.router.rolling_reload("v3", count=1)
        health = fleet.router.fleet_healthz()
    finally:
        fleet.close()
    return {"replies": replies, "health": health,
            "fleet": pkg.telemetry.summarize_events(str(events))["fleet"]}


def test_fleet_healthz_and_summary_equal_jax(tmp_path):
    out = both(_mixed, tmp_path)
    assert [r[0] for r in out["replies"]] == [200, 200, 200, 429, 200]
    assert out["health"]["role"] == "fleet"
    assert sorted(out["health"]["fleet"]) == [
        "admitted", "autoscale", "models", "replicas", "router", "tenants"]
    router = out["health"]["fleet"]["router"]
    assert router["requests"] == 4 and router["reload_rolls"] == 1
    assert out["fleet"]["tenants"]["high"]["quota_rejected"] == 1


# ------------------------------------------------------------ imports


def test_router_imports_no_torch():
    """``serve.fleet`` and ``cli.fleet`` in a fresh interpreter: the
    router process never imports torch (the replicas own the device)."""
    code = ("import sys\n"
            "import distributed_tensorflow_framework_torch.serve.fleet\n"
            "import distributed_tensorflow_framework_torch.cli.fleet\n"
            "import distributed_tensorflow_framework_torch.serve as s\n"
            "assert s.FleetRouter and s.Autoscaler\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_replica_launcher_passes_the_device_and_drops_the_faults(
        tmp_path, monkeypatch):
    """cli/fleet.py's launcher: ``entry`` with the artifact, ``--device``
    and the replica's own port and log dir, the overrides after them,
    ``DTF_REPLICA_ID`` set and the router's ``DTF_FAULTS`` withheld; a
    stale endpoint.json of an earlier life is removed first."""
    from distributed_tensorflow_framework_torch.cli import fleet as cli_fleet

    monkeypatch.setenv("DTF_FAULTS", "kill_replica:0")
    monkeypatch.setenv("DTF_FAULTS_STATE", str(tmp_path / "state"))
    record = tmp_path / "seen.json"
    script = ("import json, os, sys; json.dump({'argv': sys.argv[1:], "
              "'env': {k: os.environ.get(k) for k in ('DTF_REPLICA_ID', "
              f"'DTF_FAULTS', 'DTF_FAULTS_STATE')}}}}, open({str(record)!r}, "
              "'w'))")
    launch = cli_fleet.make_replica_launcher(
        "/runs/art", str(tmp_path / "logs"), ["serve.max_batch_size=4"],
        "cpu", entry=("-c", script))
    (tmp_path / "logs" / "r1").mkdir(parents=True)
    (tmp_path / "logs" / "r1" / "endpoint.json").write_text("{}")
    proc, endpoint = launch(1)
    assert proc.wait(60) == 0
    assert endpoint == str(tmp_path / "logs" / "r1" / "endpoint.json")
    assert not (tmp_path / "logs" / "r1" / "endpoint.json").exists()
    seen = json.loads(record.read_text())
    assert seen["argv"] == [
        "--artifact", "/runs/art", "--device", "cpu", "--set", "serve.port=0",
        "--set", f"serve.log_dir={tmp_path / 'logs' / 'r1'}",
        "--set", "serve.max_batch_size=4"]
    assert seen["env"] == {"DTF_REPLICA_ID": "r1", "DTF_FAULTS": None,
                           "DTF_FAULTS_STATE": None}
    assert cli_fleet.SERVE_ENTRY == (
        "-m", "distributed_tensorflow_framework_torch.cli.serve")
    args = cli_fleet.parse_args(["--artifact", "a"])
    assert (args.device, args.replicas) == ("cuda", None)
