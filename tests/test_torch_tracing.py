"""The port's distributed tracing and flight recorder (core/tracing.py)
against the JAX package's, and the traced serve path.

Mirrors tests/test_tracing.py: the ``X-DTF-Trace`` codec (a context
encoded by one package parses in the other), span emission, the clock
model under an injected ±0.2 s wall skew read back by the JAX package's
``scripts/analyze_trace.py`` (``collect_spans``, ``build_traces``,
``critical_path``, ``perfetto_export``) into the same tree as the JAX
tracer's trace of the same spans, the flight recorder's ring bound and
dump keys, and a repo root left without dumps. Then the server: a traced
``/predict`` gives the JAX server's span names and parentage under the
client's trace id, a malformed header is still answered 200, ``/healthz``
carries ``memory`` and ``goodput``, and SIGUSR1 makes ``cli/serve.py``
write a ``dtf-flightrec/1`` dump.

Everything compared here is exact (names, parentage, keys, counts);
times are compared only for causal order.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import pytest

from distributed_tensorflow_framework_torch.core import telemetry as pt
from distributed_tensorflow_framework_torch.core import tracing as ptr
from distributed_tensorflow_framework_tpu.core import telemetry as jt
from distributed_tensorflow_framework_tpu.core import tracing as jtr
from scripts import analyze_trace
from tests.test_torch_hygiene import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (pt, ptr), "jax": (jt, jtr)}


# --------------------------------------------------------------- codec --

@pytest.mark.parametrize("src, dst", [("port", "jax"), ("jax", "port")])
def test_span_context_parses_across_packages(src, dst):
    enc = PACKAGES[src][1]
    dec = PACKAGES[dst][1]
    for ctx in (enc.SpanContext("abcd1234abcd1234", "ef567890", 1723.456789),
                enc.SpanContext("abcd1234abcd1234", "", 5.0),
                enc.fresh_context(now=99.5)):
        got = dec.SpanContext.parse(ctx.encode())
        assert (got.trace_id, got.span_id, got.sent_at) == (
            ctx.trace_id, ctx.span_id, ctx.sent_at)
        assert got.encode() == ctx.encode()
    assert ptr.TRACE_HEADER == jtr.TRACE_HEADER
    assert ptr.TRACE_CTX_ENV == jtr.TRACE_CTX_ENV
    assert ptr.FLIGHTREC_SCHEMA == jtr.FLIGHTREC_SCHEMA


@pytest.mark.parametrize("bad", ["", "abc", "a:b", "a:b:c:d", ":s:1.0",
                                 "t:s:not-a-number"])
def test_malformed_contexts_are_refused_alike(bad):
    for _, tr in PACKAGES.values():
        with pytest.raises(tr.TraceContextError):
            tr.SpanContext.parse(bad)
        assert tr.safe_parse(bad) is None


def test_env_context_reads_the_propagation_var():
    ctx = ptr.SpanContext("feedfacefeedface", "0badf00d", 12.5)
    env = {ptr.TRACE_CTX_ENV: ctx.encode()}
    assert ptr.env_context(env) == ctx
    assert jtr.env_context(env).encode() == ctx.encode()
    assert ptr.env_context({}) is None


def test_span_events_validate_in_the_jax_schema(tmp_path):
    path = str(tmp_path / "events.jsonl")
    writer = pt.TelemetryWriter(path, run_id="r")
    tracer = ptr.Tracer(writer, service="svc")
    span = tracer.start("outer", attempt=1)
    assert [s["name"] for s in tracer.open_spans()] == ["outer"]
    t0 = time.monotonic()
    tracer.emit_span("inner", span, start_mono=t0, end_mono=t0 + 0.25,
                     rows=3)
    span.end(status="ok", n=2)
    assert span.end() == {}  # idempotent
    assert tracer.open_spans() == []
    writer.close()
    events = list(jt.read_events(path, kind=jt.KIND_SPAN))
    assert [e["extra"]["name"] for e in events] == ["inner", "outer"]
    inner, outer = events
    assert inner["extra"]["parent"] == outer["extra"]["span"]
    assert inner["metrics"]["dur_ms"] == pytest.approx(250.0)
    assert inner["extra"]["attrs"] == {"rows": 3}
    assert outer["extra"]["attrs"] == {"attempt": 1, "n": 2}
    assert set(inner["extra"]) == {"trace", "span", "parent", "name",
                                   "service", "status", "t_start",
                                   "offset_s", "attrs"}


def test_adopt_estimates_the_clock_offset_alike():
    for _, tr in PACKAGES.values():
        sender = tr.Tracer(None, service="a", skew_s=0.0)
        receiver = tr.Tracer(None, service="b", skew_s=0.2)
        receiver.adopt(sender.start("x").context())
        assert receiver.offset_s == pytest.approx(0.2, abs=0.05)
        receiver.adopt(None)  # no context: the estimate stays
        assert receiver.offset_s == pytest.approx(0.2, abs=0.05)


# -------------------------------------------- cross-process stitching --

def _two_process_trace(root, pkg: str, skew_a: float, skew_b: float) -> str:
    """The same spans through one package's writer and tracer: a parent
    span in stream A, its child in stream B, with injected wall skews."""
    tel, tr = PACKAGES[pkg]
    run_dir = root / pkg
    run_dir.mkdir()
    wa = tel.TelemetryWriter(str(run_dir / "events.jsonl"), run_id="g")
    wb = tel.TelemetryWriter(str(run_dir / "events-p1.jsonl"), run_id="g")
    ta = tr.Tracer(wa, service="launcher", skew_s=skew_a)
    tb = tr.Tracer(wb, service="worker0", skew_s=skew_b)
    root_span = ta.start("supervisor.run")
    attempt = ta.start("supervisor.attempt", root_span, attempt=1)
    tb.adopt(attempt.context())
    child = tb.start("worker.run", attempt.context())
    t0 = time.monotonic()
    tb.emit_span("train.startup", child, start_mono=t0,
                 end_mono=t0 + 0.01, first_step=1)
    child.end()
    attempt.end()
    root_span.end()
    wa.close()
    wb.close()
    return str(run_dir)


def _tree(trace: dict) -> list:
    """A trace's shape without ids or times: (name, service, status,
    children) from each root down."""
    def node(s):
        kids = trace["children"].get(s["span"], [])
        return (s["name"], s["service"], s["status"],
                sorted(node(k) for k in kids))
    return sorted(node(r) for r in trace["roots"])


@pytest.mark.parametrize("skew_a, skew_b", [(0.0, 0.2), (0.2, -0.2)])
def test_port_trace_reads_as_the_jax_tracers(tmp_path, skew_a, skew_b):
    got, want = [analyze_trace.build_traces(analyze_trace.collect_spans(
        analyze_trace._events_files(
            _two_process_trace(tmp_path, pkg, skew_a, skew_b))))
        for pkg in ("port", "jax")]
    assert len(got) == len(want) == 1
    assert _tree(got[0]) == _tree(want[0])
    assert got[0]["services"] == want[0]["services"]
    by_id = {s["span"]: s for s in got[0]["spans"]}
    for s in got[0]["spans"]:  # causal order after the offset and clamp
        parent = by_id.get(s["parent"])
        if parent is not None:
            assert s["t0"] >= parent["t0"] - 1e-9, (s, parent)
    cp_got, cp_want = (analyze_trace.critical_path(t[0])
                       for t in (got, want))
    assert set(cp_got) == set(cp_want)
    assert cp_got["total"] == pytest.approx(got[0]["dur_ms"])
    doc_got, doc_want = (analyze_trace.perfetto_export(t)
                         for t in (got, want))
    assert sorted((e["name"], e["ph"], e.get("cat")) for e in
                  doc_got["traceEvents"]) == sorted(
        (e["name"], e["ph"], e.get("cat")) for e in doc_want["traceEvents"])
    json.dumps(doc_got)


def test_spans_cli_reads_the_port_streams(tmp_path, capsys):
    run_dir = _two_process_trace(tmp_path, "port", 0.0, 0.0)
    assert analyze_trace.main([run_dir, "--spans", "--json", "-"]) == 0
    obj = json.loads(capsys.readouterr().out)
    assert obj["schema"] == analyze_trace.TRACE_SPANS_SCHEMA
    assert len(obj["traces"]) == 1


# ------------------------------------------------------ flight recorder --

def _dump(pkg, tmp_path):
    tel, tr = PACKAGES[pkg]
    writer = tel.TelemetryWriter(str(tmp_path / f"{pkg}.jsonl"))
    tracer = tr.Tracer(writer, service="s")
    rec = tr.FlightRecorder(4, dump_dir=str(tmp_path / pkg),
                            tracer=tracer).attach(writer)
    for i in range(10):
        writer.emit(tel.KIND_HEALTH, step=i)
    tracer.start("still.open")
    path = rec.dump("test")
    writer.close()
    with open(path) as fh:
        return path, json.load(fh), rec


def test_flight_recorder_ring_and_dump_keys_equal_jax(tmp_path):
    (ppath, port_doc, prec), (_, jax_doc, _) = (
        _dump(pkg, tmp_path) for pkg in ("port", "jax"))
    assert set(port_doc) == set(jax_doc)
    assert port_doc["schema"] == "dtf-flightrec/1"
    assert port_doc["event_count"] == jax_doc["event_count"] == 4
    assert [e["step"] for e in port_doc["events"]] == [6, 7, 8, 9]
    assert ([s["name"] for s in port_doc["open_spans"]]
            == [s["name"] for s in jax_doc["open_spans"]] == ["still.open"])
    assert set(port_doc["open_spans"][0]) == set(jax_doc["open_spans"][0])
    assert os.path.basename(ppath) == f"flightrec-{os.getpid()}.json"
    assert prec.dumps == 1
    with pytest.raises(ValueError):
        ptr.FlightRecorder(0)


def test_flight_recorder_default_path_never_the_cwd(tmp_path, monkeypatch):
    monkeypatch.delenv(ptr.TRACE_DIR_ENV, raising=False)
    writer = pt.TelemetryWriter(str(tmp_path / "logs" / "events.jsonl"))
    rec = ptr.FlightRecorder(2).attach(writer)
    assert rec.default_path() == str(
        tmp_path / "logs" / f"flightrec-{os.getpid()}.json")
    writer.close()
    bare = pt.TelemetryWriter(None)
    assert ptr.FlightRecorder(2).attach(bare).default_path().startswith(
        tempfile.gettempdir())
    monkeypatch.setenv(ptr.TRACE_DIR_ENV, str(tmp_path / "env"))
    assert ptr.FlightRecorder(2).default_path().startswith(
        str(tmp_path / "env"))


def test_repo_root_stays_clean_of_flightrec_dumps():
    litter = [f for f in os.listdir(ROOT)
              if f.startswith("flightrec-") and f.endswith(".json")]
    assert litter == []


# ------------------------------------------------------------ serving --

MODEL = ["model.name=bert", "model.vocab_size=100", "model.hidden_size=32",
         "model.num_layers=1", "model.num_heads=2", "model.mlp_dim=64",
         "model.max_seq_len=64", "data.seq_len=64", "model.dtype=float32",
         "model.attention_impl=pallas"]
SERVE = ["serve.port=0", "serve.max_batch_size=4", "serve.max_wait_ms=5",
         "serve.seq_buckets=[64]", "serve.report_interval_s=60"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One set of weights as a port artifact and as a JAX artifact."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from distributed_tensorflow_framework_torch.core.config import (
        load_config as port_config,
    )
    from distributed_tensorflow_framework_torch.serve import export as px
    from distributed_tensorflow_framework_tpu.core.config import (
        load_config as jax_config,
    )
    from distributed_tensorflow_framework_tpu.models import get_model
    from distributed_tensorflow_framework_tpu.serve import export as jx

    root = tmp_path_factory.mktemp("traced_serve")
    cfg = port_config(overrides=MODEL + SERVE)
    jcfg = jax_config(overrides=MODEL + SERVE)
    params = get_model(jcfg.model).init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 64), jnp.int32),
        train=False)["params"]
    params = jax.tree.map(np.asarray, jax.device_get(params))
    port_dir = px.save_artifact(
        str(root / "port"), model_config=cfg.model, task="mlm",
        params=params, step=3, input_spec=px.input_spec_for(cfg, "mlm"))
    jax_dir = jx.save_artifact(
        str(root / "jax"), model_config=jcfg.model, task="mlm",
        params=params, batch_stats={}, step=3,
        input_spec=jx.input_spec_for(jcfg, "mlm"))
    return {"port": port_dir, "jax": jax_dir, "cfg": cfg, "jcfg": jcfg}


def _request(url, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(pkg, artifacts, events):
    """An engine and an HTTP server of one package on the CPU."""
    if pkg == "port":
        from distributed_tensorflow_framework_torch.serve.engine import (
            InferenceEngine,
        )
        from distributed_tensorflow_framework_torch.serve.export import (
            load_artifact,
        )
        from distributed_tensorflow_framework_torch.serve.server import (
            ServingServer,
        )
        writer = pt.TelemetryWriter(events)
        engine = InferenceEngine(load_artifact(artifacts["port"]),
                                 artifacts["cfg"].serve, device="cpu",
                                 telemetry_writer=writer)
        cfg = artifacts["cfg"].serve
    else:
        from distributed_tensorflow_framework_tpu.serve.engine import (
            InferenceEngine,
            serving_mesh,
        )
        from distributed_tensorflow_framework_tpu.serve.export import (
            load_artifact,
        )
        from distributed_tensorflow_framework_tpu.serve.server import (
            ServingServer,
        )
        writer = jt.TelemetryWriter(events)
        engine = InferenceEngine(load_artifact(artifacts["jax"]),
                                 artifacts["jcfg"].serve,
                                 mesh=serving_mesh(1),
                                 telemetry_writer=writer)
        cfg = artifacts["jcfg"].serve
    server = ServingServer(engine, cfg, telemetry_writer=writer)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, writer, f"http://{server.host}:{server.port}"


def _traced_requests(pkg, artifacts, tmp_path):
    events = str(tmp_path / f"{pkg}_events.jsonl")
    server, thread, writer, url = _serve(pkg, artifacts, events)
    ctx = jtr.fresh_context()
    try:
        for ids, header in (([1, 2, 3, 4], ctx.encode()),
                            ([5, 6, 7], "not-a-trace-header"),
                            ([8, 9], None)):
            status, reply = _request(
                url, "/predict", {"inputs": {"input_ids": ids}},
                {} if header is None else {jtr.TRACE_HEADER: header})
            assert status == 200, reply
            assert len(reply["outputs"][0]) == len(ids)
        status, health = _request(url, "/healthz")
        assert status == 200
    finally:
        server.shutdown("test")
        thread.join(30)
        writer.close()
    return ctx, events, health


def test_traced_predict_gives_the_jax_servers_span_tree(artifacts,
                                                        tmp_path):
    trees = {}
    for pkg in ("port", "jax"):
        ctx, events, health = _traced_requests(pkg, artifacts, tmp_path)
        for ev in jt.read_events(events):  # every event validates
            assert jt.validate_event(ev) == []
        traces = analyze_trace.build_traces(
            analyze_trace.collect_spans([events]))
        # Only the request with a well-formed header is traced, under
        # the client's trace id.
        assert [t["trace"] for t in traces] == [ctx.trace_id]
        trees[pkg] = _tree(traces[0])
        assert set(health) >= {"memory", "goodput"}
        if pkg == "port":
            port_health = health
    assert trees["port"] == trees["jax"]
    [(name, _, status, children)] = trees["port"]
    assert (name, status) == ("serve.request", "ok")
    assert [c[0] for c in children] == ["engine.batch", "engine.queue"]
    assert [g[0] for g in children[0][3]] == ["engine.compute"]
    mem = port_health["memory"]
    assert mem["source_kind"] == "host_rss" and mem["bytes_in_use"] > 0
    assert set(mem) == {"device_count", "bytes_in_use", "peak_bytes_in_use",
                        "source_kind", "devices"}
    good = port_health["goodput"]
    assert set(good) == {"uptime_s", "compute_ms_total",
                         "queue_wait_ms_total", "compute_frac"}
    assert good["compute_ms_total"] > 0 and 0 < good["compute_frac"] < 1


def test_sigusr1_dumps_the_replicas_flight_recorder(artifacts, tmp_path):
    log_dir = tmp_path / "logs"
    cmd = [sys.executable, "-m",
           "distributed_tensorflow_framework_torch.cli.serve",
           "--artifact", artifacts["port"], "--device", "cpu",
           *sum((["--set", o] for o in SERVE), []),
           "--set", f"serve.log_dir={log_dir}"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        endpoint = log_dir / "endpoint.json"
        deadline = time.monotonic() + 120
        while not endpoint.exists() and proc.poll() is None:
            assert time.monotonic() < deadline, "server never came up"
            time.sleep(0.1)
        time.sleep(0.1)
        url = json.loads(endpoint.read_text())["url"]
        ctx = ptr.fresh_context()
        status, _ = _request(url, "/predict",
                             {"inputs": {"input_ids": [1, 2, 3]}},
                             {ptr.TRACE_HEADER: ctx.encode()})
        assert status == 200
        dump = log_dir / f"flightrec-{proc.pid}.json"
        proc.send_signal(signal.SIGUSR1)
        while not dump.exists():
            assert time.monotonic() < deadline + 60, "no dump"
            time.sleep(0.1)
        time.sleep(0.2)  # written to a temporary name, then renamed
        doc = json.loads(dump.read_text())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert doc["schema"] == "dtf-flightrec/1" and doc["reason"] == "SIGUSR1"
    names = [e["extra"]["name"] for e in doc["events"]
             if e["kind"] == "span"]
    assert sorted(names) == ["engine.batch", "engine.compute",
                             "engine.queue", "serve.request"]
