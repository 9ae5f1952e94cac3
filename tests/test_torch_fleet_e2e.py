"""The fleet slice end to end on the CPU, and ``serve.data`` 0 and -1.

A small BERT artifact is made from the JAX ``BertForMLM`` initialiser's
weights (tests/test_torch_serve.py's helpers; models/convert.py maps them)
and served by ``python -m distributed_tensorflow_framework_torch.cli.fleet
--device cpu`` with two port replicas (``cli.serve`` subprocesses). One
run of the fleet, under client traffic throughout, checks in turn:
``/predict`` through the fleet against the JAX ``InferenceEngine`` on the
same weights (f32: rtol 1e-4, atol 1e-5, tests/test_torch_serve.py's
tolerance) with both replicas routed; ``kill_replica:0`` with no failed
request, the replica restarted and readmitted and the router's flight
recorder dumped naming it; a ``corrupt_reload`` roll aborted at the
first replica with the old digest everywhere; a rolling reload to a
perturbed artifact with no failed request and the new digest on every
replica; and SIGTERM ending the whole tree with 0.

``serve.data`` 0 and -1 mean every visible device, as the JAX package's
``serving_mesh`` reads them: one on the CPU, where the engine then gives
``serve.data=1``'s logits bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.mesh import MeshSizeError
from distributed_tensorflow_framework_torch.serve import decode as pd
from distributed_tensorflow_framework_torch.serve import engine as pe
from distributed_tensorflow_framework_torch.serve import export as px
from distributed_tensorflow_framework_tpu.core import telemetry as jtel
from distributed_tensorflow_framework_tpu.serve import export as jx
from distributed_tensorflow_framework_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from distributed_tensorflow_framework_tpu.serve.engine import serving_mesh
from tests.test_torch_hygiene import torch_threads  # noqa: F401
from tests.test_torch_serve import (
    MODEL,
    SERVE,
    _configs,
    _ids,
    _jax_params,
    _save_port,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# The router's knobs for the drill: a short probe interval, so that the
# kill lands a few ticks after the fleet is admitted, and a roomy
# per-attempt cap for a CPU shared with other test workers.
FLEET_SET = ["serve.fleet_probe_interval_s=0.2",
             "serve.fleet_attempt_timeout_s=30", "serve.fleet_deadline_s=90",
             "serve.fleet_retry_backoff_ms=50"]
KILL_TICK = 10
DEADLINE_S = 240.0


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    cfg, jcfg = _configs()
    params = _jax_params(jcfg)
    root = tmp_path_factory.mktemp("fleet_e2e")
    rng = np.random.default_rng(5)
    perturbed = _perturb(params, rng)
    return {
        "cfg": cfg, "jcfg": jcfg, "params": params, "root": root,
        "v1": _save_port(root / "v1", cfg, params),
        "v2": _save_port(root / "v2", cfg, perturbed),
        "jax_v1": jx.save_artifact(
            str(root / "jax_v1"), model_config=jcfg.model, task="mlm",
            params=params, batch_stats={}, step=7,
            input_spec=jx.input_spec_for(jcfg, "mlm")),
    }


def _perturb(tree, rng):
    """Every leaf moved by 1% noise: a second artifact of the model."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng) for k, v in tree.items()}
    arr = np.asarray(tree)
    return (arr + 0.01 * rng.standard_normal(arr.shape)).astype(arr.dtype)


# ------------------------------------------------------------ serve.data


@pytest.mark.parametrize("data", [-1, 0])
def test_serve_data_all_devices_is_one_device_on_the_cpu(arts, data):
    cfg = arts["cfg"]
    art = px.load_artifact(arts["v1"])
    requests = [{"input_ids": _ids(30, 17)},
                {"input_ids": _ids(31, 70, rows=2)}]
    one = pe.InferenceEngine(art, cfg.serve, device="cpu")
    every = pe.InferenceEngine(
        art, dataclasses.replace(cfg.serve, data=data), device="cpu")
    jax_cfg = arts["jcfg"]
    ref = JaxEngine(jx.load_artifact(arts["jax_v1"]), jax_cfg.serve,
                    mesh=serving_mesh(1))
    try:
        for req in requests:
            got = every.predict(req, timeout=120)
            np.testing.assert_array_equal(got, one.predict(req, timeout=120))
            np.testing.assert_allclose(
                got, np.asarray(ref.predict(req, timeout=300)), **F32_TOL)
    finally:
        one.drain(30)
        every.drain(30)
        ref.drain(30)


def test_serve_data_above_the_visible_devices_raises(arts):
    art = px.load_artifact(arts["v1"])
    cfg = dataclasses.replace(arts["cfg"].serve, data=2)
    with pytest.raises(MeshSizeError, match="needs 2 devices but 1"):
        pe.InferenceEngine(art, cfg, device="cpu")
    with pytest.raises(MeshSizeError):
        pd.DecodeEngine(art, arts["cfg"].decode, cfg, device="cpu")


@pytest.mark.parametrize("data, error", [
    (1, None), (-1, None), (0, None), (2, None), (4, None),
    (5, MeshSizeError)])
def test_serve_data_on_a_machine_of_four_gpus(monkeypatch, data, error):
    """What a machine of four cards gets: -1 and 0 every card, a count up
    to four that many (cuda:0 …), more than it has MeshSizeError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = dataclasses.replace(_configs()[0].serve, data=data)
    if error is None:
        n = 4 if data in (-1, 0) else data
        assert pe.serving_devices(cfg.data, torch.device("cuda", 0)) == [
            torch.device("cuda", i) for i in range(n)]
    else:
        with pytest.raises(error, match="needs 5 devices but 4"):
            pe.serving_devices(cfg.data, torch.device("cuda", 0))


# -------------------------------------------------------- the fleet


def _request(url, path, body=None, timeout=120.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


class Traffic:
    """Two client threads sending small ``/predict`` requests until
    stopped; every answer that is not a 200 is a failed request."""

    def __init__(self, url):
        self.url = url
        self.stop = threading.Event()
        self.answers: list = []
        self.failures: list = []
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True) for i in range(2)]
        for t in self.threads:
            t.start()

    def _run(self, i):
        rng = np.random.default_rng(100 + i)
        while not self.stop.is_set():
            ids = rng.integers(0, MODEL["vocab_size"],
                               int(rng.integers(2, 9))).tolist()
            try:
                status, _, headers = _request(
                    self.url, "/predict", {"inputs": {"input_ids": ids}})
            except Exception as e:  # noqa: BLE001 — counted as a failure
                self.failures.append(repr(e))
                continue
            self.answers.append(headers.get("X-DTF-Replica"))
            if status != 200:
                self.failures.append(status)

    def finish(self):
        self.stop.set()
        for t in self.threads:
            t.join(120)
        return self.failures


def _wait(what, predicate, deadline):
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _health(url):
    try:
        return _request(url, "/healthz", timeout=10)[1]
    except OSError:
        return {}


def _replicas(url):
    return {r["replica"]: r for r in _health(url).get("fleet", {}).get(
        "replicas", [])}


def test_fleet_cli_serves_survives_rolls_and_drains(arts, tmp_path):
    deadline = time.monotonic() + DEADLINE_S
    log_dir = tmp_path / "fleet"
    bad = tmp_path / "v2_corrupt"
    shutil.copytree(arts["v2"], bad)
    cmd = [sys.executable, "-m",
           "distributed_tensorflow_framework_torch.cli.fleet",
           "--artifact", arts["v1"], "--device", "cpu", "--replicas", "2",
           *sum((["--set", o] for o in (*SERVE, *FLEET_SET)), []),
           "--set", "serve.port=0", "--set", f"serve.log_dir={log_dir}"]
    env = dict(os.environ, PYTHONPATH=ROOT,
               DTF_FAULTS=f"kill_replica:0:{KILL_TICK},corrupt_reload:v2")
    env.pop("DTF_FAULTS_STATE", None)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    traffic = None
    try:
        endpoint = log_dir / "endpoint.json"
        _wait("the fleet's endpoint.json",
              lambda: endpoint.exists() or proc.poll() is not None, deadline)
        assert proc.poll() is None, proc.communicate()[0]
        time.sleep(0.2)
        record = json.loads(endpoint.read_text())
        url = record["url"]
        assert record["role"] == "fleet" and record["replicas"] == 2
        _wait("both replicas admitted", lambda: _health(url).get(
            "fleet", {}).get("admitted") == 2, deadline)

        # Traffic from the moment the chaos clock arms: the kill lands
        # KILL_TICK ticks later, under it.
        traffic = Traffic(url)
        ref = JaxEngine(jx.load_artifact(arts["jax_v1"]), arts["jcfg"].serve,
                        mesh=serving_mesh(1))
        try:
            served = set()
            for seed, n in ((40, 5), (41, 23), (42, 64), (43, 100)):
                ids = _ids(seed, n)
                status, reply, headers = _request(
                    url, "/predict", {"inputs": {"input_ids": ids.tolist()}})
                assert status == 200, reply
                served.add(headers["X-DTF-Replica"])
                np.testing.assert_allclose(
                    np.asarray(reply["outputs"], np.float32),
                    np.asarray(ref.predict({"input_ids": ids}, timeout=300)),
                    **F32_TOL)
        finally:
            ref.drain(30)

        # kill_replica:0: ejected, restarted by supervision, readmitted.
        _wait("r0 restarted and readmitted", lambda: (
            _replicas(url).get("r0", {}).get("restarts") == 1
            and _replicas(url)["r0"]["state"] == "admitted"), deadline)
        dumps = [json.loads(p.read_text())
                 for p in log_dir.glob("flightrec-*.json")]
        assert [d["reason"] for d in dumps] == ["replica r0 dead (rc=-9)"]

        # corrupt_reload: the first roll's artifact is truncated before it
        # starts; r0 refuses it (409) and the roll stops there.
        before = {k: r["artifact"]["content_digest"]
                  for k, r in _replicas(url).items()}
        status, rolled, _ = _request(url, "/reload",
                                     {"artifact_dir": str(bad)})
        assert status == 409 and rolled["reloaded"] is False, rolled
        assert [(r["replica"], r["status"]) for r in rolled["replicas"]] == [
            ("r0", 409)]
        after = {k: r["artifact"]["content_digest"]
                 for k, r in _replicas(url).items()}
        assert after == before and len(set(after.values())) == 1

        # A rolling reload to the perturbed artifact, under traffic.
        status, rolled, _ = _request(url, "/reload",
                                     {"artifact_dir": arts["v2"]})
        assert status == 200 and rolled["reloaded"] is True, rolled
        assert [r["replica"] for r in rolled["replicas"]] == ["r0", "r1"]
        new = px.load_artifact(arts["v2"]).content_digest
        assert {r["artifact"]["content_digest"]
                for r in _replicas(url).values()} == {new} != set(
            before.values())
        failures = traffic.finish()
        answers, traffic = traffic.answers, None
        assert failures == [], failures
        assert served | set(answers) == {"r0", "r1"}
        assert len(answers) > 0
        pids = [json.loads((log_dir / f"r{i}" / "endpoint.json").read_text())[
            "pid"] for i in range(2)]

        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if traffic is not None:
            traffic.finish()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    drains = [e["health"] for e in jtel.read_events(
        str(log_dir / "events.jsonl"), kind=jtel.KIND_HEALTH)]
    assert drains == [{"event": "fleet_drain", "reason": "sigterm",
                       "clean": True}]
    for pid in pids:  # the whole tree has ended
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    summary = jtel.summarize_events(str(log_dir / "events.jsonl"))
    fleet = summary["fleet"]
    assert fleet["restarts"] == 1 and fleet["readmits"] >= 1
    assert [(r["replica"], r["ok"]) for r in fleet["reloads"]] == [
        ("r0", False), ("r0", True), ("r1", True)]
