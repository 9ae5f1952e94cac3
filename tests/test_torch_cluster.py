"""The gang supervisor's decisions, the gang and data fault kinds and the
gang supervisor itself, held to the JAX package's (tests/test_cluster.py).

The decisions (``GangBreaker``, ``decide_rejoin``, ``decide_refit``), the
six fault kinds' grammar and firing and ``stitch_attempts`` are compared
with the JAX functions on the same inputs. Then both gang supervisors,
``scripts/train_cluster.py`` and the port's ``cli/train_cluster.py``, run
in process on the same stub gangs (``spawn_gang`` monkeypatched to start
``python -c`` workers; JAX's test_cluster.py harness): crash → gang
restart, ``drop_worker`` refit, stale heartbeat, rejoin timeout, port-bind
race, per-worker crash loop and cancellation, with equal classifications,
exit codes and ``mesh_resized`` records. A port rank is one device, so
both run with ``--devices-per-proc 1``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

from distributed_tensorflow_framework_torch.cli import train_cluster as ptc
from distributed_tensorflow_framework_torch.core import cluster as pcl
from distributed_tensorflow_framework_torch.core import faults as pfaults
from distributed_tensorflow_framework_torch.core import goodput as pgood
from distributed_tensorflow_framework_torch.core import supervision as psup
from distributed_tensorflow_framework_torch.core import telemetry as ptel
from distributed_tensorflow_framework_tpu.core import cluster as jcl
from distributed_tensorflow_framework_tpu.core import faults as jfaults
from distributed_tensorflow_framework_tpu.core import goodput as jgood
from distributed_tensorflow_framework_tpu.core import telemetry as jtel
from scripts import train_cluster as jtc

# ------------------------------------------------------------- decisions

BREAKER_RECORDS = [
    (1, dict(rc=1, last_step=3, ckpt_step=2)),
    (0, dict(rc=9, last_step=1, ckpt_step=None)),
    (1, dict(rc=1, last_step=3, ckpt_step=2)),
    (1, dict(rc=1, last_step=3, ckpt_step=2, hung=True)),
    (1, dict(rc=1, last_step=5, ckpt_step=4)),
    (0, dict(rc=9, last_step=1, ckpt_step=None)),
    (1, dict(rc=85, last_step=5, ckpt_step=4, transient=True)),
    (1, dict(rc=1, last_step=5, ckpt_step=4)),
    (1, dict(rc=1, last_step=5, ckpt_step=4)),
]


@pytest.mark.parametrize("threshold", [0, 1, 2, 3])
def test_gang_breaker_equals_jax(threshold):
    ours, theirs = pcl.GangBreaker(threshold), jcl.GangBreaker(threshold)
    for worker, kw in BREAKER_RECORDS:
        assert ours.record(worker, **kw) == theirs.record(worker, **kw)
    for worker in (0, 1, 2):
        assert ours.report(worker) == theirs.report(worker)


AGES = [{0: None, 1: None}, {0: 1.5, 1: None}, {0: 0.2, 1: 3.0},
        {0: None, 1: 0.0, 2: None}, {}]


@pytest.mark.parametrize("ages,elapsed,timeout", itertools.product(
    AGES, [0.0, 5.0, 30.0], [0.0, 10.0]))
def test_decide_rejoin_equals_jax(ages, elapsed, timeout):
    assert pcl.decide_rejoin(ages, elapsed_s=elapsed,
                             rejoin_timeout_s=timeout) == \
        jcl.decide_rejoin(ages, elapsed_s=elapsed, rejoin_timeout_s=timeout)


MESHES = [{"data": 4}, {"data": 2, "model": 2}, {"data": -1},
          {"data": 2, "fsdp": 2, "pipe": 2}, {"data": 1, "seq": 4},
          {"data": 8, "expert": 2}]


@pytest.mark.parametrize("sizes,batch,accum,procs", itertools.product(
    MESHES, [16, 12, 7], [1, 3], [1, 2, 3, 4]))
def test_decide_refit_equals_jax(sizes, batch, accum, procs):
    def call(module):
        try:
            return dataclasses.asdict(module.decide_refit(
                sizes, batch, accum, process_count=procs,
                devices_per_proc=1))
        except module.ClusterSpecError as e:
            return ("refused", str(e))

    assert call(pcl) == call(jcl)


def test_zero_survivors_refused_as_in_jax():
    for module in (pcl, jcl):
        with pytest.raises(module.ClusterSpecError, match="zero"):
            module.decide_refit({"data": 2}, 8, 1, process_count=0,
                                devices_per_proc=1)


@pytest.mark.parametrize("detail", [
    "jaxlib.xla_extension.XlaRuntimeError: INVALID_ARGUMENT: Multiprocess "
    "computations aren't implemented on the CPU backend.",
    "RuntimeError: connection refused: 127.0.0.1:4444",
    "gloo: collectives are not implemented for this device"])
def test_gang_unsupported_signs_equal_jax(detail):
    assert pcl.is_gang_unsupported(detail) == \
        jcl.is_gang_unsupported(detail)


def test_probe_gang_runs_a_torch_group_on_the_cpu():
    ok, detail = pcl.probe_gang(procs=2, timeout_s=120)
    assert ok, detail
    assert detail.count("GANG_PROBE_OK") == 2
    with pytest.raises(pcl.ClusterSpecError, match="one device"):
        pcl.probe_gang(devices_per_proc=2)


def test_worker_env_carries_the_trace_context():
    env = pcl.worker_env({"PATH": "/bin"}, coordinator_port=1234,
                         num_processes=2, process_id=1, trace_ctx="t:s:1")
    assert env["DTF_TRACE_CTX"] == "t:s:1"
    assert env["JAX_PROCESS_ID"] == "1" and env["PATH"] == "/bin"
    one = pcl.worker_env({"JAX_PROCESS_ID": "3"}, coordinator_port=1,
                         num_processes=1, process_id=0)
    assert "JAX_PROCESS_ID" not in one and "DTF_TRACE_CTX" not in one


@pytest.mark.parametrize("cmd", [
    ["--set", "mesh.data=2"],
    ["--set", "cluster.rejoin_timeout_s=5",
     "--set", "cluster.rejoin_timeout_s=30"],
    ["--config", "configs/bert_base_mlm.yaml"]])
def test_parse_rejoin_timeout_equals_jax(cmd):
    assert ptc.parse_rejoin_timeout(cmd) == jtc.parse_rejoin_timeout(cmd)


# ------------------------------------------------------------ the faults

GANG_SPECS = [
    "kill_worker:1", "kill_worker:1:3", "drop_worker:0:2", "drop_worker:2",
    "stall_worker:1:10s", "stall_worker:0:0", "stall_worker:3:2.5",
    "drop_devices:4", "drop_devices:1:2", "corrupt_shard:1",
    "corrupt_shard:0:3", "skew_shard:1:10s", "skew_shard:0:0",
    "kill_worker:1:2,corrupt_shard:1:3,skew_shard:0:1s,drop_devices:2:3",
]
BAD_SPECS = [
    "kill_worker", "kill_worker:x", "kill_worker:-1", "kill_worker:1:0",
    "drop_worker:1:y", "stall_worker:a:1s", "stall_worker:-2:1s",
    "drop_devices:0", "drop_devices:2:0", "drop_devices:x",
    "corrupt_shard:-1", "corrupt_shard:1:0", "skew_shard:z:1s",
    "skew_shard:-1:1s",
]
FIELDS = ("kind", "arg", "step", "seconds", "devices", "worker", "count")


def _fields(plan):
    return [{f: getattr(fault, f) for f in FIELDS} for fault in plan.faults]


@pytest.mark.parametrize("spec", GANG_SPECS)
def test_gang_fault_grammar_equals_jax(spec):
    assert _fields(pfaults.FaultPlan.parse(spec)) == \
        _fields(jfaults.FaultPlan.parse(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_gang_fault_specs_refused_as_in_jax(spec):
    with pytest.raises(ValueError) as ours:
        pfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as theirs:
        jfaults.FaultPlan.parse(spec)
    assert str(ours.value) == str(theirs.value)


def test_only_the_fleet_kinds_are_refused():
    assert set(pfaults.NOT_PORTED) == {
        "kill_replica", "stall_replica", "spike", "tenant_stampede",
        "corrupt_reload"}
    assert {k: v for k, v in jfaults.KIND_POINTS.items()
            if k not in pfaults.NOT_PORTED} == pfaults.KIND_POINTS
    with pytest.raises(ValueError, match="A15"):
        pfaults.FaultPlan.parse("kill_replica:0")


FIRINGS = [("gang_chaos", 1, None), ("gang_chaos", 2, None),
           ("gang_chaos", 3, None), ("data_chaos", 1, 0),
           ("data_chaos", 1, 1), ("data_chaos", 3, 0), ("data_chaos", 3, 1),
           ("data_chaos", 4, 1), ("relaunch", 1, None), ("relaunch", 3, None),
           ("gang_chaos", 4, None)]


def test_gang_and_data_faults_fire_as_in_jax():
    """The same firings, in order, at the same points, ticks, pulls and
    ranks (the ``worker=`` filter), from a plan of every kind; the
    firings' stderr lines are the JAX package's too."""
    spec = ("kill_worker:1:2,drop_worker:0:3,stall_worker:1:5s,"
            "corrupt_shard:1:3,skew_shard:0:2s,drop_devices:2:3")
    ours, theirs = (pfaults.FaultPlan.parse(spec),
                    jfaults.FaultPlan.parse(spec))
    for point, step, worker in FIRINGS:
        got = [f.fault_id for f in ours.fire(point, step=step,
                                             worker=worker)]
        want = [f.fault_id for f in theirs.fire(point, step=step,
                                                worker=worker)]
        assert got == want, (point, step, worker)
    assert [f.fired for f in ours.faults] == [f.fired for f in theirs.faults]


def test_fired_faults_survive_a_relaunch_as_in_jax(tmp_path):
    spec = "kill_worker:1:2,corrupt_shard:1:3"
    for module, name in ((pfaults, "port"), (jfaults, "jax")):
        state = str(tmp_path / f"{name}.json")
        module.FaultPlan.parse(spec, state_path=state).fire(
            "gang_chaos", step=2)
        again = module.FaultPlan.parse(spec, state_path=state)
        assert [f.fired for f in again.faults] == [True, False], name
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())


# ----------------------------------------------- stitching a gang's runs

def _write_goodput(tel, path, run_id, *, t0, wall, host=None):
    ev = tel.make_event(
        tel.KIND_GOODPUT, run_id=run_id,
        metrics={"wall_s": wall, "goodput_frac": 0.8}, t0=t0, final=True,
        buckets={"step_compute": wall * 0.8, "other": wall * 0.2},
        counters={"steps": 10},
        **({"process_id": host} if host is not None else {}))
    with open(path, "a") as fh:
        fh.write(json.dumps(ev) + "\n")


def test_stitch_attempts_joins_the_ranks_relaunches_as_in_jax(tmp_path):
    chief = str(tmp_path / "events.jsonl")
    peer = str(tmp_path / "events-p1.jsonl")
    _write_goodput(ptel, chief, "r0a", t0=100.0, wall=10.0, host=0)
    _write_goodput(ptel, chief, "r0b", t0=115.0, wall=5.0, host=0)
    _write_goodput(ptel, peer, "r1a", t0=100.5, wall=9.0, host=1)
    _write_goodput(ptel, peer, "r1b", t0=116.0, wall=4.0, host=1)
    w = ptel.TelemetryWriter(str(tmp_path / "supervisor_events.jsonl"))
    w.emit(ptel.KIND_SUPERVISOR_ATTEMPT, attempt=1, rc=137,
           classification="crashed", process_id=1)
    w.close()
    ours = pgood.stitch_attempts([chief, peer])
    assert ours == jgood.stitch_attempts([chief, peer])
    assert set(ours["per_host"]) == {"0", "1"}
    assert ours["restart_gaps"][0]["classification"] == "crashed"
    assert pgood.format_goodput_table(ours) == \
        jgood.format_goodput_table(ours)


# ------------------------------------- both gang supervisors on stub gangs

def _stub_crash(rc=1, text=""):
    return f"import sys\nprint({text!r})\nsys.exit({rc})\n"


def _stub_graceful(hb_path=None, step=3):
    return textwrap.dedent(f"""
        import json, os, signal, sys, time
        signal.signal(signal.SIGTERM, lambda *a: sys.exit(83))
        hb = {hb_path!r}
        while True:
            if hb:
                tmp = hb + "." + str(os.getpid()) + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump({{"t": time.time(), "pid": os.getpid(),
                               "last_completed_step": {step}}}, fh)
                os.replace(tmp, hb)
            time.sleep(0.05)
    """)


def _stub_beat_once_then_wedge(hb_path):
    return textwrap.dedent(f"""
        import json, os, time
        hb = {hb_path!r}
        with open(hb, "w") as fh:
            json.dump({{"t": time.time(), "pid": os.getpid(),
                       "last_completed_step": 1}}, fh)
        time.sleep(60)
    """)


def _hb(ck, w):
    return os.path.join(ck, f"heartbeat-p{w}.json")


# scenario → (programs per attempt from the checkpoint dir, supervisor
# flags, extra command overrides, DTF_FAULTS)
SCENARIOS = {
    "crash_restarts_gang": (
        lambda ck: [[_stub_graceful(_hb(ck, 0)), _stub_crash(rc=1)],
                    [_stub_crash(0), _stub_crash(0)]],
        ["--procs", "2", "--max-attempts", "3", "--chaos-tick", "0"],
        [], None),
    "drop_worker_refits": (
        lambda ck: [[_stub_graceful(_hb(ck, 0)), _stub_graceful(_hb(ck, 1))],
                    [_stub_crash(0)]],
        ["--procs", "2", "--max-attempts", "2", "--chaos-tick", "0.2"],
        ["--set", "mesh.data=2", "--set", "data.global_batch_size=16"],
        "drop_worker:1:1"),
    "stale_heartbeat": (
        lambda ck: [[_stub_graceful(_hb(ck, 0)),
                     _stub_beat_once_then_wedge(_hb(ck, 1))],
                    [_stub_crash(0), _stub_crash(0)]],
        ["--procs", "2", "--max-attempts", "3", "--chaos-tick", "0",
         "--heartbeat-timeout", "0.4", "--heartbeat-poll", "0.05"],
        [], None),
    "rejoin_timeout": (
        lambda ck: [[_stub_graceful(_hb(ck, 0)), "import time; time.sleep(60)"],
                    [_stub_crash(0)]],
        ["--procs", "2", "--max-attempts", "2", "--chaos-tick", "0",
         "--rejoin-timeout", "0.5"],
        [], None),
    "port_race": (
        lambda ck: [[_stub_crash(rc=1,
                                 text="RuntimeError: Address already in use"),
                     _stub_graceful()],
                    [_stub_crash(0), _stub_crash(0)]],
        ["--procs", "2", "--max-attempts", "1", "--chaos-tick", "0"],
        [], None),
    "crash_loop_per_worker": (
        lambda ck: [[_stub_crash(rc=7)]],
        ["--procs", "1", "--max-attempts", "5", "--chaos-tick", "0",
         "--crash-loop-threshold", "2"],
        [], None),
    "cancellation": (
        lambda ck: [[_stub_crash(rc=130)]],
        ["--procs", "1", "--max-attempts", "5", "--chaos-tick", "0"],
        [], None),
}


def _run_supervisor(module, faults_module, tel, tmp_path, monkeypatch,
                    scenario):
    """One supervisor's main() in process on the scenario's stub gangs:
    (rc, gang sizes, the attempts' extras, the mesh_resized extras,
    crash_loop extras, the children's environments)."""
    programs, flags, cmd_extra, spec = SCENARIOS[scenario]
    ck = tmp_path / "ck"
    ck.mkdir()
    by_attempt = programs(str(ck))
    calls = {"procs": [], "envs": []}

    def spawn(train_args, *, procs, devices_per_proc, workdir, port,
              base_env=None):
        idx = min(len(calls["procs"]), len(by_attempt) - 1)
        calls["procs"].append(procs)
        calls["envs"].append(dict(base_env or {}))
        os.makedirs(workdir, exist_ok=True)
        children, logs = [], []
        for i in range(procs):
            log = open(os.path.join(workdir, f"worker-{i}.log"), "w")
            logs.append(log)
            children.append(subprocess.Popen(
                [sys.executable, "-c", by_attempt[idx][i]],
                stdout=log, stderr=subprocess.STDOUT))
        return children, logs

    monkeypatch.setattr(module.llc, "spawn_gang", spawn)
    monkeypatch.setattr(module, "_cancelled", False)
    faults_module.install(spec)
    try:
        rc = module.main([
            "--workdir", str(tmp_path / "logs"), "--devices-per-proc", "1",
            "--retry-sleep", "0.05", "--jitter", "0", "--backoff-max", "0.1",
            *flags, "--", "--set", f"checkpoint.directory={ck}", *cmd_extra])
    finally:
        faults_module.install(None)
    events = str(ck / "supervisor_events.jsonl")

    def extras(kind):
        return [ev.get("extra") or {} for ev in
                tel.read_events(events, kind=kind, strict=False)]

    return {"rc": rc, "procs": calls["procs"], "envs": calls["envs"],
            "attempts": extras(tel.KIND_SUPERVISOR_ATTEMPT),
            "resized": extras(tel.KIND_MESH_RESIZED),
            "loops": extras(tel.KIND_CRASH_LOOP)}


ATTEMPT_KEYS = ("attempt", "rc", "classification", "process_id",
                "process_count", "hung", "reshards")
RESIZE_KEYS = ("attempt", "rc", "reshards", "from_axes", "to_axes",
               "visible_devices", "process_count", "dropped_workers",
               "global_batch", "grad_accum", "effective_batch_preserved",
               "overrides")


@pytest.fixture
def signals():
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_gang_supervisors_classify_alike(scenario, tmp_path, monkeypatch,
                                         signals):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = _run_supervisor(ptc, pfaults, ptel, tmp_path / "port",
                           monkeypatch, scenario)
    theirs = _run_supervisor(jtc, jfaults, jtel, tmp_path / "jax",
                             monkeypatch, scenario)
    assert ours["rc"] == theirs["rc"]
    assert ours["procs"] == theirs["procs"]

    def pick(records, keys):
        return [{k: r.get(k) for k in keys} for r in records]

    assert pick(ours["attempts"], ATTEMPT_KEYS) == \
        pick(theirs["attempts"], ATTEMPT_KEYS)
    assert pick(ours["resized"], RESIZE_KEYS) == \
        pick(theirs["resized"], RESIZE_KEYS)
    assert pick(ours["loops"], ("verdict", "streak", "rc", "process_id")) \
        == pick(theirs["loops"], ("verdict", "streak", "rc", "process_id"))
    expect = {
        "crash_restarts_gang": ["crashed", "done"],
        "drop_worker_refits": ["gang_refit", "done"],
        "stale_heartbeat": ["hung", "done"],
        "rejoin_timeout": ["gang_refit", "done"],
        "port_race": ["port_race", "done"],
        "crash_loop_per_worker": ["crashed", "crashed"],
        "cancellation": ["cancelled"],
    }[scenario]
    assert [a["classification"] for a in ours["attempts"]] == expect
    if scenario == "drop_worker_refits":
        (resize,) = ours["resized"]
        assert resize["process_count"] == 1
        assert resize["dropped_workers"] == [1]
        assert resize["to_axes"]["data"] == 1
        assert resize["effective_batch_preserved"] is True
        assert (resize["global_batch"], resize["grad_accum"]) == (8, 2)
        overrides = ours["envs"][1][psup.ELASTIC_OVERRIDES_ENV]
        assert "checkpoint.allow_reshard=true" in overrides
        assert "train.grad_accum_steps=2" in overrides
    # Every rank of every attempt is handed the attempt's span.
    assert all(env.get("DTF_TRACE_CTX") for env in ours["envs"])
