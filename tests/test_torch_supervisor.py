"""The supervisors' decisions and the single-process supervisor, held to
the JAX package's (tests/test_supervisor.py, tests/test_resilient_launcher.py).

``backoff_seconds``, ``fit_axis_sizes``, ``rescale_for_devices``,
``CrashLoopBreaker``, the device report and ``heartbeat_age_s`` equal the
JAX functions over grids of meshes, device counts, batches and seeded
``random.Random`` draws. Then ``scripts/train_resilient.py`` and the
port's ``cli/train_resilient.py`` run (in process) on the same ``python
-c`` stub children — a crash, 83, 84 with and without a device report,
85, a stalled heartbeat, a silent start, a signal death, a crash loop and
cancellation — and must give the same attempts, classifications, refits
and exit codes.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import signal
import sys
import textwrap

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from distributed_tensorflow_framework_torch.cli import train_resilient as ptr
from distributed_tensorflow_framework_torch.core import faults as pfaults
from distributed_tensorflow_framework_torch.core import mesh as pmesh
from distributed_tensorflow_framework_torch.core import supervision as psup
from distributed_tensorflow_framework_torch.core import telemetry as ptel
from distributed_tensorflow_framework_tpu.core import faults as jfaults
from distributed_tensorflow_framework_tpu.core import supervision as jsup
from distributed_tensorflow_framework_tpu.core import telemetry as jtel
from scripts import train_resilient as jtr


def test_axis_order_is_the_meshs_and_jaxs():
    assert psup.MESH_AXIS_ORDER == pmesh.MESH_AXES == jsup.MESH_AXIS_ORDER
    for name in ("GRACEFUL_PREEMPT_RC", "ELASTIC_RESHARD_RC",
                 "ANOMALY_ESCALATION_RC", "DEVICE_REPORT_NAME",
                 "ELASTIC_OVERRIDES_ENV"):
        assert getattr(psup, name) == getattr(jsup, name), name


@pytest.mark.parametrize("base,cap,jitter", itertools.product(
    [0.0, 0.5, 2.0, 5.0], [3.0, 120.0], [0.0, 0.25, 0.5]))
def test_backoff_equals_jax(base, cap, jitter):
    for seed in (0, 7, 12345):
        ours, theirs = random.Random(seed), random.Random(seed)
        for i in range(1, 8):
            assert psup.backoff_seconds(
                i, base=base, cap=cap, jitter=jitter, rng=ours) == \
                jsup.backoff_seconds(i, base=base, cap=cap, jitter=jitter,
                                     rng=theirs)


MESHES = [{"data": 8}, {"data": -1}, {"data": 2, "model": 2},
          {"data": 2, "fsdp": 2, "pipe": 4}, {"fsdp": 4, "data": 2},
          {"data": 1, "seq": 4, "model": 2}, {"data": 4, "expert": 2},
          {"model": 4}, {"data": 0}, {"data": 2, "pipe": 3}]


def _both(fn_ours, fn_theirs, *args):
    try:
        ours = ("ok", fn_ours(*args))
    except ValueError as e:
        ours = ("refused", str(e))
    try:
        theirs = ("ok", fn_theirs(*args))
    except ValueError as e:
        theirs = ("refused", str(e))
    return ours, theirs


@pytest.mark.parametrize("sizes,n", itertools.product(MESHES, range(0, 10)))
def test_fit_axis_sizes_equals_jax(sizes, n):
    ours, theirs = _both(psup.fit_axis_sizes, jsup.fit_axis_sizes,
                         sizes, n)
    assert ours == theirs


@settings(max_examples=200, deadline=None)
@given(sizes=st.dictionaries(st.sampled_from(psup.MESH_AXIS_ORDER),
                             st.integers(-1, 6), max_size=6),
       n=st.integers(1, 24))
def test_fit_axis_sizes_equals_jax_on_drawn_meshes(sizes, n):
    ours, theirs = _both(psup.fit_axis_sizes, jsup.fit_axis_sizes,
                         sizes, n)
    assert ours == theirs


@pytest.mark.parametrize("batch,accum,old,new", itertools.product(
    [7, 12, 16, 64], [1, 2, 3], [0, 1, 2, 4, 8], [1, 2, 3, 4, 8]))
def test_rescale_for_devices_equals_jax(batch, accum, old, new):
    assert psup.rescale_for_devices(batch, accum, old, new) == \
        jsup.rescale_for_devices(batch, accum, old, new)


BREAKER = [dict(rc=1, last_step=10, ckpt_step=5),
           dict(rc=1, last_step=10, ckpt_step=10),
           dict(rc=1, last_step=12, ckpt_step=10),
           dict(rc=1, last_step=12, ckpt_step=10, hung=True),
           dict(rc=1, last_step=12, ckpt_step=10),
           dict(rc=85, last_step=12, ckpt_step=10, transient=True),
           dict(rc=1, last_step=12, ckpt_step=10),
           dict(rc=1, last_step=12, ckpt_step=10),
           dict(rc=1, last_step=12, ckpt_step=10)]


@pytest.mark.parametrize("threshold", [0, 1, 2, 3])
def test_crash_loop_breaker_equals_jax(threshold):
    ours, theirs = (psup.CrashLoopBreaker(threshold),
                    jsup.CrashLoopBreaker(threshold))
    for kw in BREAKER:
        assert ours.record(**kw) == theirs.record(**kw)
    assert ours.history == theirs.history
    assert ours.report() == theirs.report()


def test_device_report_round_trips_across_packages(tmp_path):
    mine = tmp_path / "port"
    psup.write_device_report(str(mine), visible_devices=1, needed=2,
                             mesh={"data": 2, "model": 1})
    theirs = jsup.read_device_report(str(mine))
    assert {k: theirs[k] for k in ("visible_devices", "needed", "mesh",
                                   "pid")} == {
        "visible_devices": 1, "needed": 2, "mesh": {"data": 2, "model": 1},
        "pid": os.getpid()}
    jsup.write_device_report(str(tmp_path / "jax"), visible_devices=4,
                             needed=8, mesh={"data": 8})
    assert psup.read_device_report(str(tmp_path / "jax")) == \
        jsup.read_device_report(str(tmp_path / "jax"))
    assert psup.read_device_report(str(tmp_path / "none")) is None
    (tmp_path / "torn").mkdir()
    (tmp_path / "torn" / psup.DEVICE_REPORT_NAME).write_text("{")
    assert psup.read_device_report(str(tmp_path / "torn")) is None


def test_heartbeat_age_equals_jax(tmp_path):
    hb = tmp_path / "heartbeat.json"
    assert psup.heartbeat_age_s(str(hb)) is None
    for record in ({"t": 100.0, "pid": 42}, {"t": 100.0}, {"pid": 42},
                   {"t": "x", "pid": 7}, [1, 2]):
        hb.write_text(json.dumps(record))
        for pid, now in itertools.product((None, 42, 43), (90.0, 130.5)):
            assert psup.heartbeat_age_s(str(hb), pid=pid, now=now) == \
                jsup.heartbeat_age_s(str(hb), pid=pid, now=now)
        assert psup.read_heartbeat(str(hb)) == jsup.read_heartbeat(str(hb))


@pytest.mark.parametrize("cmd", [
    ["python", "-c", "x", "--set", "checkpoint.directory=/tmp/ck"],
    ["python", "-c", "x", "--set", "checkpoint.directory="],
    ["python", "-c", "x", "--config", "configs/bert_base_mlm.yaml"],
    ["python", "-c", "x", "--config", "configs/missing.yaml"],
    ["python", "-c", "x", "--set", "mesh.data=4", "--set", "mesh.model=2",
     "--set", "data.global_batch_size=32", "--set",
     "train.grad_accum_steps=3"],
    ["python", "-c", "x", "--config=configs/bert_long_ring.yaml",
     "--set", "mesh.seq=2"]])
def test_command_parsing_equals_jax(cmd):
    assert ptr.find_checkpoint_dir(cmd) == jtr.find_checkpoint_dir(cmd)
    assert ptr.parse_training_params(cmd) == jtr.parse_training_params(cmd)


# ------------------------------------ both supervisors on stub children

def _once(marker: str, first: str, then: str = "sys.exit(0)") -> str:
    """A child that runs ``first`` on its first launch, ``then`` after."""
    return textwrap.dedent(f"""
        import json, os, signal, sys, time
        marker = {marker!r}
        if not os.path.exists(marker):
            open(marker, "w").close()
            {first}
        {then}
    """)


def _children(tmp: str, ck: str) -> dict:
    """scenario → (child program, supervisor flags, extra child args)."""
    m = os.path.join(tmp, "marker")
    hb = os.path.join(ck, "heartbeat.json")
    report = json.dumps({"visible_devices": 1, "needed": 2,
                         "mesh": {"data": 2}, "t": 0.0, "pid": 1})
    return {
        "crash_then_done": (_once(m, "sys.exit(1)"),
                            ["--max-attempts", "3"], []),
        "preempted": (_once(m, "sys.exit(83)"), ["--max-attempts", "1"], []),
        "elastic_with_report": (
            _once(m, f"open({os.path.join(ck, 'devices.json')!r}, 'w')"
                     f".write({report!r}); sys.exit(84)",
                  f"open({os.path.join(tmp, 'env')!r}, 'w').write("
                  f"os.environ.get('DTF_ELASTIC_OVERRIDES', ''))"),
            ["--max-attempts", "1"],
            ["--set", "mesh.data=2", "--set", "data.global_batch_size=16"]),
        "elastic_without_report": (_once(m, "sys.exit(84)"),
                                   ["--max-attempts", "3"], []),
        "persistent_anomaly": (_once(m, "sys.exit(85)"),
                               ["--max-attempts", "3"], []),
        "stalled_heartbeat": (
            _once(m, f"json.dump({{'t': time.time(), 'pid': os.getpid(), "
                     f"'last_completed_step': 1}}, open({hb!r}, 'w')); "
                     f"time.sleep(60)"),
            ["--max-attempts", "3", "--heartbeat-timeout", "0.5",
             "--heartbeat-poll", "0.1"], []),
        "silent_start": (_once(m, "time.sleep(60)"),
                         ["--max-attempts", "3", "--heartbeat-timeout", "5",
                          "--startup-grace", "0.5", "--heartbeat-poll",
                          "0.1"], []),
        "signal_death": ("import os, signal\n"
                         "os.kill(os.getpid(), signal.SIGABRT)\n",
                         ["--max-attempts", "1"], []),
        "crash_loop": ("import sys\nsys.exit(7)\n",
                       ["--max-attempts", "5", "--crash-loop-threshold", "2"],
                       []),
        "cancelled": ("import os, signal\n"
                      "os.kill(os.getpid(), signal.SIGTERM)\n",
                      ["--max-attempts", "5"], []),
    }


EXPECT = {
    "crash_then_done": (0, ["crashed", "done"]),
    "preempted": (0, ["preempted", "done"]),
    "elastic_with_report": (0, ["elastic_reshard", "done"]),
    "elastic_without_report": (0, ["elastic_no_report", "done"]),
    "persistent_anomaly": (0, ["persistent_anomaly", "done"]),
    "stalled_heartbeat": (0, ["hung", "done"]),
    "silent_start": (0, ["hung", "done"]),
    "signal_death": (134, ["crashed"]),
    "crash_loop": (7, ["crashed", "crashed"]),
    "cancelled": (143, ["cancelled"]),
}
ATTEMPT_KEYS = ("attempt", "rc", "classification", "hung", "preemptions",
                "reshards")
RESIZE_KEYS = ("attempt", "rc", "reshards", "from_axes", "to_axes",
               "visible_devices", "global_batch", "grad_accum",
               "effective_batch_preserved", "overrides")


def _supervise(module, faults_module, tel, tmp, scenario, monkeypatch):
    os.makedirs(tmp)
    ck = os.path.join(tmp, "ck")
    os.makedirs(ck)
    program, flags, extra = _children(tmp, ck)[scenario]
    monkeypatch.setattr(module, "_cancelled", False)
    faults_module.install(None)
    rc = module.main([
        "--retry-sleep", "0.05", "--jitter", "0", "--backoff-max", "0.1",
        *flags, "--", sys.executable, "-c", program,
        "--set", f"checkpoint.directory={ck}", *extra])
    events = os.path.join(ck, "supervisor_events.jsonl")

    def extras(kind, keys):
        return [{k: (ev.get("extra") or {}).get(k) for k in keys}
                for ev in tel.read_events(events, kind=kind, strict=False)]

    env_path = os.path.join(tmp, "env")
    return {"rc": rc,
            "attempts": extras(tel.KIND_SUPERVISOR_ATTEMPT, ATTEMPT_KEYS),
            "resized": extras(tel.KIND_MESH_RESIZED, RESIZE_KEYS),
            "loops": extras(tel.KIND_CRASH_LOOP, ("verdict", "streak", "rc")),
            "env": (open(env_path).read() if os.path.exists(env_path)
                    else None)}


@pytest.fixture
def signals():
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


@pytest.mark.parametrize("scenario", list(EXPECT))
def test_resilient_supervisors_classify_alike(scenario, tmp_path,
                                              monkeypatch, signals):
    ours = _supervise(ptr, pfaults, ptel, str(tmp_path / "port"), scenario,
                      monkeypatch)
    theirs = _supervise(jtr, jfaults, jtel, str(tmp_path / "jax"), scenario,
                        monkeypatch)
    assert ours == theirs
    rc, classes = EXPECT[scenario]
    assert ours["rc"] == rc
    assert [a["classification"] for a in ours["attempts"]] == classes
    if scenario == "elastic_with_report":
        (resize,) = ours["resized"]
        assert resize["to_axes"]["data"] == 1
        assert (resize["global_batch"], resize["grad_accum"]) == (8, 2)
        assert ours["env"] == (
            "mesh.data=1,mesh.fsdp=1,mesh.expert=1,mesh.pipe=1,mesh.seq=1,"
            "mesh.model=1,checkpoint.allow_reshard=true,"
            "data.global_batch_size=8,train.grad_accum_steps=2")
    if scenario == "crash_loop":
        assert ours["loops"][0]["verdict"] == "deterministic_crash_loop"


def test_drop_devices_starts_the_child_as_a_gang(tmp_path, monkeypatch,
                                                 signals):
    """drop_devices:2 (a port device is a rank): the child runs as a gang
    of two ranks; a mesh of one then exits 84 with a report of the two,
    and the refit (data 2) runs on the two ranks."""
    ck = tmp_path / "ck"
    ck.mkdir()
    seen = tmp_path / "seen"
    program = textwrap.dedent(f"""
        import json, os, sys
        world = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        rank = int(os.environ.get("JAX_PROCESS_ID", "0"))
        refit = os.environ.get("DTF_ELASTIC_OVERRIDES", "")
        with open({str(seen)!r}, "a") as fh:
            fh.write(f"{{world}} {{rank}} {{refit}}\\n")
        if "mesh.data=2" not in refit and world != 1:
            if rank == 0:
                json.dump({{"visible_devices": world, "needed": 1,
                           "mesh": {{"data": 1}}}},
                          open({str(ck / "devices.json")!r}, "w"))
            sys.exit(84)
    """)
    monkeypatch.setattr(ptr, "_cancelled", False)
    pfaults.install("drop_devices:2")
    try:
        rc = ptr.main(["--max-attempts", "1", "--retry-sleep", "0", "--",
                       sys.executable, "-c", program,
                       "--set", f"checkpoint.directory={ck}",
                       "--set", "mesh.data=1"])
    finally:
        pfaults.install(None)
    assert rc == 0
    lines = sorted(seen.read_text().splitlines())
    assert [line.split()[:2] for line in lines] == [
        ["2", "0"], ["2", "0"], ["2", "1"], ["2", "1"]]
    events = str(ck / "supervisor_events.jsonl")
    assert [(ev["extra"] or {})["classification"] for ev in ptel.read_events(
        events, kind=ptel.KIND_SUPERVISOR_ATTEMPT)] == [
        "elastic_reshard", "done"]
