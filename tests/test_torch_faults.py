"""PyTorch port's fault injection (core/faults.py) and its fault points.

The copy of the JAX registry for the single-process kinds: spec parsing
(the same ``DTF_FAULTS`` grammar, checked against the JAX parser on the
same specs), once-only firing in a process and across relaunches through
``DTF_FAULTS_STATE``, the infeed stall in ``HostDataset``, checkpoint
corruption, and the checkpoint fault points: ``crash_in_save`` leaves an
uncommitted step that restore quarantines, ``corrupt_ckpt`` a torn one it
falls back from. The fleet kinds parse to the JAX package's fields.
``crash_at_step`` is a real SIGKILL, so
it runs in the one subprocess of the port's tests.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from distributed_tensorflow_framework_torch.ckpt import manifest as mf
from distributed_tensorflow_framework_torch.core import faults
from distributed_tensorflow_framework_torch.data.pipeline import HostDataset
from distributed_tensorflow_framework_tpu.core import faults as jax_faults
from tests.test_torch_ckpt import train_run
from tests.test_torch_hygiene import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_plan():
    yield
    faults.install(faults.FaultPlan())


SPECS = ["crash_at_step:120, stall_infeed:30s, corrupt_ckpt:params,"
         "nan_grads:200, crash_in_save:40",
         "loss_spike:40, repeat_nan:30:5, stall_infeed:3s:4",
         "stall_infeed:0", " , ,"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_jax(spec):
    ours = faults.FaultPlan.parse(spec)
    ref = jax_faults.FaultPlan.parse(spec)
    assert [(f.kind, f.arg, f.step, f.seconds, f.count, f.point)
            for f in ours.faults] == [
        (f.kind, f.arg, f.step, f.seconds, f.count, f.point)
        for f in ref.faults]
    assert ours.active == ref.active


def test_parse_errors():
    for spec, msg in [("explode:3", "unknown fault kind"),
                      ("crash_at_step:soon", "integer step"),
                      ("crash_at_step:0", ">= 1"),
                      ("stall_infeed:forever", "duration"),
                      ("repeat_nan:30", "start:count"),
                      ("repeat_nan:30:0", "count >= 1"),
                      ("stall_infeed:3s:soon", "ordinal must be an integer"),
                      ("stall_infeed:3s:0", "ordinal must be >= 1")]:
        with pytest.raises(ValueError, match=msg):
            faults.FaultPlan.parse(spec)


@pytest.mark.parametrize("spec, item", [
    ("stall_replica:0:10s", "A15"), ("tenant_stampede:3:4s", "A15"),
    ("kill_replica:0", "A15"), ("kill_replica:1:3", "A15"),
    ("spike:6:8s", "A15"), ("corrupt_reload", "A15"),
])
def test_unported_kinds_name_their_item(spec, item):
    """The fleet kinds, refused until queue A item ``item`` ported them,
    parse to the JAX package's fields and fire at the router's points."""
    import dataclasses

    ours = faults.FaultPlan.parse(spec).faults
    ref = jax_faults.FaultPlan.parse(spec).faults
    assert [dataclasses.asdict(f) for f in ours] == [
        dataclasses.asdict(f) for f in ref]
    assert [f.point for f in ours] == [f.point for f in ref]
    assert ours[0].point in ("fleet_chaos", "fleet_reload")
    assert item == "A15"


def test_stall_zero_means_forever():
    assert faults.FaultPlan.parse("stall_infeed:0").faults[0].seconds >= 3600


def test_fire_matches_point_and_step():
    plan = faults.FaultPlan.parse("nan_grads:3")
    assert plan.fire("step_begin", step=2) == []
    assert plan.fire("infeed", step=3) == []
    assert [f.kind for f in plan.fire("step_begin", step=3)] == ["nan_grads"]
    assert plan.fire("step_begin", step=3) == []


def test_module_fire_inactive_is_noop():
    faults.install(faults.FaultPlan())
    assert faults.fire("step_begin", step=1) == []


def test_repeat_nan_fires_on_every_step_in_range():
    plan = faults.FaultPlan.parse("repeat_nan:30:3")
    assert plan.fire("step_begin", step=29) == []
    for s in (30, 31, 30):  # a rollback replays step 30: fires again
        assert [f.kind for f in plan.fire("step_begin", step=s)] == [
            "repeat_nan"]
    assert plan.faults[0].fired
    assert plan.fire("step_begin", step=31) == []


def test_state_file_survives_relaunch(tmp_path):
    state = str(tmp_path / "faults_state.json")
    plan = faults.FaultPlan.parse("nan_grads:5", state_path=state)
    assert [f.kind for f in plan.fire("step_begin", step=5)] == ["nan_grads"]
    assert json.loads(open(state).read()) == ["nan_grads:5"]
    again = faults.FaultPlan.parse("nan_grads:5", state_path=state)
    assert again.faults[0].fired
    assert again.fire("step_begin", step=5) == []
    # The JAX package reads the same file the same way.
    assert jax_faults.FaultPlan.parse("nan_grads:5",
                                      state_path=state).faults[0].fired


def _zeros_dataset():
    def make_iter(state):
        while True:
            yield {"x": np.zeros((2,), np.float32)}

    return HostDataset(make_iter, element_spec={"x": ((2,), np.float32)})


def test_infeed_stall_fires_in_host_dataset():
    ds = _zeros_dataset()
    faults.install("stall_infeed:0.2s")
    t0 = time.monotonic()
    next(ds)
    assert time.monotonic() - t0 >= 0.2
    t0 = time.monotonic()
    next(ds)
    assert time.monotonic() - t0 < 0.2


def test_stall_infeed_ordinal_targets_nth_pull():
    ds = _zeros_dataset()
    faults.install("stall_infeed:0.2s:3")
    for _ in range(2):
        t0 = time.monotonic()
        next(ds)
        assert time.monotonic() - t0 < 0.15
    t0 = time.monotonic()
    next(ds)
    assert time.monotonic() - t0 >= 0.2


def test_corrupt_checkpoint_dir_truncates_largest(tmp_path):
    d = tmp_path / "7"
    d.mkdir()
    (d / "small.bin").write_bytes(b"x" * 10)
    (d / "big.bin").write_bytes(b"y" * 1000)
    (d / "manifest.json").write_text("{}")
    assert faults.corrupt_checkpoint_dir(str(d)) == str(d / "big.bin")
    assert (d / "big.bin").stat().st_size == 500
    assert (d / "small.bin").stat().st_size == 10
    assert (d / "manifest.json").read_text() == "{}"
    empty = tmp_path / "9"
    empty.mkdir()
    assert faults.corrupt_checkpoint_dir(str(empty)) is None


def test_crash_in_save_leaves_an_uncommitted_step(tmp_path, monkeypatch):
    """crash_in_save fires between the payload and the manifest. Its
    SIGKILL is replaced here by an exception, so the test process lives:
    step 4's directory stays without a manifest, and the next run
    quarantines it and restores step 2."""
    class Killed(Exception):
        pass

    def kill(pid, sig):
        raise Killed

    monkeypatch.setattr(faults.os, "kill", kill)
    faults.install("crash_in_save:4")
    d = str(tmp_path / "ckpt")
    with pytest.raises(Killed):
        train_run(d, 4, "checkpoint.save_interval_steps=2",
                  "checkpoint.async_save=false")
    assert os.path.isfile(os.path.join(d, "4", "state.pt"))
    assert mf.read_manifest(os.path.join(d, "4")) is None
    assert mf.committed_steps(d) == [2]
    t = train_run(d, 4, build_only=True)
    assert t.host_step == 2
    record = json.loads(open(os.path.join(d, "4.corrupt",
                                          "quarantine.json")).read())
    assert record["reason"] == "uncommitted save"


def test_corrupt_ckpt_tears_the_next_commit(tmp_path):
    faults.install("corrupt_ckpt:params")
    d = str(tmp_path / "ckpt")
    train_run(d, 4, "checkpoint.save_interval_steps=2",
              "checkpoint.async_save=false")
    assert mf.verify_step_dir(os.path.join(d, "2"))  # torn once committed
    assert mf.verify_step_dir(os.path.join(d, "4")) == []  # fired once
    faults.install(faults.FaultPlan())
    os.remove(os.path.join(d, "4", mf.MANIFEST_NAME))
    t = train_run(d, 4, build_only=True)
    assert t.host_step == 0  # 4 uncommitted, 2 torn: nothing to restore
    assert sorted(os.listdir(d)) == ["2.corrupt", "4.corrupt",
                                     "events.jsonl", "heartbeat.json"]


def test_crash_at_step_sigkills_subprocess(tmp_path):
    """A real SIGKILL right before step 2; the state file records the
    firing first, so the relaunch does not fire again."""
    state = str(tmp_path / "state.json")
    prog = ("from distributed_tensorflow_framework_torch.core import faults\n"
            "for step in (1, 2, 3):\n"
            "    faults.fire('step_begin', step=step)\n"
            "print('SURVIVED', flush=True)\n")
    env = dict(os.environ, DTF_FAULTS="crash_at_step:2",
               DTF_FAULTS_STATE=state, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", prog], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == -9, (r.returncode, r.stderr)
    assert "SURVIVED" not in r.stdout
    assert json.loads(open(state).read()) == ["crash_at_step:2"]
    r2 = subprocess.run([sys.executable, "-c", prog], env=env, cwd=ROOT,
                        capture_output=True, text=True, timeout=60)
    assert r2.returncode == 0 and "SURVIVED" in r2.stdout, r2.stderr
