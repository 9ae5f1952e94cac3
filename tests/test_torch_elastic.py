"""The elastic and gang drills for real, on the CPU: two gloo ranks of the
port's trainer (tiny BERT, 2 layers) under the port's supervisors
(tests/test_elastic_drill.py and tests/test_cluster_drill.py are the JAX
package's, in its slow split).

* ``kill_worker:1:2`` under ``cli/train_cluster.py``: rank 1 is SIGKILLed
  mid-run, the gang is stopped and relaunched, and the final step's loss
  and every parameter equal an uninterrupted control gang's bit for bit.
* ``drop_worker:1:2`` with ``--max-attempts 1``: the survivor is refit to
  one rank with the effective batch kept, restores the two-rank
  checkpoint resharded (``ckpt_resharded``) and finishes.
* The single-process rc-84 ladder under ``cli/train_resilient.py``: a
  ``{data: 2}`` command in one process exits 84 with its device report,
  is refit to ``{data: 1}`` and restores the gang's checkpoint.

The data drills (``corrupt_shard``, ``skew_shard``) are
tests/test_torch_elastic_data.py.

So that the kill and the drop land after a checkpoint on a loaded host
as on an idle one, both drills also carry ``stall_infeed:15s:5``: every
rank of the first gang stops at its fifth pull (its step-4 checkpoint
committed: the saves are synchronous), and ``DTF_FAULTS_STATE`` keeps the
relaunched processes from stalling again. The chaos tick falls inside the
stall.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from distributed_tensorflow_framework_torch.core import telemetry as ptel
from tests.test_torch_hygiene import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10
TINY = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=2", "model.num_heads=2", "model.mlp_dim=128",
    "model.max_seq_len=32", "model.dtype=float32",
    "model.attention_impl=pallas", "model.dropout_rate=0.1",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=32",
    "data.global_batch_size=8", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=2",
    "optimizer.schedule=linear", "train.log_interval=1",
    "train.eval_steps=0", "resilience.rollback=false",
    "checkpoint.save_interval_steps=2", "checkpoint.async_save=false",
    "mesh.data=2",
]


def _args(ckpt: str, *over: str) -> list[str]:
    return ["--device", "cpu", *sum((["--set", o] for o in (
        *TINY, f"train.total_steps={STEPS}", *over,
        f"checkpoint.directory={ckpt}")), [])]


# The drills' faults: the first gang stalls at its fifth pull, and the
# chaos tick (2 × 3 s after every rank has heartbeated) falls in the stall.
STALL = "stall_infeed:15s:5"
DRILL_TICK = ("--chaos-tick", "3")


def _env(spec: str | None, state: str | None = None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("DTF_FAULTS", "DTF_FAULTS_STATE")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    if spec:
        env["DTF_FAULTS"] = spec
    if state:
        env["DTF_FAULTS_STATE"] = state
    return env


def _cluster(workdir, ckpt, *flags, faults=None, over=()):
    state = os.path.join(str(workdir) + "-faults.json")
    return subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_framework_torch.cli.train_cluster",
         "--procs", "2", "--workdir", str(workdir), "--retry-sleep", "0.2",
         "--jitter", "0", *flags, "--", *_args(str(ckpt), *over)],
        capture_output=True, text=True, timeout=300,
        env=_env(faults, state), cwd=ROOT)


def _events(path, kind=None) -> list[dict]:
    if not os.path.exists(path):
        return []
    return list(ptel.read_events(str(path), kind=kind, strict=False))


def _classes(ckpt) -> list[dict]:
    return [ev["extra"] for ev in _events(
        os.path.join(ckpt, "supervisor_events.jsonl"),
        ptel.KIND_SUPERVISOR_ATTEMPT)]


def _losses(ckpt) -> dict[int, float]:
    return {ev["step"]: ev["metrics"]["loss"] for ev in _events(
        os.path.join(ckpt, "events.jsonl"), "train_step")}


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    """An uninterrupted two-rank gang."""
    root = tmp_path_factory.mktemp("elastic")
    ckpt = root / "ctrl"
    r = _cluster(root / "w-ctrl", ckpt, "--max-attempts", "1",
                 "--chaos-tick", "0")
    assert r.returncode == 0, r.stderr[-4000:]
    return {"root": root, "ckpt": str(ckpt)}


def test_kill_worker_resumes_bit_equal_to_the_control(control):
    root = control["root"]
    ckpt = root / "kill"
    r = _cluster(root / "w-kill", ckpt, "--max-attempts", "3", *DRILL_TICK,
                 faults=f"kill_worker:1:2,{STALL}")
    assert r.returncode == 0, r.stderr[-4000:]
    assert "chaos SIGKILL worker 1" in r.stderr
    attempts = _classes(ckpt)
    assert [a["classification"] for a in attempts] == ["crashed", "done"]
    assert (attempts[0]["process_id"], attempts[0]["rc"]) == (1, 137)
    assert _losses(ckpt)[STEPS] == _losses(control["ckpt"])[STEPS]
    got = torch.load(os.path.join(ckpt, str(STEPS), "state.pt"),
                     weights_only=True)
    want = torch.load(os.path.join(control["ckpt"], str(STEPS), "state.pt"),
                      weights_only=True)
    for key, t in want["model"].items():
        assert torch.equal(got["model"][key], t), key
    # The relaunched gang resumed from the first one's step-4 checkpoint.
    starts = [ev["extra"]["restored_step"] for ev in _events(
        os.path.join(ckpt, "events.jsonl"), "startup")]
    assert starts == [None, 4]
    # Both attempts' spans hang off the supervisor's one trace.
    spans = [ev["extra"] for ev in _events(
        os.path.join(ckpt, "supervisor_events.jsonl"), ptel.KIND_SPAN)]
    names = [s["name"] for s in spans]
    assert names.count("supervisor.attempt") == 2
    assert "supervisor.restart_gap" in names


def test_drop_worker_refits_to_one_rank_keeping_the_batch(control):
    root = control["root"]
    ckpt = root / "drop"
    r = _cluster(root / "w-drop", ckpt, "--max-attempts", "1", *DRILL_TICK,
                 faults=f"drop_worker:1:2,{STALL}")
    assert r.returncode == 0, r.stderr[-4000:]
    assert "gang refit #1" in r.stderr
    assert [a["classification"] for a in _classes(ckpt)] == [
        "gang_refit", "done"]
    (resize,) = [ev["extra"] for ev in _events(
        os.path.join(ckpt, "supervisor_events.jsonl"),
        ptel.KIND_MESH_RESIZED)]
    assert resize["process_count"] == 1
    assert resize["dropped_workers"] == [1]
    assert resize["to_axes"]["data"] == 1
    assert resize["effective_batch_preserved"] is True
    assert (resize["global_batch"], resize["grad_accum"]) == (4, 2)
    (resharded,) = _events(os.path.join(ckpt, "events.jsonl"),
                           ptel.KIND_CKPT_RESHARDED)
    assert resharded["step"] == 4
    assert resharded["extra"]["from_axes"]["data"] == 2
    assert resharded["extra"]["to_axes"]["data"] == 1
    assert os.path.isdir(os.path.join(ckpt, str(STEPS)))


def test_single_process_rc84_ladder_refits_and_reshards(control, tmp_path):
    ckpt = tmp_path / "ck"
    shutil.copytree(control["ckpt"], ckpt, ignore=shutil.ignore_patterns(
        "events*", "heartbeat*", "supervisor*", "flightrec*"))
    r = subprocess.run(
        [sys.executable, "-m",
         "distributed_tensorflow_framework_torch.cli.train_resilient",
         "--max-attempts", "1", "--", sys.executable, "-m",
         "distributed_tensorflow_framework_torch.cli.train",
         *_args(str(ckpt), f"train.total_steps={STEPS + 2}")],
        capture_output=True, text=True, timeout=300, env=_env(None),
        cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    assert [a["classification"] for a in _classes(ckpt)] == [
        "elastic_reshard", "done"]
    report = json.loads((ckpt / "devices.json").read_text())
    assert (report["visible_devices"], report["needed"]) == (1, 2)
    (resize,) = [ev["extra"] for ev in _events(
        ckpt / "supervisor_events.jsonl", ptel.KIND_MESH_RESIZED)]
    assert resize["to_axes"]["data"] == 1
    assert (resize["global_batch"], resize["grad_accum"]) == (4, 2)
    (resharded,) = _events(ckpt / "events.jsonl", ptel.KIND_CKPT_RESHARDED)
    assert resharded["step"] == STEPS
    assert resharded["extra"]["from_axes"]["data"] == 2
    assert resharded["extra"]["to_axes"]["data"] == 1
    assert os.path.isdir(ckpt / str(STEPS + 2))
