"""The port's trainer with observability wired in (A16), on the CPU, held
to the JAX package's readers.

A 2-layer BERT trains 6 steps through the Trainer with a profile window
over steps (1, 3], ``train.memory_analysis`` and a checkpoint directory.
Then: the window wrote a Kineto trace that the port's analyzer covers
(coverage 1 ± 1e-6) with optimizer time in it; the first step's analysis
is a ``memory`` event whose ``argument_bytes`` equals the state's and
the batch's bytes exactly; the final ``goodput`` event's buckets sum to
its ``wall_s`` within 1%; the spans form ``worker.run`` →
``train.startup``/``train.steps``/``ckpt.save`` under one trace; every
event passes the JAX ``validate_event``, and the JAX ``summarize_events``
and ``stitch_attempts`` read the run's ``events.jsonl`` as the port's
own readers do. ``train.compilation_cache_dir`` is logged and the run
goes on; a rollback gives a ``train.rollback`` span and the ledger's
rollback bucket; a persistent anomaly and a graceful preemption dump the
flight recorder beside the run's events.
"""

import json
import logging
import os

import numpy as np
import pytest

from distributed_tensorflow_framework_torch.cli import train as port_cli
from distributed_tensorflow_framework_torch.core import faults, supervision
from distributed_tensorflow_framework_torch.core import goodput as pg
from distributed_tensorflow_framework_torch.core import telemetry as pt
from distributed_tensorflow_framework_torch.core import trace_analysis as pa
from distributed_tensorflow_framework_torch.core.config import load_config
from distributed_tensorflow_framework_torch.data import get_dataset
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_tpu.core import goodput as jg
from distributed_tensorflow_framework_tpu.core import telemetry as jt
from scripts import analyze_trace
from tests.test_torch_ckpt import TINY
from tests.test_torch_hygiene import torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    faults.install(faults.FaultPlan())
    supervision.reset_preemption()


def _config(ckpt_dir, *over):
    return load_config(overrides=TINY + [
        f"checkpoint.directory={ckpt_dir}", "checkpoint.async_save=false",
        *over])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("observed")
    cfg = _config(root / "ckpt", "train.total_steps=6",
                  "train.log_interval=2", "train.profile_start=1",
                  "train.profile_stop=3", "train.memory_analysis=true",
                  "train.goodput_interval_s=0", "train.memory_interval_s=0",
                  "checkpoint.save_interval_steps=4")
    trainer = Trainer(cfg, device="cpu", log_dir=str(root / "logs"))
    trainer.train()
    trainer.writer.close()
    path = str(root / "logs" / "events.jsonl")
    with open(path) as fh:
        events = [json.loads(line) for line in fh]
    return {"trainer": trainer, "cfg": cfg, "events": events, "path": path,
            "root": root}


def _kind(events, kind):
    return [e for e in events if e["kind"] == kind]


def test_profile_window_writes_an_analyzable_trace(run):
    [path] = pa.find_trace_files(str(run["root"] / "ckpt" / "traces"))
    report = pa.analyze_trace_file(path)
    assert report["coverage"] == pytest.approx(1.0, abs=1e-6)
    b = report["breakdown"]
    assert b["optimizer_update"]["summed_event_ps"] > 0
    assert b["gemm_conv"]["summed_event_ps"] > 0
    events = pa.parse_kineto(pa.load_kineto(path))
    # Two steps in the window: two dispatches, two optimizer updates.
    for name in ("train_step", "optimizer_update"):
        assert sum(e.scope.endswith(name) and e.name.startswith("aten::")
                   for e in events) > 0
    doc = pa.load_kineto(path)
    ranges = [e["name"] for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"]
    assert ranges.count("train_step") == 2
    assert ranges.count("optimizer_update") == 2


def test_first_step_memory_analysis_counts_the_state(run):
    [ev] = [e for e in _kind(run["events"], "memory")
            if e["extra"]["source_kind"] == "memory_analysis"]
    analysis = ev["extra"]["analysis"]
    assert set(analysis) == {"argument_bytes", "peak_bytes_est"}
    state = run["trainer"].state
    seen, want = set(), 0
    tensors = list(state.model.state_dict().values()) + [
        t for slots in state.optimizer.inner.state.values()
        for t in slots.values()]
    for t in tensors:
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            want += t.numel() * t.element_size()
    batch = next(get_dataset(run["cfg"].data))
    want += sum(np.asarray(v).nbytes for v in batch.values())
    assert analysis["argument_bytes"] == want > 0
    assert analysis["peak_bytes_est"] == want
    assert ev["metrics"] == {"peak_bytes_est": want}
    assert run["trainer"].memory_analysis == analysis
    samples = [e for e in _kind(run["events"], "memory")
               if e["extra"]["source_kind"] == "host_rss"]
    assert samples and samples[-1]["extra"]["final"] is True


def test_final_goodput_buckets_sum_to_wall(run):
    goodput = _kind(run["events"], "goodput")
    assert len(goodput) >= 2  # periodic (interval 0) and the final one
    final = goodput[-1]
    assert final["extra"]["final"] is True and final["step"] == 6
    wall = final["metrics"]["wall_s"]
    buckets = final["extra"]["buckets"]
    assert sum(buckets.values()) == pytest.approx(wall, rel=0.01)
    assert {"startup", "recompile", "step_compute", "infeed_wait",
            "metrics_fetch", "ckpt_blocked", "other"} <= set(buckets)
    assert final["extra"]["counters"] == {"recompiles": 1, "ckpt_saves": 2}
    got = pg.stitch_attempts(run["path"])
    assert got == jg.stitch_attempts(run["path"])
    assert pg.format_goodput_table(got) == jg.format_goodput_table(got)


def test_span_tree_of_the_run(run):
    traces = analyze_trace.build_traces(
        analyze_trace.collect_spans([run["path"]]))
    assert len(traces) == 1
    [root] = traces[0]["roots"]
    assert (root["name"], root["service"], root["status"]) == (
        "worker.run", "worker0", "ok")
    kids = [s["name"] for s in traces[0]["children"][root["span"]]]
    assert kids[0] == "train.startup"
    assert kids.count("train.steps") == 3
    assert kids.count("ckpt.save") == 2
    assert set(kids) == {"train.startup", "train.steps", "ckpt.save"}
    windows = [s["attrs"] for s in traces[0]["spans"]
               if s["name"] == "train.steps"]
    assert [(w["start_step"], w["end_step"]) for w in windows] == [
        (1, 2), (2, 4), (4, 6)]


def test_every_event_reads_in_the_jax_package(run):
    for ev in run["events"]:
        assert jt.validate_event(ev) == [], ev
    kinds = {e["kind"] for e in run["events"]}
    assert {"run_meta", "data_shard", "startup", "train_step", "span",
            "goodput", "memory", "ckpt_save"} <= kinds
    got, want = pt.summarize_events(run["path"]), jt.summarize_events(
        run["path"])
    assert got == want
    assert pt.format_run_summary(got) == jt.format_run_summary(want)


def test_compilation_cache_dir_is_logged_and_the_run_goes_on(
        tmp_path, caplog):
    over = TINY + ["checkpoint.directory=", "train.total_steps=2",
                   "resilience.rollback=false",
                   f"train.compilation_cache_dir={tmp_path / 'xla'}"]
    with caplog.at_level(logging.WARNING):
        rc = port_cli.main(["--device", "cpu", "--log-dir", str(tmp_path),
                            *sum((["--set", o] for o in over), [])])
    assert rc == 0
    assert "no compilation cache" in caplog.text
    with open(tmp_path / "events.jsonl") as fh:
        [startup] = [e for e in map(json.loads, fh)
                     if e["kind"] == "startup"]
    assert startup["extra"]["compilation_cache_dir"] == str(tmp_path / "xla")
    assert not (tmp_path / "xla").exists()


def test_rollback_is_a_span_and_a_goodput_bucket(tmp_path):
    faults.install("nan_grads:5")
    cfg = _config(tmp_path / "ckpt", "train.total_steps=8",
                  "train.log_interval=2",
                  "resilience.snapshot_interval_steps=2")
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    trainer.writer.close()
    path = str(tmp_path / "ckpt" / "events.jsonl")
    with open(path) as fh:
        events = [json.loads(line) for line in fh]
    [rb] = [e for e in _kind(events, "span")
            if e["extra"]["name"] == "train.rollback"]
    assert rb["extra"]["attrs"] == {"from_step": 6, "to_step": 4}
    final = _kind(events, "goodput")[-1]
    assert final["extra"]["buckets"]["rollback"] > 0
    assert final["extra"]["counters"]["rollbacks"] == 1


def test_persistent_anomaly_dumps_the_flight_recorder(tmp_path):
    faults.install("repeat_nan:3:8")
    d = tmp_path / "ckpt"
    over = TINY + [f"checkpoint.directory={d}", "train.total_steps=8",
                   "train.log_interval=2",
                   "resilience.snapshot_interval_steps=2",
                   "resilience.max_rollbacks=2", "train.nan_guard=false",
                   "checkpoint.async_save=false"]
    rc = port_cli.main(["--device", "cpu",
                        *sum((["--set", o] for o in over), [])])
    assert rc == supervision.ANOMALY_ESCALATION_RC
    with open(d / f"flightrec-{os.getpid()}.json") as fh:
        doc = json.load(fh)
    assert doc["schema"] == "dtf-flightrec/1"
    assert doc["reason"] == "persistent_anomaly"
    names = [e["extra"]["name"] for e in doc["events"]
             if e["kind"] == "span"]
    assert names.count("train.rollback") == 2
    assert [s["name"] for s in doc["open_spans"]] == ["worker.run"]


def test_graceful_preemption_dumps_the_flight_recorder(tmp_path,
                                                        monkeypatch):
    cfg = _config(tmp_path / "ckpt", "train.total_steps=6")
    trainer = Trainer(cfg, device="cpu")
    calls = []
    monkeypatch.setattr(supervision, "preemption_requested",
                        lambda: calls.append(1) or len(calls) > 2)
    trainer.train()
    trainer.writer.close()
    assert trainer.preempted and trainer.host_step == 2
    with open(tmp_path / "ckpt" / f"flightrec-{os.getpid()}.json") as fh:
        doc = json.load(fh)
    assert doc["reason"] == "graceful_preemption"
    with open(tmp_path / "ckpt" / "events.jsonl") as fh:
        events = [json.loads(line) for line in fh]
    [run_span] = [e for e in _kind(events, "span")
                  if e["extra"]["name"] == "worker.run"]
    assert run_span["extra"]["status"] == "preempted"
