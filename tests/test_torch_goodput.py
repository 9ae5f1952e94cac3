"""The port's goodput ledger (core/goodput.py) and telemetry readers
(core/telemetry.py) against the JAX package's.

Mirrors tests/test_goodput.py and the ``summarize_events`` cases of
tests/test_telemetry.py: the same sequence of ``add``, ``count``,
``timed``, ``absorb_phases`` and ``ckpt_save`` (plus the other joined
kinds) under an injected clock gives equal snapshots and equal final
events in both ledgers; ``stitch_attempts`` and ``format_goodput_table``
give equal results on one events file; and a port writer's stream of
every kind validates in the JAX schema, and the JAX ``summarize_events``
and ``format_run_summary`` read it exactly as the port's do. Every
comparison is exact: both ledgers do the same float operations on the
same injected readings.
"""

import time

import pytest

from distributed_tensorflow_framework_torch.core import goodput as pg
from distributed_tensorflow_framework_torch.core import telemetry as pt
from distributed_tensorflow_framework_tpu.core import goodput as jg
from distributed_tensorflow_framework_tpu.core import telemetry as jt
from tests.test_torch_hygiene import torch_threads  # noqa: F401


class FakeClock:
    """``time.perf_counter`` and ``time.time`` driven by the test."""

    def __init__(self, monkeypatch):
        self.now = 1000.0
        monkeypatch.setattr(time, "perf_counter", lambda: self.now)
        monkeypatch.setattr(time, "time", lambda: 1.7e9 + self.now)

    def advance(self, s: float) -> None:
        self.now += s


def _drive(gmod, tmod, clock, path):
    """One fixed sequence of ledger calls and joined events."""
    writer = tmod.TelemetryWriter(path, run_id="led")
    led = gmod.GoodputLedger(writer, interval_s=5.0, t0_perf=clock.now - 2.5,
                             process_id=1)
    led.add("startup", 2.5)
    led.add("startup", -1.0)  # ignored
    clock.advance(0.75)
    led.absorb_phases({"compile": 0.5, "dispatch": 0.125,
                       "backpressure": 0.0625, "infeed": 0.03125,
                       "metrics_fetch": 0.015625, "new_phase": 0.01})
    led.count("recompiles")
    with led.timed("rollback"):
        clock.advance(0.25)
    led.count("batches_skipped", 3)
    writer.emit(tmod.KIND_CKPT_SAVE, step=4,
                metrics={"ckpt_save_blocked_ms": 125.0,
                         "ckpt_save_total_ms": 900.0}, async_save=True)
    writer.emit(tmod.KIND_INFEED_STALL, step=4, health={"attempt": 1})
    writer.emit(tmod.KIND_ROLLBACK, step=4,
                health={"from_step": 4, "to_step": 2})
    writer.emit(tmod.KIND_BATCH_SKIPPED, step=4, health={"batches": 2})
    writer.emit(tmod.KIND_SERVE_RECOMPILE, bucket="seq64xrows1",
                metrics={"compile_ms": 40.0})
    writer.emit(tmod.KIND_DATA_STATE, step=2,
                plan={"action": "repartition"})
    snaps = [led.snapshot()]
    periodic = [led.maybe_emit(step=4)]  # interval not elapsed: None
    clock.advance(6.0)
    periodic.append(led.maybe_emit(step=5))
    clock.advance(1.0)
    final = led.finalize(step=6)
    snaps.append(led.snapshot())
    writer.close()
    return snaps, periodic, final


def _strip(ev):
    return None if ev is None else {k: v for k, v in ev.items()
                                    if k not in ("run_id", "schema")}


def test_ledgers_equal_under_an_injected_clock(tmp_path, monkeypatch):
    clock = FakeClock(monkeypatch)
    got = _drive(pg, pt, clock, str(tmp_path / "port.jsonl"))
    clock.now = 1000.0
    want = _drive(jg, jt, clock, str(tmp_path / "jax.jsonl"))
    assert got[0] == want[0]
    assert [_strip(e) for e in got[1]] == [_strip(e) for e in want[1]]
    assert _strip(got[2]) == _strip(want[2])
    final = got[0][-1]
    assert sum(final["buckets"].values()) == pytest.approx(
        final["wall_s"], abs=1e-3)
    assert final["counters"] == {
        "recompiles": 2, "batches_skipped": 5, "ckpt_saves": 1,
        "infeed_stalls": 1, "rollbacks": 1, "data_restores": 1,
        "data_repartitions": 1}
    for ev in jt.read_events(str(tmp_path / "port.jsonl"),
                             kind=jt.KIND_GOODPUT):
        assert ev["extra"]["process_id"] == 1
    assert pg.PHASE_BUCKETS == jg.PHASE_BUCKETS
    assert pg.BUCKET_ORDER == jg.BUCKET_ORDER


def _emit_attempt(tmod, path, run_id, *, t0, wall_s, buckets, process_id=None,
                  counters=None, final=True):
    w = tmod.TelemetryWriter(path, run_id=run_id)
    extra = {} if process_id is None else {"process_id": process_id}
    w.emit(tmod.KIND_GOODPUT,
           metrics={"wall_s": wall_s,
                    "goodput_frac": buckets.get("step_compute", 0) / wall_s},
           buckets=buckets, counters=counters or {}, t0=t0, final=final,
           **extra)
    w.close()


def test_stitch_attempts_and_table_equal_jax(tmp_path):
    ev = str(tmp_path / "events.jsonl")
    ev1 = str(tmp_path / "events-p1.jsonl")
    _emit_attempt(pt, ev, "a", t0=1000.0, wall_s=10.0,
                  buckets={"step_compute": 8.0, "startup": 1.0,
                           "other": 1.0}, counters={"ckpt_saves": 2})
    _emit_attempt(pt, ev, "b", t0=1012.0, wall_s=5.0, final=False,
                  buckets={"step_compute": 4.0, "other": 1.0})
    _emit_attempt(pt, ev, "b", t0=1012.0, wall_s=6.0,
                  buckets={"step_compute": 4.5, "other": 1.5})
    _emit_attempt(pt, ev1, "c", t0=1000.5, wall_s=9.0, process_id=1,
                  buckets={"step_compute": 7.0, "other": 2.0})
    sup = pt.TelemetryWriter(str(tmp_path / "supervisor_events.jsonl"))
    sup.emit(pt.KIND_SUPERVISOR_ATTEMPT, attempt=1, rc=137,
             classification="crashed")
    sup.close()
    for paths in (ev, [ev, ev1]):
        got, want = pg.stitch_attempts(paths), jg.stitch_attempts(paths)
        assert got == want
        assert pg.format_goodput_table(got) == jg.format_goodput_table(want)
    got = pg.stitch_attempts([ev, ev1])
    assert got["restart_gaps"] == [{"after_attempt": 1, "seconds": 2.0,
                                    "classification": "crashed"}]
    assert set(got["per_host"]) == {"0", "1"}
    empty = str(tmp_path / "serve.jsonl")
    pt.TelemetryWriter(empty).close()
    assert pg.stitch_attempts(empty) is None is jg.stitch_attempts(empty)


def _every_kind(path):
    """One event of every kind the readers know, through a port writer
    of a gang rank (so each event also carries ``process_id``)."""
    w = pt.TelemetryWriter(path, run_id="all-kinds", process_id=0)
    w.emit_run_meta(argv=["cli.train"], config_name="bert",
                    mesh={"data": 2})
    w.emit(pt.KIND_TRAIN_STEP, step=1, metrics={"loss": 1.0},
           throughput={"examples_per_sec": 10.0},
           collectives={"total_bytes": 400, "total_logical_bytes": 1600})
    w.emit(pt.KIND_EVAL, step=2, metrics={"eval_loss": 1.0})
    w.emit(pt.KIND_BENCH, metrics={"value": 1.0}, workload="bert")
    w.emit(pt.KIND_BENCH_PROBE, platform="gpu")
    w.emit(pt.KIND_TRACE_SUMMARY, metrics={"coverage": 1.0})
    w.emit(pt.KIND_HEALTH, step=3, health={"event": "moe_collapse"})
    w.emit(pt.KIND_FAILURE, step=3, health={"failure": "nan_loss"})
    w.emit(pt.KIND_CKPT_SAVE, step=4,
           metrics={"ckpt_save_blocked_ms": 1.0, "ckpt_save_total_ms": 2.0},
           async_save=True)
    w.emit(pt.KIND_STARTUP, step=4, time_to_first_step_s=2.5,
           restored_step=4, compilation_cache_dir=None)
    w.emit(pt.KIND_PIPELINE, schedule="gpipe", stages=2, microbatches=4,
           bubble_frac=0.2)
    w.emit(pt.KIND_ZERO_UPDATE, shards=2, buckets=3, bucket_mb=4.0)
    w.emit(pt.KIND_ANOMALY, step=5, health={"anomaly": "loss_spike"})
    w.emit(pt.KIND_ROLLBACK, step=5, health={"from_step": 5, "to_step": 4})
    w.emit(pt.KIND_BATCH_SKIPPED, step=5, health={"batches": 2})
    w.emit(pt.KIND_INFEED_STALL, step=5, health={"attempt": 1})
    w.emit(pt.KIND_CKPT_QUARANTINED, step=4, health={"reason": "hash"})
    w.emit(pt.KIND_RESTORE_FALLBACK, health={"from_step": 4, "to_step": 2})
    w.emit(pt.KIND_SUPERVISOR_ATTEMPT, attempt=1, rc=137,
           classification="crashed")
    w.emit(pt.KIND_CRASH_LOOP, verdict="deterministic_crash_loop")
    w.emit(pt.KIND_MESH_RESIZED, from_axes={"data": 2},
           to_axes={"data": 1}, visible_devices=1)
    w.emit(pt.KIND_CKPT_RESHARDED, step=4, from_axes={"data": 2},
           to_axes={"data": 1}, leaf_count=8)
    w.emit(pt.KIND_SERVE_REQUEST,
           metrics={"rows": 2, "queue_wait_ms": 1.0, "latency_ms": 4.0})
    w.emit(pt.KIND_SERVE_BATCH, metrics={"rows": 2, "padded_rows": 4,
                                         "compute_ms": 3.0,
                                         "queue_depth": 1})
    w.emit(pt.KIND_SERVE_QUEUE, metrics={"queue_depth": 2})
    w.emit(pt.KIND_SERVE_LATENCY,
           metrics={"p50_ms": 3.0, "p90_ms": 4.0, "p99_ms": 4.0,
                    "count": 1},
           throughput={"requests_per_sec": 10.0, "rows_per_sec": 20.0})
    w.emit(pt.KIND_SERVE_RECOMPILE, bucket="rows2",
           metrics={"compile_ms": 50.0})
    w.emit(pt.KIND_DECODE_STEP, metrics={"rows": 3, "padded_rows": 4,
                                         "step_ms": 6.0,
                                         "per_token_ms": 2.0,
                                         "occupancy": 0.75})
    w.emit(pt.KIND_KV_CACHE, metrics={"pages_used": 5, "pages_free": 3,
                                      "streams_active": 2,
                                      "streams_waiting": 1,
                                      "evictions": 1}, event="periodic")
    w.emit(pt.KIND_SERVE_ROUTE, metrics={"latency_ms": 5.0, "retries": 1,
                                         "status": 200},
           replica="r0", shed=False, deadline_exceeded=False)
    w.emit(pt.KIND_SERVE_EJECT, replica="r1", action="eject",
           reason="stale")
    w.emit(pt.KIND_SERVE_RELOAD, metrics={"reload_ms": 120.0},
           replica="r0", ok=True, from_digest="aaaa", to_digest="bbbb")
    w.emit(pt.KIND_SCALE, metrics={"pressure": 0.91}, action="up",
           reason="pressure", replica="r3", from_replicas=3, to_replicas=4)
    w.emit(pt.KIND_ADMISSION, tenant="t", priority=2, verdict="shed",
           retry_after_s=1.0)
    w.emit(pt.KIND_SPAN, metrics={"dur_ms": 12.5}, trace="t" * 16,
           span="s" * 16, parent=None, name="serve.request",
           service="engine", status="ok", t_start=1000.0, offset_s=0.0,
           attrs=None)
    w.emit(pt.KIND_GOODPUT, step=5,
           metrics={"wall_s": 10.0, "goodput_frac": 0.8},
           buckets={"step_compute": 8.0, "other": 2.0},
           counters={"ckpt_saves": 1}, t0=1000.0, final=True)
    w.emit(pt.KIND_MEMORY, step=5,
           metrics={"bytes_in_use": 100, "peak_bytes_in_use": 200,
                    "device_count": 1},
           source="train", source_kind="device_memory_stats")
    w.emit(pt.KIND_MEMORY, metrics={"peak_bytes_est": 75}, source="train",
           source_kind="memory_analysis", program="train_step",
           analysis={"argument_bytes": 50, "temp_bytes": 25,
                     "peak_bytes_est": 75})
    w.emit(pt.KIND_DATA_SHARD, step=0, shard={"process_index": 0,
                                              "process_count": 2})
    w.emit(pt.KIND_DATA_PACKING, step=5,
           metrics={"real_tokens": 90, "padded_tokens": 10,
                    "packing_efficiency": 0.9})
    w.emit(pt.KIND_DATA_STATE, step=4, plan={"action": "resume"})
    w.emit(pt.KIND_AUTOTUNE_TRIAL, trial="x", status="done", score=1.0)
    w.emit(pt.KIND_ZERO_UPDATE, shards=2)
    w.close()


def test_every_kind_reads_alike_in_both_packages(tmp_path):
    path = str(tmp_path / "events.jsonl")
    _every_kind(path)
    events = list(jt.read_events(path))
    assert events == list(pt.read_events(path))
    for ev in events:
        assert jt.validate_event(ev) == [] == pt.validate_event(ev)
        assert ev["extra"]["process_id"] == 0
    kinds = {getattr(jt, n) for n in dir(jt) if n.startswith("KIND_")}
    assert {ev["kind"] for ev in events} == kinds
    assert {getattr(pt, n) for n in dir(pt) if n.startswith("KIND_")} == (
        kinds)
    got, want = pt.summarize_events(path), jt.summarize_events(path)
    assert got == want
    assert pt.format_run_summary(got) == jt.format_run_summary(want)
    for n in (0, 999, 1536, 5 * 2 ** 30, None, "x"):
        assert pt.fmt_bytes(n) == jt.fmt_bytes(n)


def test_read_events_strictness_alike(tmp_path):
    path = tmp_path / "events.jsonl"
    w = pt.TelemetryWriter(str(path), run_id="r")
    w.emit(pt.KIND_HEALTH, step=1)
    w.close()
    with open(path, "a") as fh:
        fh.write('{"schema": "dtf-telemetry/1", "kind": "x"}\n{torn')
    for tel in (pt, jt):
        assert len(list(tel.read_events(str(path), strict=False))) == 1
        with pytest.raises(ValueError):
            list(tel.read_events(str(path)))
    assert pt.validate_event({"schema": "x", "bogus": 1}) == (
        jt.validate_event({"schema": "x", "bogus": 1}))


def test_writer_listeners_flush_and_enabled(tmp_path):
    seen = []
    w = pt.TelemetryWriter(str(tmp_path / "e.jsonl"))
    w.add_listener(seen.append)
    w.add_listener(lambda ev: 1 / 0)  # a broken observer is skipped
    ev = w.emit(pt.KIND_HEALTH, step=3)
    w.flush()
    assert w.enabled and seen == [ev]
    assert (tmp_path / "e.jsonl").read_text().count("\n") == 1
    w.close()
    assert not w.enabled
    off = pt.TelemetryWriter(None)
    off.add_listener(seen.append)
    off.emit(pt.KIND_HEALTH)
    off.flush()
    assert not off.enabled and len(seen) == 2
