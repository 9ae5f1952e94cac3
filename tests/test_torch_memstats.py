"""The port's memory telemetry (core/memstats.py) and roofline model
(core/roofline.py) against the JAX package's.

Mirrors tests/test_memstats.py (without its bench.py cases) and
tests/test_roofline.py. On the CPU the port's snapshot falls back to the
process RSS with the JAX fallback's keys and ``source_kind``; the
first-step analysis is measured (tests/test_torch_observability.py holds
a trainer's ``argument_bytes`` to the state's bytes). The roofline's
``predict``, ``traffic_bytes`` and ``annotate_roofline`` equal the JAX
functions' exactly once both tables hold the same synthetic chip, and
the port's table holds the H100 alone.
"""

import dataclasses

import pytest
import torch

from distributed_tensorflow_framework_torch.core import memstats as pm
from distributed_tensorflow_framework_torch.core import roofline as pr
from distributed_tensorflow_framework_torch.core import telemetry as pt
from distributed_tensorflow_framework_tpu.core import memstats as jm
from distributed_tensorflow_framework_tpu.core import roofline as jr
from distributed_tensorflow_framework_tpu.core import telemetry as jt
from tests.test_torch_hygiene import torch_threads  # noqa: F401


def test_host_rss_bytes_sane():
    current, peak = pm.host_rss_bytes()
    assert current > 0 and peak >= 1024 * 1024


def test_cpu_snapshot_has_the_jax_fallbacks_keys():
    import jax

    got = pm.device_memory_snapshot([torch.device("cpu")])
    want = jm.device_memory_snapshot(jax.devices("cpu"))
    assert set(got) == set(want)
    assert got["source_kind"] == want["source_kind"] == "host_rss"
    assert got["devices"] == want["devices"] == []
    assert got["bytes_in_use"] > 0 and got["device_count"] == 1
    assert pm.device_memory_snapshot()["source_kind"] == "host_rss"


def test_monitor_events_validate_in_the_jax_schema(tmp_path):
    path = str(tmp_path / "events.jsonl")
    w = pt.TelemetryWriter(path, run_id="mem")
    mon = pm.MemoryMonitor(w, interval_s=1e9, source="train",
                           devices=[torch.device("cpu")])
    assert mon.maybe_sample(step=1) is None  # interval not elapsed
    snap = mon.snapshot()  # no event
    mon.sample(step=2, final=True)
    x = torch.ones(64, 64)
    y, analysis = mon.capture_step(lambda: (x @ x).sum(),
                                   lambda: pm.tensor_bytes(x), "cpu")
    w.close()
    assert y.item() == 64 ** 3
    assert analysis == {"argument_bytes": 64 * 64 * 4,
                        "peak_bytes_est": 64 * 64 * 4}
    events = list(jt.read_events(path, kind=jt.KIND_MEMORY))
    assert len(events) == 2 and snap["source_kind"] == "host_rss"
    sample, captured = events
    assert sample["step"] == 2 and sample["extra"]["final"] is True
    assert set(sample["metrics"]) == {"bytes_in_use", "peak_bytes_in_use",
                                      "device_count"}
    assert sample["extra"]["source_kind"] == "host_rss"
    assert captured["extra"]["source_kind"] == "memory_analysis"
    assert captured["extra"]["analysis"] == analysis
    assert captured["metrics"] == {"peak_bytes_est": 64 * 64 * 4}
    summary = jt.summarize_events(path)
    assert summary == pt.summarize_events(path)


def test_tensor_bytes_counts_each_storage_once():
    a = torch.zeros(10, dtype=torch.float32)
    b = torch.zeros(3, 4, dtype=torch.bfloat16)
    assert pm.tensor_bytes({"a": a, "again": a, "x": [b, (b,)]}, None,
                           {"n": 3}) == 40 + 24
    assert pm.tensor_bytes(a[:5], a[5:]) == 40  # two halves of one storage
    assert pm.tensor_bytes() == 0


def test_port_table_holds_the_h100_only():
    assert set(pr.CHIP_PEAKS) == {"NVIDIA H100 80GB HBM3"}
    assert not set(pr.CHIP_PEAKS) & set(jr.CHIP_PEAKS)
    flops, bw, cap = pr.CHIP_PEAKS["NVIDIA H100 80GB HBM3"]
    assert (flops, bw) == (989e12, 3.35e12) and 80e9 < cap < 86e9
    assert pr.RIDGE_FALLBACK_CHIP == "NVIDIA H100 80GB HBM3"
    ridge, source = pr.ridge_point("cpu")
    assert ridge == pytest.approx(295.2, abs=0.1) and source == (
        "NVIDIA H100 80GB HBM3")
    assert pr.chip_hbm_capacity("NVIDIA H100 80GB HBM3") == cap
    assert pr.chip_hbm_capacity("cpu") > 0  # host RAM


SYNTH = {"Synthetic chip": (400e12, 2e12, 48 * pr.GIB)}


@pytest.fixture()
def same_table(monkeypatch):
    for mod in (pr, jr):
        monkeypatch.setattr(mod, "CHIP_PEAKS", dict(SYNTH))
        monkeypatch.setattr(mod, "RIDGE_FALLBACK_CHIP", "Synthetic chip")


RESULTS = [
    {"flops_per_step": 8e12, "bytes_per_step": 5e10, "sec_per_step": 0.05},
    {"flops_per_step": 8e12, "bytes_per_step": 2e9, "sec_per_step": 0.03,
     "collectives": {"total_bytes": 1e8},
     "memory": {"analysis": {"argument_bytes": 1e9, "temp_bytes": 3e9}}},
    {"flops_per_step": 8e12, "bytes_per_step": 0, "sec_per_step": 0.1,
     "memory": {"analysis": {"argument_bytes": 1e9}}},
    {"flops_per_step": 0, "bytes_per_step": 1e9, "sec_per_step": 0.1},
]


@pytest.mark.usefixtures("same_table")
@pytest.mark.parametrize("chip", ["Synthetic chip", "cpu"])
@pytest.mark.parametrize("n_chips", [1, 4])
def test_roofline_functions_equal_jax(chip, n_chips):
    for flops, nbytes in ((1e12, 1e10), (1e12, 1e8), (5e11, 0.0)):
        assert dataclasses.asdict(pr.predict(chip, flops, nbytes, n_chips)) \
            == dataclasses.asdict(jr.predict(chip, flops, nbytes, n_chips))
    for result in RESULTS:
        for accum in (False, True):
            got, want = {}, {}
            pr.annotate_roofline(got, result, chip, n_chips,
                                 accum_scaled=accum)
            jr.annotate_roofline(want, result, chip, n_chips,
                                 accum_scaled=accum)
            assert got == want
    for analysis in (None, {}, {"argument_bytes": 10, "output_bytes": 5,
                                "temp_bytes": 7, "generated_code_bytes": 9}):
        assert pr.traffic_bytes(analysis, 3.0, 4.0) == jr.traffic_bytes(
            analysis, 3.0, 4.0)
    assert pr.chip_hbm_capacity(chip) == jr.chip_hbm_capacity(chip)
    assert pr.ridge_point(chip) == jr.ridge_point(chip)
