"""Every configuration, cell, traffic and metric file is found, parses and
agrees with ``BENCHMARK.json``; the file keeps the contract's limits."""

import json
import re

import pytest

from benchlib import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_tok", "_dim", "_rank")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = spec.config(entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not any(w in key.lower() for w in WIDTH_WORDS), key
    assert (spec.HERE / cfg["reference"]).is_file()
    opt = cfg["experiment"]["optimizer"]["name"]
    assert callable(spec.optimizer(opt).first_grad)
    assert any(entry["name"] == w["config"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    work = spec.workload(entry["name"])
    for key in ("config", "traffic", "chips"):
        assert work[key] == entry[key]
    kind = spec.kind(spec.traffic(entry["traffic"])["kind"])
    for fn in ("make_batch", "real_tokens", "overrides"):
        assert callable(getattr(kind, fn))
    assert set(work["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    reported = [m for m in BENCH["end_to_end"]
                if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(entry["name"] in m.get("workloads", [entry["name"]])
               for m in BENCH["per_layer"])


def test_setup_s_belongs_to_every_cell():
    """``setup_s`` carries no ``workloads`` list: every cell, those added
    later too, reports it."""
    assert "workloads" not in E2E["setup_s"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_shares_of_a_roofline_are_named_for_it(metric):
    """A kernel's share of its roofline is ``<kernel>_roofline`` in %."""
    if "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline")
        assert metric["unit"] == "%"


def test_pairs_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_file(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    reader = spec.metric_reader(metric["name"])
    assert callable(reader.read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        moved = E2E[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_no_orphan_files():
    names = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert {p.stem for p in (spec.HERE / "metrics").glob("*.py")} == names
    assert {p.stem for p in (spec.HERE / "workloads").glob("*.json")} \
        == set(CELLS)
    assert {p.stem for p in (spec.HERE / "traffic").glob("*.json")} \
        == {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (spec.HERE / "configs").glob("*.json")} \
        == {c["name"] for c in BENCH["configs"]}
    assert {p.stem for p in (spec.HERE / "kinds").glob("*.py")} \
        == {spec.traffic(w["traffic"])["kind"] for w in BENCH["workloads"]}
    assert {p.stem for p in (spec.HERE / "optimizers").glob("*.py")} \
        == {spec.config(c["name"])["experiment"]["optimizer"]["name"]
            for c in BENCH["configs"]}


def test_module_spans_name_the_port_modules():
    """A reader's ``MODULE_SPANS`` names classes of the port's models."""
    from distributed_tensorflow_framework_torch.models import layers
    for m in BENCH["per_layer"]:
        for label, cls in getattr(spec.metric_reader(m["name"]),
                                  "MODULE_SPANS", {}).items():
            assert NAME.match(label) and hasattr(layers, cls), (label, cls)
