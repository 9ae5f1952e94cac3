"""A CPU dry run at a tiny size (the chip look skipped) prints the
contract's result line, and the command refuses to run where it cannot."""

import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

import run
from benchlib import report, spec
from tiny import CELLS, SEED

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _line(cell: str, trace: bool) -> dict:
    code, result = run.run_cell(cell, SEED, 0.3, trace, device="cpu",
                                tiny=CELLS[cell])
    assert code == 0
    out = io.StringIO()
    with redirect_stdout(out):
        report.emit(result)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_last_line_has_the_contract_keys(trace):
    line = _line("bert-base-mlm.s512-b96", trace)
    assert list(line) == KEYS  # no breakdown: a CPU trace has no device
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["device"]["count"] == 1
    assert list(line["checks"]) == ["loss_gap", "grad_gap", "change_gap"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    section = spec.cell_metrics(spec.benchmark(), "bert-base-mlm.s512-b96",
                                trace)
    names = {m["name"] for m in section}
    assert set(line["metrics"]) <= names
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    if not trace:  # what a CPU run can read of the end-to-end metrics
        assert {"train_tokens_per_s", "step_ms_p90", "setup_s"} \
            <= set(line["metrics"])
    assert line["correct"] is True
    assert line["attempted"] >= 12 and line["failed"] == 0


@pytest.mark.parametrize("cell", ["resnet50-imagenet.i224-b256",
                                  "resnet50-imagenet.i224-b256-dp4"])
def test_traced_image_cells_bracket_every_batchnorm(cell):
    """A traced CPU run of a ResNet cell brackets each BatchNorm's forward
    and backward (two gloo ranks under DDP for dp4) and each optimizer
    call, every span closed; a CPU trace has no markers to pair, so the
    spans' metrics stay out of the line."""
    seen = []
    init = report.Run.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen.extend(self.ranks)
    report.Run.__init__ = keep
    try:
        line = _line(cell, True)
    finally:
        report.Run.__init__ = init
    assert line["correct"] is True
    assert "batchnorm_ms.image" not in line["metrics"]
    assert len(seen) == CELLS[cell]["work"].get("chips", 1)
    for rank in seen:
        marks, steps = rank["marks"], rank["profile_steps"]
        bn = [m for m in marks if m[0] == "batchnorm"]
        opt = [m for m in marks if m[0] == "optimizer"]
        assert len(opt) == 2 * steps
        assert len(bn) == 4 * 53 * steps  # ResNet-50's BatchNorms
        assert bn[::2] == [["batchnorm", "begin"]] * (len(bn) // 2)
        assert bn[1::2] == [["batchnorm", "end"]] * (len(bn) // 2)


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bert-base-mlm.s512-b96", "--seed", "5", "--seconds", "1"],
        cwd=spec.CHECKOUT, capture_output=True, text=True)
    assert proc.returncode == 2 and proc.stdout == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bert-base-mlm.s512-b96", "--seed", "5", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""
