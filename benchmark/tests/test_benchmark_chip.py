"""On a card: each one-chip cell runs through the command, briefly, and
comes out correct with every end-to-end metric it reports."""

import json
import subprocess
import sys

import pytest
import torch

from benchlib import spec

ONE_CHIP = [w["name"] for w in spec.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.chip
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "3300000017", "--seconds", "3", "--trace", "0"],
        cwd=spec.CHECKOUT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    wanted = {m["name"] for m in spec.cell_metrics(spec.benchmark(), cell,
                                                   False)}
    assert set(line["metrics"]) == wanted
