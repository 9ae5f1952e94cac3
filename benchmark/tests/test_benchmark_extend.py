"""A later change adds a configuration, a cell, a traffic kind or a
per-layer metric as new files and new entries in ``BENCHMARK.json``,
editing no file that is there: the harness finds them by name."""

import json
import shutil
import subprocess
import sys

from benchlib import spec


def test_new_cell_and_metric_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    shutil.copy(spec.CHECKOUT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # A new traffic, cell and metric: new files and new entries only.
    b = root / "benchmark"
    (b / "traffic" / "s128-b256.json").write_text(json.dumps(
        {**json.loads((b / "traffic" / "s512-b96.json").read_text()),
         "rows_per_chip": 256, "seq_len": 128}))
    (b / "workloads" / "bert-base-mlm.s128-b256.json").write_text(json.dumps(
        {**json.loads((b / "workloads" / "bert-base-mlm.s512-b96.json")
                      .read_text()), "traffic": "s128-b256"}))
    (b / "kinds" / "ones.py").write_text(
        "import torch\n"
        "def make_batch(traffic, data, gen, device):\n"
        "    return {'x': torch.ones(traffic['rows_per_chip'], 3)}\n"
        "def real_tokens(batch):\n    return 0\n"
        "def overrides(traffic):\n    return []\n")
    (b / "metrics" / "rows_per_step.py").write_text(
        "def read(run):\n    return run.window_rows / run.steps\n")
    bench["workloads"].append({"name": "bert-base-mlm.s128-b256",
                               "config": "bert-base-mlm",
                               "traffic": "s128-b256", "chips": 1,
                               "why": "short rows"})
    bench["per_layer"].append({"name": "rows_per_step", "unit": "rows",
                               "better": "higher", "source": "host_clock",
                               "layer": "trainer loop and infeed",
                               "moves": "train_tokens_per_s",
                               "workloads": ["bert-base-mlm.s128-b256"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("train_tokens_per_s", "step_ms_p90", "peak_mem_gib"):
            m["workloads"].append("bert-base-mlm.s128-b256")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = """
import sys, types
sys.path[:0] = [sys.argv[1] + "/benchmark", sys.argv[1]]
from benchlib import spec
bench = spec.benchmark(spec.CHECKOUT)
cell = "bert-base-mlm.s128-b256"
spec.cell_entry(bench, cell)
work = spec.workload(cell)
assert spec.traffic(work["traffic"])["seq_len"] == 128
names = [m["name"] for m in spec.cell_metrics(bench, cell, True)]
assert "rows_per_step" in names, names
from benchlib import traffic
batch = traffic.make_batch({"kind": "ones", "rows_per_chip": 2}, {}, 5, 0, 0,
                           "cpu")
assert tuple(batch["x"].shape) == (2, 3)
run = types.SimpleNamespace(window_rows=2560, steps=10)
print(spec.metric_reader("rows_per_step").read(run))
"""
    out = subprocess.run([sys.executable, "-c", code, str(root)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "256.0"
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
