"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names the cells, the
configurations and the metrics; each has a file of its own under
``benchmark/``, found by its name:

  * ``configs/<config>.json`` — the experiment as run (the repo YAML's
    settings, copied, with the benchmark's overrides), its source, what
    was reduced, and the plain reference beside it (``reference``);
  * ``workloads/<cell>.json`` — the configuration, the traffic, the chips
    and the run's step counts;
  * ``traffic/<traffic>.json`` — the generator's parameters, whose
    ``kind`` names the generator, ``kinds/<kind>.py``;
  * ``optimizers/<name>.py`` — how the first gradient is read back from
    the state of the configuration's optimizer (``optimizer.name``);
  * ``metrics/<metric>.py`` — the reader of one metric, ``read(run)``;
    a traced run brackets the program's modules that the cell's readers
    name in ``MODULE_SPANS`` (label -> class name).

A later change adds a configuration, a cell or a metric as new files and
new entries in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]   # benchmark/
CHECKOUT = HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: pathlib.Path = CHECKOUT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def workload(name: str, here: pathlib.Path = HERE) -> dict:
    return load_json(here / "workloads" / f"{name}.json")


def config(name: str, here: pathlib.Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def traffic(name: str, here: pathlib.Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def load_module(path: pathlib.Path, name: str):
    """Import the file at ``path`` as module ``name`` (metric files carry
    dots in their names, which ``import`` cannot)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, here: pathlib.Path = HERE):
    return load_module(here / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")
                       .replace("-", "_"))


def kind(name: str, here: pathlib.Path = HERE):
    return load_module(here / "kinds" / f"{name}.py", "bench_kind_" + name)


def optimizer(name: str, here: pathlib.Path = HERE):
    return load_module(here / "optimizers" / f"{name}.py",
                       "bench_optimizer_" + name)


def module_spans(bench: dict, cell: str) -> dict[str, str]:
    """The module spans the cell's per-layer readers ask a traced run for:
    label -> class name of the program's modules to bracket."""
    out: dict[str, str] = {}
    for m in cell_metrics(bench, cell, True):
        out.update(getattr(metric_reader(m["name"]), "MODULE_SPANS", {}))
    return out


def reference(cfg: dict):
    """The configuration's plain reference, ``reference/<stem>.py``,
    imported as ``reference.<stem>`` (``benchmark/`` is on the path)."""
    return importlib.import_module(
        "reference." + pathlib.Path(cfg["reference"]).stem)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced. A metric without a
    ``workloads`` list belongs to every cell."""
    section = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in section
            if "workloads" not in m or cell in m["workloads"]]
