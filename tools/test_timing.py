"""Per-file test timing under pytest-xdist: which worker ran each file,
when it started and how long it held the worker.

A pytest plugin and its report. Run the suite with it loaded and an
output prefix in ``TEST_TIMING_OUT``::

    TEST_TIMING_OUT=/tmp/timing/run1 python -m pytest tests/ -n 6 \\
        --dist loadfile -p tools.test_timing ...

Each worker (``gw0``..., or ``main`` without xdist) appends one JSON line
per test start and end to ``<prefix>_<worker>.jsonl``, with the seconds
since ``TEST_TIMING_T0`` (a ``time.time()`` value; default: when the
plugin was imported). Then::

    python -m tools.test_timing /tmp/timing/run1

prints one row per file (worker, start, end, wall seconds, tests
finished), ordered by start, each worker's busy time and last end, and
the tests that started and never finished (a frozen worker shows here).
"""

from __future__ import annotations

import collections
import glob
import json
import os
import sys
import time

_T0 = float(os.environ.get("TEST_TIMING_T0", time.time()))


def _write(event: str, nodeid: str) -> None:
    prefix = os.environ.get("TEST_TIMING_OUT")
    if not prefix:
        return
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    with open(f"{prefix}_{worker}.jsonl", "a") as fh:
        fh.write(json.dumps({"e": event, "id": nodeid,
                             "t": time.time() - _T0}) + "\n")


def pytest_runtest_logstart(nodeid, location):
    _write("start", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _write("end", nodeid)


def report(prefix: str) -> str:
    """The per-file table of a run written under ``prefix``."""
    files: dict = collections.OrderedDict()
    open_tests = []
    for path in sorted(glob.glob(f"{prefix}_gw*.jsonl")):
        worker = path[len(prefix) + 1:-len(".jsonl")]
        started = {}
        for line in open(path):
            e = json.loads(line)
            name = e["id"].split("::")[0]
            row = files.setdefault((worker, name), {
                "start": e["t"], "end": e["t"], "n": 0})
            row["start"] = min(row["start"], e["t"])
            row["end"] = max(row["end"], e["t"])
            if e["e"] == "start":
                started[e["id"]] = e["t"]
            else:
                row["n"] += 1
                started.pop(e["id"], None)
        open_tests += [(worker, t, nodeid) for nodeid, t in started.items()]
    lines = ["worker   start     end    wall  tests  file"]
    busy: dict = collections.defaultdict(float)
    last: dict = collections.defaultdict(float)
    for (worker, name), row in sorted(files.items(),
                                      key=lambda kv: kv[1]["start"]):
        wall = row["end"] - row["start"]
        busy[worker] += wall
        last[worker] = max(last[worker], row["end"])
        lines.append(f"{worker:6s} {row['start']:7.1f} {row['end']:7.1f} "
                     f"{wall:7.1f} {row['n']:6d}  {name}")
    for worker in sorted(busy):
        lines.append(f"{worker}: busy {busy[worker]:.1f} s, last end "
                     f"{last[worker]:.1f} s")
    for worker, t, nodeid in open_tests:
        lines.append(f"never finished: {worker} since {t:.1f} s: {nodeid}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(report(sys.argv[1]))
