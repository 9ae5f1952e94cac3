"""The benchmark's own tests (``python -m pytest benchmark/tests`` from
the checkout's root). Tests that need a card carry the ``chip`` marker and
decide inside the test whether there is one."""

import os
import pathlib
import sys

# Two threads a process: the tests run beside one another (xdist) and a
# gang case starts a process per rank.
os.environ.setdefault("OMP_NUM_THREADS", "2")

HERE = pathlib.Path(__file__).resolve().parents[1]
for path in (str(HERE.parent), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped without one")
