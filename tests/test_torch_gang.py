"""How the port's multi-rank tests start their gangs, and the tests of it.

:class:`Gang` starts ``n`` ranks of a test program with the discovery
environment of core/cluster.py (the triple set for a world of one too, so
that a group is formed) and waits for them. The port of the free-port
probe is not held, so another process can take it before rank 0's
TCPStore binds it: a gang whose rank dies of that (the port's launcher's
``is_bind_failure``) is started again whole on a fresh port, as
cli/launch_local_cluster.py does, up to its ``PORT_RETRIES`` starts. Any
other failure, or the timeout, fails the test with the end of the failing
rank's log; the other ranks are stopped, since they would wait in a
collective for the dead one.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest

from distributed_tensorflow_framework_torch.cli import (
    launch_local_cluster as llc,
)
from distributed_tensorflow_framework_torch.core import cluster

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Gang:
    """``len(logs)`` ranks of ``python <argv>``, rank r logging to
    ``logs[r]``, started at once; :meth:`join` waits for them."""

    def __init__(self, argv: list[str], logs: list[str], *,
                 retries: int = llc.PORT_RETRIES):
        self.argv, self.logs, self.retries = list(argv), list(logs), retries
        self.starts = 0
        self._start()

    def _start(self) -> None:
        port, n = llc.free_port(), len(self.logs)
        self.starts += 1
        self.procs = []
        for rank in range(n):
            env = {**os.environ,
                   cluster.ENV_COORDINATOR: f"127.0.0.1:{port}",
                   cluster.ENV_NUM_PROCESSES: str(n),
                   cluster.ENV_PROCESS_ID: str(rank),
                   "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
            fh = open(self.logs[rank], "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, *self.argv], env=env, stdout=fh,
                stderr=subprocess.STDOUT, cwd=ROOT), fh))

    def _wait(self, deadline: float) -> tuple[int | None, int | None]:
        """(rc, the first failing rank), (0, None) when every rank ended
        0, (None, None) at the deadline; every rank is stopped after."""
        try:
            while True:
                codes = [proc.poll() for proc, _ in self.procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    return codes[failed[0]], failed[0]
                if all(c == 0 for c in codes):
                    return 0, None
                if time.monotonic() > deadline:
                    return None, None
                time.sleep(0.05)
        finally:
            for proc, fh in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                fh.close()

    def join(self, timeout: float = 300.0) -> None:
        """Wait for every rank to end 0, starting the gang again on a
        fresh port when a rank lost the port-bind race; else fail."""
        deadline = time.monotonic() + timeout
        while True:
            rc, failed = self._wait(deadline)
            if rc == 0:
                return
            if rc is None:
                pytest.fail(f"gang {self.logs[0]}: not done within "
                            f"{timeout:.0f} s:\n"
                            f"{llc.log_tail(self.logs[0], 3000)}")
            if self.starts < self.retries and llc.is_bind_failure(
                    llc.log_tail(self.logs[failed])):
                self._start()
                continue
            pytest.fail(f"{self.logs[failed]} exited {rc}:\n"
                        f"{llc.log_tail(self.logs[failed], 3000)}")


def run_gang(argv: list[str], logs: list[str],
             timeout: float = 300.0) -> None:
    """Start a :class:`Gang` and join it."""
    Gang(argv, logs).join(timeout)


# ----------------------------------------------------------------- tests

_BIND_RACE = """\
import os, sys, time
marker = sys.argv[1]
rank = int(os.environ["JAX_PROCESS_ID"])
if not os.path.exists(marker):
    if rank == 0:
        open(marker, "w").close()
        print("RuntimeError: The server socket has failed to listen on any "
              "local network address. code: -98, name: EADDRINUSE, "
              "message: address already in use", flush=True)
        sys.exit(1)
    time.sleep(60)  # waits for a store that never comes
print("port", os.environ["JAX_COORDINATOR_ADDRESS"], flush=True)
"""

_ALL_REDUCE = """\
import os, torch, torch.distributed as dist
world = int(os.environ["JAX_NUM_PROCESSES"])
dist.init_process_group(
    "gloo", init_method="tcp://" + os.environ["JAX_COORDINATOR_ADDRESS"],
    world_size=world, rank=int(os.environ["JAX_PROCESS_ID"]))
t = torch.ones(1)
dist.all_reduce(t)
assert float(t) == world
dist.destroy_process_group()
"""


def _program(tmp_path, text: str) -> str:
    path = tmp_path / "prog.py"
    path.write_text(text)
    return str(path)


def test_a_lost_bind_race_starts_the_gang_again(tmp_path):
    prog = _program(tmp_path, _BIND_RACE)
    logs = [str(tmp_path / f"r{i}.log") for i in range(2)]
    gang = Gang([prog, str(tmp_path / "marker")], logs)
    gang.join(timeout=60)
    assert gang.starts == 2
    assert all("port 127.0.0.1:" in open(p).read() for p in logs)


def test_another_failure_fails_with_the_ranks_log(tmp_path):
    prog = _program(tmp_path, "import os, sys\n"
                    "print('boom', os.environ['JAX_PROCESS_ID'])\n"
                    "sys.exit(int(os.environ['JAX_PROCESS_ID']) * 3)\n")
    logs = [str(tmp_path / f"r{i}.log") for i in range(2)]
    gang = Gang([prog], logs)
    with pytest.raises(pytest.fail.Exception, match="exited 3:\nboom 1"):
        gang.join(timeout=60)
    assert gang.starts == 1


def test_a_gloo_gang_reduces_across_its_ranks(tmp_path):
    prog = _program(tmp_path, _ALL_REDUCE)
    run_gang([prog], [str(tmp_path / f"r{i}.log") for i in range(3)],
             timeout=120)
