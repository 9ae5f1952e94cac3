"""``python -m distributed_tensorflow_framework_torch.cli.launch_local_cluster``
— start an N-rank gang of the port's trainer on this machine.

    python -m distributed_tensorflow_framework_torch.cli.launch_local_cluster \\
        --procs 2 --workdir /tmp/dtf-local-cluster -- \\
        --config configs/bert_base_mlm.yaml --device cpu \\
        --set mesh.data=2 --set checkpoint.directory=/tmp/gang_ck

The port's counterpart of ``scripts/launch_local_cluster.py``: N
processes of ``cli.train`` (everything after ``--`` is passed to it as it
is), wired together by the discovery environment of
``core/cluster.py:worker_env`` (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), from which each forms the
``torch.distributed`` group (core/mesh.py picks the backend: NCCL when
every rank has a GPU of its own, gloo on the CPU and when ranks share a
card). A rank is one device, so ``--devices-per-proc`` takes 1 only.

The exit status is the first failing rank's (0 when every rank ends 0).
Each rank logs to ``<workdir>/worker-<i>.log``; a failing rank's log tail
goes to this launcher's stderr. On the first failure the other ranks,
blocked in a collective with the dead one, get SIGTERM and after
``GRACE_S`` SIGKILL. The free port is probed, so another process can take
it before rank 0's TCPStore binds it; a gang whose rank 0 dies of that
(``is_bind_failure``) is started again on a fresh port, up to
``--port-retries`` times. cli/train_cluster.py (the supervised gang) and
the port's multi-rank tests start their gangs through the same pieces.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

from distributed_tensorflow_framework_torch.core import cluster

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# What each rank runs, after the interpreter: the port's trainer CLI.
TRAIN_ENTRY = ("-m", "distributed_tensorflow_framework_torch.cli.train")

# SIGTERM → SIGKILL escalation, and the bind-failure signatures the
# port-retry path matches against a dead rank's log tail (torch's TCPStore
# says "address already in use" / EADDRINUSE).
GRACE_S = 10.0
PORT_RETRIES = 3
BIND_FAILURE_SIGNS = (
    "address already in use",
    "failed to bind",
    "bind failed",
    "errno 98",
    "eaddrinuse",
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--devices-per-proc", type=int, default=1,
                   help="devices per rank: 1 (a port rank drives one "
                        "device)")
    p.add_argument("--workdir", default="/tmp/dtf-local-cluster")
    p.add_argument("--port-retries", type=int, default=PORT_RETRIES,
                   help="starts of the gang when rank 0 loses the "
                        "free-port bind race (1 = no retry)")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="arguments for cli.train (prefix with --)")
    args = p.parse_args(argv)
    if args.train_args and args.train_args[0] == "--":
        args.train_args = args.train_args[1:]
    if not args.train_args:
        p.error("pass cli.train arguments after --")
    if args.procs < 1:
        p.error("--procs must be >= 1")
    if args.devices_per_proc != 1:
        p.error("--devices-per-proc must be 1: a port rank drives one "
                "device")
    return args


def log_path(workdir: str, worker: int) -> str:
    return os.path.join(workdir, f"worker-{worker}.log")


def log_tail(path: str, max_bytes: int = 4096) -> str:
    """The last ``max_bytes`` of a rank's log ('' when unreadable)."""
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - max_bytes))
            return fh.read().decode("utf-8", errors="replace")
    except OSError:
        return ""


def is_bind_failure(log_text: str) -> bool:
    """Does a rank's log tail look like the lost port-bind race?"""
    lowered = log_text.lower()
    return any(sign in lowered for sign in BIND_FAILURE_SIGNS)


def spawn_gang(train_args: list[str], *, procs: int, devices_per_proc: int,
               workdir: str, port: int, base_env: dict | None = None
               ) -> tuple[list[subprocess.Popen], list]:
    """Start the N ranks of one gang; returns (processes, log handles).
    ``base_env`` defaults to ``os.environ``; cli/train_cluster.py passes
    its relaunch environment (the elastic overrides, the attempt's span)
    through here."""
    if devices_per_proc != 1:
        raise cluster.ClusterSpecError(
            f"devices_per_proc={devices_per_proc}: a port rank drives one "
            f"device")
    os.makedirs(workdir, exist_ok=True)
    base = dict(os.environ if base_env is None else base_env)
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, base.get("PYTHONPATH", "")) if p)
    children, logs = [], []
    for i in range(procs):
        env = cluster.worker_env(base, coordinator_port=port,
                                 num_processes=procs, process_id=i)
        log = open(log_path(workdir, i), "w")
        logs.append(log)
        children.append(subprocess.Popen(
            [sys.executable, *TRAIN_ENTRY, *train_args], env=env, cwd=_ROOT,
            stdout=log, stderr=subprocess.STDOUT))
    return children, logs


def _report_failure(workdir: str, worker: int, rc: int) -> None:
    path = log_path(workdir, worker)
    print(f"worker {worker} exited {rc} — log tail ({path}):",
          file=sys.stderr)
    for line in log_tail(path).splitlines()[-25:]:
        print(f"    {line}", file=sys.stderr)


def _wait_gang(procs: list[subprocess.Popen],
               workdir: str) -> tuple[int, int | None]:
    """Poll every rank until all have exited; returns (rc, the first
    failing rank). A dead rank leaves its peers blocked in a collective,
    so at the first nonzero exit the others get SIGTERM, and SIGKILL after
    ``GRACE_S`` (a rank blocked inside a native collective does not act
    on SIGTERM)."""
    rc, failed = 0, None
    live = dict(enumerate(procs))
    killed: dict[int, float] = {}  # rank → when SIGTERM was sent
    while live:
        now = time.monotonic()
        for i, proc in list(live.items()):
            r = proc.poll()
            if r is None:
                if i in killed and now - killed[i] > GRACE_S:
                    proc.kill()
                    killed[i] = float("inf")  # kill once
                continue
            del live[i]
            if r != 0 and i not in killed:
                # Peers stopped below exit nonzero too: only the first
                # real failure is the root cause.
                rc, failed = (rc or r), (failed if failed is not None else i)
                for j, p in live.items():
                    killed[j] = now
                    p.terminate()
        if live:
            time.sleep(0.2)
    return rc, failed


def _reap(procs: list[subprocess.Popen], logs: list) -> None:
    for proc in procs:
        if proc.poll() is None:
            try:
                proc.wait(timeout=GRACE_S)
            except subprocess.TimeoutExpired:
                proc.kill()
        proc.wait()
    for log in logs:
        log.close()


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    retries = max(1, args.port_retries)
    rc = 1
    for attempt in range(1, retries + 1):
        port = free_port()
        procs, logs = spawn_gang(
            args.train_args, procs=args.procs,
            devices_per_proc=args.devices_per_proc, workdir=args.workdir,
            port=port)
        print(f"launched {args.procs} workers (coordinator 127.0.0.1:{port});"
              f" logs in {args.workdir}/worker-*.log", file=sys.stderr)
        try:
            rc, failed = _wait_gang(procs, args.workdir)
        except KeyboardInterrupt:
            for proc in procs:
                proc.terminate()
            try:
                deadline = time.monotonic() + GRACE_S
                for proc in procs:
                    try:
                        proc.wait(
                            timeout=max(0.1, deadline - time.monotonic()))
                    except subprocess.TimeoutExpired:
                        proc.kill()
            except KeyboardInterrupt:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
            return 130
        finally:
            _reap(procs, logs)
        if rc == 0 or failed is None:
            return rc
        if (attempt < retries
                and is_bind_failure(log_tail(log_path(args.workdir, failed)))):
            print(f"worker {failed} lost the port-bind race on "
                  f"127.0.0.1:{port} — relaunching the gang on a fresh "
                  f"port (attempt {attempt + 1}/{retries})", file=sys.stderr)
            continue
        _report_failure(args.workdir, failed, rc)
        return rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
