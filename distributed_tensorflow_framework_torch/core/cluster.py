"""The gang contract and the gang supervisor's decisions: the port's
stdlib-only copy of ``core/cluster.py``.

A gang of N ranks is started with the same discovery environment as the
JAX package's processes (``worker_env``): the coordinator address, the
process count and the process id. The port reads them in
``core/mesh.py:initialize_runtime`` and forms a ``torch.distributed``
group from them, one process per GPU (the JAX package runs one process
per host). With no such environment the run is a single process and no
group is formed.

  * ``heartbeat_name`` / ``heartbeat_path`` — ``heartbeat-p<i>.json`` per
    rank when the gang has more than one, ``heartbeat.json`` otherwise.
  * ``worker_env`` — the discovery environment of one rank (also
    cli/launch_local_cluster.py's), with the supervisor's span context in
    ``DTF_TRACE_CTX``.
  * ``probe_gang`` — can this host run a real gang? Its workers form a
    ``torch.distributed`` group (the backend core/mesh.py picks: gloo on
    the CPU and for ranks that share a card) and run one cross-rank
    ``all_reduce``, where the JAX probe runs a ``jax.distributed``
    program.
  * ``GangBreaker`` — crash-loop breaking keyed on (worker, failure
    signature), one :class:`core.supervision.CrashLoopBreaker` per rank.
  * ``decide_rejoin`` — the workers that failed to rejoin within
    ``cluster.rejoin_timeout_s`` while their peers did.
  * ``decide_refit`` — the gang-level rc-84 path: the mesh fitted to the
    surviving ranks (``fit_axis_sizes``) with the effective batch kept
    (``rescale_for_devices``). ``devices_per_proc`` is 1 in the port's
    launchers (a rank is one device); the functions keep the parameter
    and compute what the JAX package's compute.
  * ``latest_committed_step`` / ``exit_barrier`` — no rank returns from
    training until the chief's manifest commit record for the final step
    is durable.

cli/train_cluster.py is the supervisor that runs these decisions.
"""

from __future__ import annotations

import dataclasses
import os
import time

from distributed_tensorflow_framework_torch.ckpt import manifest
from distributed_tensorflow_framework_torch.core import supervision, tracing

SINGLE_HEARTBEAT_NAME = "heartbeat.json"

# The discovery triple, the same names the JAX package's launchers write.
ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"

_DISCOVERY_VARS = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID)


class ClusterSpecError(ValueError):
    """A gang cannot be formed from the requested parameters, e.g. a rank
    outside the process count."""


class ExitBarrierTimeoutError(RuntimeError):
    """The manifest showed no durable commit record for the final step
    within ``cluster.exit_barrier_timeout_s``."""


def heartbeat_name(process_index: int, process_count: int) -> str:
    """Heartbeat file name of one rank inside the checkpoint directory."""
    if process_count <= 1:
        return SINGLE_HEARTBEAT_NAME
    if not 0 <= process_index < process_count:
        raise ClusterSpecError(
            f"process_index {process_index} outside gang of {process_count}")
    return f"heartbeat-p{process_index}.json"


def heartbeat_path(ckpt_dir: str, process_index: int,
                   process_count: int) -> str:
    return os.path.join(ckpt_dir, heartbeat_name(process_index, process_count))


def worker_env(base_env: dict[str, str], *, coordinator_port: int,
               num_processes: int, process_id: int,
               coordinator_host: str = "127.0.0.1",
               trace_ctx: str | None = None) -> dict[str, str]:
    """Environment for one rank of a local gang: the discovery triple, or,
    for a gang of one, none of it (a plain single-process run: a refit
    down to one survivor). ``trace_ctx``, an encoded
    :class:`core.tracing.SpanContext`, goes in ``DTF_TRACE_CTX`` so every
    rank's ``worker.run`` span parents on the supervisor's attempt; None
    leaves the base environment's as it is."""
    if not 0 <= process_id < num_processes:
        raise ClusterSpecError(
            f"process_id {process_id} outside gang of {num_processes}")
    env = dict(base_env)
    if num_processes > 1:
        env[ENV_COORDINATOR] = f"{coordinator_host}:{coordinator_port}"
        env[ENV_NUM_PROCESSES] = str(num_processes)
        env[ENV_PROCESS_ID] = str(process_id)
    else:
        for key in _DISCOVERY_VARS:
            env.pop(key, None)
    if trace_ctx is not None:
        env[tracing.TRACE_CTX_ENV] = trace_ctx
    return env


# Failure signatures of a backend that forms a group but cannot run a
# computation across processes (the JAX package's stock CPU jaxlib is the
# case it was written for). A torch gloo group has none of them; the
# classifier is kept so that both packages read a probe's failure alike.
GANG_UNSUPPORTED_SIGNS = (
    "multiprocess computations aren't implemented",
    "multi-process computations are not supported",
    "collectives are not implemented",
)

# One worker of the probe gang: form the group from the discovery
# environment with the backend core/mesh.py picks for the device, and run
# the smallest computation that spans the ranks, one all_reduce.
_PROBE_WORKER = """\
import os
import sys
sys.path.insert(0, os.environ["DTF_PROBE_ROOT"])
import torch
import torch.distributed as dist
from distributed_tensorflow_framework_torch.core.mesh import pick_backend
device = os.environ["DTF_PROBE_DEVICE"]
world = int(os.environ["JAX_NUM_PROCESSES"])
rank = int(os.environ["JAX_PROCESS_ID"])
if device == "cuda":
    torch.cuda.set_device(rank % torch.cuda.device_count())
dist.init_process_group(
    pick_backend(device, world),
    init_method="tcp://" + os.environ["JAX_COORDINATOR_ADDRESS"],
    world_size=world, rank=rank)
total = torch.ones(1, device=device)
dist.all_reduce(total)
assert float(total) == world, float(total)
dist.destroy_process_group()
print("GANG_PROBE_OK", flush=True)
"""


def is_gang_unsupported(detail: str) -> bool:
    """Does a probe failure match the signatures of a backend that cannot
    run gangs (as against an environmental flake worth looking into)?"""
    low = detail.lower()
    return any(sign in low for sign in GANG_UNSUPPORTED_SIGNS)


def probe_gang(*, procs: int = 2, devices_per_proc: int = 1,
               timeout_s: float = 120.0,
               device: str = "cpu") -> tuple[bool, str]:
    """Can this host run a real ``procs``-rank ``torch.distributed`` gang
    with a computation across the ranks on ``device``? Returns ``(ok,
    detail)``, the detail being the end of the workers' output.
    ``devices_per_proc`` must be 1: a port rank is one device."""
    import socket
    import subprocess
    import sys

    if devices_per_proc != 1:
        raise ClusterSpecError(
            f"devices_per_proc={devices_per_proc}: a port rank drives one "
            f"device")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    workers = []
    for i in range(procs):
        env = worker_env(dict(os.environ), coordinator_port=port,
                         num_processes=procs, process_id=i)
        # A probe of one still forms its group.
        env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
        env[ENV_NUM_PROCESSES] = str(procs)
        env[ENV_PROCESS_ID] = str(i)
        env["DTF_PROBE_ROOT"] = root
        env["DTF_PROBE_DEVICE"] = device
        workers.append(subprocess.Popen(
            [sys.executable, "-c", _PROBE_WORKER], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    ok = True
    try:
        for proc in workers:
            try:
                out, _ = proc.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                out = (out or "") + "\n[probe timeout]"
            outs.append(out or "")
            ok = ok and proc.returncode == 0 and "GANG_PROBE_OK" in out
    finally:
        for proc in workers:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return ok, "\n".join(outs)[-4000:]


class GangBreaker:
    """Crash-loop breaker keyed on (worker, failure signature): one
    :class:`core.supervision.CrashLoopBreaker` per process id, so one
    flaky rank trips its own breaker and cannot burn the gang's attempt
    budget by alternating with other ranks' noise."""

    def __init__(self, threshold: int = 2):
        self.threshold = threshold
        self._per_worker: dict[int, supervision.CrashLoopBreaker] = {}

    def record(self, worker: int, *, rc: int, last_step: int | None,
               ckpt_step: int | None, hung: bool = False,
               transient: bool = False) -> bool:
        """Register one failed attempt attributed to ``worker``; True =
        that worker's failure is a deterministic crash loop — stop."""
        breaker = self._per_worker.setdefault(
            worker, supervision.CrashLoopBreaker(self.threshold))
        return breaker.record(rc=rc, last_step=last_step,
                              ckpt_step=ckpt_step, hung=hung,
                              transient=transient)

    def report(self, worker: int) -> dict:
        """One worker's post-mortem, tagged with its id."""
        breaker = self._per_worker.get(worker)
        out = breaker.report() if breaker else {
            "verdict": "no_failures_recorded"}
        out["process_id"] = worker
        return out


def decide_rejoin(ages: dict[int, float | None], *, elapsed_s: float,
                  rejoin_timeout_s: float) -> list[int]:
    """The workers to drop for failing to rejoin: ``ages`` maps a process
    id to its heartbeat age (None: no heartbeat this attempt). A worker is
    overdue only once the window has passed, with no heartbeat, while a
    peer has one: when nobody has joined the gang is still starting.
    ``rejoin_timeout_s <= 0`` disables the watchdog."""
    if rejoin_timeout_s <= 0 or elapsed_s <= rejoin_timeout_s:
        return []
    if not any(age is not None for age in ages.values()):
        return []
    return sorted(w for w, age in ages.items() if age is None)


@dataclasses.dataclass
class GangRefit:
    """The mesh refitted to a smaller surviving gang."""

    process_count: int          # surviving processes to relaunch
    n_devices: int              # total devices across the survivors
    sizes: dict[str, int]       # fitted mesh axis sizes
    global_batch: int           # rescaled global batch
    grad_accum: int             # rescaled grad-accum factor
    batch_preserved: bool       # effective batch held constant?
    overrides: list[str]        # key.path=value overrides for the child


def decide_refit(sizes: dict[str, int], global_batch: int, grad_accum: int,
                 *, process_count: int, devices_per_proc: int) -> GangRefit:
    """Fit the mesh to ``process_count`` surviving workers: the
    single-process rc-84 ladder's ``fit_axis_sizes`` and
    ``rescale_for_devices`` over the gang's devices, with
    ``checkpoint.allow_reshard=true`` among the overrides."""
    if process_count < 1:
        raise ClusterSpecError("cannot refit a gang to zero processes")
    n_devices = process_count * devices_per_proc
    try:
        fitted = supervision.fit_axis_sizes(sizes, n_devices)
    except ValueError as e:
        raise ClusterSpecError(
            f"no mesh over {n_devices} devices satisfies {sizes}: {e}"
        ) from e
    old_dp = sizes.get("data", 1)
    new_dp = fitted.get("data", 1)
    if old_dp > 0:
        new_batch, new_accum, preserved = supervision.rescale_for_devices(
            global_batch, grad_accum, old_dp, new_dp)
    else:  # data was -1: the per-device batch is unknown here
        new_batch, new_accum, preserved = global_batch, grad_accum, False
    overrides = [f"mesh.{axis}={size}" for axis, size in fitted.items()]
    overrides.append("checkpoint.allow_reshard=true")
    if preserved:
        overrides.append(f"data.global_batch_size={new_batch}")
        overrides.append(f"train.grad_accum_steps={new_accum}")
    return GangRefit(process_count=process_count, n_devices=n_devices,
                     sizes=fitted, global_batch=new_batch,
                     grad_accum=new_accum, batch_preserved=preserved,
                     overrides=overrides)


def latest_committed_step(ckpt_dir: str) -> int | None:
    """Newest committed checkpoint step in ``ckpt_dir``."""
    return manifest.latest_committed_step(ckpt_dir)


def exit_barrier(ckpt_dir: str, *, step: int, timeout_s: float,
                 poll_s: float = 0.5, is_chief: bool = False,
                 latest_step_fn=None, sleep=time.sleep,
                 clock=time.monotonic) -> int:
    """Block until the commit record of ``step`` (or a later one) is
    durable in ``ckpt_dir``; returns the committed step seen. Raises
    ExitBarrierTimeoutError past ``timeout_s`` rather than letting a rank
    exit before the chief's save has landed. ``latest_step_fn``, ``sleep``
    and ``clock`` are test seams."""
    read_step = latest_step_fn or latest_committed_step
    deadline = clock() + max(0.0, timeout_s)
    while True:
        committed = read_step(ckpt_dir)
        if committed is not None and committed >= step:
            return committed
        if clock() >= deadline:
            role = "chief" if is_chief else "worker"
            raise ExitBarrierTimeoutError(
                f"exit barrier timed out after {timeout_s:.1f}s: {role} "
                f"waited for commit record of step {step} in {ckpt_dir} "
                f"but the manifest shows "
                f"{'nothing committed' if committed is None else committed}")
        sleep(poll_s)
