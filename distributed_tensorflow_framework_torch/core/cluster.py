"""The gang contract: the port's stdlib-only copy of the parts of
``core/cluster.py`` that a rank needs.

A gang of N ranks is started with the same discovery environment as the
JAX package's processes (``worker_env``): the coordinator address, the
process count and the process id. The port reads them in
``core/mesh.py:initialize_runtime`` and forms a ``torch.distributed``
group from them, one process per GPU (the JAX package runs one process
per host). With no such environment the run is a single process and no
group is formed.

  * ``heartbeat_name`` / ``heartbeat_path`` — ``heartbeat-p<i>.json`` per
    rank when the gang has more than one, ``heartbeat.json`` otherwise.
  * ``latest_committed_step`` / ``exit_barrier`` — no rank returns from
    training until the chief's manifest commit record for the final step
    is durable.

The supervisor's decisions (rejoin, refit, crash-loop breaking) are
ROADMAP.md queue A item A17.
"""

from __future__ import annotations

import os
import time

from distributed_tensorflow_framework_torch.ckpt import manifest

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
               coordinator_host: str = "127.0.0.1") -> dict[str, str]:
    """Environment for one rank of a local gang: the discovery triple, or,
    for a gang of one, none of it (a plain single-process run)."""
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
    return env


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
