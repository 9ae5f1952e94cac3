"""The trainer's exit-code contract, graceful preemption and the
supervisors' decisions: the port's copy of ``core/supervision.py``.

  * ``GRACEFUL_PREEMPT_RC`` (83): SIGTERM honoured — the in-flight step
    finished, a checkpoint was saved, relaunch whenever;
  * ``ELASTIC_RESHARD_RC`` (84): the configured mesh does not fit the
    gang's ranks (``core/mesh.py:MeshSizeError``) — a topology change to
    refit to, not a crash; the child leaves a device report
    (``write_device_report``, ``devices.json`` in the checkpoint
    directory) and the supervisor fits the largest valid mesh onto what
    remains (``fit_axis_sizes``), keeps the effective batch
    (``rescale_for_devices``) and relaunches with the refit in
    ``DTF_ELASTIC_OVERRIDES``;
  * ``ANOMALY_ESCALATION_RC`` (85): the in-process recovery ladder
    (train/anomaly.py) gave up after ``max_rollbacks`` consecutive
    rollbacks;
  * ``install_sigterm_handler`` arms a flag the train loop polls at step
    boundaries; a second SIGTERM kills outright. ``graceful_preemption``
    arms it for a block and puts the previous handler back after it, for
    callers that run the CLI in process (tests, ``chip_smoke.py``);
  * ``backoff_seconds`` (capped exponential with jitter), the pid-scoped
    heartbeat readers and :class:`CrashLoopBreaker`, which the supervisors
    (cli/train_resilient.py, cli/train_cluster.py) share.

A port "device" is a rank (one process per GPU), so the device report's
``visible_devices`` is the world the child saw. The JAX package's
``mask_host_device_count`` (an XLA flag that shrinks the virtual CPU
device set) has no counterpart: the ``drop_devices`` drill relaunches the
child in a gang of fewer ranks instead (cli/train_resilient.py). Stdlib
only, so a supervisor imports it without torch.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import signal
import time

log = logging.getLogger(__name__)

GRACEFUL_PREEMPT_RC = 83
ELASTIC_RESHARD_RC = 84
ANOMALY_ESCALATION_RC = 85

# core/mesh.py MESH_AXES (that module imports torch; this one stays
# stdlib-importable for the supervisors). tests/test_torch_supervisor.py
# holds the two tuples equal.
MESH_AXIS_ORDER = ("data", "fsdp", "expert", "pipe", "seq", "model")

# The rc-84 child's device report, in the checkpoint directory.
DEVICE_REPORT_NAME = "devices.json"

# The supervisor's refit, passed to the relaunched child as comma-separated
# ``key.path=value`` overrides; cli/train.py applies them after its own
# ``--set`` overrides, so the refit wins over sizes on the command line.
ELASTIC_OVERRIDES_ENV = "DTF_ELASTIC_OVERRIDES"

_preempt_requested = False
_handler_installed = False


def preemption_requested() -> bool:
    return _preempt_requested


def reset_preemption() -> None:
    """Clear the flag (tests; an in-process relaunch)."""
    global _preempt_requested
    _preempt_requested = False


def _on_sigterm(signum, frame):
    global _preempt_requested
    if _preempt_requested:  # second TERM: the operator means it
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)
        return
    _preempt_requested = True
    log.warning("SIGTERM received — graceful preemption armed: finishing the "
                "in-flight step, saving a checkpoint, exiting rc=%d",
                GRACEFUL_PREEMPT_RC)


def install_sigterm_handler() -> bool:
    """Arm graceful preemption: the first SIGTERM sets the flag the train
    loop polls; a second restores the default disposition and re-sends
    itself, so a stuck shutdown can still be killed with plain TERM.
    Returns False (arming nothing) outside the main thread."""
    global _handler_installed
    if _handler_installed:
        return True
    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, AttributeError, OSError):
        return False
    _handler_installed = True
    return True


@contextlib.contextmanager
def graceful_preemption():
    """``install_sigterm_handler`` for the block; the handler that was
    there before is put back after it, unless it was already ours. The
    preemption flag is left as it is."""
    global _handler_installed
    try:
        previous = signal.getsignal(signal.SIGTERM)
    except (ValueError, AttributeError):
        previous = None
    armed = install_sigterm_handler()
    try:
        yield armed
    finally:
        if armed and previous is not None and previous is not _on_sigterm:
            try:
                signal.signal(signal.SIGTERM, previous)
                _handler_installed = False
            except (ValueError, OSError):
                pass


def backoff_seconds(failure_index: int, *, base: float = 5.0,
                    cap: float = 120.0, jitter: float = 0.5,
                    rng: random.Random | None = None) -> float:
    """Sleep before relaunch ``failure_index`` (1-based): capped exponential
    ``base * 2^(i-1)`` with ±``jitter`` fractional randomization."""
    if base <= 0:
        return 0.0
    delay = min(cap, base * (2.0 ** max(0, failure_index - 1)))
    if jitter > 0:
        r = rng or random
        delay *= 1.0 + r.uniform(-jitter, jitter)
    return max(0.0, delay)


def read_heartbeat(path: str) -> dict | None:
    """The heartbeat record, or None when absent or torn (the writer
    commits by atomic rename, train/hooks.py ``HeartbeatHook``)."""
    try:
        with open(path) as fh:
            record = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    return record if isinstance(record, dict) else None


def heartbeat_age_s(path: str, *, pid: int | None = None,
                    now: float | None = None) -> float | None:
    """Seconds since the child's last heartbeat, or None when that child
    has written none yet. ``pid`` scopes the check to the current child:
    a predecessor's leftover file reads as no heartbeat, not as a stale
    one."""
    record = read_heartbeat(path)
    if record is None:
        return None
    if pid is not None and record.get("pid") not in (None, pid):
        return None
    t = record.get("t")
    if not isinstance(t, (int, float)):
        try:
            t = os.path.getmtime(path)
        except OSError:
            return None
    return max(0.0, (time.time() if now is None else now) - float(t))


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def fit_axis_sizes(sizes: dict[str, int], n_devices: int) -> dict[str, int]:
    """The largest valid mesh over ``n_devices``: every non-``data`` axis
    keeps its size or shrinks to a divisor of it, ``data`` absorbs the
    rest (it may shrink or grow), and all ``n_devices`` are used. Among
    the feasible meshes the one with the largest non-data product wins,
    ties going to the innermost axes (``model``, ``seq``), whose sizes the
    model's config bakes in. -1 reads as 1."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    sizes = {a: (1 if v == -1 else int(v)) for a, v in sizes.items()}
    for a, v in sizes.items():
        if v < 1:
            raise ValueError(f"axis {a!r} has invalid size {v}")
    non_data = [a for a in MESH_AXIS_ORDER if a != "data" and a in sizes]
    best: tuple | None = None
    best_fit: dict[str, int] | None = None

    def search(i: int, chosen: dict[str, int], prod: int) -> None:
        nonlocal best, best_fit
        if i == len(non_data):
            if n_devices % prod:
                return
            fit = dict(sizes)
            fit.update(chosen)
            if "data" in sizes:
                fit["data"] = n_devices // prod
            elif prod != n_devices:
                return
            key = (prod, tuple(chosen[a] for a in reversed(non_data)))
            if best is None or key > best:
                best, best_fit = key, fit
            return
        axis = non_data[i]
        for d in _divisors(sizes[axis]):
            if prod * d <= n_devices:
                search(i + 1, {**chosen, axis: d}, prod * d)

    search(0, {}, 1)
    if best_fit is None:
        raise ValueError(
            f"no mesh over {n_devices} devices fits axis sizes {sizes} "
            f"(non-data axes cannot shrink to a divisor combination "
            f"dividing {n_devices})")
    return best_fit


def rescale_for_devices(global_batch: int, grad_accum: int, old_dp: int,
                        new_dp: int) -> tuple[int, int, bool]:
    """(global batch, grad accumulation, effective batch kept) for a
    data-parallel resize ``old_dp -> new_dp``: the per-device batch stays
    and the difference moves into accumulation, so ``global_batch *
    grad_accum`` (and the LR schedule) is unchanged; when that is not
    integral, the global batch stays (still the same effective batch);
    when even that does not divide ``new_dp``, the inputs come back with
    False."""
    if old_dp == new_dp or old_dp < 1 or new_dp < 1:
        return global_batch, grad_accum, old_dp == new_dp
    if global_batch % old_dp == 0 and (grad_accum * old_dp) % new_dp == 0:
        return (global_batch * new_dp // old_dp,
                grad_accum * old_dp // new_dp, True)
    if global_batch % new_dp == 0:
        return global_batch, grad_accum, True
    return global_batch, grad_accum, False


def write_device_report(ckpt_dir: str, *, visible_devices: int,
                        needed: int, mesh: dict) -> str:
    """Commit the rc-84 child's device report by atomic rename (the
    supervisor never reads a torn one); makes the directory when the run
    died before its first checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, DEVICE_REPORT_NAME)
    record = {
        "visible_devices": int(visible_devices),
        "needed": int(needed),
        "mesh": {a: int(v) for a, v in (mesh or {}).items()},
        "t": time.time(),
        "pid": os.getpid(),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(record, fh)
    os.replace(tmp, path)
    return path


def read_device_report(ckpt_dir: str) -> dict | None:
    """The rc-84 child's device report, or None when absent or torn."""
    try:
        with open(os.path.join(ckpt_dir, DEVICE_REPORT_NAME)) as fh:
            report = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    return report if isinstance(report, dict) else None


class CrashLoopBreaker:
    """Deterministic crashes against transient infrastructure: each failed
    attempt is recorded with its exit code, the child's last completed
    step (heartbeat) and the newest committed checkpoint step;
    ``threshold`` consecutive attempts with the same signature and no
    progress trip the breaker, and the supervisor stops with
    :meth:`report`. Any progress or another exit code resets the streak;
    a watchdog kill (``hung``) and a ``transient`` class (rc 85, rc 84)
    never feed it."""

    def __init__(self, threshold: int = 2):
        self.threshold = max(0, threshold)
        self._streak = 0
        self._last: tuple | None = None
        self.history: list[dict] = []

    def record(self, *, rc: int, last_step: int | None,
               ckpt_step: int | None, hung: bool = False,
               transient: bool = False) -> bool:
        """Register one failed attempt; True = stop retrying."""
        signature = (rc, last_step, ckpt_step)
        if hung or transient or self.threshold == 0:
            self._streak, self._last = 0, None
        elif signature == self._last:
            self._streak += 1
        else:
            self._streak, self._last = 1, signature
        self.history.append({
            "rc": rc,
            "last_step": last_step,
            "ckpt_step": ckpt_step,
            "hung": hung,
            "transient": transient,
            "streak": self._streak,
        })
        return self.threshold > 0 and self._streak >= self.threshold

    def report(self) -> dict:
        """The post-mortem for the operator and the telemetry stream."""
        last = self.history[-1] if self.history else {}
        return {
            "verdict": "deterministic_crash_loop",
            "streak": self._streak,
            "threshold": self.threshold,
            "rc": last.get("rc"),
            "last_step": last.get("last_step"),
            "ckpt_step": last.get("ckpt_step"),
            "attempts_recorded": len(self.history),
            "hint": (
                "the same failure reproduced at the same step with no "
                "checkpoint progress — relaunching cannot fix it; inspect "
                "the child's last log/telemetry (and any DTF_FAULTS spec) "
                "before retrying"
            ),
        }
