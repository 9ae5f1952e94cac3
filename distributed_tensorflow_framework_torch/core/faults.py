"""Deterministic fault injection: the port's copy of ``core/faults.py``
for the single-process fault kinds.

The same ``DTF_FAULTS`` variable and grammar (comma-separated
``kind:arg`` entries) and the same ``DTF_FAULTS_STATE`` file, which
records each firing before it executes so that a relaunched process does
not fire it again:

  crash_at_step:N    SIGKILL this process right before step N runs.
  crash_in_save:N    SIGKILL between the step-N checkpoint's payload write
                     and its manifest commit (an uncommitted directory).
  corrupt_ckpt:WHAT  after the next checkpoint commits, truncate its
                     largest payload file (a committed-but-torn step that
                     restore must quarantine). WHAT is a label for logs.
  stall_infeed:S[:P] one dataset pull sleeps S seconds (suffix ``s``
                     optional; 0 = six hours); with P, the Pth pull of the
                     process (1-based) instead of the first.
  nan_grads:N        step N's loss and gradients are multiplied by NaN.
  loss_spike:N       step N's loss and gradients are multiplied by 1e4: a
                     finite jump that only the EWMA z-score catches.
  repeat_nan:N:K     nan_grads on every step in [N, N+K), K firings in all,
                     so replays after a rollback are poisoned again.

The JAX package's ``nan_grads`` and ``loss_spike`` scale the batch's
floating-point inputs, and a masked-LM batch has none (token ids, targets
and the mask are integers); the port scales the step's loss instead, so
the drills reach BERT (train/step.py ``fault_scale``).

The fleet, gang and multi-host kinds of the JAX registry raise a
ValueError naming the ROADMAP.md item that ports them. ``fire`` is
serialized by a process-wide lock, because the infeed point fires on the
prefetch thread and the checkpoint points on the saver thread. Stdlib
only; an empty plan costs one check per fault point.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass, field

log = logging.getLogger(__name__)

ENV_VAR = "DTF_FAULTS"
STATE_ENV_VAR = "DTF_FAULTS_STATE"

# Fault kind -> the point it fires at:
#   step_begin      train/loop.py, before dispatching each step
#   infeed          data/pipeline.py, each HostDataset pull
#   ckpt_in_save    ckpt/checkpoint.py, after the payload / before manifest
#   ckpt_committed  ckpt/checkpoint.py, after the manifest commit
KIND_POINTS = {
    "crash_at_step": "step_begin",
    "nan_grads": "step_begin",
    "loss_spike": "step_begin",
    "repeat_nan": "step_begin",
    "stall_infeed": "infeed",
    "crash_in_save": "ckpt_in_save",
    "corrupt_ckpt": "ckpt_committed",
}
# The JAX registry's other kinds and the ROADMAP.md item that ports each:
# A17 the gang and multi-host kinds; A15 the fleet slice's kinds (the
# router's replica kills and stalls, traffic spikes, tenant stampedes and
# ``corrupt_reload``, which the JAX fleet fires at its rolling reload).
NOT_PORTED = {
    "drop_devices": "A17", "kill_worker": "A17", "stall_worker": "A17",
    "drop_worker": "A17", "corrupt_shard": "A17", "skew_shard": "A17",
    "kill_replica": "A15", "stall_replica": "A15", "spike": "A15",
    "tenant_stampede": "A15", "corrupt_reload": "A15",
}
_STEP_KINDS = ("crash_at_step", "crash_in_save", "nan_grads", "loss_spike")
_STALL_FOREVER_S = 6 * 3600.0
# loss_spike's factor: the JAX package scales the inputs by the same.
LOSS_SPIKE_FACTOR = 1e4


@dataclass
class Fault:
    kind: str
    arg: str = ""
    step: int | None = None
    seconds: float | None = None
    # A fault may fire at `count` steps of [step, step + count)
    # (repeat_nan); it is spent once `fires` reaches it.
    count: int = 1
    fires: int = 0
    fired: bool = False

    @property
    def point(self) -> str:
        return KIND_POINTS[self.kind]

    @property
    def fault_id(self) -> str:
        return f"{self.kind}:{self.arg}" if self.arg else self.kind

    def matches(self, point: str, step: int | None) -> bool:
        if self.fired or point != self.point:
            return False
        if self.step is not None:
            return step is not None and (
                self.step <= step < self.step + self.count)
        return True


def _parse_one(entry: str) -> Fault:
    kind, _, arg = entry.partition(":")
    kind, arg = kind.strip(), arg.strip()
    if kind in NOT_PORTED:
        raise ValueError(
            f"fault kind {kind!r} in {ENV_VAR} entry {entry!r} is not ported "
            f"yet — ROADMAP.md queue A item {NOT_PORTED[kind]}")
    if kind not in KIND_POINTS:
        raise ValueError(
            f"unknown fault kind {kind!r} in {ENV_VAR} entry {entry!r}; "
            f"known kinds: {sorted(KIND_POINTS)}")
    fault = Fault(kind=kind, arg=arg)
    if kind in _STEP_KINDS:
        try:
            fault.step = int(arg)
        except ValueError:
            raise ValueError(
                f"fault {kind!r} needs an integer step, got {arg!r}") from None
        if fault.step < 1:
            raise ValueError(f"fault {kind!r} step must be >= 1, got {arg!r}")
    elif kind == "repeat_nan":
        head, _, tail = arg.partition(":")
        try:
            fault.step, fault.count = int(head), int(tail)
        except ValueError:
            raise ValueError(
                f"fault repeat_nan needs start:count (e.g. repeat_nan:30:5), "
                f"got {arg!r}") from None
        if fault.step < 1 or fault.count < 1:
            raise ValueError(
                f"fault repeat_nan needs step >= 1 and count >= 1, got "
                f"{arg!r}")
    elif kind == "stall_infeed":
        dur, _, ordinal = arg.partition(":")
        raw = dur[:-1] if dur.endswith("s") else dur
        try:
            fault.seconds = float(raw) if raw else 0.0
        except ValueError:
            raise ValueError(
                f"fault stall_infeed needs a duration (e.g. 30s), got "
                f"{arg!r}") from None
        if fault.seconds == 0.0:
            fault.seconds = _STALL_FOREVER_S
        if ordinal:
            try:
                fault.step = int(ordinal)
            except ValueError:
                raise ValueError(
                    f"fault stall_infeed ordinal must be an integer (e.g. "
                    f"stall_infeed:3s:4), got {arg!r}") from None
            if fault.step < 1:
                raise ValueError(
                    f"fault stall_infeed ordinal must be >= 1, got {arg!r}")
    return fault


@dataclass
class FaultPlan:
    """A parsed fault spec plus per-run fired-state tracking."""

    faults: list[Fault] = field(default_factory=list)
    state_path: str | None = None

    @classmethod
    def parse(cls, spec: str, *, state_path: str | None = None
              ) -> "FaultPlan":
        plan = cls(faults=[_parse_one(e) for e in
                           (e.strip() for e in spec.split(",")) if e],
                   state_path=state_path)
        fired = plan._fired_ids()
        for f in plan.faults:
            f.fired = f.fault_id in fired
        return plan

    @classmethod
    def from_env(cls) -> "FaultPlan":
        return cls.parse(os.environ.get(ENV_VAR, ""),
                         state_path=os.environ.get(STATE_ENV_VAR) or None)

    @property
    def active(self) -> bool:
        return bool(self.faults)

    def _fired_ids(self) -> set[str]:
        if not self.state_path or not os.path.exists(self.state_path):
            return set()
        try:
            with open(self.state_path) as fh:
                return set(json.load(fh))
        except (OSError, json.JSONDecodeError):
            return set()

    def _record_fired(self, fault: Fault) -> None:
        fault.fires += 1
        fault.fired = fault.fires >= fault.count
        if not self.state_path:
            return
        ids = self._fired_ids() | {fault.fault_id}
        tmp = f"{self.state_path}.{os.getpid()}.tmp"
        # fsync before a crash fault executes: the record must survive the
        # SIGKILL it is about to cause, or the fault re-fires forever.
        with open(tmp, "w") as fh:
            json.dump(sorted(ids), fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.state_path)

    def fire(self, point: str, *, step: int | None = None) -> list[Fault]:
        """Execute the self-contained faults matching this point (crash,
        stall) and return the ones the caller applies (nan_grads,
        loss_spike, repeat_nan, corrupt_ckpt). Matching and recording run
        under the process-wide lock, so two threads never claim one
        fault."""
        with _FIRE_LOCK:
            matched = [f for f in self.faults if f.matches(point, step)]
            for fault in matched:
                self._record_fired(fault)
        handled = []
        for fault in matched:
            print(f"DTF_FAULTS: firing {fault.fault_id} at point {point!r} "
                  f"(step={step}, thread={threading.current_thread().name})",
                  file=sys.stderr, flush=True)
            if fault.kind in ("crash_at_step", "crash_in_save"):
                # The process, not the thread: from the saver thread this
                # still models a machine-level kill racing the commit.
                os.kill(os.getpid(), signal.SIGKILL)
                os._exit(137)  # unreachable on POSIX
            elif fault.kind == "stall_infeed":
                time.sleep(fault.seconds or 0.0)  # outside the lock
            else:
                handled.append(fault)
        return handled


_FIRE_LOCK = threading.Lock()
_plan: FaultPlan | None = None


def active_plan() -> FaultPlan:
    """The process plan, parsed from the environment on first use."""
    global _plan
    if _plan is None:
        _plan = FaultPlan.from_env()
        if _plan.active:
            log.warning("fault injection ACTIVE: %s",
                        ", ".join(f.fault_id for f in _plan.faults))
    return _plan


def install(plan: FaultPlan | str | None) -> FaultPlan:
    """Set the process plan (a spec string or a FaultPlan), or with None
    clear it so the next use re-reads the environment."""
    global _plan
    _plan = FaultPlan.parse(plan) if isinstance(plan, str) else plan
    return active_plan()


def fire(point: str, *, step: int | None = None) -> list[Fault]:
    """Fire the process plan at a fault point; a no-op when inactive."""
    plan = active_plan()
    if not plan.active:
        return []
    return plan.fire(point, step=step)


def corrupt_checkpoint_dir(step_dir: str) -> str | None:
    """Truncate the largest payload file of a step directory to half its
    size (the corrupt_ckpt effect). Returns its path, or None when there
    is nothing to corrupt."""
    from distributed_tensorflow_framework_torch.ckpt import manifest as mf

    best, best_size = None, -1
    for rel in mf.iter_payload_files(step_dir):
        path = os.path.join(step_dir, rel)
        size = os.path.getsize(path)
        if size > best_size:
            best, best_size = path, size
    if best is None:
        return None
    with open(best, "r+b") as fh:
        fh.truncate(best_size // 2)
    log.warning("corrupt_ckpt fault: truncated %s from %d to %d bytes",
                best, best_size, best_size // 2)
    return best
