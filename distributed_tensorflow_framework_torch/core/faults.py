"""Deterministic fault injection: the port's copy of ``core/faults.py``
for the single-process, gang and multi-host fault kinds.

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
  drop_devices:N:S   before the single-process supervisor's Sth launch
                     (1-based; default 1) the child's world becomes N
                     ranks (cli/train_resilient.py's ``relaunch`` point).
                     A port device is a rank: the child is started as a
                     gang of N, so a mesh that needs another count exits
                     84 and is refit. The JAX package masks the virtual
                     CPU device count instead.
  kill_worker:W:T    SIGKILL gang worker W (0-based) at the gang
                     supervisor's Tth chaos tick (1-based; default 1); the
                     supervisor then stops the survivors and relaunches
                     the gang (cli/train_cluster.py ``gang_chaos``). The
                     tick clock starts once every worker has heartbeated.
  stall_worker:W:S   SIGSTOP gang worker W for S seconds, then SIGCONT (0 =
                     forever): its heartbeat goes stale while its peers
                     block in a collective.
  drop_worker:W:T    SIGKILL gang worker W at tick T and mark it lost for
                     good: the supervisor refits the mesh to the survivors
                     without using an attempt.
  corrupt_shard:K:P  rank K's Pth dataset pull (1-based; default 1) is
                     poisoned (data/pipeline.py ``data_chaos``): its
                     floating fields become NaN; a batch without one (an
                     MLM batch) scales that step's loss by NaN instead
                     (train/step.py ``fault_scale``), as nan_grads does.
  skew_shard:K:S     rank K's next dataset pull sleeps S seconds (0 =
                     forever): the straggler the infeed watchdog catches.

The JAX package's ``nan_grads`` and ``loss_spike`` scale the batch's
floating-point inputs, and a masked-LM batch has none (token ids, targets
and the mask are integers); the port scales the step's loss instead, so
the drills reach BERT (train/step.py ``fault_scale``).

The fleet kinds of the JAX registry raise a ValueError naming the
ROADMAP.md item that ports them. ``fire`` is serialized by a process-wide
lock, because the infeed point fires on the prefetch thread and the
checkpoint points on the saver thread. The ``worker=`` a call site passes
(the data pipeline's rank) keeps another rank's one-shot fault from
matching it. Stdlib only; an empty plan costs one check per fault point.
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
#   relaunch        cli/train_resilient.py, before launching attempt N
#                   (``step`` carries the 1-based attempt ordinal)
#   gang_chaos      cli/train_cluster.py, each supervisor tick once the
#                   whole gang has heartbeated (``step``: the 1-based
#                   tick); the supervisor applies the faults to its ranks
#   data_chaos      data/pipeline.py, each HostDataset pull (``step``: the
#                   1-based pull ordinal, ``worker``: the rank's shard
#                   index), applied by the pulling rank itself
KIND_POINTS = {
    "crash_at_step": "step_begin",
    "nan_grads": "step_begin",
    "loss_spike": "step_begin",
    "repeat_nan": "step_begin",
    "stall_infeed": "infeed",
    "crash_in_save": "ckpt_in_save",
    "corrupt_ckpt": "ckpt_committed",
    "drop_devices": "relaunch",
    "kill_worker": "gang_chaos",
    "stall_worker": "gang_chaos",
    "drop_worker": "gang_chaos",
    "corrupt_shard": "data_chaos",
    "skew_shard": "data_chaos",
}
# The JAX registry's other kinds and the ROADMAP.md item that ports them:
# the fleet slice's (the router's replica kills and stalls, traffic
# spikes, tenant stampedes and ``corrupt_reload``, which the JAX fleet
# fires at its rolling reload).
NOT_PORTED = {
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
    # drop_devices: the world the child is started in.
    devices: int | None = None
    # kill_worker / stall_worker / drop_worker: the 0-based gang process
    # id; corrupt_shard / skew_shard: the 0-based rank whose pulls it
    # poisons (matched against the ``worker=`` the pipeline passes).
    worker: int | None = None
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

    def matches(self, point: str, step: int | None,
                worker: int | None = None) -> bool:
        if self.fired or point != self.point:
            return False
        if self.step is not None:
            if step is None or not (
                    self.step <= step < self.step + self.count):
                return False
        # Only a call site that names itself (data_chaos passes the
        # pulling rank) is filtered: another rank must not consume the
        # one-shot fault. gang_chaos passes none; the supervisor applies
        # the fault to the worker it names.
        if (self.worker is not None and worker is not None
                and self.worker != worker):
            return False
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
    elif kind == "drop_devices":
        head, _, tail = arg.partition(":")
        try:
            fault.devices = int(head)
            fault.step = int(tail) if tail else 1
        except ValueError:
            raise ValueError(
                f"fault drop_devices needs devices[:attempt] (e.g. "
                f"drop_devices:4:2), got {arg!r}") from None
        if fault.devices < 1 or fault.step < 1:
            raise ValueError(
                f"fault drop_devices needs devices >= 1 and attempt >= 1, "
                f"got {arg!r}")
    elif kind in ("kill_worker", "drop_worker"):
        head, _, tail = arg.partition(":")
        try:
            fault.worker = int(head)
            fault.step = int(tail) if tail else 1
        except ValueError:
            raise ValueError(
                f"fault {kind} needs worker[:tick] (e.g. {kind}:1:3), got "
                f"{arg!r}") from None
        if fault.worker < 0 or fault.step < 1:
            raise ValueError(
                f"fault {kind} needs worker >= 0 and tick >= 1, got "
                f"{arg!r}")
    elif kind == "stall_worker":
        head, _, tail = arg.partition(":")
        raw = tail[:-1] if tail.endswith("s") else tail
        try:
            fault.worker = int(head)
            fault.seconds = float(raw) if raw else 0.0
        except ValueError:
            raise ValueError(
                f"fault stall_worker needs worker:seconds (e.g. "
                f"stall_worker:1:10s), got {arg!r}") from None
        if fault.worker < 0:
            raise ValueError(
                f"fault stall_worker worker must be >= 0, got {arg!r}")
        if fault.seconds == 0.0:
            fault.seconds = _STALL_FOREVER_S
        fault.step = 1  # the first tick, as kill_worker's default
    elif kind == "corrupt_shard":
        head, _, tail = arg.partition(":")
        try:
            fault.worker = int(head)
            fault.step = int(tail) if tail else 1
        except ValueError:
            raise ValueError(
                f"fault corrupt_shard needs host[:pull] (e.g. "
                f"corrupt_shard:1:3), got {arg!r}") from None
        if fault.worker < 0 or fault.step < 1:
            raise ValueError(
                f"fault corrupt_shard needs host >= 0 and pull >= 1, got "
                f"{arg!r}")
    elif kind == "skew_shard":
        head, _, tail = arg.partition(":")
        raw = tail[:-1] if tail.endswith("s") else tail
        try:
            fault.worker = int(head)
            fault.seconds = float(raw) if raw else 0.0
        except ValueError:
            raise ValueError(
                f"fault skew_shard needs host:seconds (e.g. "
                f"skew_shard:1:10s), got {arg!r}") from None
        if fault.worker < 0:
            raise ValueError(
                f"fault skew_shard host must be >= 0, got {arg!r}")
        if fault.seconds == 0.0:
            fault.seconds = _STALL_FOREVER_S
        # No pull ordinal: the rank's next pull after arming.
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
    def from_env(cls, env: dict | None = None) -> "FaultPlan":
        env = os.environ if env is None else env
        return cls.parse(env.get(ENV_VAR, ""),
                         state_path=env.get(STATE_ENV_VAR) or None)

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

    def fire(self, point: str, *, step: int | None = None,
             worker: int | None = None) -> list[Fault]:
        """Execute the self-contained faults matching this point (crash,
        stall) and return the ones the caller applies (nan_grads,
        loss_spike, repeat_nan, corrupt_ckpt, the gang and data kinds);
        ``worker`` lets a call site that is one rank claim only the
        faults aimed at it. Matching and recording run under the
        process-wide lock, so two threads never claim one fault."""
        with _FIRE_LOCK:
            matched = [f for f in self.faults
                       if f.matches(point, step, worker)]
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


def fire(point: str, *, step: int | None = None,
         worker: int | None = None) -> list[Fault]:
    """Fire the process plan at a fault point; a no-op when inactive."""
    plan = active_plan()
    if not plan.active:
        return []
    return plan.fire(point, step=step, worker=worker)


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
