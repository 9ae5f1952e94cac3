"""In-process anomaly detection and in-memory rollback: the port's copy
of ``train/anomaly.py``.

The recovery ladder's first rungs:

  detect (here) → roll back + skip the batches (train/loop.py) →
  re-warm the LR (optional) → escalate (``PersistentAnomalyError`` →
  rc 85, core/supervision.py) only when the anomaly survives
  ``max_rollbacks`` consecutive rollbacks.

Detection reads only metrics the trainer already fetched at its log
cadence, so the ladder adds no device syncs. The rollback ring holds host
copies of the train state (``TrainState.state_dict``): a real copy taken
at a step boundary, since torch updates the live tensors in place and on
the CPU ``tensor.to("cpu")`` would be the live tensor itself. A rollback
restores the model state only: the data iterator is not rewound, so the
batches consumed between the snapshot and the anomaly are skipped, and the
replayed step range trains on fresh data.

Every rung emits telemetry (``anomaly_detected``, ``rollback``,
``batch_skipped``).
"""

from __future__ import annotations

import collections
import logging
import math
from dataclasses import dataclass, field
from typing import Any, Mapping

from distributed_tensorflow_framework_torch.core import telemetry
from distributed_tensorflow_framework_torch.core.config import ResilienceConfig
from distributed_tensorflow_framework_torch.train.state import host_copy

log = logging.getLogger(__name__)


class PersistentAnomalyError(FloatingPointError):
    """The recovery ladder is exhausted: ``max_rollbacks`` consecutive
    rollbacks each landed back on an anomalous step (a poisoned data
    region, not a transient). Subclasses FloatingPointError so callers of
    the pre-ladder NaNGuardHook contract keep catching it; cli/train.py
    maps it to supervision.ANOMALY_ESCALATION_RC so the supervisor can
    classify the relaunch without feeding the crash-loop breaker.
    """

    def __init__(self, message: str, provenance: dict | None = None):
        super().__init__(message)
        self.provenance = provenance or {}


@dataclass
class Verdict:
    """One anomalous classification: what fired, on which metric."""

    anomaly: str            # non_finite_metric | loss_spike | grad_norm_explosion
    metric: str
    value: float | str
    step: int
    detail: dict = field(default_factory=dict)

    def to_health(self) -> dict:
        return {"anomaly": self.anomaly, "metric": self.metric,
                "value": str(self.value), **self.detail}


class AnomalyDetector:
    """Classify a step from its already-fetched host metrics.

    Three checks, cheapest first:
      * non-finite value in ANY numeric metric (the NanTensorHook class);
      * finite ``grad_norm`` above the hard ceiling ``grad_norm_max``;
      * ``loss`` more than ``loss_spike_zscore`` EWMA standard deviations
        above its running mean (needs ``min_observations`` clean fetches
        of warmup before it may fire — a cold EWMA has no baseline).

    ``observe`` feeds the EWMA and must only be called with CLEAN metrics
    — an anomalous loss folded into the baseline would teach the detector
    that spikes are normal.
    """

    def __init__(self, cfg: ResilienceConfig):
        self.cfg = cfg
        self._n = 0
        self._mean = 0.0
        self._var = 0.0

    @property
    def observations(self) -> int:
        return self._n

    @property
    def std(self) -> float:
        # Relative floor: a near-constant loss has ~zero EWMA variance and
        # would flag numeric jitter as an infinite-z spike.
        return max(math.sqrt(max(self._var, 0.0)),
                   1e-3 * abs(self._mean), 1e-8)

    def observe(self, metrics: Mapping[str, float]) -> None:
        loss = _finite_float(metrics.get("loss"))
        if loss is None:
            return
        if self._n == 0:
            self._mean, self._var = loss, 0.0
        else:
            beta = self.cfg.loss_ewma_beta
            diff = loss - self._mean
            self._mean += (1.0 - beta) * diff
            self._var = beta * (self._var + (1.0 - beta) * diff * diff)
        self._n += 1

    def classify(self, step: int, metrics: Mapping[str, float]) -> Verdict | None:
        for name, v in metrics.items():
            try:
                val = float(v)
            except (TypeError, ValueError):
                continue
            if not math.isfinite(val):
                return Verdict("non_finite_metric", name, v, step)
        gmax = self.cfg.grad_norm_max
        gnorm = _finite_float(metrics.get("grad_norm"))
        if gmax > 0 and gnorm is not None and gnorm > gmax:
            return Verdict("grad_norm_explosion", "grad_norm", gnorm, step,
                           detail={"grad_norm_max": gmax})
        zmax = self.cfg.loss_spike_zscore
        loss = _finite_float(metrics.get("loss"))
        if (zmax > 0 and loss is not None
                and self._n >= max(1, self.cfg.min_observations)):
            z = (loss - self._mean) / self.std
            if z > zmax:
                return Verdict("loss_spike", "loss", loss, step,
                               detail={"zscore": round(z, 2),
                                       "ewma_mean": round(self._mean, 6),
                                       "ewma_std": round(self.std, 6)})
        return None


def _finite_float(v: Any) -> float | None:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


# ---------------------------------------------------------------- snapshots

def snapshot_state(state: Any) -> dict:
    """A host copy of ``state.state_dict()``."""
    return host_copy(state.state_dict())


def restore_state(host: dict, live: Any) -> Any:
    """Load a ``snapshot_state`` copy into the live state in place and
    return it. The optimizer takes over the tensors it is given, so it
    gets a fresh copy: the snapshot stays as it was for a later rollback."""
    live.load_state_dict(host_copy(host))
    return live


@dataclass
class Snapshot:
    step: int
    host: Any
    data_state: dict | None = None


class SnapshotRing:
    """Bounded ring of in-memory state snapshots, newest-last."""

    def __init__(self, depth: int):
        self._ring: collections.deque[Snapshot] = collections.deque(
            maxlen=max(1, depth))

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def steps(self) -> list[int]:
        return [s.step for s in self._ring]

    def push(self, snap: Snapshot) -> None:
        self._ring.append(snap)

    def latest(self) -> Snapshot:
        return self._ring[-1]


# ------------------------------------------------------------------ manager

class RecoveryManager:
    """Policy + state for the in-process recovery ladder.

    Owned by the Trainer; the loop calls ``classify`` at every metric
    fetch, ``take_snapshot`` opportunistically on clean steps, and
    ``rollback`` on an anomaly while ``can_rollback()`` holds. When it
    does not, the loop sets ``exhausted`` and lets the anomalous metrics
    flow to the hooks — NaNGuardHook (the escalation tail) raises
    ``PersistentAnomalyError`` with the provenance collected here.
    """

    def __init__(self, cfg: ResilienceConfig,
                 telemetry_writer: telemetry.TelemetryWriter | None = None):
        self.cfg = cfg
        self.detector = AnomalyDetector(cfg)
        self.ring = SnapshotRing(cfg.snapshot_depth)
        self._telemetry = telemetry_writer
        self.consecutive_rollbacks = 0
        self.total_rollbacks = 0
        self.anomalies_detected = 0
        self.exhausted = False
        self.last_verdict: Verdict | None = None
        self._last_snapshot_step: int | None = None

    # -- telemetry helper -------------------------------------------------
    def _emit(self, kind: str, step: int, health: dict) -> None:
        if self._telemetry is not None:
            self._telemetry.emit(kind, step=step, health=health)

    # -- snapshots --------------------------------------------------------
    def take_snapshot(self, step: int, state: Any,
                      data_state: dict | None = None,
                      force: bool = False) -> bool:
        if (not force and self._last_snapshot_step is not None
                and step - self._last_snapshot_step
                < max(1, self.cfg.snapshot_interval_steps)):
            return False
        self.ring.push(Snapshot(step=step, host=snapshot_state(state),
                                data_state=dict(data_state or {})))
        self._last_snapshot_step = step
        return True

    # -- classification ---------------------------------------------------
    def classify(self, step: int, metrics: Mapping[str, float]) -> Verdict | None:
        """Classify one fetched-metrics step. Clean steps feed the EWMA
        baseline and reset the consecutive-rollback streak; anomalous
        steps emit ``anomaly_detected`` and return the verdict."""
        verdict = self.detector.classify(step, metrics)
        if verdict is None:
            self.detector.observe(metrics)
            self.consecutive_rollbacks = 0
            return None
        self.last_verdict = verdict
        self.anomalies_detected += 1
        log.warning(
            "anomaly detected at step %d: %s (%s=%s)",
            step, verdict.anomaly, verdict.metric, verdict.value,
        )
        self._emit(
            telemetry.KIND_ANOMALY, step,
            {**verdict.to_health(),
             "consecutive_rollbacks": self.consecutive_rollbacks},
        )
        return verdict

    # -- rollback ---------------------------------------------------------
    def can_rollback(self) -> bool:
        return (len(self.ring) > 0
                and self.consecutive_rollbacks < self.cfg.max_rollbacks)

    def rollback(self, live_state: Any, from_step: int) -> tuple[Any, Snapshot]:
        """Restore the newest snapshot; returns ``(state, snapshot)``.
        Emits ``rollback`` and ``batch_skipped`` — the skipped range is
        the data consumed between the snapshot and the anomaly, which the
        resumed stream will never replay (skip-batch semantics)."""
        snap = self.ring.latest()
        state = restore_state(snap.host, live_state)
        self.consecutive_rollbacks += 1
        self.total_rollbacks += 1
        log.warning(
            "rolling back: step %d -> %d (rollback %d/%d this incident, "
            "%d total)", from_step, snap.step, self.consecutive_rollbacks,
            self.cfg.max_rollbacks, self.total_rollbacks,
        )
        self._emit(telemetry.KIND_ROLLBACK, from_step, {
            "from_step": from_step, "to_step": snap.step,
            "consecutive_rollbacks": self.consecutive_rollbacks,
        })
        self._emit(telemetry.KIND_BATCH_SKIPPED, from_step, {
            "from_step": snap.step + 1, "to_step": from_step,
            "batches": from_step - snap.step,
        })
        return state, snap

    # -- escalation -------------------------------------------------------
    def provenance(self) -> dict:
        v = self.last_verdict
        return {
            "anomaly": v.anomaly if v else None,
            "metric": v.metric if v else None,
            "value": str(v.value) if v else None,
            "step": v.step if v else None,
            "consecutive_rollbacks": self.consecutive_rollbacks,
            "max_rollbacks": self.cfg.max_rollbacks,
            "total_rollbacks": self.total_rollbacks,
            "snapshot_steps": self.ring.steps,
        }

    def escalation_message(self) -> str:
        v = self.last_verdict
        what = (f"{v.anomaly} ({v.metric}={v.value}) at step {v.step}"
                if v else "anomaly")
        if len(self.ring) == 0:
            why = "no snapshot available to roll back to"
        else:
            why = (f"{self.consecutive_rollbacks} consecutive rollbacks "
                   f"all landed back on a bad step (max_rollbacks="
                   f"{self.cfg.max_rollbacks})")
        return (
            f"Persistent anomaly: {what} — {why}. Escalating to the "
            f"supervisor (rc=ANOMALY_ESCALATION_RC): this looks like a "
            f"poisoned data region or a deterministic numeric bug, not a "
            f"transient."
        )
