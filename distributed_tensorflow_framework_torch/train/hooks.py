"""Training hooks: the port's copy of ``train/hooks.py``'s NaN guard,
throughput, logging, eval, checkpoint, heartbeat and MoE collapse hooks.

Hooks only ever see host-side metric values the trainer already fetched,
so they never force an extra device sync. Across ranks every rank runs
the same hooks at the same steps, as in the JAX trainer: the logging hook
writes through the chief-only ``MetricWriter``, the checkpoint hook's
manager writes on the chief alone (core/metrics.py, ckpt/checkpoint.py),
and each rank beats its own heartbeat file (``heartbeat-p<i>.json``,
core/cluster.py). The profile hook captures a Kineto trace over a window
of steps on the chief (core/profiling.py), and the checkpoint hook saves
under a ``ckpt.save`` span when the trainer carries a tracer.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time

import torch

from distributed_tensorflow_framework_torch.core import profiling, telemetry
from distributed_tensorflow_framework_torch.core.metrics import (
    ThroughputMeter,
)
from distributed_tensorflow_framework_torch.train.anomaly import (
    PersistentAnomalyError,
)

log = logging.getLogger(__name__)


class BaseHook:
    """``after_step`` sees the fetched metrics at log steps, None at the
    steps between."""

    def on_start(self, trainer) -> None:
        pass

    def after_step(self, trainer, step, metrics) -> None:
        pass

    def on_end(self, trainer) -> None:
        pass


class NaNGuardHook(BaseHook):
    """Abort when a fetched metric goes non-finite (the NanTensorHook
    contract). Checks only at metric-fetch steps (``metrics`` is None
    otherwise) and records a ``failure`` event naming the metric, the step
    and the last committed checkpoint before raising. With the recovery
    ladder armed it is the ladder's escalation tail: a rolled-back anomaly
    never reaches it, so a non-finite value here means the ladder is
    exhausted, and the abort is a ``PersistentAnomalyError`` (rc 85)."""

    def after_step(self, trainer, step, metrics) -> None:
        if metrics is None:
            return
        for name, v in metrics.items():
            try:
                val = float(v)
            except (TypeError, ValueError):
                continue
            if not math.isfinite(val):
                ckpt = self._last_good_checkpoint(trainer)
                trainer.writer.telemetry.emit(
                    telemetry.KIND_FAILURE, step=step,
                    health={"failure": "non_finite_metric", "metric": name,
                            "value": str(v),
                            "last_good_checkpoint": ckpt or ""})
                restart = (f"restart from {ckpt}" if ckpt else
                           "no checkpoint saved — restart from scratch")
                rec = getattr(trainer, "recovery", None)
                if rec is not None and rec.exhausted:
                    raise PersistentAnomalyError(
                        f"{rec.escalation_message()} Non-finite metric "
                        f"{name}={v} at step {step}. Last good checkpoint: "
                        f"{restart}.", provenance=rec.provenance())
                raise FloatingPointError(
                    f"Non-finite metric {name}={v} at step {step} — aborting "
                    f"(NaNGuardHook). Last good checkpoint: {restart}.")

    @staticmethod
    def _last_good_checkpoint(trainer) -> str | None:
        mgr = getattr(trainer, "_ckpt_manager", None)
        last = mgr.latest_step() if mgr is not None else None
        return None if last is None else os.path.join(mgr.directory,
                                                       str(last))


class ThroughputHook(BaseHook):
    """Tracks examples/sec(/chip) over each logging window."""

    def __init__(self, batch_size: int, num_chips: int):
        self.batch_size = batch_size
        self.meter = ThroughputMeter(num_chips)

    def on_start(self, trainer) -> None:
        self.meter.start()

    def after_step(self, trainer, step, metrics) -> None:
        self.meter.update(self.batch_size)

    def rates(self) -> dict[str, float]:
        return self.meter.rates()


class LoggingHook(BaseHook):
    def __init__(self, writer, interval: int,
                 throughput: ThroughputHook | None = None):
        self.writer = writer
        self.interval = max(1, interval)
        self.throughput = throughput

    def after_step(self, trainer, step, metrics) -> None:
        # The trainer fetches metrics only at its log cadence; the interval
        # here also guards loops that fetch more often (the last step
        # always logs).
        if metrics is None:
            return
        if step % self.interval and step < trainer.config.train.total_steps:
            return
        out = dict(metrics)
        if self.throughput is not None:
            out.update(self.throughput.rates())
            self.throughput.meter.reset()
        self.writer.write(step, out, collectives=getattr(
            trainer, "collectives_summary", None))


class EvalHook(BaseHook):
    """Mid-training eval every ``interval`` steps, ``num_batches`` batches
    per firing (train.eval_steps)."""

    def __init__(self, eval_fn, interval: int, *,
                 num_batches: int | None = None):
        self.eval_fn = eval_fn
        self.interval = max(1, interval)
        self.num_batches = num_batches

    def after_step(self, trainer, step, metrics) -> None:
        if step > 0 and step % self.interval == 0:
            self.eval_fn(step, num_batches=self.num_batches)


class CheckpointHook(BaseHook):
    """Interval saver. With ``checkpoint.async_save`` on, ``save`` returns
    after the device → host copy and the commit lands on the saver thread.
    ``on_end`` is the flush: a forced save of the final step (also on the
    SIGTERM path, rc 83), then the exit barrier, so the trainer never
    returns with a commit in flight."""

    def __init__(self, manager, interval: int):
        self.manager = manager
        self.interval = max(1, interval)

    def _traced_save(self, trainer, step: int, *, force: bool = False):
        """Save under a ``ckpt.save`` span when the trainer carries a
        tracer and a run span (core/tracing.py); with async saves the span
        covers the device → host copy the loop waits for, not the commit
        on the saver thread."""
        tracer = getattr(trainer, "tracer", None)
        run_span = getattr(trainer, "run_span", None)
        span = (tracer.start("ckpt.save", run_span, step=step, force=force)
                if tracer is not None and run_span is not None else None)
        try:
            self.manager.save(step, trainer.state,
                              dataset_state=trainer.data_ckpt_state)
        finally:
            if span is not None:
                span.end()

    def after_step(self, trainer, step, metrics) -> None:
        if step > 0 and step % self.interval == 0:
            self._traced_save(trainer, step)

    def on_end(self, trainer) -> None:
        self._traced_save(trainer, int(trainer.host_step), force=True)
        self.manager.wait_until_finished()


class ProfileHook(BaseHook):
    """A Kineto trace over steps (start, stop] (core/profiling.py), the
    JAX ProfileHook's window: the trace opens after step ``start`` and
    closes after step ``stop``, when the card has finished the window's
    work (a synchronize, as the JAX hook blocks on the parameters); a run
    that ends inside the window closes it in ``on_end``. The card is
    synchronized when the window opens too, so the trace holds exactly
    the window's steps."""

    def __init__(self, logdir: str, start: int, stop: int):
        self.logdir = logdir
        # after_step first fires at step=1, so a start of 0 means "from the
        # beginning"; the trace then covers steps (start, stop].
        self.start = max(1, start)
        self.stop = stop
        self._prof = None  # the open window

    @staticmethod
    def _sync(trainer) -> None:
        device = getattr(trainer, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def after_step(self, trainer, step, metrics) -> None:
        if self.start <= step < self.stop and self._prof is None:
            self._sync(trainer)
            self._prof = profiling.start_trace()
        elif step >= self.stop and self._prof is not None:
            self._close(trainer)

    def on_end(self, trainer) -> None:
        if self._prof is not None:
            self._close(trainer)

    def _close(self, trainer) -> None:
        self._sync(trainer)
        prof, self._prof = self._prof, None
        log.info("wrote profile trace %s",
                 profiling.stop_trace(prof, self.logdir))


class HeartbeatHook(BaseHook):
    """Liveness file for an external watchdog: every ``min_interval_s`` of
    wall time, atomically rewrites a small JSON record (run id, pid, the
    last completed step, the time, the last fetched metrics), so a
    supervisor tells "slow" from "wedged" by the record's age. A
    pid-suffixed temp file, fsync'd, then one ``os.replace``: readers see
    the old record or the new one, never a torn file."""

    def __init__(self, path: str, *, min_interval_s: float = 10.0):
        self.path = path
        self.min_interval_s = min_interval_s
        self._last_write = 0.0
        self._last_metrics: dict | None = None

    def on_start(self, trainer) -> None:
        self._write(trainer, step=int(trainer.host_step), status="running")

    def after_step(self, trainer, step, metrics) -> None:
        if metrics is not None:
            self._last_metrics = {k: float(v) for k, v in metrics.items()}
        now = time.time()
        if now - self._last_write >= self.min_interval_s:
            self._write(trainer, step=step, status="running", now=now)

    def on_end(self, trainer) -> None:
        status = ("preempted" if getattr(trainer, "preempted", False)
                  else "finished")
        self._write(trainer, step=int(trainer.host_step), status=status)

    def _write(self, trainer, *, step, status, now=None) -> None:
        now = time.time() if now is None else now
        self._last_write = now
        record = {
            "schema": telemetry.SCHEMA,
            "run_id": trainer.writer.telemetry.run_id,
            "status": status,
            "step": step,
            "last_completed_step": step,
            "t": now,
            "pid": os.getpid(),
            "last_metrics": self._last_metrics,
        }
        tmp = f"{self.path}.{os.getpid()}.tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(tmp, "w") as fh:
            json.dump(record, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)


class MoECollapseHook(BaseHook):
    """Detects expert-routing collapse from the fetched step metrics:
    ``moe_drop_frac`` above ``drop_frac_threshold`` (tokens racing to one
    expert, the rest dropped by capacity) or ``moe_aux_loss`` above
    ``aux_loss_threshold`` (balanced routing gives ~1.0). Once a threshold
    holds for ``patience`` consecutive fetches it logs a structured
    warning and emits a ``health`` event with each violation's
    ``*_value``; it never stops the run."""

    def __init__(self, *, drop_frac_threshold: float = 0.35,
                 aux_loss_threshold: float = 2.0, patience: int = 2):
        self.drop_frac_threshold = drop_frac_threshold
        self.aux_loss_threshold = aux_loss_threshold
        self.patience = max(1, patience)
        self._streak = 0
        self.fired_steps: list[int] = []

    def after_step(self, trainer, step, metrics) -> None:
        if metrics is None:
            return
        drop = metrics.get("moe_drop_frac")
        aux = metrics.get("moe_aux_loss")
        if drop is None and aux is None:
            return
        violations = {}
        if drop is not None and float(drop) > self.drop_frac_threshold:
            violations["moe_drop_frac"] = {
                "value": float(drop), "threshold": self.drop_frac_threshold}
        if aux is not None and float(aux) > self.aux_loss_threshold:
            violations["moe_aux_loss"] = {
                "value": float(aux), "threshold": self.aux_loss_threshold}
        if not violations:
            self._streak = 0
            return
        self._streak += 1
        if self._streak < self.patience:
            return
        self.fired_steps.append(step)
        payload = {"warning": "moe_collapse", "step": step,
                   "streak": self._streak, "violations": violations}
        log.warning("MOE COLLAPSE SUSPECTED %s", json.dumps(payload))
        writer = getattr(trainer, "writer", None)
        if writer is not None and hasattr(writer, "telemetry"):
            writer.telemetry.emit(
                telemetry.KIND_HEALTH, step=step,
                health={"warning": "moe_collapse", "streak": self._streak,
                        **{f"{k}_value": v["value"]
                           for k, v in violations.items()}})
