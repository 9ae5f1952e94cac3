"""Training hooks: the port's copy of ``train/hooks.py``'s NaN guard,
throughput, logging and eval hooks.

Hooks only ever see host-side metric values the trainer already fetched,
so they never force an extra device sync. The checkpoint, heartbeat,
profile and MoE hooks are not ported (ROADMAP.md queue A items A4, A14,
A16 and A8).
"""

from __future__ import annotations

import math

from distributed_tensorflow_framework_torch.core import telemetry
from distributed_tensorflow_framework_torch.core.metrics import (
    ThroughputMeter,
)


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
    otherwise) and records a ``failure`` event naming the metric and step
    before raising."""

    def after_step(self, trainer, step, metrics) -> None:
        if metrics is None:
            return
        for name, v in metrics.items():
            try:
                val = float(v)
            except (TypeError, ValueError):
                continue
            if not math.isfinite(val):
                trainer.writer.telemetry.emit(
                    telemetry.KIND_FAILURE, step=step,
                    health={"failure": "non_finite_metric", "metric": name,
                            "value": str(v), "last_good_checkpoint": ""})
                raise FloatingPointError(
                    f"Non-finite metric {name}={v} at step {step} — aborting "
                    f"(NaNGuardHook). No checkpoint saved — restart from "
                    f"scratch.")


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
        self.writer.write(step, out)


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
