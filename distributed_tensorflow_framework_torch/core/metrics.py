"""Logging setup, metric writing, throughput and latency percentiles.

The port's copy of ``core/metrics.py``: :func:`setup_logging`,
:class:`MetricWriter` (console plus the ``dtf-telemetry/1`` JSONL event
stream, so ``scripts/analyze_trace.py`` reads a port run; no TensorBoard),
:class:`ThroughputMeter` and :class:`PercentileReservoir`.
"""

from __future__ import annotations

import logging
import math
import os
import random
import time
from typing import Any, Mapping

from distributed_tensorflow_framework_torch.core import telemetry

log = logging.getLogger("dtf_torch")


def setup_logging(level: int = logging.INFO) -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
        )


class MetricWriter:
    """Console + optional JSONL metric sink: one ``events.jsonl`` record
    per write under ``logdir`` (none when ``logdir`` is empty), with phase
    timings and throughput split into their schema fields.

    Only the chief writes metrics (the console and the ``write`` records).
    In a gang of more than one every rank keeps a telemetry stream of its
    own — the chief's ``events.jsonl``, rank i's ``events-p<i>.jsonl`` —
    whose events carry ``process_id``."""

    def __init__(self, logdir: str | None = None, *, is_chief: bool = True,
                 process_index: int = 0, process_count: int = 1):
        self._enabled = is_chief
        path = None
        if logdir:
            name = ("events.jsonl" if is_chief
                    else f"events-p{process_index}.jsonl")
            path = os.path.join(logdir, name)
        self.telemetry = telemetry.TelemetryWriter(
            path, process_id=process_index if process_count > 1 else None)

    def write(self, step: int, values: Mapping[str, Any], *,
              kind: str = telemetry.KIND_TRAIN_STEP,
              collectives: Mapping[str, Any] | None = None) -> None:
        if not self._enabled:
            return
        scalars = {k: telemetry._to_scalar(v) for k, v in values.items()}
        log.info("step %d: %s", step, " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scalars.items()))
        metrics, phases, throughput = telemetry.split_metrics(scalars)
        self.telemetry.emit(kind, step=step, metrics=metrics or None,
                            phases=phases or None,
                            throughput=throughput or None,
                            collectives=collectives)

    def close(self) -> None:
        self.telemetry.close()


class ThroughputMeter:
    """Examples/sec over the steps since the last reset;
    ``examples_per_sec_per_chip`` divides by the device count."""

    def __init__(self, num_chips: int):
        self.num_chips = max(1, num_chips)
        self._t0: float | None = None
        self._examples = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._examples = 0

    def update(self, batch_examples: int) -> None:
        if self._t0 is None:
            self.start()
        self._examples += batch_examples

    def rates(self) -> dict[str, float]:
        if self._t0 is None or self._examples == 0:
            return {"examples_per_sec": 0.0, "examples_per_sec_per_chip": 0.0}
        eps = self._examples / max(time.perf_counter() - self._t0, 1e-9)
        return {"examples_per_sec": eps,
                "examples_per_sec_per_chip": eps / self.num_chips}

    def reset(self) -> None:
        self.start()


class PercentileReservoir:
    """Streaming p50/p90/p99 over a bounded uniform sample (Vitter's
    algorithm R).

    A capacity-bounded reservoir holds a uniform random sample of an
    unbounded stream, so the nearest-rank percentile over the sample is an
    estimate of the stream percentile with O(capacity) memory. Under
    ``capacity`` observations the sample IS the stream and the percentiles
    are exact. Seeded — same stream, same sample.

    Not thread-safe; callers serialize (the engine adds from its single
    batcher thread).
    """

    def __init__(self, capacity: int = 4096, *, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._seed = seed
        self._rng = random.Random(seed)
        self._values: list[float] = []
        self._count = 0
        self._sum = 0.0

    @property
    def count(self) -> int:
        """Observations seen (not the retained sample size)."""
        return self._count

    def add(self, value: float) -> None:
        v = float(value)
        self._count += 1
        self._sum += v
        if len(self._values) < self.capacity:
            self._values.append(v)
        else:
            j = self._rng.randrange(self._count)
            if j < self.capacity:
                self._values[j] = v

    def percentile(self, p: float) -> float | None:
        """Nearest-rank percentile over the retained sample; None when
        empty. ``p`` is in [0, 100]."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        if not self._values:
            return None
        ordered = sorted(self._values)
        rank = max(1, math.ceil(p / 100.0 * len(ordered)))
        return ordered[rank - 1]

    def summary(self) -> dict[str, Any]:
        """The SLO rollup shape the serve telemetry emits: count, mean,
        p50/p90/p99 (None when no observations)."""
        ordered = sorted(self._values)

        def at(p: float) -> float | None:
            if not ordered:
                return None
            return ordered[max(1, math.ceil(p / 100.0 * len(ordered))) - 1]

        return {
            "count": self._count,
            "mean": (self._sum / self._count) if self._count else None,
            "p50": at(50.0),
            "p90": at(90.0),
            "p99": at(99.0),
        }

    def reset(self) -> None:
        self._rng = random.Random(self._seed)
        self._values = []
        self._count = 0
        self._sum = 0.0
