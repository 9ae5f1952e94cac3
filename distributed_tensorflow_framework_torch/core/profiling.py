"""Host-side step phase timing: the port's copy of ``core/profiling.py``'s
``StepTimer``.

The trainer times each phase of its loop (infeed, dispatch, metrics_fetch,
backpressure) and logs the means as ``time_<phase>_ms``, which the
telemetry writer files under the event's ``phases``. The XPlane trace
window (``trace``/``annotate``) is not ported (ROADMAP.md queue A item
A16).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator


class StepTimer:
    """Accumulates host-side wall time per named phase."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def means(self) -> dict[str, float]:
        return {f"time_{k}_ms": 1000.0 * v / max(self.counts[k], 1)
                for k, v in self.totals.items()}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
