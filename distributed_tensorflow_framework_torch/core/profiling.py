"""Tracing and profiling: the port's copy of ``core/profiling.py``.

  * ``trace(logdir)`` — a profile window around a block:
    ``torch.profiler`` over the CPU and, where a card is present, CUDA
    (CUPTI), written as a Kineto chrome trace
    (``<host>_<pid>.<ms>.pt.trace.json``) into ``logdir``;
    ``start_trace``/``stop_trace`` are the same window opened and closed
    from two places (the ProfileHook of train/hooks.py), as
    ``jax.profiler.start_trace``/``stop_trace`` are in the JAX package
    (torch.profiler runs one window at a time).
    core/trace_analysis.py reads the trace.
  * ``annotate(name)`` — a named range in the trace
    (``torch.profiler.record_function``). The trainer annotates each
    ``train_step`` dispatch and the train step its ``optimizer_update``;
    the analyzer files a kernel launched inside that range under the
    range's name.
  * ``StepTimer`` — host-side wall time per phase (infeed, dispatch,
    metrics_fetch, backpressure), logged as ``time_<phase>_ms``, which the
    telemetry writer files under the event's ``phases``.

Step-window traces during training: ``--set train.profile_start=N --set
train.profile_stop=M`` (the trace covers steps N+1..M).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator

import torch


def start_trace():
    """Open a profile window: ``torch.profiler`` over the CPU and, where a
    card is present, CUDA. Returns the running profiler for
    :func:`stop_trace`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, logdir: str) -> str:
    """Close the window ``prof`` and write its trace into ``logdir``;
    returns the trace's path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{int(time.time() * 1e3)}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a trace of everything inside the block."""
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, logdir)


def annotate(name: str):
    """Named range visible in the trace (and to the analyzer's scopes)."""
    return torch.profiler.record_function(name)


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
