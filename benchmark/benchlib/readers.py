"""Arithmetic the metric readers share (``metrics/<name>.py``)."""

from __future__ import annotations

import statistics

from benchlib import bounds, kineto


def mfu_pct(run) -> float | None:
    """Model FLOPs of the window's steps over its seconds, as a share of
    the chips' bf16 peak."""
    if run.window_s <= 0 or run.window_flops <= 0:
        return None
    return (100.0 * run.window_flops / run.window_s
            / (bounds.H100_BF16_FLOPS * run.chips))


def idle_pct(run) -> float | None:
    """The highest rank's share of its traced window with no kernel,
    memcpy or memset running."""
    worst = None
    for rank in range(run.chips):
        ev = run.device_events(rank)
        if not ev:
            return None
        lo, hi = kineto.window(ev)
        busy = kineto.union_ps([(e.start_ps, e.end_ps) for e in ev])
        pct = 100.0 * (1.0 - busy / (hi - lo))
        worst = pct if worst is None else max(worst, pct)
    return worst


def class_ms_per_step(run, classify, name: str) -> float | None:
    """Kernel time of class ``name`` a profiled step, on the rank where it
    is largest; None where no kernel of the class ran."""
    worst = None
    for rank in range(run.chips):
        ev = [e for e in run.device_events(rank) if e.cat == "kernel"]
        total = sum(e.dur_ps for e in ev if classify(e.name) == name)
        if total:
            ms = total / 1e9 / run.profile_steps
            worst = ms if worst is None else max(worst, ms)
    return worst


def span_ms_per_step(run, label: str) -> float | None:
    """Device time of the kernels launched inside the spans ``label``, a
    profiled step, on the rank where it is largest; collectives left out
    (they are the collectives layer's). None where a rank has no such
    span."""
    worst = None
    for rank in range(run.chips):
        ev = run.span_events(label, rank)
        if not ev:
            return None
        ms = (sum(e.dur_ps for e in ev if not bounds.is_collective(e.name))
              / 1e9 / run.profile_steps)
        worst = ms if worst is None else max(worst, ms)
    return worst


def p90(values: list[float]) -> float | None:
    if len(values) < 10:
        return None
    return statistics.quantiles(values, n=10)[8]
