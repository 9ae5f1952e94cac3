"""Learning-rate schedules: the port's copy of ``train/schedules.py``.

:func:`make_schedule` returns a plain function of the step (a Python int)
that gives the same values as the optax schedules the JAX package builds:
``constant``, ``cosine``, ``linear`` and ``staircase``, each behind an
optional linear warmup. As in ``optax.join_schedules``, the decay schedule
after warmup sees ``step - warmup_steps``. :func:`with_rewarmup` is the
post-rollback re-warmup (``resilience.lr_rewarmup_steps``).
"""

from __future__ import annotations

import math
from typing import Callable

from distributed_tensorflow_framework_torch.core.config import OptimizerConfig

Schedule = Callable[[int], float]


def linear_schedule(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``: init → end over ``steps``, then end."""
    def sched(step: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return sched


def make_schedule(config: OptimizerConfig, total_steps: int) -> Schedule:
    base = config.learning_rate
    warmup = config.warmup_steps
    decay_steps = max(1, total_steps - warmup)
    if config.schedule == "constant":
        def decay(step: int) -> float:
            return base
    elif config.schedule == "cosine":
        def decay(step: int) -> float:
            count = min(step, decay_steps)
            return base * 0.5 * (1.0 + math.cos(math.pi * count
                                                / decay_steps))
    elif config.schedule == "linear":
        decay = linear_schedule(base, 0.0, decay_steps)
    elif config.schedule == "staircase":
        # Config boundaries are absolute global steps; the post-warmup
        # schedule sees (step - warmup_steps), so shift them. A repeated
        # boundary decays once (optax keys the boundaries in a dict).
        boundaries = sorted({int(b) - warmup for b in config.boundaries})

        def decay(step: int) -> float:
            value = base
            for boundary in boundaries:
                if step >= boundary:
                    value *= config.decay_factor
            return value
    else:
        raise ValueError(f"Unknown schedule {config.schedule!r}")
    if warmup <= 0:
        return decay
    ramp = linear_schedule(0.0, base, warmup)

    def sched(step: int) -> float:
        return ramp(step) if step < warmup else decay(step - warmup)
    return sched


def with_rewarmup(schedule: Schedule, resume_step: int,
                  rewarmup_steps: int) -> Schedule:
    """After an in-memory rollback to ``resume_step``, scale ``schedule``
    linearly from 1/``rewarmup_steps`` back to 1 over
    ``[resume_step, resume_step + rewarmup_steps)``; unchanged outside that
    window (``resilience.lr_rewarmup_steps``)."""
    if rewarmup_steps <= 0:
        return schedule

    def sched(step: int) -> float:
        frac = (step - resume_step + 1.0) / rewarmup_steps
        return schedule(step) * min(max(frac, 0.0), 1.0)
    return sched
