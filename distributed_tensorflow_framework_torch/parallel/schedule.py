"""Static pipeline schedules: slot tables, bubbles, activation residency.

The port's copy of the JAX package's ``parallel/schedule.py``, whole and
unchanged in what it computes (the port imports nothing of that
package). Everything here is plain Python over static ints: the schedule
for a (S stages, M microbatches, v virtual stages) triple is fully known
before a step runs, so the executors of parallel/pipeline.py walk tables
built here, the trainer logs the analytic bubble from here, and the unit
tests pin warmup/steady/cooldown structure without touching a device.

Three schedules (ModelConfig.pipeline_schedule):

``gpipe``
    Circular fill-drain: one forward pass of ``M + S - 1`` slots (slot t,
    stage s runs microbatch ``t - s``), backward mirrored by autodiff.
    Bubble fraction ``(S-1)/(M+S-1)`` per direction; every slot's
    residuals stay live until its mirrored backward slot → activation
    residency **O(M + S)** stage-activation sets per device.

``1f1b``
    Same forward pass; the backward is hand-built (pipeline.py) as a
    combined recompute+backward schedule: slot ``t`` runs a forward
    (re)compute of microbatch ``t - s`` on stage ``s`` AND the backward
    of microbatch ``t - 2(S-1) + s`` — one-forward-one-backward in the
    steady region, with ``S-1`` forward-only warmup slots and ``S-1``
    backward-only cooldown slots. Only the stage-INPUT boundary
    activation is carried between a microbatch's forward slot and its
    backward slot (a depth-``2S-1`` rolling store); per-layer residuals
    exist only transiently inside the backward slot's VJP. Residency
    **O(S)**, independent of M — the schedule that buys more
    microbatches at a fixed activation budget. Analytic bubble equals
    gpipe's (the win is memory, not slots).

``interleaved``
    v virtual stages per device, round-robin layer assignment (global
    chunk ``q = c*S + s`` lives on device ``s``, chunks cover the layer
    stack in order). Forward pass ``v*M + S - 1`` slots of 1/v-sized
    chunk work, backward mirrored by autodiff → bubble fraction
    ``(S-1)/(v*M + S-1)`` — strictly below gpipe's for v > 1 at equal
    (S, M). Requires ``M % S == 0`` (microbatches advance in groups of
    S) and ``num_layers % (S*v) == 0``.

Bubble convention: fraction of total schedule slots that are fill/drain
(idle on real hardware, skipped by the port's executors, masked garbage
compute under the JAX package's SPMD lockstep) —
the same convention as the original gpipe ``pipe_bubble_frac`` metric
(3/11 = 0.2727 at S=4, M=8). The Megatron-style bubble/ideal ratio is
``(S-1)/(v*M)``; both shrink with v.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SCHEDULES = ("gpipe", "1f1b", "interleaved")


def resolve_virtual(schedule: str, num_stages: int, num_microbatches: int,
                    virtual_stages: int, num_layers: int) -> int:
    """Validate the (schedule, S, M, v, L) tuple; return the resolved v.

    ``virtual_stages == 0`` means "default": 1 for gpipe/1f1b,
    ``num_layers // num_stages`` (one layer per chunk — the maximal
    bubble cut) for interleaved.
    """
    if schedule not in SCHEDULES:
        raise ValueError(
            f"model.pipeline_schedule must be one of {SCHEDULES}, "
            f"got {schedule!r}"
        )
    s, m, v = num_stages, num_microbatches, virtual_stages
    if s < 1 or m < 1:
        raise ValueError(f"need stages>=1 and microbatches>=1, got {s}, {m}")
    if schedule != "interleaved":
        if v not in (0, 1):
            raise ValueError(
                f"model.pipeline_virtual_stages={v} only applies to "
                f"pipeline_schedule='interleaved' (got {schedule!r})"
            )
        return 1
    if v == 0:
        v = max(num_layers // s, 1)
    if m % s:
        raise ValueError(
            f"interleaved schedule needs pipeline_microbatches ({m}) "
            f"divisible by pipeline_stages ({s}) — microbatches advance "
            f"through the virtual chunks in groups of S"
        )
    if num_layers % (s * v):
        raise ValueError(
            f"interleaved schedule needs num_layers ({num_layers}) "
            f"divisible by stages*virtual_stages ({s}*{v}) for the "
            f"round-robin chunk assignment"
        )
    return v


def num_slots(schedule: str, num_stages: int, num_microbatches: int,
              virtual_stages: int = 1) -> int:
    """Forward-pass slot count (the scan/unroll length per direction)."""
    s, m, v = num_stages, num_microbatches, virtual_stages
    if schedule == "interleaved":
        return v * m + s - 1
    return m + s - 1


def bubble_frac(schedule: str, num_stages: int, num_microbatches: int,
                virtual_stages: int = 1) -> float:
    """Analytic fill/drain fraction of the schedule (see module note)."""
    s, m, v = num_stages, num_microbatches, virtual_stages
    if schedule == "interleaved":
        return (s - 1) / (v * m + s - 1)
    # gpipe and 1f1b share the analytic bubble; 1f1b's win is residency.
    return (s - 1) / (m + s - 1)


def peak_inflight(schedule: str, num_stages: int, num_microbatches: int,
                  virtual_stages: int = 1) -> float:
    """Peak per-device activation residency, in stage-activation-set
    units (one unit = the saved forward state for one microbatch across
    one device's layers), worst stage.

    gpipe/interleaved: autodiff through the forward scan keeps every
    slot's residuals until the mirrored backward slot → all slots live
    at the turnaround (interleaved slots are 1/v-sized, hence /v).
    1f1b: a microbatch's state lives from its forward slot ``mb + s`` to
    its backward slot ``mb + 2(S-1) - s``; span ``2(S-1-s) + 1``, worst
    at stage 0 and capped by M → ``min(M, 2S-1)`` — O(S), not O(M).
    """
    s, m, v = num_stages, num_microbatches, virtual_stages
    if schedule == "1f1b":
        return float(min(m, 2 * s - 1))
    if schedule == "interleaved":
        return (v * m + s - 1) / v
    return float(m + s - 1)


@dataclass
class Slot:
    """One schedule slot: which microbatch each stage runs, per phase.

    ``fwd``/``bwd`` map stage → microbatch id (absent = stage idle in
    that phase). ``kind`` classifies the slot: "warmup" (forward-only),
    "steady" (both phases active somewhere), "cooldown" (backward-only).
    """

    t: int
    fwd: dict[int, int] = field(default_factory=dict)
    bwd: dict[int, int] = field(default_factory=dict)
    kind: str = "steady"


def slot_table(schedule: str, num_stages: int, num_microbatches: int,
               virtual_stages: int = 1) -> list[Slot]:
    """The full static schedule as a list of Slots.

    gpipe/interleaved tables are forward-pass only (autodiff mirrors
    them); the 1f1b table is the combined recompute+backward schedule
    its executor unrolls, with the warmup / steady / cooldown structure
    the ISSUE's unit tests pin.
    """
    s, m, v = num_stages, num_microbatches, virtual_stages
    slots: list[Slot] = []
    if schedule == "1f1b":
        for t in range(m + 2 * s - 2):
            slot = Slot(t=t)
            if t <= m + s - 2:  # forward (re)compute phase
                for st in range(s):
                    mb = t - st
                    if 0 <= mb < m:
                        slot.fwd[st] = mb
            if t >= s - 1:      # backward phase
                for st in range(s):
                    mb = t - 2 * (s - 1) + st
                    if 0 <= mb < m:
                        slot.bwd[st] = mb
            if not slot.bwd:
                slot.kind = "warmup"
            elif not slot.fwd:
                slot.kind = "cooldown"
            slots.append(slot)
        return slots
    for t in range(num_slots(schedule, s, m, v)):
        slot = Slot(t=t)
        for st in range(s):
            tp = t - st  # stage-local clock
            if schedule == "interleaved":
                if 0 <= tp < v * m:
                    g, r = divmod(tp, s * v)
                    c, j = divmod(r, s)
                    slot.fwd[st] = g * s + j  # chunk c of microbatch g*S+j
            else:
                if 0 <= tp < m:
                    slot.fwd[st] = tp
        if t < s - 1:
            slot.kind = "warmup"
        elif len(slot.fwd) < s:
            slot.kind = "cooldown"
        slots.append(slot)
    return slots
