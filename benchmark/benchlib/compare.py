"""The comparison that decides ``correct``: the program's first steps
against the plain reference's from the same weights and rows.

Three numbers, each a relative gap:

  * ``loss_gap`` — the largest over the compared steps of
    |loss_program − loss_reference| / |loss_reference|;
  * ``grad_gap`` — over the leaves, the largest |‖g_program‖ −
    ‖g_reference‖| / max(‖g_reference‖, the median leaf's ‖g_reference‖),
    g being the first step's gradient as the update takes it (the program's
    worked out from its optimizer state after that step);
  * ``change_gap`` — the same of each leaf's change over the compared
    steps (parameters, and BatchNorm running statistics where the model
    has them). A parameter whose first gradient in the reference is under
    ``RULE`` times the median leaf's is left out: it moves under Adam by
    round-off alone (the key bias under the softmax is one).

The reference's norms decide which leaves count, never a leaf's name.
"""

from __future__ import annotations

import math
import statistics

RULE = 1e-3
NAMES = ("loss_gap", "grad_gap", "change_gap")


def _worst(prog: dict, ref: dict, keys) -> tuple[float, str]:
    keys = list(keys)
    median = statistics.median(ref[k] for k in keys)
    worst, name = 0.0, ""
    for k in keys:
        p = prog.get(k, 0.0)
        gap = abs(p - ref[k]) / max(ref[k], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, name = gap, k
    return worst, name


def gaps(program: dict, reference: dict) -> dict:
    """The three numbers and the leaf that set each."""
    lp, lr = program["losses"], reference["losses"]
    if len(lp) != len(lr):
        loss_gap = math.inf
    else:
        loss_gap = max((abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(lp, lr)), default=math.inf)
        if any(not math.isfinite(a) for a in lp):
            loss_gap = math.inf
    rg = reference["grad_norms"]
    grad_gap, grad_leaf = _worst(program["grad_norms"], rg, rg)
    median = statistics.median(rg.values())
    rc = reference["change_norms"]
    kept = [k for k in rc if k not in rg or rg[k] >= RULE * median]
    change_gap, change_leaf = _worst(program["change_norms"], rc, kept)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "left_out": sorted(set(rc) - set(kept))}


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
