"""Moving state across a change of the replica count: the port's copies
of ``ckpt/reshard.py``'s :func:`fold_residual` and
:func:`refold_zero_opt_state` (the rest of that module, the elastic
reshard, is ROADMAP.md queue A item A17)."""

from __future__ import annotations

import torch

from distributed_tensorflow_framework_torch.parallel.sharding import map_slots
from distributed_tensorflow_framework_torch.parallel.zero import refold_rows


def fold_residual(rows: dict[str, torch.Tensor],
                  n_new: int) -> dict[str, torch.Tensor]:
    """Fold stored ``(n_old, *shape)`` error-feedback residual rows
    (train/state.py ``collective_residual``, one row per replica) onto
    ``n_new`` rows, keeping each leaf's sum over the rows — what error
    feedback owes the optimizer: the mean gradient's path depends on the
    total residual, not on how it is spread over the replicas.

    An even shrink (``n_old % n_new == 0``) sums ``n_old / n_new``
    consecutive rows into each new row; any other change puts the total
    in row 0 and starts the other replicas from zero."""

    def fold(leaf: torch.Tensor) -> torch.Tensor:
        n_old = leaf.shape[0]
        if n_old == n_new:
            return leaf
        if n_old % n_new == 0:
            return leaf.reshape((n_new, n_old // n_new)
                                + tuple(leaf.shape[1:])).sum(dim=1)
        out = torch.zeros((n_new,) + tuple(leaf.shape[1:]),
                          dtype=leaf.dtype, device=leaf.device)
        out[0] = leaf.sum(dim=0)
        return out

    return {k: fold(v) for k, v in rows.items()}


def refold_zero_opt_state(stored: dict, names: list[str],
                          sizes: dict[str, int], n_new: int) -> dict:
    """Re-chunk ZeRO-stacked optimizer slots (an ``Optimizer.state_dict()``
    whose slots are ``(n_old, ceil(size/n_old))`` rows, as a checkpoint
    stores them) for ``n_new`` replicas: each slot flattened, truncated to
    its parameter's true ``size`` (``sizes`` by key; ``names`` maps the
    optimizer's indices to keys) and re-padded to ``(n_new,
    ceil(size/n_new))``. The padding is inert (zero gradient and zero
    parameter give a zero update under every rule ZeRO allows), so the
    refold changes no real cell; the step counters pass through."""
    return map_slots(lambda t, key: refold_rows(t, sizes[key], n_new),
                     stored, names)
