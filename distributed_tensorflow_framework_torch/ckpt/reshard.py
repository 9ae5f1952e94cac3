"""Moving state across a change of the replica count: the port's copy of
``ckpt/reshard.py``'s :func:`fold_residual` (the rest of that module, the
elastic reshard, is ROADMAP.md queue A item A17)."""

from __future__ import annotations

import torch


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
