"""Masked-LM loss and metrics: the port's copy of ``train/losses.py``'s MLM
half.

Everything is computed in f32 on the logits. ``targets`` holds the
original token at masked (predicted) positions and -1 elsewhere; the
denominator of the training loss is ``max(#masked, 1)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mlm_mask(targets: torch.Tensor) -> torch.Tensor:
    """1.0 at masked (predicted) positions, 0.0 elsewhere — the single
    definition of the '-1 means unmasked' sentinel, shared with the
    grad-accumulation micro-batch weighting (train/step.py)."""
    return (targets >= 0).float()


def _token_losses(logits: torch.Tensor, targets: torch.Tensor):
    """Per-token CE against ``max(targets, 0)`` and per-token
    correctness, both f32 of the targets' shape."""
    logits = logits.float()
    safe = targets.clamp(min=0).long()
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             safe.reshape(-1), reduction="none")
    correct = (logits.argmax(dim=-1) == safe).float()
    return losses.reshape(safe.shape), correct


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor
             ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Masked-LM CE: the mean over masked positions, with its accuracy."""
    mask = mlm_mask(targets)
    losses, correct = _token_losses(logits, targets)
    denom = mask.sum().clamp(min=1.0)
    loss = (losses * mask).sum() / denom
    acc = (correct * mask).sum() / denom
    return loss, {"loss": loss, "mlm_acc": acc}


def mlm_metrics_sums(logits: torch.Tensor, targets: torch.Tensor,
                     weight: torch.Tensor) -> dict[str, torch.Tensor]:
    """Weighted metric SUMS over masked positions for exact evaluation:
    the eval loop adds them over batches and divides by ``weight_sum``,
    the masked tokens of real (weight-1) examples."""
    mask = mlm_mask(targets) * weight.float()[:, None]
    losses, correct = _token_losses(logits, targets)
    return {
        "loss_sum": (losses * mask).sum(),
        "mlm_acc_sum": (correct * mask).sum(),
        "weight_sum": mask.sum(),
    }
