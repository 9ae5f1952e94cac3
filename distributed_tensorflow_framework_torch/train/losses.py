"""Losses and metrics: the port's copy of ``train/losses.py``.

Everything is computed in f32 on the logits. Classification: softmax CE
(with ``label_smoothing`` α the target is (1−α)·onehot + α/K, as
``optax.smooth_labels`` makes it), top-1, and top-5 when there are more
than 5 classes; ties in ``topk`` may order differently than in
``jax.lax.top_k``. Masked LM: ``targets`` holds the original token at
masked (predicted) positions and -1 elsewhere; the denominator of the
training loss is ``max(#masked, 1)``. The ``*_metrics_sums`` functions
give the weighted sums of exact evaluation, which the eval loop adds over
batches and divides by ``weight_sum``. A MoE model's aux outputs join the
MLM loss through :func:`add_moe_terms`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _top5(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.topk(5, dim=-1).indices == labels[:, None]).any(
        dim=-1).float()


def classification_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                        label_smoothing: float = 0.0
                        ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean softmax CE over the batch, with top-1 (and top-5)."""
    logits = logits.float()
    labels = labels.long()
    loss = F.cross_entropy(logits, labels, label_smoothing=label_smoothing)
    metrics = {"loss": loss,
               "top1": (logits.argmax(dim=-1) == labels).float().mean()}
    if logits.shape[-1] > 5:
        metrics["top5"] = _top5(logits, labels).mean()
    return loss, metrics


def classification_metrics_sums(logits: torch.Tensor, labels: torch.Tensor,
                                weight: torch.Tensor
                                ) -> dict[str, torch.Tensor]:
    """Weighted metric SUMS for exact evaluation: zero-weight padding rows
    add nothing, and ``weight_sum`` counts the real examples."""
    logits = logits.float()
    labels = labels.long()
    w = weight.float()
    losses = F.cross_entropy(logits, labels, reduction="none")
    correct = (logits.argmax(dim=-1) == labels).float()
    out = {"loss_sum": (losses * w).sum(), "top1_sum": (correct * w).sum(),
           "weight_sum": w.sum()}
    if logits.shape[-1] > 5:
        out["top5_sum"] = (_top5(logits, labels) * w).sum()
    return out


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


def add_moe_terms(loss: torch.Tensor, metrics: dict, out: dict,
                  aux_weight: float) -> torch.Tensor:
    """The MoE terms of the JAX step's MLM loss: ``loss`` plus
    ``aux_weight`` times the model's ``moe_aux_loss``, with the metrics
    ``moe_aux_loss``, ``total_loss``, ``moe_drop_frac`` and (armed only)
    ``moe_zloss`` added to ``metrics`` in place; returns the total."""
    total = loss + aux_weight * out["moe_aux_loss"]
    metrics["moe_aux_loss"] = out["moe_aux_loss"]
    metrics["total_loss"] = total
    metrics["moe_drop_frac"] = out["moe_drop_frac"]
    if "moe_zloss" in out:
        metrics["moe_zloss"] = out["moe_zloss"]
    return total
