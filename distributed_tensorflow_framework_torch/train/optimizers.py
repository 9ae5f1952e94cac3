"""Optimizer construction from config: the port's copy of
``train/optimizers.py`` for ``adamw``, the BERT recipe's optimizer.

The JAX package builds the optax chain ``clip_by_global_norm →
scale_by_adam → add_decayed_weights(mask) → −lr·schedule(count)``, with
the count starting at 0 (so the first update uses ``schedule(0)``, which
is 0 under warmup). :class:`AdamW` computes the same update with
``torch.optim.AdamW`` over two parameter groups (decayed and not): its
step is ``p ← p·(1 − lr·wd) − lr·m̂/(√v̂ + ε)``, ε outside the square root
and bias correction from count 1, which is the chain's update. The global
norm clip runs first, on the gradients in place.

The weight-decay mask is the JAX package's ``_decay_mask`` rule applied to
the Flax names and shapes that models/convert.py gives each parameter:
rank ≥ 2 kernels, ``embed/embedding`` and ``pos_embedding`` decay; every
``bias`` and ``scale``, and ``mlm_bias``, do not.
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_tensorflow_framework_torch.core.config import OptimizerConfig
from distributed_tensorflow_framework_torch.models.convert import flax_layout
from distributed_tensorflow_framework_torch.train.schedules import (
    Schedule,
    make_schedule,
)

_NOT_PORTED = ("sgd", "sgd_momentum", "momentum", "adam", "rmsprop", "lars")


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """state_dict key → whether weight decay applies to that parameter."""
    return {key: (not any(n in ("bn", "scale", "bias") for n in path)
                  and len(shape) >= 2)
            for key, (path, shape) in flax_layout(model).items()}


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """√Σ t² over all tensors, in f32, on their device (no host sync)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """The optax ``adamw`` chain with global-norm clipping, on a model's
    parameters. ``step(grad_norm)`` takes the pre-clip global norm of the
    gradients held in ``.grad`` and applies one update with the learning
    rate ``schedule(count)``."""

    def __init__(self, config: OptimizerConfig, schedule: Schedule,
                 model: nn.Module):
        mask = decay_mask(model)
        params = dict(model.named_parameters())
        groups = [
            {"params": [p for k, p in params.items() if mask[k]],
             "weight_decay": config.weight_decay},
            {"params": [p for k, p in params.items() if not mask[k]],
             "weight_decay": 0.0},
        ]
        self.inner = torch.optim.AdamW(
            groups, lr=0.0, betas=(config.beta1, config.beta2),
            eps=config.eps)
        self.params = list(params.values())
        self.clip_norm = config.grad_clip_norm
        self.schedule = schedule
        self.count = 0

    def step(self, grad_norm: torch.Tensor) -> None:
        grads = [p.grad for p in self.params]
        if self.clip_norm > 0:
            # optax.clip_by_global_norm: unchanged below the threshold,
            # scaled to norm clip_norm above it.
            scale = (self.clip_norm / grad_norm).clamp(max=1.0)
            torch._foreach_mul_(grads, scale.to(grads[0].device))
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)


def make_optimizer(config: OptimizerConfig, total_steps: int,
                   model: nn.Module) -> tuple[AdamW, Schedule]:
    """The optimizer over ``model``'s parameters and its schedule."""
    name = config.name.lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {config.name!r} is not ported yet (the port has "
            f"adamw) — ROADMAP.md queue A item A3")
    if name != "adamw":
        raise ValueError(f"Unknown optimizer {config.name!r}")
    schedule = make_schedule(config, total_steps)
    return AdamW(config, schedule, model), schedule
