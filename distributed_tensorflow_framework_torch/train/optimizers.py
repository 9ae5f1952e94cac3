"""Optimizer construction from config: the port's copy of
``train/optimizers.py``.

The JAX package builds an optax chain ``clip_by_global_norm → base rule
→ −lr·schedule(count)``, the count starting at 0 (so the first update uses
``schedule(0)``, which is 0 under warmup). :class:`Optimizer` runs the
clip on the gradients in place, sets the learning rate ``schedule(count)``
on every parameter group, and steps an inner ``torch.optim`` optimizer
over two groups, decayed and not:

  * ``adamw``: ``torch.optim.AdamW`` — ``p ← p·(1 − lr·wd) −
    lr·m̂/(√v̂ + ε)``, ε outside the root, bias correction from count 1,
    which is optax's ``adamw`` update;
  * ``sgd``/``sgd_momentum``/``momentum``: ``torch.optim.SGD`` with
    dampening 0 — ``g + wd·p`` (optax ``add_decayed_weights`` before the
    trace), the trace ``m ← g + μ·m`` (zero start, so the first step's
    buffer is g), then ``−lr·m``, or ``−lr·(g + μ·m)`` with ``nesterov``;
  * ``adam``: ``torch.optim.Adam`` with its coupled ``g + wd·p``, which is
    ``add_decayed_weights`` followed by optax's ``adam``;
  * ``rmsprop`` (:class:`RMSProp`, by hand): optax's ``scale_by_rms`` with
    the TF1 slot start ν = 1 and ε INSIDE the root, ``u = g·(ν + ε)^-½``
    after ``ν ← d·ν + (1−d)·g²``, then ``−lr·u`` and a momentum trace
    after the scaling when ``momentum > 0``. ``torch.optim.RMSprop``
    starts ν at 0 and adds ε outside the root, which with Inception's
    ε = 1 is a different optimizer;
  * ``lars`` (:class:`LARS`, by hand): optax's order — ``g + wd·p`` on the
    decayed leaves, the trust ratio 0.001·‖p‖/‖u‖ on every leaf (1 where
    either norm is 0), ``−lr·u``, then the momentum trace, which here
    comes AFTER the learning rate.

The weight-decay mask is the JAX package's ``_decay_mask`` rule applied to
the Flax names and shapes that models/convert.py gives each parameter:
rank ≥ 2 kernels (dense and conv), ``embed/embedding`` and
``pos_embedding`` decay; every ``bias``, ``scale`` and BatchNorm leaf, and
``mlm_bias``, do not.

The optimizer runs on the model's parameters, or on tensors cut from them
(``params``, keyed by the same names): ZeRO's flattened 1-D shards and
FSDP's parts (parallel/zero.py, parallel/sharding.py). Such a shard has
lost the rank and the name the mask rule reads, so the mask is computed
once from the model's real parameters, as the JAX step precomputes its
``decay_mask_ref`` (a tensor-parallel part keeps its leaf's rank, so the
rule reads it as it stands). Every rule here is elementwise but LARS's per-leaf
norms, so an update on a shard equals the same cells of the update on the
whole tensor, and the padding cells of a ZeRO shard (zero gradient, zero
parameter) stay zero: zero moments, zero decay, zero update (RMSProp's ν
starts at 1 there and its update is still 0 · (ν + ε)^-½). LARS on FSDP
or tensor-parallel parts takes whole-tensor norms from ``whole_norms``
(the parts' squared norms summed over ``fsdp``, then over ``model``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_framework_torch.core.config import OptimizerConfig
from distributed_tensorflow_framework_torch.models.convert import flax_layout
from distributed_tensorflow_framework_torch.train.schedules import (
    Schedule,
    make_schedule,
)

SGD_NAMES = ("sgd", "sgd_momentum", "momentum")


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """state_dict key → whether weight decay applies to that parameter."""
    return {key: (not any(n in ("bn", "scale", "bias") for n in path)
                  and len(shape) >= 2)
            for key, (path, shape) in flax_layout(model).items()}


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """√Σ t² over all tensors, in f32, on their device (no host sync)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def _decayed_grads(group: dict) -> tuple[list, list]:
    """The group's parameters with a gradient, and ``g + wd·p`` for them
    (optax ``add_decayed_weights``; the gradients themselves when the
    group does not decay)."""
    params = [p for p in group["params"] if p.grad is not None]
    grads = [p.grad for p in params]
    if group["weight_decay"]:
        grads = torch._foreach_add(grads, params,
                                   alpha=group["weight_decay"])
    return params, grads


def _trace(opt: torch.optim.Optimizer, params: list, updates: list,
           momentum: float) -> list:
    """optax ``trace``: ``t ← u + μ·t`` from zero; returns the new t."""
    traces = []
    for p, u in zip(params, updates):
        state = opt.state[p]
        if "trace" not in state:
            state["trace"] = torch.zeros_like(p)
        traces.append(state["trace"])
    torch._foreach_mul_(traces, momentum)
    torch._foreach_add_(traces, updates)
    return traces


class RMSProp(torch.optim.Optimizer):
    """optax ``rmsprop(initial_scale=1.0, eps_in_sqrt=True)`` after an
    optional ``add_decayed_weights`` (see the module docstring)."""

    def __init__(self, groups, *, decay: float, eps: float,
                 momentum: float):
        super().__init__(groups, dict(lr=0.0, weight_decay=0.0, decay=decay,
                                      eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params, grads = _decayed_grads(group)
            if not params:
                continue
            nus = []
            for p in params:
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.ones_like(p)
                nus.append(state["nu"])
            decay = group["decay"]
            torch._foreach_mul_(nus, decay)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - decay)
            scale = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(scale)
            updates = torch._foreach_mul(grads, scale)
            torch._foreach_mul_(updates, -group["lr"])
            if group["momentum"] > 0:
                updates = _trace(self, params, updates, group["momentum"])
            torch._foreach_add_(params, updates)


class LARS(torch.optim.Optimizer):
    """optax ``lars(trust_coefficient=0.001, eps=0, nesterov=False)`` with
    the weight-decay mask as the parameter groups (see the module
    docstring). ``whole_norms(params, norms)``, when given, turns the
    norms of the tensors held into those of the whole leaves they were
    cut from."""

    def __init__(self, groups, *, momentum: float,
                 trust_coefficient: float = 0.001, whole_norms=None):
        super().__init__(groups, dict(lr=0.0, weight_decay=0.0,
                                      momentum=momentum,
                                      trust_coefficient=trust_coefficient))
        self.whole_norms = whole_norms

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params, grads = _decayed_grads(group)
            if not params:
                continue
            p_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(grads))
            if self.whole_norms is not None:
                p_norm = self.whole_norms(params, p_norm)
                u_norm = self.whole_norms(params, u_norm)
            ratio = group["trust_coefficient"] * p_norm / u_norm
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(ratio), ratio)
            updates = torch._foreach_mul(grads, list(ratio.unbind()))
            torch._foreach_mul_(updates, -group["lr"])
            updates = _trace(self, params, updates, group["momentum"])
            torch._foreach_add_(params, updates)


def _inner(config: OptimizerConfig, groups: list[dict], whole_norms=None
           ) -> torch.optim.Optimizer:
    name = config.name.lower()
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=0.0,
                                 betas=(config.beta1, config.beta2),
                                 eps=config.eps)
    if name in SGD_NAMES:
        return torch.optim.SGD(groups, lr=0.0, momentum=config.momentum,
                               nesterov=config.nesterov
                               and config.momentum > 0)
    if name == "adam":
        return torch.optim.Adam(groups, lr=0.0,
                                betas=(config.beta1, config.beta2),
                                eps=config.eps)
    if name == "rmsprop":
        return RMSProp(groups, decay=config.rms_decay, eps=config.eps,
                       momentum=config.momentum)
    if name == "lars":
        return LARS(groups, momentum=config.momentum,
                    whole_norms=whole_norms)
    raise ValueError(f"Unknown optimizer {config.name!r}")


class Optimizer:
    """The config's optax chain with global-norm clipping, on a model's
    parameters or on ``params`` (state_dict key → a tensor cut from that
    parameter; see the module docstring). ``step(grad_norm)`` takes the
    pre-clip global norm of the whole gradient and applies one update to
    the tensors' ``.grad`` with the learning rate ``schedule(count)``.
    ``names`` lists the keys in torch.optim's parameter order (the state's
    integer indices)."""

    def __init__(self, config: OptimizerConfig, schedule: Schedule,
                 model: nn.Module,
                 params: dict[str, torch.Tensor] | None = None,
                 whole_norms=None):
        mask = decay_mask(model)
        if params is None:
            params = dict(model.named_parameters())
        self.names = ([k for k in params if mask[k]]
                      + [k for k in params if not mask[k]])
        groups = [
            {"params": [p for k, p in params.items() if mask[k]],
             "weight_decay": config.weight_decay},
            {"params": [p for k, p in params.items() if not mask[k]],
             "weight_decay": 0.0},
        ]
        self.inner = _inner(config, groups, whole_norms)
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

    def state_dict(self) -> dict:
        """The inner optimizer's state (slots, and the per-parameter step
        of Adam and AdamW) and the schedule's count. The tensors are the
        live ones, not copies."""
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """The inverse of ``state_dict``. torch.optim keeps a tensor it is
        given where device and dtype already match, so pass tensors that
        nothing else holds."""
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


class BucketOptimizers:
    """``precision.fused_update``'s optimizer (the JAX step's
    ``_ensure_fused_txs``): one :class:`Optimizer` per ZeRO bucket
    (parallel/zero.py), each over that bucket's shards (``buckets``: one
    dict of state_dict key → shard per bucket, in the plan's order) with
    the bucket's subset of the decay mask. Every rule ZeRO allows is
    elementwise, and each bucket's optimizer is the same torch.optim class
    on the same kind of tensors as the whole-tree one, so the same
    single-tensor or foreach kernels run, and the update is the whole-tree
    one's bit for bit. The slots are grouped per bucket: ``state_dict``
    holds ``{"buckets": [...]}``, one ``Optimizer.state_dict()`` each,
    and ``names`` one key list per bucket."""

    def __init__(self, config: OptimizerConfig, schedule: Schedule,
                 model: nn.Module, buckets: list[dict[str, torch.Tensor]]):
        self.opts = [Optimizer(config, schedule, model, params=bucket)
                     for bucket in buckets]
        self.names = [opt.names for opt in self.opts]
        self._schedule = schedule

    @property
    def schedule(self) -> Schedule:
        return self._schedule

    @schedule.setter
    def schedule(self, schedule: Schedule) -> None:
        self._schedule = schedule
        for opt in self.opts:
            opt.schedule = schedule

    @property
    def count(self) -> int:
        return self.opts[0].count

    def zero_grad(self) -> None:
        for opt in self.opts:
            opt.zero_grad()

    def state_dict(self) -> dict:
        return {"buckets": [opt.state_dict() for opt in self.opts]}

    def load_state_dict(self, state: dict) -> None:
        if "buckets" not in state or len(state["buckets"]) != len(self.opts):
            raise ValueError(
                "the stored optimizer state is not grouped into this run's "
                f"{len(self.opts)} ZeRO buckets (precision.fused_update)")
        for opt, part in zip(self.opts, state["buckets"]):
            opt.load_state_dict(part)


def make_optimizer(config: OptimizerConfig, total_steps: int,
                   model: nn.Module,
                   params: dict[str, torch.Tensor] | None = None,
                   whole_norms=None) -> tuple[Optimizer, Schedule]:
    """The optimizer over ``model``'s parameters (or over ``params`` cut
    from them) and its schedule."""
    schedule = make_schedule(config, total_steps)
    return Optimizer(config, schedule, model, params, whole_norms), schedule


def ema_decay_at(decay: float, step: int) -> np.float32:
    """The EMA's decay after step ``step`` (the count before the
    increment): ``min(decay, (1 + t)/(10 + t))`` in f32, as the JAX step
    computes it (tf.train.ExponentialMovingAverage with num_updates)."""
    t = np.float32(step)
    return np.minimum(np.float32(decay),
                      (np.float32(1.0) + t) / (np.float32(10.0) + t))


@torch.no_grad()
def ema_update_(ema: list[torch.Tensor], params: list[torch.Tensor],
                decay: float, step: int) -> None:
    """``ema ← d·ema + (1 − d)·p`` in place, d = :func:`ema_decay_at`."""
    d = ema_decay_at(decay, step)
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, [p.float() for p in params],
                        alpha=float(np.float32(1.0) - d))
