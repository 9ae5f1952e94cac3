"""Training state: the port's counterpart of ``train/state.py``'s
``TrainState``.

The step counter, the parameters and the BatchNorm running statistics
(the model: the JAX state's ``params`` and ``batch_stats``), the optimizer
and its state, the dropout generator (the JAX state's ``rng``) and the
parameter EMA (``ema_params``: f32 copies on the device, empty unless
``optimizer.ema_decay > 0``) and the collective error-feedback residual
(``collective_residual``: this rank's f32 row, one tensor per parameter,
empty unless ``train.spmd_mode: shard_map`` runs the int8 wire with
``parallel.error_feedback``). PyTorch updates the parameters and optimizer
slots in place, so the state is a mutable record rather than a pytree that
each step replaces.

Sharded across ranks (``layout``: parallel/zero.py ``ZeroUpdate``,
parallel/sharding.py ``DimSharding``) each rank holds its own part: under
ZeRO the optimizer slots are this rank's ``(chunk,)`` row of the stacked
``(n, chunk)`` layout, grouped per bucket under ``precision.fused_update``
(train/optimizers.py ``BucketOptimizers``, one optimizer a bucket); under FSDP the parameters, the slots and the EMA
are this rank's parts between steps (the model's parameters are the parts
themselves); under ZeRO-1 the slots are parts. The int8 residual keeps
the full parameter shape in every mode. Under tensor parallelism
(``tp``) the parameters, the slots and the EMA are this rank's
tensor-parallel parts, which FSDP and ZeRO-1 may cut further. Under
expert parallelism (``ep``) the MoE layers' ``wi``/``wo``, their slots and
their EMA are this rank's experts. Under
pipeline parallelism (``pipe``) the model, its slots and its EMA are
this rank's stage (and the embedding and head).
``state_dict`` and
``load_state_dict`` carry these parts as they are (a rollback snapshot of
one rank restores into the same rank); ckpt/checkpoint.py turns them into
the whole layout and back.

``state_dict``/``load_state_dict`` are what a checkpoint and a rollback
snapshot hold: the step, the model's tensors (BN buffers included), the
optimizer (the inner torch optimizer's slots and ``Optimizer.count``), the
dropout generator's state with the device type it belongs to, the EMA
when there is one and the residual when there is one. ``state_dict``
returns the LIVE tensors: anything kept past the next step takes
:func:`host_copy` of it, since on the CPU ``tensor.to("cpu")`` is the
same tensor and the next ``optimizer.step`` would overwrite it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
from torch import nn

from distributed_tensorflow_framework_torch.train.optimizers import (
    BucketOptimizers,
    Optimizer,
)


def host_copy(tree: Any) -> Any:
    """A host copy of every tensor in a nest of dicts, lists and tuples
    (``copy=True``, so a CPU tensor is copied too); other leaves as they
    are. A device tensor's copy waits for the work that writes it."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return type(tree)((k, host_copy(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer | BucketOptimizers
    dropout_generator: torch.Generator
    # Parameter name → its f32 moving average; {} when the EMA is off.
    ema_params: dict[str, torch.Tensor] = field(default_factory=dict)
    # Parameter name → this rank's f32 error-feedback residual of the int8
    # gradient all-reduce (parallel/collectives.py); {} when unused.
    collective_residual: dict[str, torch.Tensor] = field(
        default_factory=dict)
    # The DistributedDataParallel wrapper of ``model`` that the train step
    # runs forward through when a process group exists; not state: it
    # holds no tensor of its own, and a checkpoint names the model's.
    ddp: nn.Module | None = None
    # How the state is sharded across ranks (ZeroUpdate or DimSharding),
    # None when it is replicated; not state: it holds the shards the
    # optimizer updates, which it re-cuts or which the model's
    # parameters are.
    layout: Any = None
    # The tensor-parallel split of the model (parallel/tensor_parallel.py
    # ``TensorParallel``), None without one; not state: the model's
    # parameters are its parts.
    tp: Any = None
    # The expert-parallel split of the MoE layers (parallel/expert.py
    # ``ExpertParallel``), None without one; not state: the model's
    # expert parameters are its parts.
    ep: Any = None
    # A pipelined model's stage layout (parallel/pipeline.py
    # ``StageLayout``), None without a pipeline; not state: the model
    # holds this rank's stage.
    pipe: Any = None

    @property
    def train_module(self) -> nn.Module:
        """What the train step calls: the DDP wrapper, else the model."""
        return self.model if self.ddp is None else self.ddp

    def state_dict(self) -> dict:
        out = {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "dropout_generator": self.dropout_generator.get_state(),
            "generator_device": self.dropout_generator.device.type,
        }
        if self.ema_params:
            out["ema"] = dict(self.ema_params)
        if self.collective_residual:
            out["collective_residual"] = dict(self.collective_residual)
        return out

    def load_state_dict(self, state: dict) -> None:
        """Load ``state`` in place. Its optimizer tensors are taken over
        (see ``Optimizer.load_state_dict``): pass a copy nothing else
        holds. The EMA follows ``optimizer.ema_decay`` across a restart,
        as in the JAX trainer: a saved EMA is copied into this state's,
        re-seeded from the restored parameters when none was saved, and
        dropped when this run keeps none. The residual follows the same
        rule: copied when saved, zero when not, dropped when this run has
        none (ckpt/checkpoint.py picks or folds the rank's row first).
        A generator state from another device type is refused — a CUDA
        generator's state does not fit a CPU generator, nor the reverse,
        and re-seeding would silently change the dropout stream."""
        saved = state["generator_device"]
        here = self.dropout_generator.device.type
        if saved != here:
            raise ValueError(
                f"the saved dropout generator state belongs to a {saved} "
                f"generator and this run's generator is on {here}: a "
                f"checkpoint restores only onto the device type it was "
                f"saved from ({saved}), and re-seeding would change the "
                f"dropout stream")
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        with torch.no_grad():
            for key, p in self.model.named_parameters():
                if key in self.ema_params:
                    self.ema_params[key].copy_(
                        state["ema"][key] if "ema" in state else p)
            for key, r in self.collective_residual.items():
                if "collective_residual" in state:
                    r.copy_(state["collective_residual"][key])
                else:
                    r.zero_()
        self.dropout_generator.set_state(
            state["dropout_generator"].to("cpu"))
        self.step = int(state["step"])
