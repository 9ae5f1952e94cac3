"""Train and eval steps: the port's counterpart of ``train/step.py``.

:class:`StepBuilder` is cut to the JAX package's single-device ``jit``
path for the masked-LM task: one micro-step is the forward in ``train()``
mode, :func:`~.losses.mlm_loss` and the backward (through the
flash-attention kernels when ``attention_impl: pallas``); with
``train.grad_accum_steps > 1`` the micro-batch gradients are summed
weighted by their masked-token counts and divided by the total, which is
the full-batch gradient (``_accumulated_grads``), and the dropout stream
advances per micro-batch. Then the optimizer applies one update.

Step metrics: ``loss`` and ``mlm_acc``, ``grad_norm`` (the global norm of
the gradients BEFORE clipping) and ``learning_rate`` (the schedule at the
step before the increment). They stay on the device; the trainer syncs
only when it logs.

Every knob whose JAX machinery is not ported raises NotImplementedError
naming its ROADMAP.md item when it is not at its off value: multi-device
meshes, ``spmd_mode: shard_map``, ZeRO/FSDP, compressed collectives, the
fused update, the selective remat policies and the EMA. ``model.remat``
(per-layer checkpointing) is carried by the model.
"""

from __future__ import annotations

from typing import Any

import torch

from distributed_tensorflow_framework_torch.core import prng
from distributed_tensorflow_framework_torch.core.config import ExperimentConfig
from distributed_tensorflow_framework_torch.core.device import resolve_device
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.train import losses
from distributed_tensorflow_framework_torch.train.optimizers import (
    global_norm,
    make_optimizer,
)
from distributed_tensorflow_framework_torch.train.state import TrainState


def task_for_model(name: str) -> str:
    return "mlm" if "bert" in name.lower() else "classification"


def model_inputs(task: str, batch: Any) -> tuple:
    if task == "mlm":
        if "segment_ids" in batch:
            # Packed sequences: block-diagonal attention over the per-row
            # segment ids.
            return (batch["input_ids"], batch["attention_mask"],
                    batch["segment_ids"])
        if "attention_mask" in batch:
            return (batch["input_ids"], batch["attention_mask"])
        return (batch["input_ids"],)
    return (batch["image"],)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet — ROADMAP.md queue A item {item}")


def check_single_device_jit(config: ExperimentConfig) -> None:
    """Raise for every setting the single-card jit path does not carry."""
    mesh = config.mesh.axis_sizes()
    if any(size > 1 for size in mesh.values()):
        raise _not_ported(
            f"a mesh of more than one device ({mesh}); the port trains on "
            f"one card", "A1 (torch.distributed runtime) and A10 (FSDP)")
    if config.train.spmd_mode != "jit":
        raise _not_ported(f"train.spmd_mode={config.train.spmd_mode!r} "
                          f"(explicit collectives)", "A9")
    opt = config.optimizer
    if opt.zero_sharding != "off" or opt.shard_opt_state:
        raise _not_ported("ZeRO weight-update sharding "
                          "(optimizer.zero_sharding)", "A10")
    if config.parallel.collective_dtype or config.train.grad_allreduce_dtype:
        raise _not_ported("compressed collectives "
                          "(parallel.collective_dtype)", "A9")
    precision = config.precision
    if precision.fused_update:
        raise _not_ported("precision.fused_update", "A13")
    if precision.remat_policy != "none":
        raise _not_ported("selective rematerialisation "
                          "(precision.remat_policy)", "A13")
    if precision.activation_dtype or precision.matmul_dtype:
        raise _not_ported("the precision pack (precision.activation_dtype, "
                          "precision.matmul_dtype)", "A13")
    if opt.ema_decay > 0:
        raise _not_ported("the parameter EMA (optimizer.ema_decay>0)", "A3")


class StepBuilder:
    """Builds the train state and the train/eval steps for a workload on
    one device (default CUDA; ``device="cpu"`` runs the plain path)."""

    def __init__(self, config: ExperimentConfig, *,
                 device: str | torch.device = "cuda"):
        check_single_device_jit(config)
        self.config = config
        self.device = resolve_device(device)
        self.task = task_for_model(config.model.name)
        if self.task != "mlm":
            raise _not_ported(f"training model {config.model.name!r}",
                              "A2 (LeNet-5), A5 (ResNet) and A6 (Inception)")
        if config.data.vocab_size > config.model.vocab_size:
            # Ids at or above the embedding size would fault the CUDA
            # gather; the JAX package refuses the same configuration.
            raise ValueError(
                f"data.vocab_size={config.data.vocab_size} exceeds "
                f"model.vocab_size={config.model.vocab_size}: the stream "
                f"can emit token ids the embedding/MLM head cannot "
                f"represent. Shrink data.vocab_size or grow "
                f"model.vocab_size.")
        self.accum = max(1, config.train.grad_accum_steps)

    def init_state(self, seed: int) -> TrainState:
        """Parameters drawn from the (seed, init) stream, the optimizer
        over them, and the (seed, dropout) generator; model in train()."""
        model = get_model(
            self.config.model, device=self.device,
            generator=prng.torch_generator(seed, prng.ROLE_INIT,
                                           self.device))
        optimizer, self.schedule = make_optimizer(
            self.config.optimizer, self.config.train.total_steps, model)
        self.base_schedule = self.schedule
        return TrainState(
            step=0, model=model.train(), optimizer=optimizer,
            dropout_generator=prng.torch_generator(seed, prng.ROLE_DROPOUT,
                                                   self.device))

    def set_schedule_wrapper(self, state: TrainState, wrapper) -> None:
        """Apply ``wrapper`` to the config's schedule for the optimizer and
        the ``learning_rate`` metric (the post-rollback re-warmup,
        schedules.with_rewarmup)."""
        self.schedule = wrapper(self.base_schedule)
        state.optimizer.schedule = self.schedule

    def _micro_step(self, state: TrainState, batch: dict, loss_scale,
                    fault_scale: float = 1.0) -> dict[str, torch.Tensor]:
        """Forward + MLM loss + backward of ``loss * loss_scale``; the
        gradients add into ``.grad``. ``fault_scale`` multiplies the loss
        itself (see ``train_step``)."""
        logits = state.model(*model_inputs(self.task, batch),
                             dropout_generator=state.dropout_generator)
        loss, metrics = losses.mlm_loss(logits, batch["targets"])
        if fault_scale != 1.0:
            loss = loss * fault_scale
            metrics["loss"] = loss
        (loss * loss_scale).backward()
        return {k: v.detach() for k, v in metrics.items()}

    def _split(self, batch: dict) -> list[dict]:
        out = []
        for key, value in batch.items():
            if value.shape[0] % self.accum:
                raise ValueError(
                    f"grad_accum_steps={self.accum} does not divide batch "
                    f"leaf {key} of size {value.shape[0]}")
        for chunks in zip(*(v.chunk(self.accum) for v in batch.values())):
            out.append(dict(zip(batch.keys(), chunks)))
        return out

    def train_step(self, state: TrainState, batch: dict, *,
                   fault_scale: float = 1.0
                   ) -> dict[str, torch.Tensor | float]:
        """One optimizer step on ``batch`` (tensors on the device). Updates
        ``state`` in place and returns the step's metrics, unsynced.
        ``fault_scale`` multiplies the loss, its gradients and the reported
        loss: NaN for the ``nan_grads`` drills, 1e4 for ``loss_spike``
        (core/faults.py); the default 1.0 leaves the step untouched."""
        state.model.train()
        state.optimizer.zero_grad()
        if self.accum == 1:
            metrics = self._micro_step(state, batch, 1.0, fault_scale)
        else:
            weights, sums = [], {}
            for mb in self._split(batch):
                w = losses.mlm_mask(mb["targets"]).sum()
                m = self._micro_step(state, mb, w, fault_scale)
                weights.append(w)
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + w * v
            inv = 1.0 / torch.stack(weights).sum().clamp(min=1e-9)
            grads = [p.grad for p in state.model.parameters()]
            torch._foreach_mul_(grads, inv)
            metrics = {k: v * inv for k, v in sums.items()}
        grad_norm = global_norm([p.grad for p in state.model.parameters()])
        state.optimizer.step(grad_norm)
        metrics["grad_norm"] = grad_norm
        metrics["learning_rate"] = self.schedule(state.step)
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState,
                  batch: dict) -> dict[str, torch.Tensor]:
        """Weighted MLM metric sums for one eval batch, in ``eval()`` mode
        (no dropout). Batches without a ``weight`` key weight every
        example 1."""
        state.model.eval()
        try:
            logits = state.model(*model_inputs(self.task, batch))
        finally:
            state.model.train()
        targets = batch["targets"]
        weight = batch.get("weight")
        if weight is None:
            weight = torch.ones(targets.shape[0], device=targets.device)
        return losses.mlm_metrics_sums(logits, targets, weight)

