"""Train and eval steps: the port's counterpart of ``train/step.py``.

:class:`StepBuilder` is cut to the JAX package's single-device ``jit``
path, for the masked-LM task (BERT) and the classification task (LeNet,
ResNet). One micro-step is the forward in ``train()`` mode, the task's
loss (:func:`~.losses.mlm_loss`, or :func:`~.losses.classification_loss`
with ``train.label_smoothing``) and the backward (through the
flash-attention kernels when ``attention_impl: pallas``). With
``train.grad_accum_steps > 1`` the micro-batch gradients are summed
weighted — by their masked-token counts for MLM, by 1 for classification
— and divided by the total, which is the full-batch gradient
(``_accumulated_grads``); BatchNorm's running statistics move micro-batch
by micro-batch, and the dropout stream advances per micro-batch. Then the
optimizer applies one update, and with ``optimizer.ema_decay > 0`` the
parameter EMA follows it (``ema ← d·ema + (1 − d)·p``,
``d = min(decay, (1 + t)/(10 + t))`` at the step t before the increment).

Step metrics: ``loss`` and ``mlm_acc`` or ``top1``/``top5``,
``grad_norm`` (the global norm of the gradients BEFORE clipping) and
``learning_rate`` (the schedule at the step before the increment). They
stay on the device; the trainer syncs only when it logs. The eval step
runs in ``eval()`` mode (BN on its running statistics, no dropout), on the
EMA parameters when ``train.eval_use_ema`` and the EMA is on.

Every knob whose JAX machinery is not ported raises NotImplementedError
naming its ROADMAP.md item when it is not at its off value: multi-device
meshes, ``spmd_mode: shard_map``, ZeRO/FSDP, compressed collectives, the
fused update and the selective remat policies. ``model.remat``
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
    ema_update_,
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


class StepBuilder:
    """Builds the train state and the train/eval steps for a workload on
    one device (default CUDA; ``device="cpu"`` runs the plain path)."""

    def __init__(self, config: ExperimentConfig, *,
                 device: str | torch.device = "cuda"):
        check_single_device_jit(config)
        self.config = config
        self.device = resolve_device(device)
        self.task = task_for_model(config.model.name)
        if (self.task == "mlm"
                and config.data.vocab_size > config.model.vocab_size):
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
        over them, the (seed, dropout) generator and, with
        ``optimizer.ema_decay > 0``, the EMA starting at the parameters;
        model in train()."""
        model = get_model(
            self.config.model, device=self.device,
            generator=prng.torch_generator(seed, prng.ROLE_INIT,
                                           self.device),
            in_channels=(None if self.task == "mlm"
                         else self.config.data.channels))
        optimizer, self.schedule = make_optimizer(
            self.config.optimizer, self.config.train.total_steps, model)
        self.base_schedule = self.schedule
        ema = ({k: p.detach().float().clone()
                for k, p in model.named_parameters()}
               if self.config.optimizer.ema_decay > 0 else {})
        return TrainState(
            step=0, model=model.train(), optimizer=optimizer,
            dropout_generator=prng.torch_generator(seed, prng.ROLE_DROPOUT,
                                                   self.device),
            ema_params=ema)

    def set_schedule_wrapper(self, state: TrainState, wrapper) -> None:
        """Apply ``wrapper`` to the config's schedule for the optimizer and
        the ``learning_rate`` metric (the post-rollback re-warmup,
        schedules.with_rewarmup)."""
        self.schedule = wrapper(self.base_schedule)
        state.optimizer.schedule = self.schedule

    def _micro_step(self, state: TrainState, batch: dict, loss_scale,
                    fault_scale: float = 1.0) -> dict[str, torch.Tensor]:
        """Forward + the task's loss + backward of ``loss * loss_scale``;
        the gradients add into ``.grad``. ``fault_scale`` multiplies the
        loss itself (see ``train_step``)."""
        if self.task == "mlm":
            logits = state.model(*model_inputs(self.task, batch),
                                 dropout_generator=state.dropout_generator)
            loss, metrics = losses.mlm_loss(logits, batch["targets"])
        else:
            logits = state.model(batch["image"])
            loss, metrics = losses.classification_loss(
                logits, batch["label"],
                label_smoothing=self.config.train.label_smoothing)
        if fault_scale != 1.0:
            loss = loss * fault_scale
            metrics["loss"] = loss
        (loss * loss_scale).backward()
        return {k: v.detach() for k, v in metrics.items()}

    def _microbatch_weight(self, mb: dict) -> torch.Tensor:
        """A micro-batch's share of the full-batch loss denominator: its
        masked tokens for MLM, 1 for the per-example mean of
        classification."""
        if self.task == "mlm":
            return losses.mlm_mask(mb["targets"]).sum()
        return torch.ones((), device=mb["label"].device)

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
                w = self._microbatch_weight(mb)
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
        if state.ema_params:
            ema_update_(list(state.ema_params.values()),
                        [p for _, p in state.model.named_parameters()],
                        self.config.optimizer.ema_decay, state.step)
        metrics["grad_norm"] = grad_norm
        metrics["learning_rate"] = self.schedule(state.step)
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState,
                  batch: dict) -> dict[str, torch.Tensor]:
        """Weighted metric sums for one eval batch, in ``eval()`` mode (no
        dropout; BN on its running statistics), with the EMA parameters
        when ``train.eval_use_ema`` and the EMA is on. Batches without a
        ``weight`` key weight every example 1."""
        inputs = model_inputs(self.task, batch)
        state.model.eval()
        try:
            if state.ema_params and self.config.train.eval_use_ema:
                logits = torch.func.functional_call(
                    state.model, state.ema_params, inputs)
            else:
                logits = state.model(*inputs)
        finally:
            state.model.train()
        labels = batch["targets" if self.task == "mlm" else "label"]
        weight = batch.get("weight")
        if weight is None:
            weight = torch.ones(labels.shape[0], device=labels.device)
        if self.task == "mlm":
            return losses.mlm_metrics_sums(logits, labels, weight)
        return losses.classification_metrics_sums(logits, labels, weight)
