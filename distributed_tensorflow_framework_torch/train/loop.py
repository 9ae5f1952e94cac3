"""The training loop: the port's counterpart of ``train/loop.py``'s
``Trainer``.

``build`` → step loop with hooks → final eval, on one device. As in the
JAX trainer, each step's metrics stay on the device and the host syncs
only at ``train.log_interval`` and at the last step; ``train.dispatch_ahead``
bounds how many unsynced steps may be queued by syncing on the oldest.
The first step builds the CUDA kernels (at first use), so its host time is
filed under the ``compile`` phase, as the JAX trainer files its first
dispatch.

Not ported, and refused where the JAX trainer would act on them:
checkpointing (``checkpoint.directory`` non-empty raises, ROADMAP.md queue
A item A4), the in-process recovery ladder (``resilience.rollback: true``
raises, A14), the infeed watchdog (``resilience.infeed_deadline_s > 0``,
A14), the profile window and compiled-memory analysis (A16) and the XLA
compilation cache (``train.compilation_cache_dir``, no eager counterpart).
Left out because they only write events and change no result: tracing
spans, the goodput ledger, memory sampling, the startup event, fault
injection, the flight recorder, the collective tally and the background
prefetcher (``data.async_infeed``, ``data.prefetch``). Evaluation walks
``train.eval_steps`` batches of the (infinite, synthetic) eval stream; the
exact single-pass eval over a finite set arrives with the TFRecord reader
(A7).
"""

from __future__ import annotations

import collections
import logging
import sys

import torch

from distributed_tensorflow_framework_torch.core import profiling, telemetry
from distributed_tensorflow_framework_torch.core.config import ExperimentConfig
from distributed_tensorflow_framework_torch.core.metrics import (
    MetricWriter,
    setup_logging,
)
from distributed_tensorflow_framework_torch.data import get_dataset
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.train import hooks as hooks_lib
from distributed_tensorflow_framework_torch.train.step import StepBuilder

log = logging.getLogger(__name__)


def check_trainer_config(config: ExperimentConfig) -> None:
    """Raise for the loop-level settings the port does not carry."""
    if config.checkpoint.directory:
        raise NotImplementedError(
            f"checkpoint.directory={config.checkpoint.directory!r}: "
            f"checkpointing is not ported yet — ROADMAP.md queue A item A4 "
            f"(set checkpoint.directory= to train without checkpoints)")
    res = config.resilience
    if res.rollback:
        raise NotImplementedError(
            "resilience.rollback=true: the in-process recovery ladder is not "
            "ported yet — ROADMAP.md queue A item A14 (set "
            "resilience.rollback=false)")
    if res.infeed_deadline_s > 0:
        raise NotImplementedError(
            "resilience.infeed_deadline_s>0: the infeed watchdog is not "
            "ported yet — ROADMAP.md queue A item A14")
    tcfg = config.train
    if tcfg.profile_stop > tcfg.profile_start or tcfg.memory_analysis:
        raise NotImplementedError(
            "train.profile_start/profile_stop and train.memory_analysis are "
            "not ported yet — ROADMAP.md queue A item A16")
    if tcfg.compilation_cache_dir:
        raise NotImplementedError(
            "train.compilation_cache_dir is the XLA compilation cache; the "
            "eager port compiles no programs ahead — ROADMAP.md queue A "
            "item A16")


class Trainer:
    """Trains ``config`` on ``device`` (default CUDA; ``device="cpu"``
    runs the plain PyTorch path). ``log_dir`` receives ``events.jsonl``
    (the JAX trainer writes it to ``checkpoint.directory``, which the port
    refuses until checkpointing is ported)."""

    def __init__(self, config: ExperimentConfig, *,
                 device: str | torch.device = "cuda",
                 log_dir: str | None = None):
        setup_logging()
        check_trainer_config(config)
        self.config = config
        self.builder = StepBuilder(config, device=device)
        self.device = self.builder.device
        self.dataset = get_dataset(config.data)
        self.writer = MetricWriter(log_dir)
        self.state = None
        self.host_step = 0
        self._eval_ds = None
        self._eval_start: dict = {}

    def build(self) -> None:
        cfg = self.config
        self.writer.telemetry.emit_run_meta(
            argv=list(sys.argv), config_name=cfg.name,
            spmd_mode=cfg.train.spmd_mode, model=cfg.model.name,
            dataset=cfg.data.name,
            global_batch_size=cfg.data.global_batch_size,
            mesh={"data": 1}, process_count=1, process_index=0,
            device=str(self.device))
        self.state = self.builder.init_state(cfg.train.seed)
        if cfg.train.eval_steps > 0:
            self._ensure_eval()

    def default_hooks(self) -> list:
        cfg = self.config
        tp = hooks_lib.ThroughputHook(batch_size=cfg.data.global_batch_size,
                                      num_chips=1)
        hooks = [tp, hooks_lib.LoggingHook(self.writer,
                                           cfg.train.log_interval, tp)]
        if cfg.train.nan_guard:
            hooks.append(hooks_lib.NaNGuardHook())
        if cfg.train.eval_interval > 0:
            if cfg.train.eval_steps > 0:
                hooks.append(hooks_lib.EvalHook(
                    self.evaluate, cfg.train.eval_interval,
                    num_batches=cfg.train.eval_steps))
            else:
                log.warning("train.eval_interval=%d but eval_steps=0 — "
                            "mid-training eval disabled",
                            cfg.train.eval_interval)
        return hooks

    def train(self, hooks: list | None = None) -> dict[str, float]:
        if self.state is None:
            self.build()
        cfg = self.config.train
        hooks = self.default_hooks() if hooks is None else hooks
        for h in hooks:
            h.on_start(self)
        timer = profiling.StepTimer()
        pending: collections.deque = collections.deque()
        last_metrics: dict[str, float] = {}
        first = True
        while self.host_step < cfg.total_steps:
            with timer.phase("infeed"):
                batch = to_device(next(self.dataset), self.device)
            if cfg.dispatch_ahead > 0 and len(pending) >= cfg.dispatch_ahead:
                with timer.phase("backpressure"):
                    float(pending.popleft()["loss"])
            with timer.phase("compile" if first else "dispatch"):
                metrics = self.builder.train_step(self.state, batch)
            first = False
            if cfg.dispatch_ahead > 0:
                pending.append(metrics)
            self.host_step += 1
            host_metrics = None
            if (self.host_step % cfg.log_interval == 0
                    or self.host_step >= cfg.total_steps):
                # Apart from the backpressure above, the host waits for
                # the device only here.
                with timer.phase("metrics_fetch"):
                    host_metrics = {k: float(v) for k, v in metrics.items()}
                host_metrics.update(timer.means())
                timer.reset()
                pending.clear()
                last_metrics = host_metrics
            for h in hooks:
                h.after_step(self, self.host_step, host_metrics)
        for h in hooks:
            h.on_end(self)
        return last_metrics

    def _ensure_eval(self):
        """Build the eval stream once (``eval_data``, else ``data``) and
        remember its start, so every evaluation reads the same batches."""
        if self._eval_ds is None:
            self._eval_ds = get_dataset(self.config.eval_data
                                        or self.config.data, train=False)
            self._eval_start = self._eval_ds.state()
        return self._eval_ds

    def evaluate(self, step: int | None = None,
                 num_batches: int | None = None) -> dict[str, float]:
        """Weighted means of the MLM metrics over ``num_batches`` (default
        ``train.eval_steps``) eval batches; ``eval_examples`` is the masked
        tokens seen. Written as an ``eval`` event when ``step`` is given."""
        if self.state is None:
            self.build()
        ds = self._ensure_eval()
        ds.restore(self._eval_start)  # a fresh pass every call
        n = self.config.train.eval_steps if num_batches is None else num_batches
        totals: dict[str, float] = {}
        for _ in range(n):
            m = self.builder.eval_step(self.state,
                                       to_device(next(ds), self.device))
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v)
        weight = totals.pop("weight_sum", 0.0)
        results = {f"eval_{k[:-len('_sum')]}": v / max(weight, 1e-9)
                   for k, v in totals.items()}
        results["eval_examples"] = weight
        if step is not None:
            self.writer.write(step, results, kind=telemetry.KIND_EVAL)
        return results
