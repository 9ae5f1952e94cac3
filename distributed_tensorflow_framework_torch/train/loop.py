"""The training loop: the port's counterpart of ``train/loop.py``'s
``Trainer``.

build → maybe-restore → step loop with hooks → final save, on one device
or on every rank of a gang (``runtime``, core/mesh.py: one process per
GPU, the model under DDP, train/step.py). Each data-parallel rank reads
its block of every global batch (``get_dataset`` with its data-parallel
index and count, ``MeshRuntime.data_group``; the ranks along
``mesh.model`` read the same block; the layout in a ``data_shard``
event); at log steps the task metrics are reduced to the global batch's,
so every rank sees the same values and the recovery ladder decides alike
everywhere. Metrics go to the console and
``events.jsonl`` from the chief only; rank i keeps ``events-p<i>.jsonl``
and ``heartbeat-p<i>.json``. The chief writes the checkpoints, and after
the final one every rank waits at the exit barrier for its commit record
(core/cluster.py).
As in the JAX trainer, each step's metrics stay on the device and the host
syncs only at ``train.log_interval`` and at the last step;
``train.dispatch_ahead`` bounds how many unsynced steps may be queued by
syncing on the oldest. The first step builds the CUDA kernels (at first
use), so its host time is filed under the ``compile`` phase, as the JAX
trainer files its first dispatch. The same loop trains the masked-LM
(BERT) and the image classification (LeNet, ResNet) configs;
``examples_per_sec`` counts sequences or images.

With ``checkpoint.directory`` set, ``build`` restores the newest verified
checkpoint (or ``checkpoint.restore_step``), the checkpoint hook saves
every ``checkpoint.save_interval_steps`` and at the end, a heartbeat file
is kept there, and ``events.jsonl`` goes there unless ``log_dir`` is
given. Batches come through the prefetcher of data/infeed.py (a producer
thread with ``data.async_infeed``), behind the infeed watchdog
(``resilience.infeed_deadline_s``) with retries and backoff. With
``resilience.rollback`` (the default), the recovery ladder of
train/anomaly.py classifies every fetched step, rolls back to the last
clean in-memory snapshot on an anomaly, skips the batches in between and
escalates with ``PersistentAnomalyError`` when it runs out of rollbacks.
A SIGTERM (core/supervision.py) stops the loop at the next step boundary
for a final save. The ``DTF_FAULTS`` points of core/faults.py fire at
each step's start.

Observability, as in the JAX trainer (core/goodput.py, core/memstats.py,
core/tracing.py, core/profiling.py): a goodput ledger, backdated to the
trainer's construction, files every second of the run under its buckets
and writes ``goodput`` events (periodic, and a final one after the exit
barrier); device memory is sampled every ``train.memory_interval_s`` and
at the end (``memory`` events); with ``train.memory_analysis`` the first
step is measured (a ``memory`` event with ``extra.analysis``); spans
``worker.run`` → ``train.startup``, ``train.steps`` (one a log window),
``ckpt.save`` and ``train.rollback`` go out as ``span`` events
(``trace.enabled``), parented on ``DTF_TRACE_CTX`` when a launcher set
it; a flight recorder keeps the last ``trace.ring_size`` events and dumps
them on a graceful preemption, a persistent anomaly and SIGUSR1; and
``train.profile_start``/``profile_stop`` open a profile window over steps
(start, stop] into ``<checkpoint.directory>/traces`` (the chief only).
Each dispatch runs under ``annotate("train_step")``. The XLA compilation
cache (``train.compilation_cache_dir``) has no eager counterpart: the
kernels persist in ``build/kernels/`` by source hash, the setting is named
in the ``startup`` event and the run goes on uncached (cli/train.py logs
it). The first step runs inside the collective tally
(parallel/collectives.py), whose summary rides every logged
``train_step`` event as its ``collectives`` field (a DDP run's is empty:
DDP owns its reduction, as XLA does under the JAX package's ``jit``;
a ZeRO run's holds the ``zero_reduce_scatter`` and ``zero_all_gather``
kinds). A ZeRO run writes its static plan once as a ``zero_update`` event
(parallel/zero.py ``plan_summary``), and ``run_meta`` names
``zero_sharding``, the mesh's ``fsdp`` and the bucket count, the mesh's
``model`` and how many leaves tensor parallelism splits
(``tp_sharded_leaves``), the mesh's ``expert`` and how many leaves expert
parallelism splits (``ep_sharded_leaves``). A MoE model arms the MoE
collapse hook, as the JAX trainer does.
Evaluation is exact, as in the JAX
trainer: a finite eval stream (TFRecords) is walked once in full, every
record once, the padded tail weighted out; an infinite one (the synthetic
fallback) gives ``train.eval_steps`` batches. Across ranks each rank
evaluates its shard (the same number of batches everywhere,
data/tfdata.py) and the metric sums are added over the data-parallel
ranks, and under sequence parallelism over the ``seq`` ranks too, each of
which scores its part of every row (``StepBuilder.reduce_group``). The
throughput counts the global batch once, whatever ranks share its rows;
``run_meta`` names ``sequence_parallel`` (the ``seq`` ranks a row is
split over, 1 when it is not) and the ring's ``p2p_transport``. A
pipelined run (parallel/pipeline.py) writes its resolved schedule once as
a ``pipeline_schedule`` event (stages, microbatches, virtual stages, the
analytic bubble and the peak activation residency, parallel/schedule.py),
as the JAX trainer does, and ``run_meta`` names ``pipeline_schedule`` and
``pipeline_stages``. At each
metrics fetch the sequence-packing census of the train stream's state is
written as a ``data_packing`` event.
"""

from __future__ import annotations

import collections
import logging
import os
import sys
import tempfile
import time

import torch

from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
    CheckpointManager,
)
from distributed_tensorflow_framework_torch.core import (
    cluster,
    faults,
    goodput,
    memstats,
    profiling,
    supervision,
    telemetry,
    tracing,
)
from distributed_tensorflow_framework_torch.core.config import ExperimentConfig
from distributed_tensorflow_framework_torch.core.mesh import (
    MeshRuntime,
    initialize_runtime,
)
from distributed_tensorflow_framework_torch.core.metrics import (
    MetricWriter,
    setup_logging,
)
from distributed_tensorflow_framework_torch.data import get_dataset, packing
from distributed_tensorflow_framework_torch.data import shard as data_shard
from distributed_tensorflow_framework_torch.data.infeed import (
    InfeedStallError,
    prefetch_to_device,
    to_device,
)
from distributed_tensorflow_framework_torch.data.pipeline import (
    FAULT_SCALE_KEY,
)
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from distributed_tensorflow_framework_torch.parallel import schedule as sched
from distributed_tensorflow_framework_torch.parallel import zero
from distributed_tensorflow_framework_torch.train import anomaly as anomaly_lib
from distributed_tensorflow_framework_torch.train import hooks as hooks_lib
from distributed_tensorflow_framework_torch.train import schedules
from distributed_tensorflow_framework_torch.train.step import (
    StepBuilder,
    zero_mode,
)

log = logging.getLogger(__name__)


def _fault_scale(fault: faults.Fault) -> float:
    """The loss multiplier of a step_begin fault (train/step.py)."""
    if fault.kind in ("nan_grads", "repeat_nan"):
        return float("nan")
    return faults.LOSS_SPIKE_FACTOR  # loss_spike


class Trainer:
    """Trains ``config`` on ``device`` (default CUDA; ``device="cpu"``
    runs the plain PyTorch path), or as one rank of ``runtime`` (default:
    ``initialize_runtime`` from the gang environment, a single process
    without it). ``events.jsonl`` goes to ``log_dir``, else to
    ``checkpoint.directory``, else nowhere."""

    def __init__(self, config: ExperimentConfig, *,
                 device: str | torch.device = "cuda",
                 log_dir: str | None = None,
                 runtime: MeshRuntime | None = None):
        setup_logging()
        # Construction → first completed step (the startup event, the
        # train.startup span and the ledger's startup bucket).
        self._init_t = time.perf_counter()
        self._init_mono = time.monotonic()
        self.config = config
        rt = runtime or initialize_runtime(config.mesh, device)
        self.builder = StepBuilder(config, runtime=rt)
        # The builder's runtime: a runtime formed for another mesh over
        # the same ranks comes back with this config's subgroups.
        rt = self.runtime = self.builder.runtime
        self.device = self.builder.device
        dp = rt.data_group
        self.dataset = get_dataset(config.data, process_index=dp.index,
                                   process_count=dp.size)
        self.log_dir = log_dir or config.checkpoint.directory or None
        self.writer = MetricWriter(self.log_dir, is_chief=rt.is_chief,
                                   process_index=rt.process_index,
                                   process_count=rt.process_count)
        tw = self.writer.telemetry
        self.recovery = (anomaly_lib.RecoveryManager(
            config.resilience, telemetry_writer=tw)
            if config.resilience.rollback else None)
        self.goodput = goodput.GoodputLedger(
            tw, interval_s=config.train.goodput_interval_s,
            t0_perf=self._init_t,
            process_id=rt.process_index if rt.process_count > 1 else None)
        self._startup_accounted = False
        self.memstats = memstats.MemoryMonitor(
            tw, interval_s=config.train.memory_interval_s, source="train",
            devices=[self.device])
        self.tracer = tracing.Tracer(tw if config.trace.enabled else None,
                                     service=f"worker{rt.process_index}")
        self._trace_parent = tracing.env_context()
        self.tracer.adopt(self._trace_parent)
        self.run_span: tracing.Span | None = None  # opened by train()
        self.flightrec = tracing.FlightRecorder(
            config.trace.ring_size,
            dump_dir=(config.trace.dump_dir or config.checkpoint.directory
                      or None),
            tracer=self.tracer).attach(tw)
        self.flightrec.install_sigusr1()
        # The first step's memory analysis (train.memory_analysis), once
        # measured.
        self.memory_analysis: dict | None = None
        self.state = None
        self.host_step = 0
        self.preempted = False
        self._ckpt_manager = None
        self.restored_step: int | None = None
        self._startup_emitted = False
        self._eval_ds = None
        self._eval_start: dict = {}
        # The first step's collective tally (the trainer's
        # ``collectives_summary`` in the JAX package).
        self.collectives_summary: dict | None = None
        # Iterator snapshot paired with host_step (data/infeed.py).
        self.data_ckpt_state: dict = self.dataset.state()

    def build(self) -> None:
        cfg, rt = self.config, self.runtime
        self.state = self.builder.init_state(cfg.train.seed)
        layout = self.state.layout
        plan = getattr(layout, "plan", None)
        self.writer.telemetry.emit_run_meta(
            argv=list(sys.argv), config_name=cfg.name,
            spmd_mode=cfg.train.spmd_mode, model=cfg.model.name,
            dataset=cfg.data.name,
            global_batch_size=cfg.data.global_batch_size,
            mesh=rt.sizes, process_count=rt.process_count,
            process_index=rt.process_index, device=str(self.device),
            process_group=rt.backend, ddp=self.state.ddp is not None,
            collective_dtype=self.builder.wire,
            collective_block_size=cfg.parallel.collective_block_size,
            error_feedback=self.builder.use_residual,
            collective_transport=self.builder.collective_transport,
            zero_sharding=zero_mode(cfg), fsdp=rt.sizes["fsdp"],
            zero_buckets=None if plan is None else plan.num_buckets,
            model_parallel=rt.sizes["model"],
            tp_sharded_leaves=(0 if self.state.tp is None
                               else self.state.tp.sharded),
            expert_parallel=rt.sizes["expert"],
            ep_sharded_leaves=(0 if self.state.ep is None
                               else self.state.ep.sharded),
            sequence_parallel=(rt.sizes["seq"] if self.builder.seq_parallel
                               else 1),
            p2p_transport=(rt.p2p_transport(self.device)
                           if self.builder.seq_parallel
                           or self.builder.pipelined else None),
            pipeline_stages=cfg.model.pipeline_stages,
            pipeline_schedule=(cfg.model.pipeline_schedule
                               if self.builder.pipelined else None))
        if plan is not None:
            # One record of the static shard/bucket plan, so that byte and
            # step-time rollups read against the plan that produced them.
            self.writer.telemetry.emit(
                telemetry.KIND_ZERO_UPDATE, **zero.plan_summary(
                    plan, wire_dtype=self.builder.wire or None,
                    block_size=cfg.parallel.collective_block_size))
        stages = cfg.model.pipeline_stages
        if self.builder.pipelined:
            # One record of the resolved schedule, so that step-time
            # rollups read against the right bubble.
            name = cfg.model.pipeline_schedule
            micro = cfg.model.pipeline_microbatches or stages
            virtual = self.state.model.virtual_stages
            self.writer.telemetry.emit(
                telemetry.KIND_PIPELINE, schedule=name, stages=stages,
                microbatches=micro, virtual_stages=virtual,
                bubble_frac=sched.bubble_frac(name, stages, micro, virtual),
                peak_inflight=sched.peak_inflight(name, stages, micro,
                                                  virtual))
        self.writer.telemetry.emit(
            telemetry.KIND_DATA_SHARD, step=self.host_step,
            shard=data_shard.shard_plan(
                data_shard.ShardAssignment(rt.data_group.index,
                                           rt.data_group.size),
                global_batch=cfg.data.global_batch_size,
                data_parallel=rt.data_parallel_size,
                shard_mode=cfg.data.shard_mode))
        if cfg.train.eval_steps > 0:
            self._ensure_eval()
        ck = cfg.checkpoint
        if ck.restore_step >= 0 and not (ck.directory and ck.restore):
            # Fail loudly: starting from scratch because restoring is off
            # is the fallback restore_step exists to prevent.
            raise ValueError(
                "checkpoint.restore_step set but restoring is disabled — "
                "need checkpoint.directory non-empty and "
                "checkpoint.restore=true")
        if not ck.directory:
            return
        self._ckpt_manager = CheckpointManager(
            ck, telemetry_writer=self.writer.telemetry, runtime=rt)
        self._ckpt_manager.set_data_sources(
            repartition=self.dataset.repartition,
            resume_strict=cfg.data.resume_strict)
        if not ck.restore:
            return
        want = ck.restore_step
        if want >= 0 and want not in self._ckpt_manager.all_steps():
            raise ValueError(
                f"checkpoint.restore_step={want} not found in "
                f"{ck.directory!r} (available: "
                f"{self._ckpt_manager.all_steps()})")
        restored = self._ckpt_manager.restore(
            self.state, dataset=self.dataset,
            step=want if want >= 0 else None)
        if restored is not None:
            self.host_step = self.restored_step = restored
            # Re-pair the checkpointable snapshot with the restored stream
            # position: a rollback baseline built from the initial one
            # would mis-compute skip ordinals.
            self.data_ckpt_state = self.dataset.state()
            log.info("Restored checkpoint at step %d from %s", restored,
                     self._ckpt_manager.directory)

    def default_hooks(self) -> list:
        cfg = self.config
        rt = self.runtime
        tp = hooks_lib.ThroughputHook(batch_size=cfg.data.global_batch_size,
                                      num_chips=rt.process_count)
        hooks = [tp, hooks_lib.LoggingHook(self.writer,
                                           cfg.train.log_interval, tp)]
        if cfg.train.nan_guard:
            hooks.append(hooks_lib.NaNGuardHook())
        if cfg.model.num_experts > 0:
            hooks.append(hooks_lib.MoECollapseHook())
        if self._ckpt_manager is not None:
            hooks.append(hooks_lib.HeartbeatHook(
                cluster.heartbeat_path(self._ckpt_manager.directory,
                                       rt.process_index, rt.process_count),
                min_interval_s=cfg.cluster.heartbeat_interval_s))
            hooks.append(hooks_lib.CheckpointHook(
                self._ckpt_manager, cfg.checkpoint.save_interval_steps))
        if cfg.train.eval_interval > 0:
            if cfg.train.eval_steps > 0:
                hooks.append(hooks_lib.EvalHook(
                    self.evaluate, cfg.train.eval_interval,
                    num_batches=cfg.train.eval_steps))
            else:
                log.warning("train.eval_interval=%d but eval_steps=0 — "
                            "mid-training eval disabled",
                            cfg.train.eval_interval)
        if cfg.train.profile_stop > cfg.train.profile_start and rt.is_chief:
            hooks.append(hooks_lib.ProfileHook(
                os.path.join(cfg.checkpoint.directory or self.log_dir
                             or tempfile.gettempdir(), "traces"),
                cfg.train.profile_start, cfg.train.profile_stop))
        return hooks

    def train(self, hooks: list | None = None) -> dict[str, float]:
        if self.state is None:
            self.build()
        ck = self.config.checkpoint
        if (self._ckpt_manager is not None and ck.restore_step >= 0
                and ck.restore_step < (self._ckpt_manager.latest_step()
                                       or 0)):
            # Saving a branch into a directory that holds NEWER steps
            # would skip every already-saved step and a restart would
            # re-restore restore_step, losing the branch.
            raise ValueError(
                f"checkpoint.restore_step={ck.restore_step} is older than "
                f"the directory's latest step "
                f"({self._ckpt_manager.latest_step()}) — training would "
                f"interleave two lineages. Copy the checkpoint into a fresh "
                f"checkpoint.directory to branch, or use --eval-only.")
        cfg = self.config.train
        hooks = self.default_hooks() if hooks is None else hooks
        # The rank's root span, parented on the launcher's span when
        # DTF_TRACE_CTX names one; left open on a crash, so the flight
        # recorder's open spans still show the fault's ancestry.
        self.run_span = self.tracer.start(
            "worker.run", self._trace_parent,
            process=self.runtime.process_index, start_step=self.host_step)
        for h in hooks:
            h.on_start(self)
        infeed = prefetch_to_device(
            self.dataset, self.device, size=self.config.data.prefetch,
            background=self.config.data.async_infeed,
            deadline_s=self.config.resilience.infeed_deadline_s)
        if self._ckpt_manager is not None:
            self._ckpt_manager.set_data_sources(
                watermark_source=infeed.watermark)
        if self.recovery is not None:
            # Baseline: the ladder can roll back even if the first anomaly
            # lands before the first clean fetch.
            self.recovery.take_snapshot(self.host_step, self.state,
                                        data_state=self.data_ckpt_state,
                                        force=True)
        timer = profiling.StepTimer()
        pending: collections.deque = collections.deque()
        last_metrics: dict[str, float] = {}
        first = True
        if not self._startup_accounted:
            # Construction → loop entry (restore, input and eval build);
            # the first dispatch lands in the recompile bucket.
            self._startup_accounted = True
            self.goodput.add("startup", time.perf_counter() - self._init_t)
        try:
            while self.host_step < cfg.total_steps:
                if supervision.preemption_requested():
                    # SIGTERM: the previous step is complete; on_end below
                    # force-saves and the CLI exits GRACEFUL_PREEMPT_RC.
                    self.preempted = True
                    log.warning("preemption requested — stopping at step %d "
                                "for a final checkpoint", self.host_step)
                    self.writer.telemetry.emit(
                        telemetry.KIND_HEALTH, step=self.host_step,
                        health={"event": "graceful_preemption",
                                "step": self.host_step})
                    # A supervisor SIGKILLs after its grace window: make
                    # the stream durable and dump the recorder now.
                    self.writer.telemetry.flush()
                    self.flightrec.dump("graceful_preemption")
                    break
                with timer.phase("infeed"):
                    batch, self.data_ckpt_state = self._next_batch(infeed)
                # A corrupt_shard fault on a batch without floating
                # fields poisons the step's loss (data/pipeline.py).
                poison = batch.pop(FAULT_SCALE_KEY, None)
                scale = 1.0 if poison is None else float(poison)
                for fault in faults.fire("step_begin",
                                         step=self.host_step + 1):
                    scale *= _fault_scale(fault)
                if (cfg.dispatch_ahead > 0
                        and len(pending) >= cfg.dispatch_ahead):
                    with timer.phase("backpressure"):
                        float(pending.popleft()["loss"])
                with timer.phase("compile" if first else "dispatch"), \
                        profiling.annotate("train_step"):
                    if self.collectives_summary is None:
                        with coll.tally() as tly:
                            metrics = self._first_step(batch, scale)
                        self.collectives_summary = tly.summary()
                    else:
                        metrics = self.builder.train_step(
                            self.state, batch, fault_scale=scale)
                if first:
                    self.goodput.count("recompiles")
                first = False
                if cfg.dispatch_ahead > 0:
                    pending.append(metrics)
                self.host_step += 1
                if not self._startup_emitted:
                    self._startup_emitted = True
                    self.writer.telemetry.emit(
                        telemetry.KIND_STARTUP, step=self.host_step,
                        time_to_first_step_s=(time.perf_counter()
                                              - self._init_t),
                        restored_step=self.restored_step,
                        compilation_cache_dir=(cfg.compilation_cache_dir
                                               or None))
                    self.tracer.emit_span(
                        "train.startup", self.run_span,
                        start_mono=self._init_mono,
                        end_mono=time.monotonic(),
                        first_step=self.host_step,
                        restored_step=self.restored_step)
                    self._window_mono = time.monotonic()
                    self._window_step = self.host_step
                host_metrics = None
                if (self.host_step % cfg.log_interval == 0
                        or self.host_step >= cfg.total_steps):
                    # Apart from the backpressure above, the host waits
                    # for the device only here.
                    with timer.phase("metrics_fetch"):
                        host_metrics = {
                            k: float(v) for k, v in
                            self.builder.global_metrics(metrics).items()}
                    host_metrics.update(timer.means())
                    self.goodput.absorb_phases(timer.totals)
                    timer.reset()
                    pending.clear()
                    # A rollback returns None: the hooks never see the
                    # anomalous metrics, and host_step has been rewound.
                    host_metrics = self._maybe_recover(host_metrics)
                    if host_metrics is not None:
                        last_metrics = host_metrics
                    self.goodput.maybe_emit(step=self.host_step)
                    self.memstats.maybe_sample(step=self.host_step)
                    self._emit_packing()
                    # One span a log window: cheap, and a restart's dead
                    # time shows as a gap between windows.
                    now = time.monotonic()
                    self.tracer.emit_span(
                        "train.steps", self.run_span,
                        start_mono=self._window_mono, end_mono=now,
                        start_step=self._window_step,
                        end_step=self.host_step)
                    self._window_mono, self._window_step = (now,
                                                            self.host_step)
                for h in hooks:
                    h.after_step(self, self.host_step, host_metrics)
                if self.recovery is not None and self.recovery.exhausted:
                    # A finite anomaly past max_rollbacks (NaNGuardHook
                    # sees only non-finite ones), or nan_guard off. The
                    # recorder's ring holds the rollbacks that led here.
                    self.flightrec.dump("persistent_anomaly")
                    raise anomaly_lib.PersistentAnomalyError(
                        self.recovery.escalation_message(),
                        provenance=self.recovery.provenance())
        finally:
            # The producer must stop pulling from a dataset the caller
            # may restore or reuse, and the final save must not poll it.
            infeed.close()
            if self._ckpt_manager is not None:
                self._ckpt_manager.set_data_sources(watermark_source=None)
            # The phases since the last fetch, on the escalation path too
            # (its last periodic snapshot is then its ledger of record).
            self.goodput.absorb_phases(timer.totals)
            timer.reset()
        for h in hooks:
            h.on_end(self)
        if self._ckpt_manager is not None:
            # Exit barrier, for hook lists without the CheckpointHook too.
            self._ckpt_manager.wait_until_finished()
            if self.runtime.process_count > 1:
                # No rank returns before the chief's final commit record
                # is durable: a rank that exits early takes the process
                # group down under a peer.
                cluster.exit_barrier(
                    self._ckpt_manager.directory, step=self.host_step,
                    timeout_s=self.config.cluster.exit_barrier_timeout_s,
                    poll_s=self.config.cluster.exit_barrier_poll_s,
                    is_chief=self.runtime.is_chief)
        # After the exit barrier, so the last save's blocked ms is in.
        self.goodput.finalize(step=self.host_step)
        self.memstats.sample(step=self.host_step, final=True)
        self.run_span.end(status="preempted" if self.preempted else "ok",
                          end_step=self.host_step)
        return last_metrics

    def _first_step(self, batch: dict, scale: float) -> dict:
        """The first dispatch; with ``train.memory_analysis`` (the chief
        only, as in the JAX trainer) measured by core/memstats.py: the
        state's and the batch's bytes, and on CUDA the allocator's peak
        over the step."""
        def step():
            return self.builder.train_step(self.state, batch,
                                           fault_scale=scale)

        if not (self.config.train.memory_analysis
                and self.runtime.is_chief):
            return step()

        def argument_bytes() -> int:
            held = self.state.state_dict()
            return memstats.tensor_bytes(held["model"], held["optimizer"],
                                         held.get("ema"),
                                         held.get("collective_residual"),
                                         batch)

        metrics, self.memory_analysis = self.memstats.capture_step(
            step, argument_bytes, self.device)
        return metrics

    def _emit_packing(self) -> None:
        """The packing census riding the step-paired data snapshot
        (data/packing.py counters), cumulative: the last event of a run
        is its total. Streams without the counters emit nothing."""
        real = self.data_ckpt_state.get(packing.REAL_TOKENS_KEY)
        if real is not None:
            self.writer.telemetry.emit(
                telemetry.KIND_DATA_PACKING, step=self.host_step,
                metrics=packing.packing_stats(
                    int(real), int(self.data_ckpt_state.get(
                        packing.PADDED_TOKENS_KEY, 0))))

    # ------------------------------------------------- recovery ladder --
    def _next_batch(self, infeed):
        """One infeed pull behind the stall watchdog: past the deadline,
        wait for the SAME pull again with linear backoff, one
        ``infeed_stall`` event per attempt; past ``infeed_retries`` the
        InfeedStallError propagates."""
        rcfg = self.config.resilience
        attempt = 0
        while True:
            try:
                return next(infeed)
            except InfeedStallError as e:
                attempt += 1
                self.writer.telemetry.emit(
                    telemetry.KIND_INFEED_STALL, step=self.host_step,
                    health={"deadline_s": e.deadline_s, "attempt": attempt,
                            "max_retries": rcfg.infeed_retries})
                if attempt > rcfg.infeed_retries:
                    log.error("infeed stalled past %d retries — escalating",
                              rcfg.infeed_retries)
                    raise
                backoff = rcfg.infeed_backoff_s * attempt
                log.warning("infeed stall (attempt %d/%d, deadline %.1fs) — "
                            "retrying in %.2fs", attempt,
                            rcfg.infeed_retries, e.deadline_s, backoff)
                time.sleep(backoff)

    def _maybe_recover(self, host_metrics: dict[str, float]
                       ) -> dict[str, float] | None:
        """Classify a fetched step. Clean: feed the detector, maybe
        snapshot, return the metrics. Anomalous with a rollback left:
        restore the newest snapshot, record the skipped batch ordinals,
        rewind host_step, return None. Anomalous with none left: set
        ``recovery.exhausted`` and return the metrics (the caller
        escalates after the hooks)."""
        rec = self.recovery
        if rec is None:
            return host_metrics
        if rec.classify(self.host_step, host_metrics) is None:
            rec.take_snapshot(self.host_step, self.state,
                              data_state=self.data_ckpt_state)
            return host_metrics
        if not rec.can_rollback():
            rec.exhausted = True
            return host_metrics
        from_step, t_rb = self.host_step, time.monotonic()
        with self.goodput.timed("rollback"):
            snap = self._rollback()
        self.tracer.emit_span(
            "train.rollback", self.run_span, start_mono=t_rb,
            end_mono=time.monotonic(), from_step=from_step,
            to_step=snap.step)
        return None

    def _rollback(self):
        """Restore the newest snapshot, record the skipped ordinals,
        rewind host_step and re-warm the rate; returns the snapshot."""
        self.state, snap = self.recovery.rollback(self.state,
                                                  from_step=self.host_step)
        # The data iterator is NOT rewound: record which consumed ordinals
        # were skipped, in the dataset and (rebound, never mutated: queued
        # saves share nested lists) in the step-paired snapshot.
        snap_consumed = int((snap.data_state or {}).get("consumed", 0))
        live_consumed = int(self.data_ckpt_state.get("consumed", 0))
        if live_consumed > snap_consumed:
            skipped = range(snap_consumed + 1, live_consumed + 1)
            self.dataset.record_skipped(skipped)
            merged = sorted(
                {int(o) for o in self.data_ckpt_state.get("batches_skipped",
                                                          ())}
                | set(skipped))
            self.data_ckpt_state = {**self.data_ckpt_state,
                                    "batches_skipped": merged}
        self.host_step = snap.step
        steps = self.config.resilience.lr_rewarmup_steps
        if steps > 0:
            log.info("re-warming learning rate over steps [%d, %d) after "
                     "rollback", snap.step, snap.step + steps)
            self.builder.set_schedule_wrapper(
                self.state, lambda sched: schedules.with_rewarmup(
                    sched, snap.step, steps))
        return snap

    # ------------------------------------------------------------ eval --
    def _ensure_eval(self):
        """Build the eval stream once (``eval_data``, else ``data``) and
        remember its start, so every evaluation reads the same batches."""
        if self._eval_ds is None:
            dp = self.runtime.data_group
            self._eval_ds = get_dataset(
                self.config.eval_data or self.config.data,
                process_index=dp.index, process_count=dp.size, train=False)
            self._eval_start = self._eval_ds.state()
        return self._eval_ds

    def evaluate(self, step: int | None = None,
                 num_batches: int | None = None) -> dict[str, float]:
        """Exact evaluation: weighted means of the task's metrics
        (``eval_loss`` and ``eval_mlm_acc``, or ``eval_top1``/``eval_top5``)
        and ``eval_examples``, the masked tokens (MLM) or the images seen,
        over every rank's shard. A finite eval stream
        (``cardinality`` set) is walked once in full, every record once,
        the zero-padded tail adding no weight; ``num_batches`` at or above
        the cardinality means the full set, below it truncates with a
        warning. An infinite stream gives ``num_batches`` (default
        ``train.eval_steps``) batches. Written as an ``eval`` event when
        ``step`` is given."""
        if self.state is None:
            self.build()
        ds = self._ensure_eval()
        ds.restore(self._eval_start)  # a fresh pass every call
        if ds.cardinality is None:
            n = (self.config.train.eval_steps if num_batches is None
                 else num_batches)
        elif num_batches is None or num_batches >= ds.cardinality:
            n = ds.cardinality
        else:
            # A silently dropped tail would bias every mid-training
            # metric logged, so a truncation is said out loud.
            n = num_batches
            log.warning("eval truncated: %d of %d batches (set "
                        "train.eval_steps >= %d for full coverage)", n,
                        ds.cardinality, ds.cardinality)
        totals: dict[str, float] = {}
        for _ in range(n):
            m = self.builder.eval_step(self.state,
                                       to_device(next(ds), self.device))
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v)
        group = self.builder.reduce_group
        if group.size > 1:
            keys = sorted(totals)
            summed = self.runtime.all_reduce_(torch.tensor(
                [totals[k] for k in keys], dtype=torch.float64,
                device=self.runtime.collective_device), group)
            totals = dict(zip(keys, summed.tolist()))
        weight = totals.pop("weight_sum", 0.0)
        results = {f"eval_{k[:-len('_sum')]}": v / max(weight, 1e-9)
                   for k, v in totals.items()}
        results["eval_examples"] = weight
        if step is not None:
            self.writer.write(step, results, kind=telemetry.KIND_EVAL)
        return results
