"""Train and eval steps: the port's counterpart of ``train/step.py``.

:class:`StepBuilder` is cut to the JAX package's ``jit`` path, for the
masked-LM task (BERT) and the classification task (LeNet, ResNet,
Inception-v3), on one device or data parallel over the ranks of a process
group (core/mesh.py). One micro-step is the forward in ``train()`` mode,
the task's loss (:func:`~.losses.mlm_loss`, or
:func:`~.losses.classification_loss` with ``train.label_smoothing``, plus
0.4 times the same loss of Inception's aux logits, reported as
``aux_loss`` beside ``total_loss``) and the backward (through the flash-attention kernels when ``attention_impl:
pallas``). With ``train.grad_accum_steps > 1`` the micro-batch gradients
are summed weighted — by their masked-token counts for MLM, by 1 for
classification — and divided by the total, which is the full-batch
gradient (``_accumulated_grads``); BatchNorm's running statistics move
micro-batch by micro-batch, and the dropout stream advances per
micro-batch. Then the optimizer applies one update, and with
``optimizer.ema_decay > 0`` the parameter EMA follows it (``ema ← d·ema +
(1 − d)·p``, ``d = min(decay, (1 + t)/(10 + t))`` at the step t before
the increment).

Across ranks, under ``train.spmd_mode: jit`` (the default), the model
runs under ``DistributedDataParallel`` over the data × fsdp ranks
(``MeshRuntime.data_group``: every rank unless ``mesh.seq`` or
``mesh.model`` exceeds 1; data × fsdp × seq under sequence parallelism;
``gradient_as_bucket_view``, no buffer broadcast: the BatchNorm
statistics are already global, models/layers.py; ``no_sync`` on every
micro-batch but the last), and each data-parallel rank feeds its block of
the global batch. DDP averages the ranks' gradients, while the JAX MLM
loss divides by the masked tokens of the GLOBAL batch; so before any
forward one ``all_reduce`` sums the step's masked count W, and each
rank's gradient is scaled so that the average is the global one: at one
micro-batch the rank back-propagates its Σce · n / W (n the
data-parallel ranks); with accumulation it sums its micro-batches' Σce
and the reduced gradient is multiplied by n / W. At n = 1 both factors
are exactly today's (1 and 1 / ΣW), so the single-rank step is bit for
bit the single-device one. Classification shards are equal, so the mean
of the ranks' means is the global mean. Each data-parallel rank's dropout
stream is its own ((seed, dropout, data-parallel index)); at n = 1 it is
the single-device stream.

Tensor parallelism (``mesh.model > 1`` under ``jit``; the JAX package's
GSPMD layout of ``TP_RULES``): the model is built whole from the seed on
every rank and parallel/tensor_parallel.py cuts it Megatron-style, so
each rank computes its heads and its MLP columns and the ranks along
``model`` reduce the row-parallel outputs. They share a data-parallel
index, so they read the same batch and draw the same dropout masks, and
the replicated leaves get the same gradients on every one of them.
``grad_norm`` (and the clipping) is the whole gradient's: the split
leaves' squared norms summed over ``model``, a replicated leaf counted
once. DDP runs over data × fsdp only, and not at all when that is one
rank. FSDP and ZeRO-1 cut the tensor-parallel parts further, along a dim
``model`` left free (parallel/sharding.py). Under ``shard_map`` there is
no tensor parallelism, as in the JAX package (its ``shard_map`` step
replicates every leaf): the ranks along ``model`` repeat the data × fsdp
step on the same batch and every collective spans data × fsdp. A fused
or separate QKV whose heads ``model`` does not divide (while it divides
H) keeps its column split: the columns are gathered whole over ``model``
before the attention, which every rank runs on every head, and each rank
keeps its columns of the context for the row-parallel ``attn_out``
(parallel/tensor_parallel.py); a leaf whose dim ``model`` does not
divide stays whole, as JAX's ``_match_rules`` leaves it.

Sequence parallelism (``mesh.seq > 1`` with ``attention_impl: ring``
under ``jit``; ROADMAP.md A11): the ranks along ``seq`` share a
data-parallel index, so they read the same rows and draw the same
dropout masks; each keeps its part of every row (models/bert.py
``shard_sequence``, parallel/ring.py) and of the targets. The parameters
are replicated over ``seq`` and each rank's gradient is the sum over its
tokens, so the gradient reduction (DDP's process group), the masked-token
weight, the task metrics and the exact eval's sums all span data × fsdp
× seq (:attr:`StepBuilder.reduce_group`), while ``data_group`` keeps its
meaning. With ``mesh.seq > 1`` and another attention, or another model,
the ranks along ``seq`` repeat the data-parallel step on the same batch,
as GSPMD replicates it. Ring attention under ``shard_map`` raises the
JAX package's failure as a ValueError (models/__init__.py). Beside
``fsdp`` (and ZeRO-1) the parameters are gathered per step and the
gradient is reduced over data × fsdp × seq before each rank keeps its
part; beside ``model`` each ``model`` rank rotates its own heads' K/V
around its ``seq`` line (core/mesh.py forms the line per (data, fsdp,
expert, model) index).

Pipeline parallelism (``mesh.pipe > 1`` with ``model.pipeline_stages``
equal to it, BERT under ``jit``; ROADMAP.md A12): each rank along
``pipe`` holds one stage of the encoder stack and the embedding and MLM
head whole (parallel/pipeline.py ``PipelinedBert``, under the gpipe, 1f1b
or interleaved schedule). The ranks along ``pipe`` share a data-parallel
index: they read the same batch, draw from the same dropout stream and
compute the same loss, which is counted once (the weight, the metrics
and DDP's reduction span data × fsdp, the stage parameters over the
replicas of the rank's own stage). The embedding and head take the same
gradients on every stage, and ``grad_norm`` (and the clipping) is the
whole gradient's: the stacks' squares summed over ``pipe``, the
replicated leaves counted once. FSDP keeps sharding the embedding and
head, never the stage layers (parallel/sharding.py), and so does ZeRO-1
with their slots. The step's metrics gain ``pipe_bubble_frac``, the
schedule's analytic bubble. The JAX package's refusals hold (stages
equal to ``pipe``, BERT only, ``jit`` only, beside ``data`` and ``fsdp``
only).

Mixture-of-Experts (BERT with ``model.num_experts > 0``; ROADMAP.md A8):
the model returns its logits with the MoE layers' aux outputs, and the
micro-step's loss is the MLM loss plus ``train.moe_aux_weight`` times
``moe_aux_loss`` (JAX ``_microbatch_grads``), with the metrics
``moe_aux_loss``, ``total_loss``, ``moe_drop_frac`` and, when the router
z-loss is armed, ``moe_zloss``; the eval step keeps the logits. Under
``jit`` across ranks the router's statistics are the global batch's
(parallel/expert.py ``RouterStats``), so the loss, the metrics and the
gradients are the JAX ``jit`` step's. With ``mesh.expert > 1`` the batch
is split over data × fsdp × expert (core/mesh.py ``DATA_AXES``) and each
rank along ``expert`` holds ``num_experts / mesh.expert`` of every MoE
layer's experts (parallel/expert.py ``ExpertParallel``): DDP reduces
every other leaf over data × fsdp × expert and leaves the expert parts
out, whose gradients one all-reduce over data × fsdp carries;
``grad_norm`` (and the clipping) is the whole gradient's. Beside
``model`` the MoE layers follow ``MOE_RULES`` (``wi`` column-parallel and
``wo`` row-parallel over F, the expert outputs summed over ``model``), and
the expert parts are cut from the tensor-parallel ones; beside ``fsdp``
FSDP cuts them further along the dim JAX's ``_apply_fsdp`` picks; under
the ring each ``seq`` rank routes its part of every row with the whole
row's capacity and claim order (one exchange of slot counts along
``seq``, models/moe.py), the router's statistics span data × fsdp ×
expert × seq, and the expert parts' gradients data × fsdp × seq. The
JAX package's refusals hold: ``mesh.expert > 1`` under ``shard_map``, MoE
or ``expert`` beside ``pipe``. Under ``shard_map`` (``expert`` 1) each
rank routes its own rows, as the JAX ``shard_map`` step's replicas do.

Under ``train.spmd_mode: shard_map`` (the JAX package's explicit
per-replica step, ``_train_step_replica``) there is no DDP wrapper: each
rank runs the micro-steps as a single device would, its micro-batches
weighted by its OWN masked tokens, so the MLM gradient is the mean of the
ranks' means; then parallel/collectives.py reduces the gradients on the
configured wire (``parallel.collective_dtype``: "" the f32 mean,
``bfloat16`` with ``train.grad_allreduce_accum`` float32 or wire, ``int8``
block-scaled, with the error-feedback residual
``state.collective_residual`` when ``parallel.error_feedback``), the
metrics become their plain mean over the ranks, and the BatchNorm running
statistics their mean after the step. BatchNorm's batch statistics span
every rank with ``model.bn_cross_replica`` (the default) and each rank's
own batch without it (the reference's per-GPU BN). The ranks start from
rank 0's parameters and buffers (one ``broadcast`` each). At a world of 1
with no wire the step is the single-device step bit for bit.

Step metrics: ``loss`` and ``mlm_acc`` or ``top1``/``top5``,
``grad_norm`` (the global norm of the reduced gradients BEFORE clipping)
and ``learning_rate`` (the schedule at the step before the increment).
They stay on the device; the trainer syncs only when it logs, and above
one rank under DDP reduces the task metrics there into global weighted
means (:meth:`StepBuilder.global_metrics`). The eval step runs in
``eval()`` mode (BN on its running statistics, no dropout), on the EMA
parameters when ``train.eval_use_ema`` and the EMA is on.

Sharded state (ROADMAP.md A10's ZeRO and FSDP halves; the layouts live in
parallel/zero.py and parallel/sharding.py):

  * ``optimizer.zero_sharding: shard_map`` (under ``shard_map``, over
    data × fsdp > 1 ranks; the JAX ``_zero_train_step_replica``): the
    micro-steps as above, then a bucketed mean reduce-scatter of the
    gradients on the wire (int8 with the error-feedback residual), the
    optimizer on this rank's 1/n of every flattened leaf, and a bucketed
    all-gather into every rank's whole parameters; ``grad_norm`` from the
    shards (``shard_global_norm``). The parameters, the EMA and the
    BatchNorm statistics stay replicated. At two ranks on the f32 wire the
    parameters and losses are the replicated ``shard_map`` step's bit for
    bit.
  * ``mesh.fsdp > 1`` under ``shard_map`` (explicit FSDP, the JAX
    ``_train_step_replica``'s fsdp branch): the parameters, slots and EMA
    are sharded at rest; a step gathers the parameters over ``fsdp`` on
    the wire, runs the micro-steps, reduces the gradients over every rank
    on the wire, takes ``grad_norm`` of the whole gradient, then slices
    each rank's part for the update.
  * ``mesh.fsdp > 1`` under ``jit`` (FSDP) and ``optimizer.zero_sharding:
    jit`` (ZeRO-1, ``mesh.fsdp > 1``): the jit step's numbers — DDP over
    the whole (gathered) parameters, the global masked-token weight,
    clipping on the whole gradient's norm, LARS's norms over whole leaves,
    BatchNorm allowed — with only the at-rest layout changed: FSDP holds
    the parameters, slots and EMA as parts between steps, ZeRO-1 the
    slots. Both equal the DDP step at the same world.

The JAX package's refusals hold: ZeRO ``shard_map`` needs ``shard_map``
and more than one replica and refuses ``lars`` and ``grad_clip_norm > 0``
(the update sees only shards); explicit FSDP refuses both as well and
BatchNorm models; ZeRO ``jit`` needs ``jit`` and ``mesh.fsdp > 1``.

The precision pack (``precision.*``; ROADMAP.md A13) is carried by the
model and the update: ``activation_dtype``, ``matmul_dtype`` and
``remat_policy`` go to ``get_model`` (models/__init__.py, with the JAX
package's refusals), ``model.remat`` (per-block checkpointing) is carried
by the model, and ``fused_update`` (ZeRO ``shard_map`` only, a
ValueError otherwise) runs parallel/zero.py's fused walk: per bucket the
reduce-scatter, the update by that bucket's optimizer
(``BucketOptimizers``), the all-gather and the apply, in place of the
three whole-tree passes.

A wire dtype under ``jit`` and a ``train.grad_allreduce_accum`` other
than float32 or wire raise the JAX package's ValueErrors.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.nn.parallel import DistributedDataParallel

from distributed_tensorflow_framework_torch.core import mesh as mesh_lib
from distributed_tensorflow_framework_torch.core import prng, profiling
from distributed_tensorflow_framework_torch.core.config import ExperimentConfig
from distributed_tensorflow_framework_torch.core.device import resolve_device
from distributed_tensorflow_framework_torch.models import (
    BERT_NAMES,
    check_precision,
    check_ring_mode,
    custom_model_task,
    get_model,
    model_kwargs,
)
from distributed_tensorflow_framework_torch.models.layers import (
    BatchNorm,
    use_cross_rank_bn,
)
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from distributed_tensorflow_framework_torch.parallel import expert as ep_lib
from distributed_tensorflow_framework_torch.parallel import ring
from distributed_tensorflow_framework_torch.parallel import schedule as sched
from distributed_tensorflow_framework_torch.parallel import zero
from distributed_tensorflow_framework_torch.parallel.pipeline import (
    StageLayout,
)
from distributed_tensorflow_framework_torch.parallel.sharding import (
    DimSharding,
)
from distributed_tensorflow_framework_torch.parallel.tensor_parallel import (
    TensorParallel,
)
from distributed_tensorflow_framework_torch.train import losses
from distributed_tensorflow_framework_torch.train.optimizers import (
    BucketOptimizers,
    ema_update_,
    global_norm,
    make_optimizer,
)
from distributed_tensorflow_framework_torch.train.state import TrainState


# Inception-v3's auxiliary classifier joins the loss at this weight (the
# canonical 0.4, JAX train/step.py).
AUX_LOSS_WEIGHT = 0.4


def task_for_model(name: str) -> str:
    custom = custom_model_task(name)
    if custom is not None:
        return custom
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


def zero_mode(config: ExperimentConfig) -> str:
    """``optimizer.zero_sharding``, with the deprecated
    ``optimizer.shard_opt_state`` honoured as "jit" for configs built
    without load_config's shim."""
    zs = config.optimizer.zero_sharding
    if config.optimizer.shard_opt_state and zs == "off":
        zs = "jit"
    return zs


def sequence_parallel(config: ExperimentConfig,
                      sizes: dict[str, int]) -> bool:
    """Whether the step splits each row over the ``seq`` ranks: ring
    attention in BERT at ``mesh.seq > 1``."""
    return (sizes["seq"] > 1 and config.model.attention_impl == "ring"
            and config.model.name.lower() in BERT_NAMES)


def check_pipeline(config: ExperimentConfig, sizes: dict[str, int]) -> None:
    """The JAX StepBuilder's pipeline checks (ValueErrors, the schedule's
    among them) and the model's refusals beside the pipeline."""
    mcfg = config.model
    pipe, stages = sizes["pipe"], mcfg.pipeline_stages
    if not (pipe > 1 or stages > 1 or mcfg.pipeline_microbatches > 0):
        return
    if stages <= 1:
        raise ValueError("pipeline_microbatches / mesh.pipe>1 require "
                         "model.pipeline_stages>1")
    if "bert" not in mcfg.name.lower():
        raise ValueError(
            "pipeline parallelism is only wired for the transformer (bert) "
            "models (parallel/pipeline.py)")
    if stages != pipe:
        raise ValueError(f"model.pipeline_stages={stages} must equal the "
                         f"mesh's pipe axis size {pipe}")
    if config.train.spmd_mode == "shard_map":
        raise ValueError(
            "pipeline parallelism runs under spmd_mode='jit' (the stage "
            "schedule is its own nested shard_map)")
    if (sizes["model"] > 1 or sizes["seq"] > 1 or sizes["expert"] > 1
            or mcfg.num_experts > 0):
        raise ValueError(
            "v1 pipeline scope: pipe composes with data/fsdp only — "
            "TP/seq/expert parallelism inside the pipelined stack needs "
            "manual-mode collectives in the stage body")
    sched.resolve_virtual(
        mcfg.pipeline_schedule, stages, mcfg.pipeline_microbatches or stages,
        mcfg.pipeline_virtual_stages, mcfg.num_layers)
    model_kwargs(mcfg)


def check_step_config(config: ExperimentConfig, world: int = 1
                      ) -> dict[str, int]:
    """Raise for every setting the data-parallel step over ``world`` ranks
    does not carry: MeshSizeError when the mesh does not fit the world,
    ValueError for the JAX package's refusals (a wire dtype under ``jit``,
    a bad ``train.grad_allreduce_accum``, ZeRO and explicit FSDP where
    their update cannot run, ring attention under ``shard_map``, a row
    the ring cannot split, a pipeline it cannot run, expert parallelism
    under ``shard_map``). Returns the mesh's sizes."""
    sizes = mesh_lib.resolve_mesh(config.mesh, world)
    tcfg = config.train
    if tcfg.spmd_mode not in ("jit", "shard_map"):
        raise ValueError(f"train.spmd_mode must be 'jit' or 'shard_map', "
                         f"got {tcfg.spmd_mode!r}")
    if tcfg.spmd_mode == "shard_map" and sizes["expert"] > 1:
        raise ValueError(
            "spmd_mode='shard_map' is the pure-DP reference-parity path; "
            "expert parallelism (mesh.expert>1) requires spmd_mode='jit'")
    check_pipeline(config, sizes)
    check_ring_mode(config.model, tcfg.spmd_mode)
    if sequence_parallel(config, sizes):
        for data in (config.data, config.eval_data):
            if data is not None:
                ring.check_ring_shape(data.seq_len, sizes["seq"])
    if ((config.parallel.collective_dtype or tcfg.grad_allreduce_dtype)
            and tcfg.spmd_mode != "shard_map"):
        raise ValueError(
            "parallel.collective_dtype (and the deprecated "
            "train.grad_allreduce_dtype) only applies to the explicit "
            "collective path — set train.spmd_mode='shard_map' (under "
            "'jit' DDP owns the gradient reduction wire format)")
    if tcfg.grad_allreduce_accum not in ("float32", "wire"):
        raise ValueError(
            "train.grad_allreduce_accum must be 'float32' or 'wire', "
            f"got {tcfg.grad_allreduce_accum!r}")
    opt = config.optimizer
    zs = zero_mode(config)
    shard_map = tcfg.spmd_mode == "shard_map"
    if zs == "shard_map":
        if not shard_map:
            raise ValueError(
                "optimizer.zero_sharding='shard_map' is the explicit "
                "bucketed reduce-scatter path and needs "
                "train.spmd_mode='shard_map'; under spmd_mode='jit' use "
                "optimizer.zero_sharding='jit'")
        zero_n = sizes["data"] * sizes["fsdp"]
        if zero_n <= 1:
            raise ValueError(
                "optimizer.zero_sharding='shard_map' shards the weight "
                "update over the data×fsdp replicas — this mesh has "
                f"{zero_n}, so it would be a silent no-op")
        if opt.name == "lars":
            raise ValueError(
                "optimizer.name='lars' needs full per-layer param/update "
                "norms, but zero_sharding='shard_map' updates flattened "
                "parameter SHARDS — use zero_sharding='jit' for lars")
        if opt.grad_clip_norm > 0:
            raise ValueError(
                "optimizer.grad_clip_norm>0 computes the global grad norm "
                "inside the optimizer, which under zero_sharding="
                "'shard_map' sees only gradient SHARDS — use "
                "zero_sharding='jit' for clipped training")
    if shard_map and sizes["fsdp"] > 1 and zs != "shard_map":
        if opt.name == "lars":
            raise ValueError(
                "optimizer.name='lars' needs full per-layer param/update "
                "norms, but explicit fsdp (spmd_mode='shard_map' with "
                "mesh.fsdp>1) updates parameter SHARDS — use "
                "spmd_mode='jit' for lars+fsdp")
        if opt.grad_clip_norm > 0:
            raise ValueError(
                "optimizer.grad_clip_norm>0 computes the global grad norm "
                "inside the optimizer, which under explicit fsdp "
                "(spmd_mode='shard_map' with mesh.fsdp>1) sees only "
                "gradient SHARDS — use spmd_mode='jit' for clipped fsdp "
                "training")
    if zs == "jit":
        if shard_map:
            raise ValueError(
                "optimizer.zero_sharding='jit' (and the deprecated "
                "optimizer.shard_opt_state) needs spmd_mode='jit'; the "
                "explicit path is optimizer.zero_sharding='shard_map'")
        if sizes["fsdp"] <= 1:
            raise ValueError(
                "optimizer.zero_sharding='jit' (and the deprecated "
                "optimizer.shard_opt_state) shards over the fsdp mesh axis "
                "— set mesh.fsdp > 1 (it would be a silent no-op on this "
                "mesh)")
    if config.precision.fused_update and zs != "shard_map":
        raise ValueError(
            "precision.fused_update=true fuses the optax apply into "
            "the ZeRO bucketed reverse-layer walk and therefore "
            "requires optimizer.zero_sharding='shard_map'")
    check_precision(config.model, config.precision)
    return sizes


def _taken_dims(tp, ep) -> dict[str, tuple[int, ...]] | None:
    """Each leaf's Flax dims that tensor and expert parallelism split,
    which FSDP leaves alone; None when neither splits anything."""
    if tp is None and ep is None:
        return None
    out: dict[str, tuple[int, ...]] = {}
    for layout in (tp, ep):
        for key, leaf in ({} if layout is None else layout.leaves).items():
            if leaf is None:
                continue
            dim = tp.flax_dims[key] if layout is tp else 0
            out[key] = out.get(key, ()) + (dim,)
    return out


class StepBuilder:
    """Builds the train state and the train/eval steps for a workload on
    one device (default CUDA; ``device="cpu"`` runs the plain path), or,
    given a ``runtime`` (core/mesh.py), on its device and data parallel
    over its ranks."""

    def __init__(self, config: ExperimentConfig, *,
                 device: str | torch.device = "cuda",
                 runtime: mesh_lib.MeshRuntime | None = None):
        self.world = 1 if runtime is None else runtime.process_count
        sizes = check_step_config(config, self.world)
        if runtime is not None and runtime.sizes != sizes:
            # A runtime formed for another mesh over the same ranks (one
            # process group serving several configs): its subgroups are
            # formed for this config's mesh.
            runtime = runtime.remesh(sizes)
        self.runtime = runtime
        self.config = config
        self.device = (resolve_device(device) if runtime is None
                       else runtime.device)
        # The data-parallel ranks (data × fsdp) and the tensor-parallel
        # split (``model`` under jit; under shard_map the ranks along
        # ``model`` repeat the step).
        self.data_group = None if runtime is None else runtime.data_group
        self.dp_world = 1 if runtime is None else self.data_group.size
        self.tensor_parallel = (config.train.spmd_mode == "jit"
                                and sizes["model"] > 1)
        # Expert parallelism: each rank along ``expert`` holds its block
        # of every MoE layer's experts.
        self.expert_parallel = (runtime is not None and sizes["expert"] > 1
                                and config.train.spmd_mode == "jit")
        # Sequence parallelism: the ranks the gradients, the loss weight
        # and the metrics reduce over are data × fsdp × expert × seq.
        self.seq_parallel = (runtime is not None
                             and sequence_parallel(config, sizes))
        self.reduce_group = (
            None if runtime is None
            else runtime.axis_group(mesh_lib.TOKEN_AXES)
            if self.seq_parallel else self.data_group)
        self.reduce_world = (1 if runtime is None
                             else self.reduce_group.size)
        # Pipeline parallelism: this rank is one stage of the stack.
        self.pipelined = config.model.pipeline_stages > 1
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
        self.shard_map = config.train.spmd_mode == "shard_map"
        # The ranks a step's loss denominator spans: the data-parallel
        # ranks (and the seq ranks of a split row) under DDP (the JAX jit
        # step's global weight), the rank alone under shard_map (each
        # replica's own mean).
        self.weight_world = 1 if self.shard_map else self.reduce_world
        # The explicit collectives' wire: parallel.collective_dtype, with
        # the deprecated train.grad_allreduce_dtype honoured for configs
        # built without load_config's shim.
        self.wire = (config.parallel.collective_dtype
                     or config.train.grad_allreduce_dtype)
        self.block = config.parallel.collective_block_size
        self.use_residual = (self.shard_map and self.wire == "int8"
                             and config.parallel.error_feedback)
        # The sharded layouts (module docstring). Under ZeRO shard_map the
        # fsdp axis folds into the shard count: no parameter gathers.
        zs = zero_mode(config)
        self.zero = zs == "shard_map"
        self.fused = self.zero and config.precision.fused_update
        self.zero_jit = zs == "jit"
        self.fsdp = sizes["fsdp"] > 1 and not (self.zero or self.zero_jit)

    @property
    def collective_transport(self) -> str | None:
        """How the explicit collectives travel (core/mesh.py), None under
        DDP."""
        if not self.shard_map:
            return None
        if self.runtime is None:
            return mesh_lib.TRANSPORT_NATIVE
        return self.runtime.collective_transport(self.device)

    def init_state(self, seed: int) -> TrainState:
        """Parameters drawn from the (seed, init) stream, the optimizer
        over them, the (seed, dropout) generator — (seed, dropout,
        data-parallel index) above one data-parallel rank — and, with
        ``optimizer.ema_decay > 0``, the EMA starting at the parameters;
        model in train(). Under tensor parallelism the whole model is cut
        into this rank's parts first. With a process group under ``jit``
        the model is wrapped in DDP over the data-parallel ranks (which
        broadcasts their first rank's parameters), and above one
        data-parallel rank its BatchNorms take their statistics over them.
        Under ``shard_map`` rank 0's parameters and buffers are broadcast,
        the BatchNorms are global above one data-parallel rank only with
        ``model.bn_cross_replica``, and with the int8 error-feedback wire
        the residual starts at zero. A sharded run's layout (ZeRO, FSDP or
        ZeRO-1) is cut from the replicated start, after DDP's broadcast,
        and the optimizer and the EMA run on its shards."""
        # Only a pipelined model takes the runtime (its stage).
        stage = {"runtime": self.runtime} if self.pipelined else {}
        model = get_model(
            self.config.model, device=self.device,
            generator=prng.torch_generator(seed, prng.ROLE_INIT,
                                           self.device),
            in_channels=(None if self.task == "mlm"
                         else self.config.data.channels),
            precision=self.config.precision, **stage)
        tp = (TensorParallel(model, self.runtime) if self.tensor_parallel
              else None)
        ep = (ep_lib.ExpertParallel(model, self.runtime, tp)
              if self.expert_parallel else None)
        if ep is not None and not ep.sharded:
            ep = None
        if not self.shard_map:
            # The JAX jit step routes the global batch: the balance
            # statistics are summed over the ranks that hold its tokens.
            ep_lib.attach_router_stats(model, self.runtime,
                                       self.seq_parallel)
        pipe = StageLayout(model) if self.pipelined else None
        if self.seq_parallel:
            model.shard_sequence(self.runtime)
        if self.dp_world > 1 and (not self.shard_map
                                  or self.config.model.bn_cross_replica):
            use_cross_rank_bn(model, self.data_group.group)
        if self.shard_map and self.world > 1:
            with torch.no_grad():
                for t in model.state_dict().values():
                    self.runtime.broadcast_(t)
        if (self.fsdp and self.shard_map
                and any(isinstance(m, BatchNorm) for m in model.modules())):
            raise ValueError(
                "explicit fsdp (spmd_mode='shard_map' with mesh.fsdp>1) "
                "does not support BN models: running stats would be "
                "updated from gathered params on every replica — use "
                "spmd_mode='jit' or a BN-free model")
        ddp = None
        if (not self.shard_map and self.runtime is not None
                and self.runtime.backend is not None
                and (self.reduce_world > 1 or self.world == 1)):
            # No DDP when only the ranks along ``model`` (or along a
            # repeating ``seq``) are there: they share one data-parallel
            # index.
            # Under sequence parallelism DDP keeps its first bucket order
            # (find_unused_parameters stops the rebuild after the first
            # backward): a ring all-reduce over more than two ranks sums
            # an element in an order set by its place in the bucket, so a
            # rebuilt order would make a resumed run's sums differ in the
            # last bit from a straight run's.
            if ep is not None:
                # The expert parts reduce over data × fsdp alone
                # (ExpertParallel.reduce_grads_).
                DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(  # noqa: E501
                    model, ep.part_keys())
            ddp = DistributedDataParallel(
                model, device_ids=(None if self.device.type == "cpu"
                                   else [self.device.index]),
                broadcast_buffers=False, gradient_as_bucket_view=True,
                process_group=self.reduce_group.group,
                find_unused_parameters=self.seq_parallel)
        # At the whole parameters' shapes, whatever the layout.
        residual = ({k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in model.named_parameters()}
                    if self.use_residual else {})
        layout, whole_norms = None, None
        if self.zero:
            layout = zero.ZeroUpdate(
                model, self.runtime,
                bucket_mb=self.config.optimizer.zero_bucket_mb,
                wire=self.wire or None, block_size=self.block)
        elif self.fsdp or self.zero_jit:
            layout = DimSharding(model, self.runtime, at_rest=self.fsdp,
                                 tally=self.shard_map,
                                 wire=self.wire or None,
                                 block_size=self.block,
                                 taken=_taken_dims(tp, ep),
                                 whole=() if pipe is None else [
                                     k for k, _ in model.named_parameters()
                                     if model.is_stage_key(k)])
            whole_norms = layout.whole_norms()
        params = (dict(model.named_parameters()) if layout is None
                  else layout.params)
        if tp is not None:
            whole_norms = tp.whole_norms(params, whole_norms)
        if ep is not None:
            whole_norms = ep.whole_norms(params, whole_norms)
        optimizer, self.schedule = make_optimizer(
            self.config.optimizer, self.config.train.total_steps, model,
            params=None if layout is None else layout.params,
            whole_norms=whole_norms)
        if self.fused:
            # One optimizer per ZeRO bucket, over its shards.
            optimizer = BucketOptimizers(self.config.optimizer,
                                         self.schedule, model,
                                         layout.bucket_params())
        self.base_schedule = self.schedule
        ema = {}
        if self.config.optimizer.ema_decay > 0:
            ema = (layout.ema_init(model) if isinstance(layout, DimSharding)
                   else {k: p.detach().float().clone()
                         for k, p in model.named_parameters()})
        rank = () if self.dp_world == 1 else (self.data_group.index,)
        return TrainState(
            step=0, model=model.train(), optimizer=optimizer,
            dropout_generator=prng.torch_generator(
                seed, prng.ROLE_DROPOUT, self.device, *rank),
            ema_params=ema, ddp=ddp, layout=layout,
            collective_residual=residual, tp=tp, ep=ep, pipe=pipe)

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
            out = state.train_module(
                *model_inputs(self.task, batch),
                dropout_generator=state.dropout_generator)
            logits = out["logits"] if isinstance(out, dict) else out
            loss, metrics = losses.mlm_loss(logits,
                                            self._targets(batch["targets"]))
            if isinstance(out, dict):
                loss = losses.add_moe_terms(
                    loss, metrics, out, self.config.train.moe_aux_weight)
        else:
            # Inception draws its dropout from the trainer's stream and, in
            # train mode, returns its aux head's logits too.
            kwargs = ({"dropout_generator": state.dropout_generator}
                      if getattr(state.model, "dropout_rate", 0.0) else {})
            logits = state.train_module(batch["image"], **kwargs)
            aux_logits = None
            if isinstance(logits, dict):
                logits, aux_logits = logits["logits"], logits["aux_logits"]
            smoothing = self.config.train.label_smoothing
            loss, metrics = losses.classification_loss(
                logits, batch["label"], label_smoothing=smoothing)
            if aux_logits is not None:
                aux_loss, _ = losses.classification_loss(
                    aux_logits, batch["label"], label_smoothing=smoothing)
                loss = loss + AUX_LOSS_WEIGHT * aux_loss
                metrics["aux_loss"] = aux_loss
                metrics["total_loss"] = loss
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
            return losses.mlm_mask(self._targets(mb["targets"])).sum()
        return torch.ones((), device=mb["label"].device)

    def _targets(self, targets: torch.Tensor) -> torch.Tensor:
        """The MLM targets of this rank's tokens: its part of each row
        under sequence parallelism, else all of them."""
        if not self.seq_parallel:
            return targets
        return targets[:, ring.seq_part(self.runtime, targets.shape[1])]

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

    def _global_weight(self, local: torch.Tensor) -> torch.Tensor:
        """The step's loss denominator over the ranks it spans."""
        if self.weight_world == 1:
            return local
        return self.runtime.all_reduce_(local.clone(), self.reduce_group)

    def train_step(self, state: TrainState, batch: dict, *,
                   fault_scale: float = 1.0
                   ) -> dict[str, torch.Tensor | float]:
        """One optimizer step on ``batch`` (this rank's block, tensors on
        the device). Updates ``state`` in place and returns the step's
        metrics, unsynced; above one rank under DDP the task metrics are
        this rank's, with their weight under ``_weight``
        (:meth:`global_metrics`); under ``shard_map`` they are the ranks'
        plain mean already. ``fault_scale`` multiplies the loss, its
        gradients and the reported loss: NaN for the ``nan_grads`` drills,
        1e4 for ``loss_spike`` (core/faults.py); the default 1.0 leaves
        the step untouched."""
        state.model.train()
        layout = state.layout
        state.optimizer.zero_grad()
        if layout is not None:
            state.model.zero_grad(set_to_none=True)
            if isinstance(layout, DimSharding):
                layout.begin_step_(state.model)
        world = self.weight_world
        if self.accum == 1:
            scale, weight = 1.0, None
            if world > 1:
                weight = self._microbatch_weight(batch)
                if self.task == "mlm":
                    scale = (weight.clamp(min=1.0) * world
                             / self._global_weight(weight).clamp(min=1.0))
            metrics = self._micro_step(state, batch, scale, fault_scale)
        else:
            micro = self._split(batch)
            weights = [self._microbatch_weight(mb) for mb in micro]
            weight = torch.stack(weights).sum()
            total = self._global_weight(weight)
            sums = {}
            for i, (mb, w) in enumerate(zip(micro, weights)):
                # DDP reduces the summed gradients in the last backward.
                with (state.ddp.no_sync()
                      if state.ddp is not None and i < self.accum - 1
                      else contextlib.nullcontext()):
                    m = self._micro_step(state, mb, w, fault_scale)
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + w * v
            inv = world / total.clamp(min=1e-9)
            grads = [p.grad for p in state.model.parameters()]
            torch._foreach_mul_(grads, inv)
            local_inv = inv if world == 1 else 1.0 / weight.clamp(min=1e-9)
            metrics = {k: v * local_inv for k, v in sums.items()}
        if world > 1:
            metrics["_weight"] = weight
        grad_norm = None
        if self.shard_map:
            metrics, grad_norm = self._explicit_collectives(state, metrics)
        if state.ep is not None:
            state.ep.reduce_grads_(state.model, self.reduce_world,
                                   seq=self.seq_parallel)
            grad_norm = state.ep.global_norm(
                {k: p.grad for k, p in state.model.named_parameters()})
        if grad_norm is None and state.tp is not None:
            grad_norm = state.tp.global_norm(
                {k: p.grad for k, p in state.model.named_parameters()})
        elif grad_norm is None and state.pipe is not None:
            grad_norm = state.pipe.global_norm(
                {k: p.grad for k, p in state.model.named_parameters()})
        elif grad_norm is None:
            grad_norm = global_norm([p.grad
                                     for p in state.model.parameters()])
        if isinstance(layout, DimSharding):
            layout.shard_grads_(state.model)
        if not self.fused:  # the fused walk has updated the parameters
            # The JAX step's named_scope: the trace analyzer
            # (core/trace_analysis.py) files the kernels launched here
            # under optimizer_update. The fused walk annotates each
            # bucket's update between its collectives.
            with profiling.annotate("optimizer_update"):
                state.optimizer.step(grad_norm)
            if layout is not None:
                layout.finish_step_(state.model)
        if state.ema_params:
            ema_update_(list(state.ema_params.values()),
                        (layout.ema_sources(state.model)
                         if isinstance(layout, DimSharding)
                         else [p for _, p in state.model.named_parameters()]),
                        self.config.optimizer.ema_decay, state.step)
        metrics["grad_norm"] = grad_norm
        metrics["learning_rate"] = self.schedule(state.step)
        if self.pipelined:
            metrics["pipe_bubble_frac"] = state.model.bubble_frac
        state.step += 1
        return metrics

    @torch.no_grad()
    def _explicit_collectives(self, state: TrainState, metrics: dict
                              ) -> tuple[dict, torch.Tensor | None]:
        """The shard_map step's collectives, in the JAX order: the
        gradients' mean on the configured wire (with the residual, which
        is replaced by the new one) — under ZeRO the bucketed
        reduce-scatter onto the shards, and under ``precision.fused_update``
        the whole fused walk, update included — the metrics' plain mean,
        and the mean of the BatchNorm running statistics. Returns the metrics and,
        under ZeRO, the mean gradient's norm from its shards (else None:
        the whole reduced gradients are in ``.grad``)."""
        rt = self.runtime
        named = list(state.model.named_parameters())
        if self.fused:
            grad_norm, residual = state.layout.fused_walk_(
                state.model, state.optimizer,
                state.collective_residual if self.use_residual else None)
            if residual is not None:
                state.collective_residual.update(residual)
            return self._mean_metrics_and_stats(state, metrics), grad_norm
        if self.zero:
            grad_norm, residual = state.layout.scatter_(
                state.model, state.collective_residual if self.use_residual
                else None)
            if residual is not None:
                state.collective_residual.update(residual)
            return self._mean_metrics_and_stats(state, metrics), grad_norm
        grads = {k: p.grad for k, p in named}
        if self.use_residual:
            grads, residual = coll.allreduce_gradients_ef(
                grads, state.collective_residual, rt, block_size=self.block)
            state.collective_residual.update(residual)
        else:
            grads = coll.allreduce_gradients(
                grads, rt, compute_dtype=self.wire or None,
                accumulate_f32=(
                    self.config.train.grad_allreduce_accum == "float32"),
                block_size=self.block)
        for k, p in named:
            p.grad = grads[k]
        return self._mean_metrics_and_stats(state, metrics), None

    def _mean_metrics_and_stats(self, state: TrainState,
                                metrics: dict) -> dict:
        """The metrics' plain mean over the ranks, and the BatchNorm
        running statistics' mean in place."""
        rt = self.runtime
        metrics = coll.pmean(metrics, rt)
        stats = [t for m in state.model.modules() if isinstance(m, BatchNorm)
                 for t in (m.running_mean, m.running_var)]
        if stats:
            torch._foreach_copy_(stats, coll.pmean(stats, rt))
        return metrics

    def global_metrics(self, metrics: dict) -> dict:
        """The step's metrics with its task metrics as weighted means over
        every data-parallel rank's batch, and every seq rank's part of it
        (one ``all_reduce`` over :attr:`reduce_group`; the JAX loss over
        the global batch): each rank's mean times its weight, summed,
        over the summed weight, at least 1 as in ``mlm_loss``. Called at
        log steps, which are the same on every rank. Single-rank metrics
        pass as they are."""
        if "_weight" not in metrics:
            return metrics
        out = dict(metrics)
        weight = out.pop("_weight")
        keys = [k for k in out if k not in ("grad_norm", "learning_rate",
                                            "pipe_bubble_frac")]
        sums = torch.stack([out[k].float() * weight for k in keys]
                           + [weight.float()])
        self.runtime.all_reduce_(sums, self.reduce_group)
        total = sums[-1].clamp(min=1.0)
        out.update({k: sums[i] / total for i, k in enumerate(keys)})
        return out

    @torch.no_grad()
    def eval_step(self, state: TrainState,
                  batch: dict) -> dict[str, torch.Tensor]:
        """Weighted metric sums for one eval batch, in ``eval()`` mode (no
        dropout; BN on its running statistics), with the EMA parameters
        when ``train.eval_use_ema`` and the EMA is on. Batches without a
        ``weight`` key weight every example 1. Under FSDP the parameters
        (or the EMA) are gathered whole, exactly, for the call."""
        inputs = model_inputs(self.task, batch)
        fsdp = state.layout if isinstance(state.layout, DimSharding) else None
        state.model.eval()
        try:
            if state.ema_params and self.config.train.eval_use_ema:
                ema = state.ema_params
                if fsdp is not None and fsdp.at_rest:
                    ema = fsdp.whole(ema)
                logits = torch.func.functional_call(state.model, ema, inputs)
            else:
                with (fsdp.whole_params(state.model) if fsdp is not None
                      else contextlib.nullcontext()):
                    logits = state.model(*inputs)
        finally:
            state.model.train()
        if isinstance(logits, dict):  # MoE: the logits beside the aux
            logits = logits["logits"]
        labels = (self._targets(batch["targets"]) if self.task == "mlm"
                  else batch["label"])
        weight = batch.get("weight")
        if weight is None:
            weight = torch.ones(labels.shape[0], device=labels.device)
        if self.task == "mlm":
            return losses.mlm_metrics_sums(logits, labels, weight)
        return losses.classification_metrics_sums(logits, labels, weight)
