"""Tensor parallelism (``mesh.model > 1``; parallel/tensor_parallel.py,
the ``TP_RULES`` half of parallel/sharding.py) against the JAX package and
against the port's own one-process, DDP and FSDP steps.

Mirrors ``tests/test_models.py::test_fused_qkv_tp_sharding_rule``, the TP
half of ``parallel/sharding.py``'s ``infer_param_specs`` and
``tests/test_train_models.py::test_bert_tensor_parallel`` (the JAX jit
step at ``{data: 1, model: 2}`` here, from the port's initial parameters).
Two worlds of gloo ranks, each rank a child process running this file
with the gang environment of core/cluster.py (torch alone):

  * world A, two ranks (``{data: 1, model: 2}``, and ``data=2`` for the
    DDP and ZeRO references): a tiny BERT (f32, dropout 0, clipping 1.0)
    with the fused QKV on the plain attention and on ``pallas`` (its plain
    version on the CPU), the unfused projections, at dropout 0.1, and with
    LARS, accumulation, the EMA, remat and bf16 (``VARIANTS``); LeNet-5
    and a small ResNet; the ``shard_map`` step; a TP checkpoint restored
    by one process and exported, a one-process checkpoint restored into
    TP; the ladder's snapshot and rollback; the Trainer's run_meta and
    exact eval; the heads refusal. Rank 0 also runs the one-process
    references (no group, the same one thread);
  * world B, four ranks: the subgroups at ``{data: 2, model: 2}`` and
    ``{fsdp: 2, model: 2}``; TP under jit FSDP and ZeRO-1 at ``{fsdp: 2,
    model: 2}``; ZeRO ``shard_map`` and the small ResNet (BatchNorm over
    the data-parallel ranks) at ``{data: 2, model: 2}``.

In this process the JAX StepBuilder runs the jit step on a ``{data: 1,
model: 2}`` mesh over conftest's CPU devices (GSPMD's TP).

Tolerances. Exact: the rules and the layout (JAX's specs, leaf for leaf),
the parts and their round trips, everything the model axis leaves alone
(LeNet, the ResNet, the ``shard_map`` steps), the replicated leaves across
the ranks of a group, and the checkpoints. TP against an unsplit step in
f32: the row-parallel sums, the split GEMMs and the norm's two partial
sums add in other orders, so losses rtol 1e-5 and grad_norm rtol 1e-5,
and the parameters within 1e-3 × lr after 3 steps: AdamW divides each
gradient by its root mean square, and a gradient that is zero in exact
arithmetic (the key bias: softmax ignores a score shift shared by every
key) moves by its rounding noise over ε = 1e-6 (as tests/test_torch_fsdp.py
holds BERT). Against the JAX step the same, with grad_norm rtol 1e-4 (XLA
also splits the LayerNorms' sums over the hidden dim).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.parallel import sharding as shd
from tests.test_torch_gang import run_gang
from tests.test_torch_hygiene import torch_threads  # noqa: F401

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
STEPS = 3
TINY_BERT = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=2", "model.num_heads=4", "model.mlp_dim=128",
    "model.max_seq_len=128", "model.dtype=float32",
    "model.attention_impl=xla", "model.dropout_rate=0.0",
    "model.fused_qkv=true",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=128",
    "data.global_batch_size=8", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=2",
    "optimizer.schedule=linear", "optimizer.weight_decay=0.01",
    "optimizer.grad_clip_norm=1.0", "optimizer.eps=1e-6",
    f"train.total_steps={STEPS}", "checkpoint.directory=",
    "resilience.rollback=false"]
PALLAS = ["model.attention_impl=pallas"]
UNFUSED = ["model.fused_qkv=false"]
# Variants of the tiny BERT that each reach another part of the step:
# LARS's per-leaf norms over whole leaves, micro-batch accumulation, the
# EMA (evaluated through it), per-layer remat (whose recompute runs the
# row-parallel reductions again) and bf16 (the reductions in f32 of
# bf16-rounded partials).
VARIANTS = {
    "lars": ["optimizer.name=lars", "optimizer.momentum=0.9",
             "optimizer.learning_rate=0.1"],
    "accum": ["train.grad_accum_steps=2"],
    "ema": ["optimizer.ema_decay=0.9", "train.eval_use_ema=true"],
    "remat": ["model.remat=true"],
    "bf16": ["model.dtype=bfloat16"],
}
LENET = [
    "model.name=lenet5", "model.dtype=float32", "data.name=synthetic_images",
    "data.image_size=28", "data.channels=1", "data.seed=4",
    "data.global_batch_size=8", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.1", "optimizer.momentum=0.9",
    "optimizer.weight_decay=0.001", "optimizer.warmup_steps=1",
    "optimizer.schedule=cosine", "optimizer.grad_clip_norm=0.5",
    f"train.total_steps={STEPS}", "train.label_smoothing=0.1",
    "checkpoint.directory=", "resilience.rollback=false"]
SMALL_RESNET = [o for o in LENET if not o.startswith(("model.", "data."))] + [
    "model.name=resnet18_cifar", "model.dtype=float32",
    "data.name=synthetic_images", "data.image_size=32", "data.channels=3",
    "data.seed=2", "data.global_batch_size=8"]
TP2 = ["mesh.data=1", "mesh.model=2"]
DP2 = ["mesh.data=2"]
DM = ["mesh.data=2", "mesh.model=2"]
FM = ["mesh.data=1", "mesh.fsdp=2", "mesh.model=2"]
SHARD_MAP = ["train.spmd_mode=shard_map"]
ZERO_SM = SHARD_MAP + ["optimizer.zero_sharding=shard_map",
                       "optimizer.grad_clip_norm=0.0"]
# The cases each rank runs, and the one-process references rank 0 of
# world A runs (no mesh axis: a single process).
WORLD_A = {
    "bert_tp": TINY_BERT + TP2,
    "bert_tp_pallas": TINY_BERT + PALLAS + TP2,
    "bert_tp_unfused": TINY_BERT + UNFUSED + TP2,
    "bert_tp_dropout": TINY_BERT + ["model.dropout_rate=0.1"] + TP2,
    **{f"bert_tp_{k}": TINY_BERT + v + TP2 for k, v in VARIANTS.items()},
    "bert_sm": TINY_BERT + SHARD_MAP + TP2,
    "lenet_tp": LENET + TP2,
    "resnet_tp": SMALL_RESNET + TP2,
    "bert_ddp": TINY_BERT + DP2,
    "bert_zero_dp": TINY_BERT + ZERO_SM + DP2,
    "resnet_ddp": SMALL_RESNET + DP2,
}
ONE = {
    "bert": TINY_BERT,
    "bert_pallas": TINY_BERT + PALLAS,
    "bert_unfused": TINY_BERT + UNFUSED,
    **{f"bert_{k}": TINY_BERT + v for k, v in VARIANTS.items()},
    "bert_sm": TINY_BERT + SHARD_MAP,
    "lenet": LENET,
    "resnet": SMALL_RESNET,
}
WORLD_B = {
    "bert_tp_fsdp": TINY_BERT + FM,
    "bert_tp_zero1": TINY_BERT + FM + ["optimizer.zero_sharding=jit"],
    "bert_zero_dm": TINY_BERT + ZERO_SM + DM,
    "resnet_dm": SMALL_RESNET + DM,
}
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-5
PARAM_ATOL_LR = 1e-3
# bf16: a row-parallel output is two bf16-rounded partials summed and
# rounded again, where one process rounds one product (2^-8 relative an
# element); averaged over a batch's masked tokens the loss moves far less
# than an element. Losses rtol 2e-3, grad_norm rtol 2e-2 (chip_smoke.py's
# TP_LOSS_TOL), parameters within 2 × lr a step (an AdamW step moves a
# cell by at most about lr, and a sign flip of a noisy gradient by twice
# that).
BF16_TOL = {"loss": 2e-3, "grad_norm": 2e-2, "params_lr": 2.0 * STEPS}
# LARS scales each leaf's update by one trust ratio of whole-leaf norms:
# no element is divided by its own rounding noise, so its parameters are
# held within 1e-5 × lr (3e-8 seen at lr 0.1; the ratio of the parts'
# norms instead of the whole leaves' moves them by 3e-6).
LARS_PARAM_ATOL_LR = 1e-5


def _small_resnet(config, *, device, generator=None, in_channels=None,
                  precision=None):
    """What the port builds for ``resnet18_cifar`` here: stages (1, 1),
    width 8, the CIFAR stem (as tests/test_torch_ddp.py)."""
    from distributed_tensorflow_framework_torch.models.resnet import ResNet

    model = ResNet((1, 1), 10, width=8, cifar_stem=True,
                   dtype=torch.float32)
    model.init_weights(generator)
    return model.to(device).eval()


def _builder(overrides, runtime, seed=0):
    from distributed_tensorflow_framework_torch.train import step as port_step

    config = port_config(overrides=overrides)
    saved = port_step.get_model
    if config.model.name.startswith("resnet"):
        port_step.get_model = _small_resnet
    try:
        builder = port_step.StepBuilder(config, device="cpu",
                                        runtime=runtime)
        return builder, builder.init_state(seed)
    finally:
        port_step.get_model = saved


# ------------------------------------------------------------ the ranks

def _block(batch, builder):
    """This rank's block of a global batch: the data-parallel rank's (the
    ranks along ``model`` take the same one)."""
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    n, r = (1, 0) if builder.data_group is None else (
        builder.data_group.size, builder.data_group.index)
    b = builder.config.data.global_batch_size // n
    return to_device({k: v[r * b:(r + 1) * b] for k, v in batch.items()},
                     torch.device("cpu"))


def _whole(state) -> dict:
    """The model's tensors, whole (FSDP's parts gathered, then TP's)."""
    tensors = state.model.state_dict()
    if isinstance(state.layout, shd.DimSharding) and state.layout.at_rest:
        with state.layout.whole_params(state.model):
            tensors = {k: v.clone() for k, v in
                       state.model.state_dict().items()}
    if state.tp is not None:
        tensors = state.tp.whole(tensors)
    return {k: v.detach().clone() for k, v in tensors.items()}


def _run(overrides, runtime, steps=STEPS) -> dict:
    from distributed_tensorflow_framework_torch.data import get_dataset

    builder, state = _builder(overrides, runtime)
    ds = get_dataset(builder.config.data)
    at_rest = {k: tuple(p.shape) for k, p in state.model.named_parameters()}
    metrics = []
    for _ in range(steps):
        m = builder.global_metrics(builder.train_step(
            state, _block(next(ds), builder)))
        metrics.append({k: float(v) for k, v in m.items()})
    tp = state.tp
    return {"metrics": metrics, "tensors": _whole(state),
            "at_rest": at_rest,
            "parts": ({} if tp is None else {
                k: tuple(leaf.part_shape) for k, leaf in tp.leaves.items()
                if leaf is not None}),
            "replicated": {k: p.detach().clone() for k, p in
                           state.model.named_parameters()
                           if tp is None or tp.leaves[k] is None},
            "eval": {k: float(v) for k, v in builder.eval_step(
                state, _block(next(ds), builder)).items()},
            "ddp": state.ddp is not None,
            "tp": None if tp is None else tp.sharded,
            "layout": type(state.layout).__name__}


def _checkpoints(workdir, runtime) -> dict:
    """A TP checkpoint (model 2) read by one process, and a one-process
    checkpoint read into TP; each then takes one more step."""
    import torch.distributed as dist

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.serve.export import (
        export_checkpoint,
        load_artifact,
    )
    from distributed_tensorflow_framework_torch.train.anomaly import (
        restore_state,
        snapshot_state,
    )

    over = TINY_BERT + ["optimizer.ema_decay=0.9"]
    tp_builder, tp_state = _builder(over + TP2, runtime)
    ds = get_dataset(tp_builder.config.data)
    batches = [next(ds) for _ in range(3)]
    for b in batches[:2]:
        tp_builder.train_step(tp_state, _block(b, tp_builder))
    # Restored into one process and back into TP: allow_reshard.
    ck = dataclasses.replace(tp_builder.config.checkpoint,
                             directory=f"{workdir}/ck_tp", async_save=False,
                             allow_reshard=True)
    manager = CheckpointManager(ck, runtime=runtime)
    manager.save(2, tp_state)
    manager.close()
    whole = _whole(tp_state)
    ema = {k: v.clone() for k, v in
           tp_state.tp.whole(tp_state.ema_params).items()}
    snap = snapshot_state(tp_state)
    tp_builder.train_step(tp_state, _block(batches[2], tp_builder))
    out = {"tp_next": _whole(tp_state)}
    # The ladder's snapshot holds this rank's parts; a rollback puts them
    # back and the step after it is the step after the save again.
    restore_state(snap, tp_state)
    out["snapshot_parts"] = all(
        torch.equal(p, snap["model"][k])
        for k, p in tp_state.model.state_dict().items())
    out["rolled_back_whole"] = all(torch.equal(v, whole[k]) for k, v in
                                   _whole(tp_state).items())
    tp_builder.train_step(tp_state, _block(batches[2], tp_builder))
    out["replayed"] = all(torch.equal(v, out["tp_next"][k]) for k, v in
                          _whole(tp_state).items())
    dist.barrier()
    if runtime.process_index == 0:
        # Into one process: the whole tensors as they are.
        one_builder, one = _builder(over, None, seed=1)
        manager = CheckpointManager(dataclasses.replace(ck), runtime=None)
        out["into_one"] = manager.restore(one)
        manager.close()
        out["one_equal"] = all(torch.equal(one.model.state_dict()[k], v)
                               for k, v in whole.items())
        out["one_ema_equal"] = all(torch.equal(one.ema_params[k], v)
                                   for k, v in ema.items())
        one_builder.train_step(one, _block(batches[2], one_builder))
        out["one_next"] = _whole(one)
        # cli/export.py's path: the TP checkpoint exports whole, its EMA
        # under serve.use_ema (the default) and the trained tensors
        # without it, onto one process under serve.allow_reshard.
        serve = dataclasses.replace(one_builder.config.serve,
                                    allow_reshard=True)
        art = load_artifact(export_checkpoint(dataclasses.replace(
            one_builder.config, checkpoint=ck, serve=serve),
            f"{workdir}/art_tp", device="cpu"))
        raw = load_artifact(export_checkpoint(dataclasses.replace(
            one_builder.config, checkpoint=ck,
            serve=dataclasses.replace(serve, use_ema=False)),
            f"{workdir}/art_tp_raw", device="cpu"))
        out["export_step"] = art.step
        out["export_equal"] = (
            all(torch.equal(art.state_dict[k], v) for k, v in ema.items())
            and all(torch.equal(raw.state_dict[k], v)
                    for k, v in whole.items()))
        # And the reverse: one process saves, TP restores.
        manager = CheckpointManager(dataclasses.replace(
            ck, directory=f"{workdir}/ck_one"), runtime=None)
        manager.save(2, one)
        manager.close()
        out["one_saved"] = _whole(one)
    dist.barrier()
    fb, fresh = _builder(over + TP2, runtime, seed=2)
    manager = CheckpointManager(dataclasses.replace(
        ck, directory=f"{workdir}/ck_one"), runtime=runtime)
    out["into_tp"] = manager.restore(fresh)
    manager.close()
    out["tp_restored"] = _whole(fresh)
    out["tp_parts"] = {k: p.detach().clone()
                       for k, p in fresh.model.named_parameters()}
    return out


def _trainer(workdir, runtime) -> dict:
    """Two steps through the Trainer at ``{data: 1, model: 2}`` with an
    exact eval; its run_meta and data_shard events."""
    import json

    from distributed_tensorflow_framework_torch.train.loop import Trainer

    logs = f"{workdir}/trainer_logs"
    cfg = port_config(overrides=TINY_BERT + TP2 + [
        "train.total_steps=2", "train.log_interval=1", "train.eval_steps=2"])
    trainer = Trainer(cfg, device="cpu", log_dir=logs, runtime=runtime)
    final = trainer.train()
    result = trainer.evaluate()
    trainer.writer.close()
    out = {"final": final, "eval": result}
    if runtime.is_chief:
        with open(f"{logs}/events.jsonl") as fh:
            events = [json.loads(line) for line in fh]
        out["run_meta"] = next(e for e in events
                               if e["kind"] == "run_meta")["extra"]
        out["data_shard"] = next(e for e in events
                                 if e["kind"] == "data_shard")
    return out


def _heads_not_divisible(runtime) -> dict:
    """One head over ``model`` 2: the QKV columns split inside the head
    (gathered whole before the attention), the step run; rank 0 runs one
    process on the same batches."""
    over = TINY_BERT + ["model.num_heads=1"]
    out = {"tp": _run(over + TP2, runtime)}
    out["head_groups"] = sum(
        getattr(m, "head_group", None) is not None
        for m in _builder(over + TP2, runtime)[1].model.modules())
    if runtime.process_index == 0:
        out["one"] = _run(over, None)
    return out


def _mesh_checks(runtime) -> dict:
    """The model and data-parallel groups of every rank at
    ``{data: 2, model: 2}`` and ``{fsdp: 2, model: 2}``, and a gather
    over each."""
    from distributed_tensorflow_framework_torch.parallel import (
        collectives as coll,
    )

    out = {}
    for name, sizes in (("dm", {"data": 2, "model": 2}),
                        ("fm", {"fsdp": 2, "model": 2})):
        rt = runtime.remesh({**{k: 1 for k in runtime.sizes}, **sizes})
        x = torch.tensor([float(rt.process_index)])
        out[name] = {
            "model": (rt.axis_group("model").index,
                      rt.axis_group("model").size,
                      coll.all_gather(x, rt, axes="model").tolist()),
            "dp": (rt.data_group.index, rt.data_group.size,
                   coll.all_gather(x, rt).tolist())}
    return out


def _rank_main(workdir: str, world: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    runtime = initialize_runtime(MeshConfig(data=-1), "cpu")
    cases = WORLD_A if world == "a" else WORLD_B
    out = {"steps": {n: _run(o, runtime) for n, o in cases.items()}}
    if world == "a":
        if runtime.process_index == 0:
            out["one"] = {n: _run(o, None) for n, o in ONE.items()}
        out["ckpt"] = _checkpoints(workdir, runtime)
        out["trainer"] = _trainer(workdir, runtime)
        out["heads_refusal"] = _heads_not_divisible(runtime)
    else:
        out["mesh"] = _mesh_checks(runtime)
    runtime.shutdown()
    torch.save(out, os.path.join(workdir,
                                 f"{world}{runtime.process_index}.pt"))


# ------------------------------------------------------- the test side


def _spawn(workdir: str, world: str, n: int) -> list:
    run_gang([HERE, workdir, world],
             [os.path.join(workdir, f"{world}{rank}.log")
              for rank in range(n)],
             timeout=300)
    return [torch.load(os.path.join(workdir, f"{world}{r}.pt"),
                       weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("tp"))
    return {"a": _spawn(workdir, "a", 2), "b": _spawn(workdir, "b", 4)}


def _model(overrides):
    from distributed_tensorflow_framework_torch.train import step as port_step

    config = port_config(overrides=overrides)
    if config.model.name.startswith("resnet"):
        return _small_resnet(config, device="cpu")
    return port_step.get_model(
        config.model, device="cpu",
        in_channels=None if "bert" in config.model.name else
        config.data.channels)


def _close(got: dict, want: dict, lr: float, *, loss=LOSS_RTOL,
           norm=NORM_RTOL, params=PARAM_ATOL_LR) -> None:
    """TP against an unsplit step (the module docstring's tolerances)."""
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=loss,
                                   err_msg=f"step {i} loss")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=norm, err_msg=f"step {i}")
    assert set(got["tensors"]) == set(want["tensors"])
    for k, v in want["tensors"].items():
        np.testing.assert_allclose(got["tensors"][k], v, rtol=0,
                                   atol=params * lr, err_msg=k)


def _equal(got: dict, want: dict) -> None:
    assert got["metrics"] == want["metrics"]
    for k, v in want["tensors"].items():
        assert torch.equal(got["tensors"][k], v), k
    assert got["eval"] == want["eval"]


# ---------------------------------------------------------- the rules

@pytest.mark.parametrize("path, shape, sizes", [
    # tests/test_models.py::test_fused_qkv_tp_sharding_rule's two cases.
    ("layer0/attn/qkv/kernel", (32, 3, 32), {"data": 4, "model": 2}),
    ("layer0/attn/qkv/kernel", (32, 96), {"data": 4, "model": 2}),
    ("layer0/attn/query/kernel", (64, 64), {"model": 2}),
    ("layer0/attn/attn_out/kernel", (64, 64), {"model": 4}),
    ("layer1/mlp_in/kernel", (64, 128), {"model": 2}),
    ("layer1/mlp_out/kernel", (128, 64), {"model": 2}),
    ("embed_block/embed/embedding", (512, 64), {"model": 2}),
    # A dim the axis does not divide stays whole.
    ("layer0/attn/qkv/kernel", (64, 3, 64), {"model": 3}),
    ("embed_block/embed/embedding", (30522, 768), {"model": 5}),
    ("layer0/mlp_in/kernel", (64, 128), {"data": 2}),
    ("layer0/attn/qkv/bias", (3, 64), {"model": 2}),
    ("head/mlm_bias", (512,), {"model": 2}),
])
def test_match_rules_is_jax(path, shape, sizes):
    import jax

    from distributed_tensorflow_framework_tpu.core.config import MeshConfig
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.parallel.sharding import (
        TP_RULES,
        _match_rules,
    )

    n = int(np.prod(list(sizes.values())))
    mesh = create_mesh(MeshConfig(**{"data": 1, **sizes}),
                       devices=jax.devices()[:n])
    want = _match_rules(path, shape, mesh, TP_RULES)
    got = shd._match_rules(path, shape, dict(mesh.shape), shd.TP_RULES)
    assert (got is None) == (want is None)
    if want is not None:
        assert got == tuple(want) + (None,) * (len(shape) - len(want))
    assert shd.TP_RULES == TP_RULES


@pytest.mark.parametrize("model, sizes", [
    ("bert_fused", {"model": 2}), ("bert", {"model": 2}),
    ("bert_fused", {"fsdp": 2, "model": 2}), ("bert", {"fsdp": 2, "model": 2}),
    ("bert_fused", {"model": 4}), ("bert_fused", {"model": 8}),
    ("bert_fused", {"model": 3}), ("lenet", {"model": 2})])
def test_layout_is_jax_infer_param_specs(model, sizes):
    """Each leaf's spec equals JAX's ``infer_param_specs`` on the same
    tree and mesh; TP's dim, then fsdp's among the free ones."""
    import jax

    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        flax_layout,
        to_flax,
    )
    from distributed_tensorflow_framework_tpu.core.config import MeshConfig
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.parallel.sharding import (
        infer_param_specs,
    )

    over = {"bert": TINY_BERT + UNFUSED, "bert_fused": TINY_BERT,
            "lenet": LENET}[model]
    m = _model(over)
    tree = to_flax(m)
    n = int(np.prod(list(sizes.values())))
    mesh = create_mesh(MeshConfig(**{"data": 1, **sizes}),
                       devices=jax.devices()[:n])
    specs = flatten_tree(jax.tree.map(
        lambda s: s, infer_param_specs(tree, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    ours = shd.infer_param_specs(m, sizes)
    split = 0
    for key, (path, shape) in flax_layout(m).items():
        want = tuple(specs[path]) + (None,) * (len(shape)
                                               - len(specs[path]))
        assert ours[key] == want, key
        split += "model" in want
    # Divisible: the 4 kernels of each of 2 layers (6 unfused) and the
    # table; model=3 divides nothing of H 64, MLP 128, vocab 512.
    expect = {"bert_fused": 9, "bert": 13, "lenet": 0}[model]
    assert split == (0 if sizes.get("model") == 3 else expect)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("m", [2, 4])
def test_parts_are_jax_blocks_and_round_trip(fused, m):
    """For every TP leaf: the port's part r (``TpLeaf.cut`` of the whole
    tensor) is the port layout of block r of the Flax leaf
    (``convert.leaf_part``), the blocks join back into the leaf
    (``convert.leaf_whole``) and the parts into the tensor
    (``TpLeaf.unshard``); the fused qkv's part holds rows i·H + [r·H/m,
    (r+1)·H/m) of the (3H, H) weight for i = 0, 1, 2."""
    from distributed_tensorflow_framework_torch.models import convert

    m_ = _model(TINY_BERT + ([] if fused else UNFUSED))
    with torch.no_grad():
        for p in m_.parameters():
            p.copy_(torch.randn(p.shape))
    flat = convert.flatten_tree(convert.to_flax(m_))
    layout = convert.flax_layout(m_)
    leaves = shd.tp_layout(m_, m)
    params = dict(m_.named_parameters())
    specs = shd.infer_param_specs(m_, {"model": m})
    split = 0
    for key, leaf in leaves.items():
        if leaf is None:
            continue
        split += 1
        path, _ = layout[key]
        dim = specs[key].index("model")
        whole = params[key].detach()
        blocks = [convert.leaf_part(flat[path], dim, m, r) for r in range(m)]
        np.testing.assert_array_equal(convert.leaf_whole(blocks, dim),
                                      flat[path])
        parts = []
        for r, block in enumerate(blocks):
            part = leaf.cut(whole, r)
            assert tuple(part.shape) == leaf.part_shape == \
                convert.torch_shape(path, block.shape)
            want = convert.flax_to_state_dict(
                convert.unflatten_tree({path: block}))
            np.testing.assert_array_equal(part.numpy(),
                                          next(iter(want.values())).numpy())
            parts.append(part.reshape(leaf.shard_view))
        assert torch.equal(leaf.unshard(torch.stack(parts)), whole)
        if path[-2] == "qkv":
            h = whole.shape[1]
            rows = torch.cat([whole[i * h + 1 * h // m:
                                    i * h + 2 * h // m] for i in range(3)])
            assert torch.equal(leaf.cut(whole, 1), rows)
    assert split == (9 if fused else 13)


def test_fsdp_takes_a_dim_tp_left_free():
    """On the TP parts (``taken``), fsdp's dim is the one JAX picks on the
    whole leaf with ``model`` taken: mlp_in's input dim, not its larger
    (split) output dim."""
    from distributed_tensorflow_framework_torch.models.convert import (
        flax_layout,
    )

    m = _model(TINY_BERT)
    specs = shd.infer_param_specs(m, {"fsdp": 2, "model": 2})
    leaves = shd.tp_layout(m, 2)
    taken = {k: (s.index("model") if "model" in s else -1)
             for k, s in shd.infer_param_specs(m, {"model": 2}).items()}
    with torch.no_grad():
        for key, p in m.named_parameters():
            if leaves[key] is not None:
                p.data = leaves[key].cut(p.detach(), 0)
    dims = shd.infer_fsdp_dims(m, 2, taken)
    for key, (path, _) in flax_layout(m).items():
        want = specs[key].index("fsdp") if "fsdp" in specs[key] else -1
        assert dims[key] == want, key
    assert dims["layer0.mlp_in.weight"] == 0


# ----------------------------------------------------------- the mesh

def test_tp_groups_are_adjacent_ranks(worlds):
    """``model`` is the innermost axis: the ranks of a TP group are
    adjacent (r = dp_index · 2 + model_index); the data-parallel group
    joins the ranks of one model coordinate."""
    for rank, r in enumerate(worlds["b"]):
        for name in ("dm", "fm"):
            got = r["mesh"][name]
            d, mi = divmod(rank, 2)
            assert got["model"] == (mi, 2, [float(2 * d), float(2 * d + 1)])
            assert got["dp"] == (d, 2, [float(mi), float(2 + mi)])


# ----------------------------------------------------------- the steps

@pytest.mark.parametrize("case, ref", [
    ("bert_tp", "bert"), ("bert_tp_pallas", "bert_pallas"),
    ("bert_tp_unfused", "bert_unfused"),
    *((f"bert_tp_{k}", f"bert_{k}") for k in VARIANTS)])
def test_tp_step_matches_one_process(worlds, case, ref):
    over = WORLD_A[case]
    lr = port_config(overrides=over).optimizer.learning_rate
    want = worlds["a"][0]["one"][ref]
    tol = ({"loss": BF16_TOL["loss"], "norm": BF16_TOL["grad_norm"],
            "params": BF16_TOL["params_lr"]} if case.endswith("bf16")
           else {"params": LARS_PARAM_ATOL_LR} if case.endswith("lars")
           else {})
    for r in worlds["a"]:
        got = r["steps"][case]
        assert got["tp"] == (13 if "unfused" in case else 9)
        assert not got["ddp"]
        _close(got, want, lr, **tol)
        np.testing.assert_allclose(got["eval"]["loss_sum"],
                                   want["eval"]["loss_sum"],
                                   rtol=tol.get("loss", LOSS_RTOL))
        for k, shape in got["parts"].items():
            assert got["at_rest"][k] == shape, k


def test_ranks_of_a_group_agree(worlds):
    """The ranks along ``model`` see the same metrics and hold every
    replicated leaf bit for bit, also at dropout 0.1 (the same batch and
    the same masks)."""
    a0, a1 = worlds["a"]
    for case in ("bert_tp", "bert_tp_pallas", "bert_tp_dropout"):
        x, y = a0["steps"][case], a1["steps"][case]
        assert x["metrics"] == y["metrics"]
        assert set(x["replicated"]) == set(y["replicated"])
        for k, v in x["replicated"].items():
            assert torch.equal(v, y["replicated"][k]), (case, k)
        for k, v in x["tensors"].items():
            assert torch.equal(v, y["tensors"][k]), (case, k)
    d = a0["steps"]["bert_tp_dropout"]["metrics"]
    assert [m["loss"] for m in d] != [
        m["loss"] for m in a0["steps"]["bert_tp"]["metrics"]]


def _jax_tp_steps(overrides, port_init):
    """The JAX StepBuilder's jit step on a {data: 1, model: 2} mesh (GSPMD
    TP) over the port's global batches, from the port's initial
    parameters."""
    import jax

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        to_flax,
    )
    from distributed_tensorflow_framework_tpu.core.config import (
        MeshConfig,
        load_config,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.train.step import StepBuilder

    mesh = create_mesh(MeshConfig(data=1, model=2), devices=jax.devices()[:2])
    builder = StepBuilder(load_config(overrides=overrides + TP2), mesh)
    ds = get_dataset(port_config(overrides=overrides).data)
    batches = [next(ds) for _ in range(STEPS)]
    state = builder.init_state(0, to_global(batches[0], mesh))
    model = _model(overrides)
    model.load_state_dict(port_init)
    state = state.replace(params=jax.tree.map(
        lambda x, ref: jax.device_put(x, ref.sharding), to_flax(model),
        state.params))
    step = builder.make_train_step(to_global(batches[0], mesh))
    metrics = []
    for batch in batches:
        state, m = step(state, to_global(batch, mesh))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return metrics, flatten_tree(jax.device_get(state.params))


def test_tp_step_matches_the_jax_jit_step(worlds):
    """f32, the plain attention on both sides, dropout 0, clipping 1.0:
    losses, grad_norm and the gathered parameters against GSPMD's TP."""
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        to_flax,
    )
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    init = StepBuilder(port_config(overrides=TINY_BERT),
                       device="cpu").init_state(0).model.state_dict()
    ref, params = _jax_tp_steps(TINY_BERT, init)
    lr = port_config(overrides=TINY_BERT).optimizer.learning_rate
    got = worlds["a"][0]["steps"]["bert_tp"]
    for i, (g, w) in enumerate(zip(got["metrics"], ref)):
        for key in ("loss", "mlm_acc"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4, err_msg=f"step {i}")
    model = _model(TINY_BERT)
    model.load_state_dict(got["tensors"])
    ours = flatten_tree(to_flax(model))
    assert set(ours) == set(params)
    for path, want in params.items():
        np.testing.assert_allclose(ours[path], want, rtol=0,
                                   atol=PARAM_ATOL_LR * lr, err_msg=str(path))


@pytest.mark.parametrize("case", ["bert_tp_fsdp", "bert_tp_zero1"])
def test_tp_with_fsdp_and_zero1_matches_ddp(worlds, case):
    """At {fsdp: 2, model: 2} the TP parts are cut again over fsdp (FSDP:
    the parameters; ZeRO-1: the slots) and the step is DDP's at
    {data: 2} within the TP tolerance."""
    lr = port_config(overrides=TINY_BERT).optimizer.learning_rate
    want = worlds["a"][0]["steps"]["bert_ddp"]
    leaves = shd.tp_layout(_model(TINY_BERT), 2)
    for r in worlds["b"]:
        got = r["steps"][case]
        assert got["ddp"] and got["layout"] == "DimSharding"
        assert got["tp"] == 9
        _close(got, want, lr)
        for k, leaf in leaves.items():
            part = leaf.part_shape if leaf is not None else \
                tuple(want["tensors"][k].shape)
            n = int(np.prod(part))
            held = int(np.prod(got["at_rest"][k]))
            if case == "bert_tp_zero1":
                assert held == n, k
            else:
                assert held in (n, n // 2), k
        if case == "bert_tp_fsdp":
            total = sum(int(np.prod(s)) for s in got["at_rest"].values())
            whole = sum(v.numel() for v in want["tensors"].values())
            assert total < 0.3 * whole


@pytest.mark.parametrize("world, case, ref", [
    ("a", "bert_sm", "bert_sm"), ("b", "bert_zero_dm", "bert_zero_dp")])
def test_shard_map_repeats_the_data_parallel_step(worlds, world, case, ref):
    """Under shard_map the model stays whole and the ranks along
    ``model`` repeat the data × fsdp step: bit-equal to the same step
    without the model axis (one process; ZeRO at {data: 2})."""
    for rank, r in enumerate(worlds[world]):
        got = r["steps"][case]
        assert got["tp"] is None and not got["ddp"]
        # World B's rank r reads data-parallel block r // 2, world A's
        # rank r // 2 the same.
        want = (worlds["a"][0]["one"][ref] if world == "a"
                else worlds["a"][rank // 2]["steps"][ref])
        _equal(got, want)
    if world == "b":
        assert worlds["b"][0]["steps"][case]["layout"] == "ZeroUpdate"


@pytest.mark.parametrize("world, case, ref", [
    ("a", "lenet_tp", "lenet"), ("a", "resnet_tp", "resnet"),
    ("b", "resnet_dm", "resnet_ddp")])
def test_models_without_tp_leaves_are_unchanged(worlds, world, case, ref):
    """No leaf of LeNet or the ResNet matches a rule: at {data: 1, model:
    2} the step is one process's bit for bit, and at {data: 2, model: 2}
    DDP's at {data: 2}, BatchNorm's statistics over the data-parallel
    ranks only."""
    for rank, r in enumerate(worlds[world]):
        got = r["steps"][case]
        assert got["tp"] == 0
        want = (worlds["a"][0]["one"][ref] if world == "a"
                else worlds["a"][rank // 2]["steps"][ref])
        _equal(got, want)


# ------------------------------------------------------ the checkpoint

def test_tp_checkpoint_round_trips_across_model_sizes(worlds):
    a0, a1 = worlds["a"]
    ck = a0["ckpt"]
    assert ck["into_one"] == 2 and ck["one_equal"] and ck["one_ema_equal"]
    assert ck["export_step"] == 2 and ck["export_equal"]
    lr = port_config(overrides=TINY_BERT).optimizer.learning_rate
    for k, v in ck["one_next"].items():
        np.testing.assert_allclose(ck["tp_next"][k], v, rtol=0,
                                   atol=PARAM_ATOL_LR * lr, err_msg=k)
    leaves = shd.tp_layout(_model(TINY_BERT), 2)
    for i, r in enumerate((a0, a1)):
        c = r["ckpt"]
        assert c["into_tp"] == 2
        for k, v in a0["ckpt"]["one_saved"].items():
            assert torch.equal(c["tp_restored"][k], v), k
            part = v if leaves.get(k) is None else leaves[k].cut(v, i)
            assert torch.equal(c["tp_parts"][k], part), k


def test_ladder_snapshot_holds_the_parts(worlds):
    for r in worlds["a"]:
        ck = r["ckpt"]
        assert ck["snapshot_parts"] and ck["rolled_back_whole"]
        assert ck["replayed"]


# ------------------------------------------------------ the trainer

def test_trainer_reads_one_block_and_names_the_split(worlds):
    a0, a1 = worlds["a"]
    t = a0["trainer"]
    assert t["run_meta"]["model_parallel"] == 2
    assert t["run_meta"]["tp_sharded_leaves"] == 9
    assert t["run_meta"]["ddp"] is False
    shard = t["data_shard"]["extra"]["shard"]
    assert shard["process_count"] == 1
    assert t["eval"] == a1["trainer"]["eval"]
    for key in ("loss", "grad_norm", "mlm_acc"):
        assert t["final"][key] == a1["trainer"]["final"][key]
    assert t["eval"]["eval_examples"] > 0


def test_heads_not_divisible_raise(worlds):
    """A QKV whose heads ``model`` does not divide no longer raises: it
    keeps JAX's column split (``TP_RULES``), gathers Q/K/V whole for the
    attention and trains as one process does."""
    one = worlds["a"][0]["heads_refusal"]["one"]
    for r in worlds["a"]:
        got = r["heads_refusal"]
        assert got["head_groups"] == 2 and got["tp"]["tp"] == 9
        assert got["tp"]["parts"]["layer0.attn.qkv.weight"] == (96, 64)
        _close(got["tp"], one,
               port_config(overrides=TINY_BERT).optimizer.learning_rate)
        assert got["tp"]["metrics"] == \
            worlds["a"][0]["heads_refusal"]["tp"]["metrics"]


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
