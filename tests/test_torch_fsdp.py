"""FSDP (``mesh.fsdp > 1``; parallel/sharding.py) under ``shard_map``
(explicit FSDP) and under ``jit``, and the mesh's subgroups
(core/mesh.py), against the JAX package and against the port's own
replicated steps.

Mirrors ``tests/test_zero_sharding.py::test_pick_fsdp_dim_trailing_dim_wins_ties``,
the fsdp half of ``parallel/sharding.py``'s ``infer_param_specs``,
``tests/test_compressed_allreduce.py::test_int8_ef_fsdp_loss_parity`` and
the dp+fsdp half of ``test_int8_wire_bytes_drop_3x_dp_fsdp`` (which
tests/test_torch_collectives.py left for this item). Two worlds of gloo
ranks, each rank a child process running this file with the gang
environment of core/cluster.py (torch alone):

  * world A, two ranks (``mesh.data=1, mesh.fsdp=2``, and ``data=2`` for
    the replicated references): three steps of LeNet-5 and of a tiny BERT
    (dropout 0) under explicit FSDP and replicated ``shard_map``; LeNet-5
    under jit FSDP (with the EMA and clipping) against DDP, a small ResNet
    (BatchNorm) likewise; the explicit-FSDP BatchNorm refusal; a
    checkpoint round trip and its restore into a DDP run; the exact eval;
    the parameters' bytes at rest;
  * world B, four ranks (``data=2, fsdp=2``, and ``data=4``): the
    subgroups' coordinates and collectives; LeNet-5 under explicit FSDP on
    the f32 and the int8 wires (first step under a tally) and under jit
    FSDP against DDP.

In this process the JAX StepBuilder runs explicit FSDP on the same meshes
over conftest's CPU devices from the port's initial parameters, and
lowers its int8 and f32 steps under a tally.

Tolerances. Exact: the shard dims and the parts (the JAX package's
leaves and specs); explicit FSDP on the f32 wire against the replicated
``shard_map`` step at the same world, and jit FSDP against DDP (the
gathers are exact, the update elementwise, the reduction the same); the
round trips; the tallies. Against the JAX StepBuilder, as
tests/test_torch_shard_map.py holds the replicated step: losses rtol
1e-5, grad_norm rtol 1e-4, parameters within 1e-5 × lr (LeNet) and 1e-3 ×
lr (BERT: AdamW divides a gradient that is zero in exact arithmetic by
its noise). The int8 run against the f32 run of the same mesh: the JAX
acceptance tolerance, rtol 0.02 and atol 2e-3 on the losses.
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
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from distributed_tensorflow_framework_torch.parallel import sharding as shd
from tests.test_torch_gang import run_gang
from tests.test_torch_hygiene import torch_threads  # noqa: F401

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
STEPS = 3
LENET = [
    "model.name=lenet5", "model.dtype=float32", "data.name=synthetic_images",
    "data.image_size=28", "data.channels=1", "data.seed=4",
    "data.global_batch_size=8", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.1", "optimizer.momentum=0.9",
    "optimizer.weight_decay=0.001", "optimizer.warmup_steps=1",
    "optimizer.schedule=cosine", "optimizer.grad_clip_norm=0.0",
    f"train.total_steps={STEPS}", "train.label_smoothing=0.1",
    "checkpoint.directory=", "resilience.rollback=false",
    "parallel.collective_block_size=64"]
TINY_BERT = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=2", "model.num_heads=4", "model.mlp_dim=128",
    "model.max_seq_len=128", "model.dtype=float32",
    "model.attention_impl=pallas", "model.dropout_rate=0.0",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=128",
    "data.global_batch_size=8", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=2",
    "optimizer.schedule=linear", "optimizer.weight_decay=0.01",
    "optimizer.grad_clip_norm=0.0", "optimizer.eps=1e-6",
    f"train.total_steps={STEPS}", "checkpoint.directory=",
    "resilience.rollback=false"]
SMALL_RESNET = [o for o in LENET if not o.startswith(("model.", "data."))] + [
    "model.name=resnet18_cifar", "model.dtype=float32",
    "data.name=synthetic_images", "data.image_size=32", "data.channels=3",
    "data.seed=2", "data.global_batch_size=8"]
SHARD_MAP = ["train.spmd_mode=shard_map"]
FSDP2 = ["mesh.data=1", "mesh.fsdp=2"]
DP_FSDP = ["mesh.data=2", "mesh.fsdp=2"]
JIT_EXTRA = ["optimizer.ema_decay=0.9", "optimizer.grad_clip_norm=0.5"]
INT8 = ["parallel.collective_dtype=int8"]
WORLD_A = {
    "lenet_rep": LENET + SHARD_MAP,
    "lenet_efsdp": LENET + SHARD_MAP + FSDP2,
    "bert_rep": TINY_BERT + SHARD_MAP,
    "bert_efsdp": TINY_BERT + SHARD_MAP + FSDP2,
    "lenet_ddp": LENET + JIT_EXTRA,
    "lenet_jfsdp": LENET + JIT_EXTRA + FSDP2,
    "resnet_ddp": SMALL_RESNET,
    "resnet_jfsdp": SMALL_RESNET + FSDP2,
}
WORLD_B = {
    "lenet_efsdp": LENET + SHARD_MAP + DP_FSDP,
    "lenet_efsdp_int8": LENET + SHARD_MAP + DP_FSDP + INT8,
    "lenet_rep4": LENET + SHARD_MAP,
    "lenet_ddp4": LENET + JIT_EXTRA,
    "lenet_jfsdp4": LENET + JIT_EXTRA + DP_FSDP,
}


def _small_resnet(config, *, device, generator=None, in_channels=None,
                  precision=None):
    """What the port builds for ``resnet18_cifar`` here: stages (1, 1),
    width 8, the CIFAR stem (as tests/test_torch_ddp.py)."""
    from distributed_tensorflow_framework_torch.models.resnet import ResNet

    model = ResNet((1, 1), 10, width=8, cifar_stem=True,
                   dtype=torch.float32)
    model.init_weights(generator)
    return model.to(device).eval()


def _builder(overrides, runtime):
    from distributed_tensorflow_framework_torch.train import step as port_step

    config = port_config(overrides=overrides)
    saved = port_step.get_model
    if config.model.name.startswith("resnet"):
        port_step.get_model = _small_resnet
    try:
        builder = port_step.StepBuilder(config, device="cpu",
                                        runtime=runtime)
        return builder, builder.init_state(0)
    finally:
        port_step.get_model = saved


# ------------------------------------------------------------ the ranks

def _block(batch, runtime, global_batch):
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    b = global_batch // runtime.process_count
    r = runtime.process_index
    return to_device({k: v[r * b:(r + 1) * b] for k, v in batch.items()},
                     torch.device("cpu"))


def _whole(state) -> dict:
    """The model's tensors, whole (gathered under FSDP)."""
    if isinstance(state.layout, shd.DimSharding):
        with state.layout.whole_params(state.model):
            return {k: v.clone() for k, v in
                    state.model.state_dict().items()}
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _run(overrides, runtime, steps=STEPS) -> dict:
    from distributed_tensorflow_framework_torch.data import get_dataset

    builder, state = _builder(overrides, runtime)
    ds = get_dataset(builder.config.data)
    at_rest = {k: p.numel() for k, p in state.model.named_parameters()}
    metrics, tally = [], None
    for _ in range(steps):
        batch = _block(next(ds), runtime, builder.config.data.global_batch_size)
        with coll.tally() as t:
            m = builder.global_metrics(builder.train_step(state, batch))
        tally = tally or t.summary()
        metrics.append({k: float(v) for k, v in m.items()})
    ema = dict(state.ema_params)
    if ema and isinstance(state.layout, shd.DimSharding) and \
            state.layout.at_rest:
        ema = state.layout.whole(ema)
    eval_batch = _block(next(ds), runtime,
                        builder.config.data.global_batch_size)
    return {"metrics": metrics, "tally": tally, "tensors": _whole(state),
            "ema": ema, "at_rest": at_rest,
            "after": {k: p.numel() for k, p in
                      state.model.named_parameters()},
            "eval": {k: float(v) for k, v in
                     builder.eval_step(state, eval_batch).items()},
            "ddp": state.ddp is not None,
            "layout": type(state.layout).__name__}


def _checkpoint(workdir, runtime) -> dict:
    """Explicit FSDP LeNet with the EMA: two steps, a save, a restore into
    a fresh FSDP state and into a DDP run, one more step each."""
    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.data import get_dataset

    over = LENET + SHARD_MAP + FSDP2 + ["optimizer.ema_decay=0.9"]
    builder, state = _builder(over, runtime)
    ds = get_dataset(builder.config.data)
    batches = [_block(next(ds), runtime, 8) for _ in range(3)]
    for b in batches[:2]:
        builder.train_step(state, b)
    # Read back by the other layouts' meshes too: allow_reshard.
    ck = dataclasses.replace(builder.config.checkpoint,
                             directory=f"{workdir}/ck_fsdp", async_save=False,
                             allow_reshard=True)
    manager = CheckpointManager(ck, runtime=runtime)
    manager.save(2, state)
    fb, fresh = _builder(over, runtime)
    out = {"restored": manager.restore(fresh)}
    manager.close()
    saved = torch.load(f"{workdir}/ck_fsdp/2/state.pt", weights_only=True)
    whole = _whole(state)
    out["saved_whole"] = all(
        saved["model"][k].shape == v.shape and torch.equal(saved["model"][k],
                                                           v)
        for k, v in whole.items())
    ema = state.layout.whole(state.ema_params)
    out["saved_ema_whole"] = all(torch.equal(saved["ema"][k], v)
                                 for k, v in ema.items())
    out["state_equal"] = all(
        torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                          fresh.model.state_dict().values())
    ) and all(torch.equal(state.ema_params[k], fresh.ema_params[k])
              for k in state.ema_params)
    builder.train_step(state, batches[2])
    fb.train_step(fresh, batches[2])
    out["next_equal"] = all(torch.equal(a, b) for a, b in zip(
        _whole(state).values(), _whole(fresh).values()))
    # Into a replicated shard_map run: the whole tensors as they are.
    _, rep = _builder(LENET + SHARD_MAP + ["optimizer.ema_decay=0.9"],
                      runtime)
    manager = CheckpointManager(ck, runtime=runtime)
    out["into_rep"] = manager.restore(rep, step=2)
    manager.close()
    out["rep_equal"] = all(torch.equal(rep.model.state_dict()[k], v)
                           for k, v in whole.items())
    return out


def _refusal(runtime) -> str | None:
    try:
        _builder(SMALL_RESNET + SHARD_MAP + FSDP2, runtime)
    except ValueError as e:
        return str(e)
    return None


def _mesh_checks(runtime) -> dict:
    """Coordinates and the collectives of each subgroup at data=2,
    fsdp=2, on gloo's native ops and on the all_reduce transport."""
    rt = runtime.remesh({**runtime.sizes, "data": 2, "fsdp": 2})
    x = torch.tensor([float(rt.process_index)] * 3)
    out = {}
    for name, axes in (("fsdp", "fsdp"), ("data", "data"),
                       ("all", ("data", "fsdp"))):
        res = {"index": coll.linear_axis_index(rt, axes),
               "size": coll._size(rt, axes),
               "gather": coll.all_gather(x, rt, axes=axes).tolist(),
               "psum": coll.psum(x, rt, axes=axes).tolist(),
               "scatter": coll.reduce_scatter(
                   torch.arange(4.0) + rt.process_index, rt,
                   axes=axes).tolist() if axes != ("data", "fsdp") else None}
        rt.collective_transport = lambda device: "all_reduce"
        res["forced_gather"] = coll.all_gather(x, rt, axes=axes).tolist()
        if res["scatter"] is not None:
            res["forced_scatter"] = coll.reduce_scatter(
                torch.arange(4.0) + rt.process_index, rt, axes=axes).tolist()
        del rt.collective_transport
        out[name] = res
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
        out["ckpt"] = _checkpoint(workdir, runtime)
        out["bn_refusal"] = _refusal(runtime)
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
    workdir = str(tmp_path_factory.mktemp("fsdp"))
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


# ---------------------------------------------------------- the layout

@pytest.mark.parametrize("shape, fsdp, taken", [
    ((3, 3, 8, 8), 2, ()), ((8, 8), 4, ()), ((16, 8), 4, ()),
    ((8, 8), 4, (None, "model")), ((3, 5), 4, ()), ((768, 3, 768), 2, ()),
    ((30522, 768), 2, ()), ((5, 5, 1, 6), 2, ()), ((), 2, ()),
    ((7,), 7, ()), ((0, 4), 2, ())])
def test_pick_fsdp_dim_matches_jax(shape, fsdp, taken):
    from distributed_tensorflow_framework_tpu.parallel.sharding import (
        pick_fsdp_dim,
    )

    assert shd.pick_fsdp_dim(shape, fsdp, taken) == pick_fsdp_dim(
        shape, fsdp, taken)


def test_pick_fsdp_dim_trailing_dim_wins_ties():
    assert shd.pick_fsdp_dim((3, 3, 8, 8), 2) == 3
    assert shd.pick_fsdp_dim((8, 8), 4) == 1
    assert shd.pick_fsdp_dim((16, 8), 4) == 0
    assert shd.pick_fsdp_dim((8, 8), 4, taken=(None, "model")) == 0
    assert shd.pick_fsdp_dim((3, 5), 4) == -1


@pytest.mark.parametrize("model, fsdp", [
    ("lenet", 2), ("lenet", 4), ("bert", 2), ("bert_fused", 2),
    ("bert_fused", 3), ("resnet", 2)])
def test_shard_dims_and_parts_match_jax_specs(model, fsdp):
    """The dim of each Flax leaf that JAX's ``infer_param_specs`` shards
    over fsdp, and the port's part i, laid out as Flax lays the leaf, is
    JAX's shard i."""
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

    over = {"lenet": LENET, "bert": TINY_BERT, "resnet": SMALL_RESNET,
            "bert_fused": TINY_BERT + ["model.fused_qkv=true"]}[model]
    m = _model(over)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape))
    tree = to_flax(m)
    mesh = create_mesh(MeshConfig(data=1, fsdp=fsdp),
                       devices=jax.devices()[:fsdp])
    specs = flatten_tree(jax.tree.map(
        lambda s: s, infer_param_specs(tree, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    flat = flatten_tree(tree)
    dims = shd.infer_fsdp_dims(m, fsdp)
    leaves = shd.fsdp_layout(m, fsdp)
    sharded = 0
    for key, (path, _) in flax_layout(m).items():
        spec = tuple(specs[path]) + (None,) * (flat[path].ndim
                                               - len(specs[path]))
        want = spec.index("fsdp") if "fsdp" in spec else -1
        assert dims[key] == want, key
        leaf = leaves[key]
        assert (leaf is None) == (want < 0)
        if leaf is None:
            continue
        sharded += 1
        tensor = dict(m.named_parameters())[key].detach()
        for i, ref in enumerate(np.split(flat[path], fsdp, axis=want)):
            part = leaf.shard(tensor, i).numpy()
            if path[-1] == "kernel" and part.ndim == 4:
                part = part.transpose(2, 3, 1, 0)
            elif path[-1] == "kernel":
                part = np.moveaxis(part, -1, 0)
            np.testing.assert_array_equal(part.reshape(ref.shape), ref)
        parts = torch.stack([leaf.shard(tensor, i) for i in range(fsdp)])
        assert torch.equal(leaf.unshard(parts), tensor)
    # At fsdp=3 only the fused QKV's 3 divides: each rank holds one of q,
    # k and v.
    assert sharded >= (4 if fsdp == 3 else 5)


# ---------------------------------------------------------- the mesh

def test_subgroups_hold_the_jax_coordinates(worlds):
    """data=2, fsdp=2: rank r = data_idx · 2 + fsdp_idx; each subgroup's
    gather is its members' in order, the forced all_reduce transport gives
    the native ops' results."""
    for rank, r in enumerate(worlds["b"]):
        m = r["mesh"]
        d, f = divmod(rank, 2)
        assert (m["all"]["index"], m["all"]["size"]) == (rank, 4)
        assert (m["fsdp"]["index"], m["fsdp"]["size"]) == (f, 2)
        assert (m["data"]["index"], m["data"]["size"]) == (d, 2)
        assert m["fsdp"]["gather"] == [float(2 * d)] * 3 + [
            float(2 * d + 1)] * 3
        assert m["data"]["gather"] == [float(f)] * 3 + [float(2 + f)] * 3
        assert m["all"]["gather"] == sum(([float(i)] * 3 for i in range(4)),
                                         [])
        assert m["fsdp"]["psum"] == [float(4 * d + 1)] * 3
        assert m["data"]["psum"] == [float(2 * f + 2)] * 3
        members = {"fsdp": (2 * d, 2 * d + 1), "data": (f, 2 + f)}
        for name, (a, b) in members.items():
            total = [2 * v + a + b for v in range(4)]
            i = m[name]["index"]
            assert m[name]["scatter"] == total[2 * i:2 * i + 2]
            assert m[name]["forced_scatter"] == m[name]["scatter"]
        for name in m:
            assert m[name]["forced_gather"] == m[name]["gather"]


# ----------------------------------------------------------- the steps

@pytest.mark.parametrize("world, rep, fsdp", [
    ("a", "lenet_rep", "lenet_efsdp"), ("a", "bert_rep", "bert_efsdp"),
    ("b", "lenet_rep4", "lenet_efsdp")])
def test_explicit_fsdp_f32_is_the_replicated_step(worlds, world, rep, fsdp):
    for r in worlds[world]:
        a, b = r["steps"][rep], r["steps"][fsdp]
        assert b["layout"] == "DimSharding" and not b["ddp"]
        assert [m["loss"] for m in a["metrics"]] == [
            m["loss"] for m in b["metrics"]]
        assert [m["grad_norm"] for m in a["metrics"]] == [
            m["grad_norm"] for m in b["metrics"]]
        for k, v in a["tensors"].items():
            assert torch.equal(b["tensors"][k], v), k
        assert b["eval"] == a["eval"]


@pytest.mark.parametrize("world, ddp, fsdp", [
    ("a", "lenet_ddp", "lenet_jfsdp"), ("a", "resnet_ddp", "resnet_jfsdp"),
    ("b", "lenet_ddp4", "lenet_jfsdp4")])
def test_jit_fsdp_is_the_ddp_step_bit_for_bit(worlds, world, ddp, fsdp):
    """DDP over the gathered parameters, the update on the parts: DDP's
    losses, grad_norm (clipped on the whole gradient), parameters, BN
    statistics, EMA and eval, in every bit."""
    for r in worlds[world]:
        a, b = r["steps"][ddp], r["steps"][fsdp]
        assert a["ddp"] and b["ddp"] and b["layout"] == "DimSharding"
        assert a["metrics"] == b["metrics"]
        for k, v in a["tensors"].items():
            assert torch.equal(b["tensors"][k], v), k
        assert set(a["ema"]) == set(b["ema"])
        for k, v in a["ema"].items():
            assert torch.equal(b["ema"][k], v), k
        assert b["eval"] == a["eval"]


@pytest.mark.parametrize("world, case", [
    ("a", "lenet_efsdp"), ("a", "bert_efsdp"), ("a", "lenet_jfsdp"),
    ("a", "resnet_jfsdp"), ("b", "lenet_efsdp"), ("b", "lenet_jfsdp4")])
def test_parameters_are_halved_at_rest(worlds, world, case):
    for r in worlds[world]:
        got = r["steps"][case]
        dims = shd.infer_fsdp_dims(_model((WORLD_A if world == "a"
                                           else WORLD_B)[case]), 2)
        full = {k: v.numel() for k, v in got["tensors"].items()
                if k in got["at_rest"]}
        for k, n in full.items():
            want = n // 2 if dims[k] >= 0 else n
            assert got["at_rest"][k] == got["after"][k] == want, k
        assert sum(got["after"].values()) < 0.6 * sum(full.values())


def _jax_fsdp_steps(overrides, mesh_cfg, port_init):
    """The JAX StepBuilder in shard_map mode on ``mesh_cfg`` (explicit
    FSDP) over the port's global batches, from the port's initial
    parameters."""
    import math

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

    n = math.prod(mesh_cfg.values())
    mesh = create_mesh(MeshConfig(**mesh_cfg), devices=jax.devices()[:n])
    sets = [f"mesh.{k}={v}" for k, v in mesh_cfg.items()]
    builder = StepBuilder(load_config(overrides=overrides + sets), mesh)
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


def _port_init(overrides):
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    over = [o for o in overrides if not o.startswith(
        ("train.spmd_mode", "mesh.", "parallel.collective_dtype"))]
    return StepBuilder(port_config(overrides=over),
                       device="cpu").init_state(0).model.state_dict()


@pytest.mark.parametrize("world, case, mesh_cfg", [
    ("a", "lenet_efsdp", {"data": 1, "fsdp": 2}),
    ("a", "bert_efsdp", {"data": 1, "fsdp": 2}),
    ("b", "lenet_efsdp", {"data": 2, "fsdp": 2})])
def test_explicit_fsdp_matches_the_jax_step(worlds, world, case, mesh_cfg):
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        to_flax,
    )

    over = (WORLD_A if world == "a" else WORLD_B)[case]
    over = [o for o in over if not o.startswith("mesh.")]
    ref, params = _jax_fsdp_steps(over, mesh_cfg, _port_init(over))
    lr = port_config(overrides=over).optimizer.learning_rate
    atol = lr * (1e-3 if case.startswith("bert") else 1e-5)
    for r in worlds[world]:
        got = r["steps"][case]
        for i, (g, w) in enumerate(zip(got["metrics"], ref)):
            for key in ("loss", "mlm_acc", "top1"):
                if key in w:
                    np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                               atol=1e-7,
                                               err_msg=f"step {i} {key}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-4, err_msg=f"step {i}")
        model = _model(over)
        model.load_state_dict(got["tensors"])
        ours = flatten_tree(to_flax(model))
        for path, want in params.items():
            np.testing.assert_allclose(ours[path], want, rtol=0, atol=atol,
                                       err_msg=str(path))


def test_int8_ef_fsdp_loss_parity(worlds):
    """dp+fsdp: the explicit-FSDP path on the int8 wire (quantized
    parameter gather, error-feedback all-reduce over every rank, the
    gradient sliced back) tracks the same mesh's f32 run."""
    for r in worlds["b"]:
        f32 = [m["loss"] for m in r["steps"]["lenet_efsdp"]["metrics"]]
        q8 = [m["loss"] for m in r["steps"]["lenet_efsdp_int8"]["metrics"]]
        assert all(np.isfinite(q8)) and q8 != f32
        np.testing.assert_allclose(q8, f32, rtol=0.02, atol=2e-3)


def test_int8_wire_bytes_drop_3x_dp_fsdp(worlds):
    """The dp+fsdp recipe's tallied wire bytes — the gradient all-reduce
    AND the fsdp parameter gather — drop >= 3x against the f32 wire."""
    f32 = worlds["b"][0]["steps"]["lenet_efsdp"]["tally"]
    q8 = worlds["b"][0]["steps"]["lenet_efsdp_int8"]["tally"]
    assert f32["total_bytes"] / q8["total_bytes"] >= 3.0, (f32, q8)
    assert "allreduce_grads_q8_scatter_bytes" in q8
    assert "allreduce_grads_q8_gather_bytes" in q8
    assert q8["all_gather_bytes"] < f32["all_gather_bytes"]
    assert (abs(q8["total_logical_bytes"] - f32["total_logical_bytes"])
            <= 0.05 * f32["total_logical_bytes"])


def _jax_fsdp_tally(overrides) -> dict:
    import jax

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_tpu.core.config import (
        MeshConfig,
        load_config,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.parallel import (
        collectives as jcoll,
    )
    from distributed_tensorflow_framework_tpu.train.step import StepBuilder

    mesh = create_mesh(MeshConfig(data=2, fsdp=2), devices=jax.devices()[:4])
    builder = StepBuilder(load_config(overrides=overrides), mesh)
    batch = to_global(next(get_dataset(port_config(
        overrides=overrides).data)), mesh)
    state = builder.init_state(0, batch)
    with jcoll.tally() as t:
        builder.make_train_step(batch).lower(state, batch)
    return t.summary()


@pytest.mark.parametrize("case", ["lenet_efsdp", "lenet_efsdp_int8"])
def test_dp_fsdp_tally_equals_jax(worlds, case):
    want = _jax_fsdp_tally(WORLD_B[case])
    for r in worlds["b"]:
        assert r["steps"][case]["tally"] == want


def test_jit_fsdp_tally_is_empty(worlds):
    """Under jit the gathers are the layout's own, as XLA's are in the
    JAX package: nothing is tallied."""
    for r in worlds["a"]:
        assert r["steps"]["lenet_jfsdp"]["tally"] == r["steps"][
            "lenet_ddp"]["tally"]


# ------------------------------------------------------ the checkpoint

def test_fsdp_checkpoint_is_whole_and_round_trips(worlds):
    for r in worlds["a"]:
        ck = r["ckpt"]
        assert ck["restored"] == 2 and ck["saved_whole"]
        assert ck["saved_ema_whole"] and ck["state_equal"]
        assert ck["next_equal"]
        assert ck["into_rep"] == 2 and ck["rep_equal"]


# ----------------------------------------------------------- refusals

def test_explicit_fsdp_refuses_batchnorm(worlds):
    for r in worlds["a"]:
        assert r["bn_refusal"] is not None
        assert "does not support BN models" in r["bn_refusal"]


@pytest.mark.parametrize("extra, match", [
    (["optimizer.name=lars"], "lars"),
    (["optimizer.grad_clip_norm=1.0"], "grad_clip_norm")])
def test_explicit_fsdp_refuses_lars_and_clipping(extra, match):
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    with pytest.raises(ValueError, match=match):
        check_step_config(port_config(
            overrides=LENET + SHARD_MAP + FSDP2 + extra), 2)
    # Under jit both run (on whole leaves).
    sizes = check_step_config(port_config(overrides=LENET + FSDP2 + extra),
                              2)
    assert sizes["fsdp"] == 2


def test_check_step_config_accepts_fsdp_with_model_under_jit():
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    sizes = check_step_config(port_config(overrides=LENET + [
        "mesh.data=1", "mesh.fsdp=2", "mesh.model=2"]), 4)
    assert (sizes["data"], sizes["fsdp"], sizes["model"]) == (1, 2, 2)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
