"""ZeRO weight-update sharding (``optimizer.zero_sharding: shard_map``,
parallel/zero.py) and ZeRO-1 (``optimizer.zero_sharding: jit``, the
deprecated ``optimizer.shard_opt_state``; parallel/sharding.py) against
the JAX package and against the port's own replicated steps.

Mirrors ``tests/test_zero_sharding.py``, ``tests/test_opt_state_sharding.py``
and ``tests/test_reshard.py::test_zero_opt_state_reshard_8_to_4``. Two
worlds of gloo ranks, each rank a child process running this file with
the gang environment of core/cluster.py (torch alone):

  * world B, four ranks: LeNet-5 under ZeRO for two steps and a
    chief-written checkpoint;
  * world A, two ranks: the bucketed collectives on seeded per-rank
    leaves on each wire; three steps of LeNet-5 and of a tiny BERT
    (dropout 0, two micro-batches of unequal masked counts) replicated
    under ``shard_map`` and under ZeRO on each wire, each first step
    under a tally; a ZeRO checkpoint round trip, the refold of world B's
    checkpoint onto two ranks, the toggle refusals and a ladder rollback;
    ZeRO-1 and the deprecated knob against DDP at ``mesh.data=2``.

In this process the JAX package builds the plans of the same models,
runs the bucketed collectives under ``shard_map`` on a ``data=2`` mesh
over two of conftest's eight CPU devices, lowers its ZeRO step under a
tally and runs its ZeRO step on the bf16 and int8 wires from the port's
initial parameters.

Tolerances. Exact (bit-equal or equal dicts): the plans; the f32 and
int8 bucketed collectives and the new residuals (the same f32 operations
in the same order as XLA's, as tests/test_torch_collectives.py holds the
all-reduce); the tallies; the f32 ZeRO step's losses and parameters
against the replicated ``shard_map`` step at two ranks (the update is
elementwise, the shards are cut from the same reduced gradients); ZeRO-1
against DDP at the same world; every checkpoint and rollback round
trip. ``grad_norm`` under ZeRO comes from the shards' squared sums, the
replicated one from the leaves' norms: rtol 1e-6. A bf16 sum of two ranks
is rounded once by gloo and maybe twice by XLA: within one bf16 ulp. The
bf16 and int8 ZeRO steps against JAX's: the tolerances of
tests/test_torch_shard_map.py (loss rtol 1e-5 at step 1, then the
largest grad_norm times the parameter tolerance; parameters within lr ×
(1e-5 + 3 × step × the largest grad_norm), the step one bf16 ulp (2^-8)
or one int8 quantum on the scatter and one on the gather (2/127), carried
at most three times by the momentum: the two packages' f32 gradients
differ in their last bits, and a transposed leaf's elements fall into
other int8 blocks than JAX's). ZeRO-1 with LARS against DDP: its
per-leaf norms are summed over the parts (one all_reduce of squared
norms), not taken over the whole leaf: rtol 1e-6 on the losses,
parameters within 1e-6 × lr.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from distributed_tensorflow_framework_torch.parallel import zero as port_zero
from tests.test_torch_hygiene import torch_threads  # noqa: F401

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
STEPS = 3
BLOCK = 64
# Seeded leaves for the bucketed collectives: Flax-style paths (digits
# sorted naturally), a scalar, a leaf that does not divide two.
LEAVES = {("layer_2", "kernel"): (37, 11), ("layer_10", "bias"): (5,),
          ("head", "scale"): (), ("embed", "embedding"): (300,),
          ("layer_2", "bias"): (11,)}
LEAF_BUCKET_MB = 600 / 2**20
LENET = [
    "model.name=lenet5", "model.dtype=float32", "data.name=synthetic_images",
    "data.image_size=28", "data.channels=1", "data.seed=4",
    "data.global_batch_size=8", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.1", "optimizer.momentum=0.9",
    "optimizer.weight_decay=0.001", "optimizer.warmup_steps=1",
    "optimizer.schedule=cosine", "optimizer.grad_clip_norm=0.0",
    f"train.total_steps={STEPS}", "train.label_smoothing=0.1",
    "checkpoint.directory=", "resilience.rollback=false",
    f"parallel.collective_block_size={BLOCK}",
    # A small bucket so that LeNet splits into several.
    "optimizer.zero_bucket_mb=0.05"]
ADAM = ["optimizer.name=adam", "optimizer.learning_rate=0.01",
        "optimizer.weight_decay=0.0"]
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
    "resilience.rollback=false", "train.grad_accum_steps=2",
    "optimizer.zero_bucket_mb=0.1"]
SHARD_MAP = ["train.spmd_mode=shard_map"]
ZERO = SHARD_MAP + ["optimizer.zero_sharding=shard_map"]
WIRES = {"f32": [], "bf16": ["parallel.collective_dtype=bfloat16"],
         "int8": ["parallel.collective_dtype=int8"]}
# name → overrides of the step cases of world A.
CASES = {
    "lenet_rep": LENET + SHARD_MAP,
    **{f"lenet_zero_{w}": LENET + ZERO + o for w, o in WIRES.items()},
    "bert_rep": TINY_BERT + SHARD_MAP,
    "bert_zero": TINY_BERT + ZERO,
    "bert_zero_int8": TINY_BERT + ZERO + WIRES["int8"],
    "lenet_ddp": LENET + ADAM,
    "lenet_zero1": LENET + ADAM + ["mesh.data=1", "mesh.fsdp=2",
                                   "optimizer.zero_sharding=jit"],
    "lenet_shard_opt_state": LENET + ADAM + [
        "mesh.data=1", "mesh.fsdp=2", "optimizer.shard_opt_state=true"],
    "lenet_ddp_lars": LENET + ["optimizer.name=lars",
                               "optimizer.grad_clip_norm=1.0"],
    "lenet_zero1_lars": LENET + ["optimizer.name=lars",
                                 "optimizer.grad_clip_norm=1.0",
                                 "mesh.data=1", "mesh.fsdp=2",
                                 "optimizer.zero_sharding=jit"],
}
ZERO4 = LENET + ADAM + ZERO + ["mesh.data=4"]


def _leaf_names():
    return {"/".join(path): (path, shape) for path, shape in LEAVES.items()}


def _inputs() -> dict:
    """Every rank's gradients (of another magnitude on each rank) and
    residuals, stacked on a leading rank axis, keyed by leaf name."""
    rng = np.random.default_rng(3)
    scale = np.array([1e-2, 1e1], np.float32)
    names = _leaf_names()
    return {
        "g": {k: (rng.standard_normal((2,) + s).astype(np.float32)
                  * scale.reshape((2,) + (1,) * len(s)))
              for k, (_, s) in names.items()},
        "r": {k: rng.standard_normal((2,) + s).astype(np.float32)
              * np.float32(1e-3) for k, (_, s) in names.items()}}


# ------------------------------------------------------------ the ranks

def _run_case(overrides, runtime, steps=STEPS, seed=0):
    """``steps`` steps on this rank's blocks of the global batches: the
    builder, the state, every step's metrics and the first step's
    tally."""
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    config = port_config(overrides=overrides)
    builder = StepBuilder(config, device="cpu", runtime=runtime)
    state = builder.init_state(seed)
    ds = get_dataset(config.data)
    metrics, tally = [], None
    world, rank = runtime.process_count, runtime.process_index
    for _ in range(steps):
        batch = next(ds)
        b = config.data.global_batch_size // world
        block = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        with coll.tally() as t:
            m = builder.global_metrics(builder.train_step(
                state, to_device(block, torch.device("cpu"))))
        tally = tally or t.summary()
        metrics.append({k: float(v) for k, v in m.items()})
    return builder, state, metrics, tally, ds


def _tensors(state) -> dict:
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


def _slots(state) -> dict:
    """The optimizer's per-parameter slot tensors: {name: {slot: t}}."""
    opt = state.optimizer.state_dict()["inner"]["state"]
    return {state.optimizer.names[i]: {k: v.clone() for k, v in s.items()}
            for i, s in opt.items()}


def _collectives(runtime) -> dict:
    inp = _inputs()
    rank = runtime.process_index
    g = {k: torch.tensor(v[rank]) for k, v in inp["g"].items()}
    r = {k: torch.tensor(v[rank]) for k, v in inp["r"].items()}
    plan = port_zero.build_plan(_leaf_names(), 2, LEAF_BUCKET_MB)
    out = {}
    for wire in WIRES:
        w = {"f32": None, "bf16": "bfloat16", "int8": "int8"}[wire]
        with coll.tally() as t:
            shards, res = port_zero.bucketed_reduce_scatter(
                plan, g, runtime, wire_dtype=w, block_size=BLOCK,
                residual=r if wire == "int8" else None)
        rs_tally = t.summary()
        with coll.tally() as t:
            full = port_zero.bucketed_all_gather(
                plan, shards, runtime, wire_dtype=w, block_size=BLOCK)
        out[wire] = {"shards": shards, "residual": res, "full": full,
                     "rs_tally": rs_tally, "ag_tally": t.summary()}
    return out


def _checkpoints(workdir: str, runtime) -> dict:
    """The ZeRO round trip (int8 with error feedback), the toggle
    refusals, the refold of world B's checkpoint and a rollback."""
    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.core.config import (
        ResilienceConfig,
    )
    from distributed_tensorflow_framework_torch.train.anomaly import (
        RecoveryManager,
    )

    over = CASES["lenet_zero_int8"]
    builder, state, _, _, ds = _run_case(over, runtime, steps=2)
    ck = dataclasses.replace(builder.config.checkpoint,
                             directory=f"{workdir}/ck_zero",
                             async_save=False)
    manager = CheckpointManager(ck, runtime=runtime)
    manager.save(2, state)
    fresh_builder, fresh, _, _, _ = _run_case(over, runtime, steps=0, seed=9)
    restored = manager.restore(fresh)
    manager.close()
    out = {"restored": restored,
           "params_equal": all(torch.equal(a, b) for a, b in zip(
               _tensors(state).values(), _tensors(fresh).values())),
           "slots_equal": all(
               torch.equal(x, y) for a, b in zip(_slots(state).values(),
                                                 _slots(fresh).values())
               for x, y in zip(a.values(), b.values())),
           "residual_equal": all(torch.equal(
               state.collective_residual[k], fresh.collective_residual[k])
               for k in state.collective_residual),
           "residual_nonzero": any(bool(v.any()) for v in
                                   state.collective_residual.values())}
    # One more step from the live state and from the restored one.
    batch = next(ds)
    b = 8 // runtime.process_count
    block = {k: v[runtime.process_index * b:(runtime.process_index + 1) * b]
             for k, v in batch.items()}
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    a = builder.train_step(state, to_device(block, torch.device("cpu")))
    c = fresh_builder.train_step(fresh, to_device(block,
                                                  torch.device("cpu")))
    out["next_step_equal"] = (float(a["loss"]) == float(c["loss"]) and all(
        torch.equal(x, y) for x, y in zip(_tensors(state).values(),
                                          _tensors(fresh).values())))
    # The toggle, both ways.
    errors = []
    for path, case in ((f"{workdir}/ck_zero", "lenet_rep"),
                       (f"{workdir}/ck_rep", "lenet_zero_f32")):
        if case == "lenet_zero_f32":
            _, rep, _, _, _ = _run_case(CASES["lenet_rep"], runtime, 1)
            m = CheckpointManager(dataclasses.replace(
                ck, directory=path), runtime=runtime)
            m.save(1, rep)
            m.close()
        _, target, _, _, _ = _run_case(CASES[case], runtime, steps=0)
        m = CheckpointManager(dataclasses.replace(ck, directory=path),
                              runtime=runtime)
        try:
            m.restore(target)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
        finally:
            m.close()
    out["toggle_errors"] = errors
    # World B's four-row checkpoint onto two ranks.
    _, two, _, _, _ = _run_case(ZERO4[:-1], runtime, steps=0, seed=5)
    m = CheckpointManager(dataclasses.replace(ck, directory=f"{workdir}/ck4"),
                          runtime=runtime)
    out["refold_restored"] = m.restore(two)
    m.close()
    out["refold_tensors"] = _tensors(two)
    out["refold_slots"] = two.layout.global_state(
        two.state_dict(), two.optimizer.names)["optimizer"]
    out["refold_local"] = _slots(two)
    # The ladder: a snapshot after step 1, a rollback after step 2.
    rec = RecoveryManager(ResilienceConfig())
    lb, ls, _, _, lds = _run_case(CASES["lenet_zero_f32"], runtime, 1)
    rec.take_snapshot(1, ls, force=True)
    want_t, want_s = _tensors(ls), _slots(ls)
    batch = next(lds)
    block = {k: v[runtime.process_index * b:(runtime.process_index + 1) * b]
             for k, v in batch.items()}
    lb.train_step(ls, to_device(block, torch.device("cpu")))
    moved = not all(torch.equal(x, y) for x, y in zip(
        _tensors(ls).values(), want_t.values()))
    rec.rollback(ls, from_step=2)
    out["ladder"] = {"moved": moved, "step": ls.step, "tensors_equal": all(
        torch.equal(x, y) for x, y in zip(_tensors(ls).values(),
                                          want_t.values())),
        "slots_equal": all(
            torch.equal(x, y) for a, c in zip(_slots(ls).values(),
                                              want_s.values())
            for x, y in zip(a.values(), c.values()))}
    return out


def _world_a(workdir: str, runtime) -> dict:
    out = {"collectives": _collectives(runtime), "steps": {}}
    for name, over in CASES.items():
        builder, state, metrics, tally, _ = _run_case(over, runtime)
        slot_numel = sum(t.numel() for s in _slots(state).values()
                         for t in s.values() if t.dim() >= 1)
        out["steps"][name] = {
            "metrics": metrics, "tally": tally, "tensors": _tensors(state),
            "residual": dict(state.collective_residual),
            "slot_numel": slot_numel,
            "slot_shapes": {k: next(tuple(t.shape) for t in s.values()
                                    if t.dim())
                            for k, s in _slots(state).items()
                            if any(t.dim() for t in s.values())},
            "global_slots": (None if state.layout is None else
                             state.layout.global_state(
                                 state.state_dict(),
                                 state.optimizer.names)["optimizer"]),
            "local_slots": _slots(state),
            "ddp": state.ddp is not None,
            "plan_summary": (
                None if not isinstance(state.layout, port_zero.ZeroUpdate)
                else port_zero.plan_summary(
                    state.layout.plan, wire_dtype=builder.wire or None,
                    block_size=BLOCK))}
    out["ckpt"] = _checkpoints(workdir, runtime)
    return out


def _world_b(workdir: str, runtime) -> dict:
    import dataclasses as dc

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    builder, state, _, _, _ = _run_case(ZERO4, runtime, steps=2)
    manager = CheckpointManager(dc.replace(
        builder.config.checkpoint, directory=f"{workdir}/ck4",
        async_save=False), runtime=runtime)
    manager.save(2, state)
    manager.close()
    return {"tensors": _tensors(state),
            "global_slots": state.layout.global_state(
                state.state_dict(), state.optimizer.names)["optimizer"],
            "names": state.optimizer.names,
            "local_shapes": {k: tuple(v["exp_avg"].shape)
                             for k, v in _slots(state).items()}}


def _rank_main(workdir: str, world: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    runtime = initialize_runtime(MeshConfig(data=-1), "cpu")
    out = (_world_a if world == "a" else _world_b)(workdir, runtime)
    runtime.shutdown()
    torch.save(out, os.path.join(workdir,
                                 f"{world}{runtime.process_index}.pt"))


# ------------------------------------------------------- the test side

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(workdir: str, world: str, n: int) -> list:
    port = _free_port()
    procs = []
    for rank in range(n):
        env = {**os.environ, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(rank),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
        log = open(os.path.join(workdir, f"{world}{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, HERE, workdir, world], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=ROOT), log))
    try:
        for proc, _ in procs:
            proc.wait(timeout=300)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for proc, log in procs:
        if proc.returncode != 0:
            with open(log.name) as fh:
                pytest.fail(f"{log.name} exited {proc.returncode}:\n"
                            f"{fh.read()[-3000:]}")
    return [torch.load(os.path.join(workdir, f"{world}{r}.pt"),
                       weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("zero"))
    b = _spawn(workdir, "b", 4)
    return {"b": b, "a": _spawn(workdir, "a", 2)}


def _model(overrides):
    from distributed_tensorflow_framework_torch.train import step as port_step

    config = port_config(overrides=overrides)
    return port_step.get_model(
        config.model, device="cpu",
        in_channels=None if "bert" in config.model.name else
        config.data.channels)


# ------------------------------------------------------------- the plan

def test_natural_key_orders_digits_numerically():
    from distributed_tensorflow_framework_tpu.parallel import zero as jzero

    paths = ["layer_10/kernel", "layer_2/kernel", "layer_2/bias",
             "encoder/layer_11/attn/qkv/kernel"]
    assert (sorted(paths, key=port_zero.natural_key)
            == sorted(paths, key=jzero.natural_key)
            == ["encoder/layer_11/attn/qkv/kernel", "layer_2/bias",
                "layer_2/kernel", "layer_10/kernel"])


def _jax_plan(tree, n, bucket_mb):
    from distributed_tensorflow_framework_tpu.parallel import zero as jzero

    return jzero.build_plan(tree, n, bucket_mb)


def _plan_rows(plan):
    return ([(lc.index, lc.path, lc.shape, lc.size, lc.chunk)
             for lc in plan.leaf_chunks],
            [[lc.path for lc in b] for b in plan.buckets],
            plan.n, plan.bucket_bytes, plan.shard_elements())


@pytest.mark.parametrize("model, n, bucket_mb", [
    ("lenet", 2, 0.05), ("lenet", 8, 0.05), ("lenet", 2, 4.0),
    ("bert", 2, 0.1), ("bert", 4, 0.02), ("bert", 3, 4.0)])
def test_plan_equals_jax_build_plan(model, n, bucket_mb):
    """Paths, shapes, chunks, bucket membership and order, from the Flax
    paths of the port's parameters (models/convert.py)."""
    from distributed_tensorflow_framework_torch.models.convert import (
        flax_layout,
        to_flax,
    )

    m = _model(LENET if model == "lenet" else TINY_BERT)
    ours = port_zero.build_plan(flax_layout(m), n, bucket_mb)
    ref = _jax_plan(to_flax(m), n, bucket_mb)
    assert _plan_rows(ours) == _plan_rows(ref)
    assert ours.num_buckets > 1 or bucket_mb == 4.0
    # Every port name maps to its leaf.
    layout = flax_layout(m)
    for lc in ours.leaf_chunks:
        assert "/".join(layout[lc.name][0]) == lc.path


def test_build_plan_reverse_order_and_chunk_math():
    leaves = {"a": (("layer_2", "kernel"), (7, 3)),
              "b": (("layer_10", "kernel"), (5,)),
              "c": (("head", "bias"), ())}
    plan = port_zero.build_plan(leaves, 4, 1e-6)
    by_path = {lc.path: lc for lc in plan.leaf_chunks}
    assert by_path["layer_2/kernel"].chunk == 6
    assert by_path["layer_10/kernel"].chunk == 2
    assert by_path["head/bias"].chunk == 1
    issue = [lc.path for bucket in plan.buckets for lc in bucket]
    assert issue == sorted(issue, key=port_zero.natural_key, reverse=True)
    assert plan.num_buckets == 3
    eight = {f"l{i}": ((f"l{i}",), (64,)) for i in range(8)}
    assert [len(b) for b in port_zero.build_plan(
        eight, 2, 512 / 2**20).buckets] == [2, 2, 2, 2]


def test_plan_summary_equals_jax():
    """Every field but the nominal-rate estimate (the port's link rate is
    the H100's NVLink, JAX's a TPU interconnect's)."""
    from distributed_tensorflow_framework_tpu.parallel import zero as jzero

    tree = {"a": np.zeros((64, 64), np.float32),
            "b": np.zeros((128,), np.float32)}
    leaves = {k: ((k,), v.shape) for k, v in tree.items()}
    for wire in (None, "bfloat16", "int8"):
        ours = port_zero.plan_summary(port_zero.build_plan(leaves, 8, 0.005),
                                      wire_dtype=wire, block_size=64)
        ref = jzero.plan_summary(jzero.build_plan(tree, 8, 0.005),
                                 wire_dtype=wire, block_size=64)
        assert ours.pop("hidden_ms_est") >= 0
        ref.pop("hidden_ms_est")
        assert ours == ref


# ------------------------------------------------- the bucketed collectives

def _jax_bucketed(wire):
    import jax
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_framework_torch.models.convert import (
        unflatten_tree,
    )
    from distributed_tensorflow_framework_tpu.core.config import MeshConfig
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.parallel import (
        collectives as jcoll,
    )
    from distributed_tensorflow_framework_tpu.parallel import zero as jzero

    mesh = create_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    inp = _inputs()
    names = _leaf_names()
    g = unflatten_tree({names[k][0]: v for k, v in inp["g"].items()})
    r = unflatten_tree({names[k][0]: v for k, v in inp["r"].items()})
    plan = jzero.build_plan(jax.tree.map(lambda x: x[0], g), 2,
                            LEAF_BUCKET_MB)
    w = {"f32": None, "bf16": "bfloat16", "int8": "int8"}[wire]

    def body(gs, rs):
        gs = jax.tree.map(lambda v: v[0], gs)
        rs = jax.tree.map(lambda v: v[0], rs)
        with jcoll.tally() as t1:
            shards, res = jzero.bucketed_reduce_scatter(
                plan, gs, ("data",), wire_dtype=w, block_size=BLOCK,
                residual=rs if wire == "int8" else None)
        with jcoll.tally() as t2:
            full = jzero.bucketed_all_gather(plan, shards, ("data",),
                                             wire_dtype=w, block_size=BLOCK)
        tallies.extend([t1.summary(), t2.summary()])
        out = (shards, res if res is not None else {}, full)
        return jax.tree.map(lambda v: v[None], out)

    tallies = []
    mapped = jcoll.shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                             out_specs=P("data"), check_vma=False)
    out = jax.tree.map(np.asarray, jax.jit(mapped)(g, r))
    return out, tallies


def _by_name(tree):
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
    )

    return {"/".join(k): v for k, v in flatten_tree(tree).items()}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("wire", list(WIRES))
def test_bucketed_collectives_match_jax(worlds, wire):
    (shards, res, full), tallies = _jax_bucketed(wire)
    shards, res, full = _by_name(shards), _by_name(res), _by_name(full)
    for rank, r in enumerate(worlds["a"]):
        got = r["collectives"][wire]
        assert got["rs_tally"] == tallies[0]
        assert got["ag_tally"] == tallies[1]
        for k, want in shards.items():
            a = got["shards"][k].numpy()
            if wire == "bf16":
                assert np.all(np.abs(a - want[rank])
                              <= _bf16_ulp(want[rank])), k
            else:
                np.testing.assert_array_equal(a, want[rank], err_msg=k)
        for k, want in full.items():
            a = got["full"][k].numpy().reshape(want[rank].shape)
            if wire == "bf16":
                assert np.all(np.abs(a - want[rank])
                              <= 2 * _bf16_ulp(want[rank])), k
            else:
                np.testing.assert_array_equal(a, want[rank], err_msg=k)
        if wire == "int8":
            for k, want in res.items():
                np.testing.assert_array_equal(got["residual"][k].numpy(),
                                              want[rank], err_msg=k)
        else:
            assert got["residual"] is None and res == {}


def test_bucketed_reduce_scatter_issue_order(monkeypatch):
    """One collective per bucket, in the plan's (reverse natural) order —
    the dispatch spy of the JAX test, on one process."""
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core import mesh as mesh_lib
    from distributed_tensorflow_framework_torch.core.mesh import MeshRuntime

    m = _model(LENET)
    from distributed_tensorflow_framework_torch.models.convert import (
        flax_layout,
    )

    plan = port_zero.build_plan(flax_layout(m), 1, 0.05)
    calls = []
    real = port_zero._reduce_scatter_bucket

    def spy(mat, runtime, *, wire, block_size, paths):
        calls.append(tuple(paths))
        return real(mat, runtime, wire=wire, block_size=block_size,
                    paths=paths)

    monkeypatch.setattr(port_zero, "_reduce_scatter_bucket", spy)
    grads = {k: torch.randn(p.shape) for k, p in m.named_parameters()}
    rt = MeshRuntime(mesh_lib.resolve_mesh(MeshConfig(), 1), 0, 1,
                     torch.device("cpu"))
    shards, _ = port_zero.bucketed_reduce_scatter(plan, grads, rt)
    assert len(calls) >= 2
    assert calls == [tuple(lc.path for lc in b) for b in plan.buckets]
    flat = [p for bucket in calls for p in bucket]
    assert flat == sorted(flat, key=port_zero.natural_key, reverse=True)
    for k, g in grads.items():
        torch.testing.assert_close(shards[k], g.reshape(-1), rtol=0, atol=0)


# --------------------------------------------------------------- the steps

def test_f32_zero_is_the_replicated_step_bit_for_bit(worlds):
    for model in ("lenet", "bert"):
        for r in worlds["a"]:
            rep = r["steps"][f"{model}_rep"]
            z = r["steps"][f"{model}_zero" + ("_f32" if model == "lenet"
                                               else "")]
            assert [m["loss"] for m in z["metrics"]] == [
                m["loss"] for m in rep["metrics"]]
            for k, v in rep["tensors"].items():
                assert torch.equal(z["tensors"][k], v), (model, k)
            np.testing.assert_allclose(
                [m["grad_norm"] for m in z["metrics"]],
                [m["grad_norm"] for m in rep["metrics"]], rtol=1e-6)


@pytest.mark.parametrize("case", ["lenet_zero_f32", "lenet_zero_int8",
                                  "bert_zero", "bert_zero_int8"])
def test_zero_slots_are_one_row_of_n_per_rank(worlds, case):
    """Every slot is (ceil(S/n),) on each rank and (n, ceil(S/n)) in the
    checkpoint's layout; the ranks' slots together are 1/n of the
    replicated run's (plus padding), and the parameters stay whole and
    equal on both ranks."""
    from distributed_tensorflow_framework_torch.models.convert import (
        flax_layout,
    )

    rep = "lenet_rep" if case.startswith("lenet") else "bert_rep"
    over = CASES[case]
    layout = flax_layout(_model(over))
    want = {k: -(-int(np.prod(s)) // 2) for k, (_, s) in layout.items()}
    a, b = worlds["a"]
    for r in worlds["a"]:
        got = r["steps"][case]
        assert got["slot_shapes"] == {k: (c,) for k, c in want.items()}
        for slots in got["global_slots"]["inner"]["state"].values():
            for t in slots.values():
                if t.dim():
                    assert t.dim() == 2 and t.shape[0] == 2
        per_rank = got["slot_numel"]
        assert per_rank <= r["steps"][rep]["slot_numel"] / 2 + len(want) * 2
    for k in a["steps"][case]["tensors"]:
        assert torch.equal(a["steps"][case]["tensors"][k],
                           b["steps"][case]["tensors"][k])
    # The ranks hold different rows.
    la, lb = (r["steps"][case]["local_slots"] for r in worlds["a"])
    assert any(not torch.equal(x, y) for k in la for x, y in
               zip(la[k].values(), lb[k].values()) if x.dim())


def _jax_zero_steps(name, port_init):
    """The JAX StepBuilder's ZeRO step on a data=2 mesh over the port's
    global batches, from the port's initial parameters."""
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

    overrides = CASES[name]
    config = port_config(overrides=overrides)
    mesh = create_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    builder = StepBuilder(load_config(overrides=overrides + ["mesh.data=2"]),
                          mesh)
    ds = get_dataset(config.data)
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
    return metrics, flatten_tree(jax.device_get(state.params)), builder


def _port_init(name):
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    over = [o for o in CASES[name] if not o.startswith(
        ("optimizer.zero_sharding", "train.spmd_mode",
         "parallel.collective_dtype"))]
    return StepBuilder(port_config(overrides=over),
                       device="cpu").init_state(0).model.state_dict()


# The wire's rounding step relative to grad_norm (the tolerances of
# tests/test_torch_shard_map.py): one bf16 ulp, or one int8 quantum on the
# scatter and one on the gather.
WIRE_STEP = {"bf16": 2.0 ** -8, "int8": 2.0 / 127}


@pytest.mark.parametrize("wire", sorted(WIRE_STEP))
def test_zero_step_matches_the_jax_zero_step(worlds, wire):
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        to_flax,
    )

    name = f"lenet_zero_{wire}"
    ref, params, builder = _jax_zero_steps(name, _port_init(name))
    assert builder._zero_plan is not None and builder._zero_plan.n == 2
    lr = port_config(overrides=CASES[name]).optimizer.learning_rate
    top = max(m["grad_norm"] for m in ref)
    step = WIRE_STEP[wire]
    atol = lr * (1e-5 + 3 * step * top)
    for r in worlds["a"]:
        got = r["steps"][name]
        for i, (g, w) in enumerate(zip(got["metrics"], ref)):
            np.testing.assert_allclose(
                g["loss"], w["loss"], rtol=1e-5,
                atol=1e-7 + (top * atol if i else 0.0),
                err_msg=f"step {i}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-4, atol=2 * step * top)
        model = _model(CASES[name])
        model.load_state_dict(got["tensors"])
        ours = flatten_tree(to_flax(model))
        for path, want in params.items():
            np.testing.assert_allclose(ours[path], want, rtol=0, atol=atol,
                                       err_msg=str(path))
        assert (any(v.abs().max() > 0 for v in got["residual"].values())
                if wire == "int8" else got["residual"] == {})


def _jax_zero_tally(overrides) -> dict:
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
    import jax

    mesh = create_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    builder = StepBuilder(load_config(overrides=overrides + ["mesh.data=2"]),
                          mesh)
    batch = to_global(next(get_dataset(port_config(
        overrides=overrides).data)), mesh)
    state = builder.init_state(0, batch)
    step = builder.make_train_step(batch)
    with jcoll.tally() as t:
        step.lower(state, batch)
    return t.summary()


@pytest.mark.parametrize("wire", list(WIRES))
def test_zero_step_tally_equals_jax(worlds, wire):
    name = f"lenet_zero_{wire}"
    want = _jax_zero_tally(CASES[name])
    for r in worlds["a"]:
        tally = r["steps"][name]["tally"]
        assert tally == want
        assert tally["zero_reduce_scatter_calls"] >= 2
    if wire == "int8":
        f32 = worlds["a"][0]["steps"]["lenet_zero_f32"]["tally"]
        assert tally["zero_reduce_scatter_bytes"] * 3 <= f32[
            "zero_reduce_scatter_bytes"]


def test_zero_int8_error_feedback(worlds):
    for r in worlds["a"]:
        got = r["steps"]["bert_zero_int8"]
        assert all(np.isfinite(m["loss"]) for m in got["metrics"])
        assert set(got["residual"]) == set(got["tensors"]) - {
            k for k in got["tensors"] if "running" in k}
        assert any(v.abs().max() > 0 for v in got["residual"].values())
        f32 = r["steps"]["bert_zero"]["metrics"]
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   [m["loss"] for m in f32], rtol=0.02,
                                   atol=2e-3)
        assert r["steps"]["lenet_zero_bf16"]["residual"] == {}


def test_plan_summary_rides_the_state(worlds):
    for r in worlds["a"]:
        s = r["steps"]["lenet_zero_int8"]["plan_summary"]
        assert s["shards"] == 2 and s["buckets"] >= 2
        assert s["wire"] == "int8" and s["rs_wire_bytes"] > 0


# ------------------------------------------------------------- ZeRO-1

@pytest.mark.parametrize("case", ["lenet_zero1", "lenet_shard_opt_state"])
def test_zero1_is_the_ddp_step_bit_for_bit(worlds, case):
    """Slots sharded over fsdp, parameters whole: the DDP step at
    mesh.data=2 in every bit, and the checkpoint's whole slots are DDP's
    slots."""
    from distributed_tensorflow_framework_torch.parallel.sharding import (
        infer_fsdp_dims,
    )

    dims = infer_fsdp_dims(_model(CASES[case]), 2)
    for r in worlds["a"]:
        ddp, z1 = r["steps"]["lenet_ddp"], r["steps"][case]
        assert ddp["ddp"] and z1["ddp"]
        assert [m["loss"] for m in z1["metrics"]] == [
            m["loss"] for m in ddp["metrics"]]
        assert [m["grad_norm"] for m in z1["metrics"]] == [
            m["grad_norm"] for m in ddp["metrics"]]
        for k, v in ddp["tensors"].items():
            assert torch.equal(z1["tensors"][k], v), k
        whole = z1["global_slots"]["inner"]["state"]
        names = list(z1["local_slots"])
        for i, k in enumerate(names):
            for slot, t in ddp["local_slots"][k].items():
                assert torch.equal(whole[i][slot], t), (k, slot)
                local = z1["local_slots"][k][slot]
                if t.dim() and dims[k] >= 0:
                    assert local.numel() * 2 == t.numel(), k
        assert any(d >= 0 for d in dims.values())


def test_zero1_lars_takes_whole_leaf_norms(worlds):
    lr = port_config(overrides=CASES["lenet_ddp_lars"]).optimizer.learning_rate
    for r in worlds["a"]:
        ddp, z1 = r["steps"]["lenet_ddp_lars"], r["steps"]["lenet_zero1_lars"]
        np.testing.assert_allclose([m["loss"] for m in z1["metrics"]],
                                   [m["loss"] for m in ddp["metrics"]],
                                   rtol=1e-6)
        for k, v in ddp["tensors"].items():
            np.testing.assert_allclose(z1["tensors"][k], v, rtol=0,
                                       atol=1e-6 * lr, err_msg=k)


# ---------------------------------------------------------- checkpoints

def test_zero_checkpoint_round_trip(worlds):
    for r in worlds["a"]:
        ck = r["ckpt"]
        assert ck["restored"] == 2
        assert ck["params_equal"] and ck["slots_equal"]
        assert ck["residual_equal"] and ck["residual_nonzero"]
        assert ck["next_step_equal"]


def test_zero_toggle_across_resume_is_rejected(worlds):
    for r in worlds["a"]:
        for err in r["ckpt"]["toggle_errors"]:
            assert err is not None and "zero_sharding" in err


def test_zero_opt_state_reshard_4_to_2(worlds):
    """World B's checkpoint (four rows) restored on two ranks: the
    parameters as saved, each slot refolded to (2, ceil(S/2)) and equal
    to the saved values on the true prefix."""
    from distributed_tensorflow_framework_torch.ckpt.reshard import (
        refold_zero_opt_state,
    )

    saved = worlds["b"][0]
    names = saved["names"]
    sizes = {}
    for r in worlds["a"]:
        ck = r["ckpt"]
        assert ck["refold_restored"] == 2
        for k, v in saved["tensors"].items():
            assert torch.equal(ck["refold_tensors"][k], v), k
        new, old = ck["refold_slots"]["inner"]["state"], saved[
            "global_slots"]["inner"]["state"]
        refolded = 0
        for i, k in enumerate(names):
            size = int(np.prod(ck["refold_tensors"][k].shape))
            sizes[k] = size
            for slot, t in old[i].items():
                if not t.dim():
                    assert torch.equal(new[i][slot], t)
                    continue
                assert t.shape == (4, -(-size // 4))
                assert new[i][slot].shape == (2, -(-size // 2))
                assert torch.equal(new[i][slot].reshape(-1)[:size],
                                   t.reshape(-1)[:size])
                refolded += 1
        assert refolded >= 8
    # The function itself, on the stored rows.
    out = refold_zero_opt_state(saved["global_slots"], names, sizes, 2)
    for i, slots in out["inner"]["state"].items():
        for slot, t in slots.items():
            if t.dim():
                assert torch.equal(
                    t, worlds["a"][0]["ckpt"]["refold_slots"]["inner"][
                        "state"][i][slot])


def test_world_b_slots_are_rows_of_four(worlds):
    for r in worlds["b"]:
        for shape in r["local_shapes"].values():
            assert len(shape) == 1
        for slots in r["global_slots"]["inner"]["state"].values():
            for t in slots.values():
                if t.dim():
                    assert t.shape[0] == 4


def test_ladder_rollback_restores_the_shards(worlds):
    for r in worlds["a"]:
        lad = r["ckpt"]["ladder"]
        assert lad["moved"] and lad["step"] == 1
        assert lad["tensors_equal"] and lad["slots_equal"]


# ------------------------------------------------------------ refusals

def _cfg(extra):
    return port_config(overrides=LENET + extra)


def test_zero_on_one_replica_raises():
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    with pytest.raises(ValueError, match="silent no-op"):
        StepBuilder(_cfg(ZERO), device="cpu")


def test_zero_shard_map_rejected_under_jit():
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    with pytest.raises(ValueError, match="shard_map"):
        check_step_config(_cfg(["optimizer.zero_sharding=shard_map",
                                "mesh.data=2"]), 2)


@pytest.mark.parametrize("extra, match", [
    (["optimizer.grad_clip_norm=1.0"], "grad_clip_norm"),
    (["optimizer.name=lars"], "lars")])
def test_zero_rejects_lars_and_grad_clip(extra, match):
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    with pytest.raises(ValueError, match=match):
        check_step_config(_cfg(ZERO + ["mesh.data=2"] + extra), 2)


def test_shard_opt_state_conflict_rejected():
    with pytest.raises(ValueError, match="zero_sharding"):
        _cfg(["optimizer.zero_sharding=shard_map",
              "optimizer.shard_opt_state=true"])


def test_shard_opt_state_maps_to_jit_with_warning(caplog):
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
        zero_mode,
    )

    with caplog.at_level("WARNING"):
        cfg = _cfg(["optimizer.shard_opt_state=true", "mesh.fsdp=2",
                    "mesh.data=1"])
    assert cfg.optimizer.zero_sharding == "jit" == zero_mode(cfg)
    assert any("deprecated" in r.message for r in caplog.records)
    assert check_step_config(cfg, 2)["fsdp"] == 2


@pytest.mark.parametrize("extra, match", [
    (["optimizer.zero_sharding=jit", "mesh.data=2"], "fsdp"),
    (["optimizer.zero_sharding=jit", "mesh.fsdp=2", "mesh.data=1",
      "train.spmd_mode=shard_map"], "jit")])
def test_zero1_refusals(extra, match):
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    with pytest.raises(ValueError, match=match):
        check_step_config(_cfg(extra), 2)


def test_bad_zero_mode_rejected():
    with pytest.raises(ValueError, match="zero_sharding"):
        _cfg(["optimizer.zero_sharding=zero3"])



if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
