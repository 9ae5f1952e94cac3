"""The fused ZeRO update (``precision.fused_update``, parallel/zero.py
``ZeroUpdate.fused_walk_``, train/optimizers.py ``BucketOptimizers``) and
the precision and remat levers across ranks, against the port's own
unfused and unchecked steps and against the JAX package.

Mirrors ``tests/test_precision.py``'s fused-update contract. One gloo
world of two ranks, each rank a child process running this file with the
gang environment of core/cluster.py (torch alone), runs every case:

  * LeNet-5 and a tiny BERT under ZeRO ``shard_map``, unfused and fused,
    on the f32 wire, and LeNet on the int8 error-feedback wire: three
    steps each, the first under a tally;
  * LeNet with ``activation_dtype: bf16`` and ``matmul_dtype: int8``,
    replicated under ``shard_map`` and under ZeRO;
  * a small ResNet (CIFAR stem, stages (1, 1), width 8) under DDP at
    ``mesh.data=2`` (BatchNorm over both ranks' batches), with and
    without ``model.remat`` (conv_saved, and ``precision.remat_policy``
    dots_saveable): the cross-rank BatchNorm replays its all-reduce in
    the recompute;
  * a tiny BERT at ``{data: 1, pipe: 2}`` under gpipe, 1f1b and
    interleaved, with and without ``precision.remat_policy`` (dropout
    0.1, so each stage's recompute replays its masks);
  * a fused checkpoint's round trip on the int8 wire and the resumes that
    toggle ``precision.fused_update`` either way.

In this process the JAX package runs its fused ZeRO step on a ``data=2``
mesh over two of conftest's CPU devices from the port's initial
parameters.

Tolerances. Exact: the fused step against the unfused one (losses,
parameters, slots, residual, tally) on both wires — the same collectives
on the same buckets and the same elementwise rules; the precision levers
replicated against ZeRO; remat against none on every rank, BatchNorm
statistics included; the pipeline with a policy against without; the
round trip. ``grad_norm``: the fused walk sums the shards' squares, the
unfused step squares their norms: rtol 1e-6. Against the JAX fused step:
those of tests/test_torch_zero.py's ZeRO comparison (the parameters
within lr × (1e-5 + 3 × step × the largest grad_norm), the step 0 on the
f32 wire and one int8 quantum on the scatter and one on the gather).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from tests.test_torch_hygiene import torch_threads  # noqa: F401
from tests.test_torch_zero import LENET, STEPS, TINY_BERT, ZERO, _free_port

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
FUSED = ["precision.fused_update=true"]
INT8 = ["parallel.collective_dtype=int8"]
PRECISION = ["precision.activation_dtype=bf16", "precision.matmul_dtype=int8"]
SMALL_RESNET = [
    "model.name=resnet18_cifar", "model.dtype=float32",
    "data.name=synthetic_images", "data.image_size=16", "data.channels=3",
    "data.seed=3", "data.global_batch_size=8", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.1", "optimizer.momentum=0.9",
    "optimizer.weight_decay=0.001", "optimizer.warmup_steps=0",
    "optimizer.grad_clip_norm=0.0", f"train.total_steps={STEPS}",
    "checkpoint.directory=", "resilience.rollback=false", "mesh.data=2"]
PIPE_BERT = [
    "model.name=bert", "model.vocab_size=64", "model.hidden_size=32",
    "model.num_layers=4", "model.num_heads=2", "model.mlp_dim=64",
    "model.max_seq_len=16", "model.dtype=float32",
    "model.attention_impl=xla", "model.dropout_rate=0.1",
    "data.name=synthetic_mlm", "data.vocab_size=64", "data.seq_len=16",
    "data.global_batch_size=8", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=0",
    "optimizer.grad_clip_norm=1.0", "train.total_steps=2",
    "checkpoint.directory=", "resilience.rollback=false", "mesh.data=1",
    "mesh.pipe=2", "model.pipeline_stages=2",
    "model.pipeline_microbatches=4"]
SCHEDULES = {"gpipe": ["model.pipeline_schedule=gpipe"],
             "1f1b": ["model.pipeline_schedule=1f1b"],
             "interleaved": ["model.pipeline_schedule=interleaved",
                             "model.pipeline_virtual_stages=2"]}
# name → overrides of the step cases.
CASES = {
    "lenet_zero_f32": LENET + ZERO,
    "lenet_fused_f32": LENET + ZERO + FUSED,
    "lenet_zero_int8": LENET + ZERO + INT8,
    "lenet_fused_int8": LENET + ZERO + INT8 + FUSED,
    "bert_zero_f32": TINY_BERT + ZERO,
    "bert_fused_f32": TINY_BERT + ZERO + FUSED,
    "lenet_prec_rep": LENET + ["train.spmd_mode=shard_map"] + PRECISION,
    "lenet_prec_zero": LENET + ZERO + PRECISION,
    "resnet_ddp": SMALL_RESNET,
    "resnet_ddp_conv_saved": SMALL_RESNET + [
        "model.remat=true", "model.remat_policy=conv_saved"],
    "resnet_ddp_dots": SMALL_RESNET + [
        "model.remat=true", "precision.remat_policy=dots_saveable"],
    **{f"pipe_{s}": PIPE_BERT + o for s, o in SCHEDULES.items()},
    **{f"pipe_{s}_dots": PIPE_BERT + o + [
        "precision.remat_policy=dots_saveable"]
        for s, o in SCHEDULES.items()},
    "pipe_1f1b_save_nothing": PIPE_BERT + SCHEDULES["1f1b"] + [
        "precision.remat_policy=save_nothing"],
}
# Each case with a lever against the one without it.
PAIRS = {
    "lenet_fused_f32": "lenet_zero_f32",
    "lenet_fused_int8": "lenet_zero_int8",
    "bert_fused_f32": "bert_zero_f32",
    "lenet_prec_zero": "lenet_prec_rep",
    "resnet_ddp_conv_saved": "resnet_ddp",
    "resnet_ddp_dots": "resnet_ddp",
    **{f"pipe_{s}_dots": f"pipe_{s}" for s in SCHEDULES},
    "pipe_1f1b_save_nothing": "pipe_1f1b",
}


def _small_resnet(config, *, device, generator=None, in_channels=None,
                  precision=None):
    """``resnet18_cifar`` cut to stages (1, 1) at width 8, with the
    config's remat and the precision's policy."""
    from distributed_tensorflow_framework_torch.models import _ckpt_policy
    from distributed_tensorflow_framework_torch.models.resnet import ResNet

    model = ResNet((1, 1), 10, width=8, cifar_stem=True,
                   remat=config.remat, remat_policy=config.remat_policy,
                   ckpt_policy=_ckpt_policy(precision),
                   dtype=torch.float32, device=device)
    model.init_weights(generator)
    return model.eval()


def _slots(state) -> dict:
    """The optimizer's per-parameter slots, {name: {slot: tensor}},
    whether one optimizer holds them or one per ZeRO bucket."""
    sd = state.optimizer.state_dict()
    parts = sd["buckets"] if "buckets" in sd else [sd]
    names = (state.optimizer.names if "buckets" in sd
             else [state.optimizer.names])
    return {part_names[i]: {k: v.clone() for k, v in s.items()}
            for part, part_names in zip(parts, names)
            for i, s in part["inner"]["state"].items()}


def _run_case(overrides, runtime, steps=STEPS, seed=0):
    """``steps`` steps on this rank's block of the global batches (each
    data-parallel rank its block, the pipe line the same one)."""
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train import step as port_step

    config = port_config(overrides=overrides)
    saved = port_step.get_model
    if config.model.name.startswith("resnet"):
        port_step.get_model = _small_resnet
    try:
        builder = port_step.StepBuilder(config, device="cpu",
                                        runtime=runtime)
        state = builder.init_state(seed)
    finally:
        port_step.get_model = saved
    ds = get_dataset(config.data)
    n, r = builder.dp_world, (builder.data_group.index
                              if builder.dp_world > 1 else 0)
    metrics, tally = [], None
    for _ in range(steps):
        batch = next(ds)
        b = config.data.global_batch_size // n
        block = {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
        with coll.tally() as t:
            m = builder.global_metrics(builder.train_step(
                state, to_device(block, torch.device("cpu"))))
        tally = tally or t.summary()
        metrics.append({k: float(v) for k, v in m.items()})
    return builder, state, metrics, tally, ds


def _tensors(state) -> dict:
    return {k: v.detach().clone() for k, v in
            state.model.state_dict().items()}


def _checkpoints(workdir: str, runtime) -> dict:
    """The fused round trip on the int8 wire and the toggles."""
    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    over = CASES["lenet_fused_int8"]
    builder, state, _, _, ds = _run_case(over, runtime, steps=2)
    ck = dataclasses.replace(builder.config.checkpoint,
                             directory=f"{workdir}/ck_fused",
                             async_save=False)
    manager = CheckpointManager(ck, runtime=runtime)
    manager.save(2, state)
    fresh_builder, fresh, _, _, _ = _run_case(over, runtime, steps=0, seed=9)
    restored = manager.restore(fresh)
    manager.close()
    want_slots, got_slots = _slots(state), _slots(fresh)
    out = {"restored": restored,
           "buckets": len(state.optimizer.opts),
           "plan_buckets": state.layout.plan.num_buckets,
           "params_equal": all(torch.equal(a, b) for a, b in zip(
               _tensors(state).values(), _tensors(fresh).values())),
           "slots_equal": want_slots.keys() == got_slots.keys() and all(
               torch.equal(x, got_slots[k][s])
               for k, slots in want_slots.items()
               for s, x in slots.items()),
           "residual_equal": all(torch.equal(
               state.collective_residual[k], fresh.collective_residual[k])
               for k in state.collective_residual)}
    batch = next(ds)
    b = 8 // runtime.process_count
    block = {k: v[runtime.process_index * b:(runtime.process_index + 1) * b]
             for k, v in batch.items()}
    a = builder.train_step(state, to_device(block, torch.device("cpu")))
    c = fresh_builder.train_step(fresh, to_device(block,
                                                  torch.device("cpu")))
    out["next_step_equal"] = (float(a["loss"]) == float(c["loss"]) and all(
        torch.equal(x, y) for x, y in zip(_tensors(state).values(),
                                          _tensors(fresh).values())))
    # The toggles: the fused checkpoint into an unfused ZeRO run, and an
    # unfused one into a fused run.
    _, unfused, _, _, _ = _run_case(CASES["lenet_zero_int8"], runtime, 1)
    m = CheckpointManager(dataclasses.replace(
        ck, directory=f"{workdir}/ck_unfused"), runtime=runtime)
    m.save(1, unfused)
    m.close()
    errors = {}
    for name, path, case in (
            ("fused_into_unfused", "ck_fused", "lenet_zero_int8"),
            ("unfused_into_fused", "ck_unfused", "lenet_fused_int8")):
        _, target, _, _, _ = _run_case(CASES[case], runtime, steps=0)
        m = CheckpointManager(dataclasses.replace(
            ck, directory=f"{workdir}/{path}"), runtime=runtime)
        try:
            m.restore(target)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
        finally:
            m.close()
    out["toggle_errors"] = errors
    return out


def _world(workdir: str, runtime) -> dict:
    out = {"steps": {}}
    for name, over in CASES.items():
        _, state, metrics, tally, _ = _run_case(over, runtime)
        buffers = {k: v.clone() for k, v in state.model.named_buffers()}
        out["steps"][name] = {
            "metrics": metrics, "tally": tally, "tensors": _tensors(state),
            "buffers": buffers, "slots": _slots(state),
            "residual": dict(state.collective_residual),
            "param_dtypes": {str(p.dtype)
                             for p in state.model.parameters()}}
    out["ckpt"] = _checkpoints(workdir, runtime)
    return out


def _rank_main(workdir: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    runtime = initialize_runtime(MeshConfig(data=-1), "cpu")
    out = _world(workdir, runtime)
    runtime.shutdown()
    torch.save(out, os.path.join(workdir, f"f{runtime.process_index}.pt"))


# ------------------------------------------------------- the test side

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("fused"))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(rank),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
        log = open(os.path.join(workdir, f"f{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, HERE, workdir], env=env, stdout=log,
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
    return [torch.load(os.path.join(workdir, f"f{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_lever_equals_the_step_without_it_bit_for_bit(world, case):
    """Every rank's losses, parameters and buffers (BatchNorm statistics)
    under the lever equal those without it."""
    base = PAIRS[case]
    for r in world:
        got, want = r["steps"][case], r["steps"][base]
        assert [m["loss"] for m in got["metrics"]] == [
            m["loss"] for m in want["metrics"]]
        for k, v in want["tensors"].items():
            assert torch.equal(got["tensors"][k], v), (case, k)
        for k, v in want["buffers"].items():
            assert torch.equal(got["buffers"][k], v), (case, k)
        np.testing.assert_allclose(
            [m["grad_norm"] for m in got["metrics"]],
            [m["grad_norm"] for m in want["metrics"]], rtol=1e-6)
        assert got["param_dtypes"] == {"torch.float32"}


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_fused_slots_residual_and_tally_equal_the_unfused(world, wire):
    """The fused update's slots (grouped per bucket) are the unfused
    ones, cell for cell; so are the int8 residual and the collectives'
    tally: one reduce-scatter and one all-gather a bucket."""
    for r in world:
        got = r["steps"][f"lenet_fused_{wire}"]
        want = r["steps"][f"lenet_zero_{wire}"]
        assert got["slots"].keys() == want["slots"].keys()
        for k, slots in want["slots"].items():
            for s, t in slots.items():
                assert torch.equal(got["slots"][k][s], t), (k, s)
        assert got["residual"].keys() == want["residual"].keys()
        for k, t in want["residual"].items():
            assert torch.equal(got["residual"][k], t), k
        assert got["tally"] == want["tally"]
        assert (bool(got["residual"]) == (wire == "int8"))


def test_ranks_agree(world):
    a, b = world
    for case in CASES:
        assert [m["loss"] for m in a["steps"][case]["metrics"]] == [
            m["loss"] for m in b["steps"][case]["metrics"]], case


def test_fused_checkpoint_round_trip(world):
    for r in world:
        ck = r["ckpt"]
        assert ck["restored"] == 2
        assert ck["buckets"] == ck["plan_buckets"] > 1
        assert ck["params_equal"] and ck["slots_equal"]
        assert ck["residual_equal"] and ck["next_step_equal"]


@pytest.mark.parametrize("toggle", ["fused_into_unfused",
                                    "unfused_into_fused"])
def test_fused_toggle_across_resume_is_refused(world, toggle):
    """JAX ckpt/checkpoint.py: the per-bucket slots do not restore into
    an unfused ZeRO state, nor the reverse, though the bytes are the
    same."""
    for r in world:
        msg = r["ckpt"]["toggle_errors"][toggle]
        assert msg is not None and "precision.fused_update" in msg


def _jax_fused_steps(overrides, port_init):
    """The JAX StepBuilder's fused ZeRO step on a data=2 mesh over the
    port's global batches, from the port's initial parameters."""
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
    from tests.test_torch_zero import _model

    config = port_config(overrides=overrides)
    mesh = create_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    builder = StepBuilder(load_config(overrides=overrides + ["mesh.data=2"]),
                          mesh)
    assert builder._fused
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
    return metrics, flatten_tree(jax.device_get(state.params))


# The wire's rounding step relative to grad_norm (tests/test_torch_zero.py).
WIRE_STEP = {"f32": 0.0, "int8": 2.0 / 127}


@pytest.mark.parametrize("wire", sorted(WIRE_STEP))
def test_fused_step_matches_the_jax_fused_step(world, wire):
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        to_flax,
    )
    from distributed_tensorflow_framework_torch.train.step import StepBuilder
    from tests.test_torch_zero import _model

    name = f"lenet_fused_{wire}"
    over = CASES[name]
    plain = [o for o in over if not o.startswith(
        ("optimizer.zero_sharding", "train.spmd_mode",
         "parallel.collective_dtype", "precision.fused_update"))]
    init = StepBuilder(port_config(overrides=plain),
                       device="cpu").init_state(0).model.state_dict()
    ref, params = _jax_fused_steps(over, init)
    lr = port_config(overrides=over).optimizer.learning_rate
    top = max(m["grad_norm"] for m in ref)
    step = WIRE_STEP[wire]
    atol = lr * (1e-5 + 3 * step * top)
    for r in world:
        got = r["steps"][name]
        for i, (g, w) in enumerate(zip(got["metrics"], ref)):
            np.testing.assert_allclose(
                g["loss"], w["loss"], rtol=1e-5,
                atol=1e-7 + (top * atol if i else 0.0), err_msg=f"step {i}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-4, atol=2 * step * top)
        model = _model(over)
        model.load_state_dict(got["tensors"])
        ours = flatten_tree(to_flax(model))
        for path, want in params.items():
            np.testing.assert_allclose(ours[path], want, rtol=0, atol=atol,
                                       err_msg=str(path))


# ---------------------------------------------------- one process alone

def test_bucket_optimizers_equal_the_whole_tree_optimizer():
    """One optimizer per bucket over the buckets' shards (each with its
    subset of the decay mask) steps every cell as the whole-tree
    optimizer over the same shards does."""
    from distributed_tensorflow_framework_torch.models.lenet import LeNet5
    from distributed_tensorflow_framework_torch.parallel import zero
    from distributed_tensorflow_framework_torch.models.convert import (
        flax_layout,
    )
    from distributed_tensorflow_framework_torch.train.optimizers import (
        BucketOptimizers,
        make_optimizer,
    )

    model = LeNet5(10)
    model.init_weights(torch.Generator().manual_seed(0))
    plan = zero.build_plan(flax_layout(model), 2, 0.05)
    assert plan.num_buckets > 1
    cfg = port_config(overrides=["optimizer.name=adamw",
                                 "optimizer.weight_decay=0.01",
                                 "optimizer.warmup_steps=0"]).optimizer
    gen = torch.Generator().manual_seed(1)
    named = dict(model.named_parameters())
    whole = {lc.name: zero.local_shard(named[lc.name].detach(), lc.chunk, 2,
                                       1).clone() for lc in plan.leaf_chunks}
    parts = {k: v.clone() for k, v in whole.items()}
    opt, schedule = make_optimizer(cfg, 10, model, params=whole)
    bucketed = BucketOptimizers(cfg, schedule, model, [
        {lc.name: parts[lc.name] for lc in bucket} for bucket in plan.buckets])
    for _ in range(3):
        for k in whole:
            g = torch.randn(whole[k].shape, generator=gen)
            whole[k].grad, parts[k].grad = g, g.clone()
        opt.step(None)
        for o in bucketed.opts:
            o.step(None)
    for k in whole:
        assert torch.equal(whole[k], parts[k]), k
    assert len(bucketed.state_dict()["buckets"]) == plan.num_buckets
    assert bucketed.count == opt.count == 3


def test_fused_update_requires_zero_shard_map():
    """The JAX StepBuilder's refusal, also for a config built without
    load_config's check."""
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    with pytest.raises(ValueError, match="fused_update"):
        port_config(overrides=LENET + ["train.spmd_mode=shard_map",
                                       "mesh.data=2"] + FUSED)
    cfg = port_config(overrides=LENET + ["train.spmd_mode=shard_map",
                                         "mesh.data=2"])
    cfg.precision.fused_update = True
    with pytest.raises(ValueError, match="fused_update"):
        check_step_config(cfg, 2)
    check_step_config(port_config(overrides=LENET + ZERO + FUSED
                                  + ["mesh.data=2"]), 2)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
