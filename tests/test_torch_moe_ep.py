"""Mixture-of-Experts across ranks: the router's global statistics under
data parallelism, expert parallelism (``mesh.expert > 1``;
parallel/expert.py) and the ``shard_map`` step, against the JAX package.

Two worlds of gloo ranks, each rank a child process running this file
with the gang environment of core/cluster.py (torch alone):

  * world A, two ranks: the tiny MoE BERT of tests/test_torch_moe.py (f32,
    4 experts, top-2, capacity 1.25, sorted dispatch, clipping 1.0) at
    ``{data: 2}``, at ``{data: 1, expert: 2}`` (also with the dense
    dispatcher, the z-loss armed and ``moe_aux_weight`` 1.0, and with
    remat), and under ``shard_map`` at ``{data: 2}``; a checkpoint written
    at ``expert: 2`` read by one process and one written by one process
    read at ``expert: 2``; the Trainer's run_meta at ``{data: 1, expert:
    2}``;
  * world B, four ranks: ``{data: 2, expert: 2}`` and ``{data: 1, expert:
    4}`` (one expert a rank).

In this process the JAX StepBuilder runs the same steps on as many CPU
devices: the ``jit`` step on the same mesh (GSPMD's expert parallelism,
whose router statistics are the global batch's), the ``shard_map`` step
at ``{data: 2}`` (each replica routes its own rows), from the port's
initial parameters and on the port's global batches.

Tolerances: losses, the MoE metrics and grad_norm rtol 1e-5; every
parameter after 2 SGD steps rtol 1e-5 (atol 1e-6); the checkpoints and
the ranks' agreement exactly.
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
from tests.test_torch_gang import Gang
from tests.test_torch_hygiene import torch_threads  # noqa: F401
from tests.test_torch_moe import TINY_MOE

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
STEPS = 2
RTOL = 1e-5
DP2 = ["mesh.data=2"]
EP2 = ["mesh.data=1", "mesh.expert=2"]
DE = ["mesh.data=2", "mesh.expert=2"]
EP4 = ["mesh.data=1", "mesh.expert=4"]
SHARD_MAP = ["train.spmd_mode=shard_map"]
HEAVY = ["model.moe_dispatch=dense", "model.moe_zloss_weight=0.1",
         "train.moe_aux_weight=1.0"]
WORLD_A = {
    "dp2": TINY_MOE + DP2,
    "ep2": TINY_MOE + EP2,
    "ep2_heavy": TINY_MOE + HEAVY + EP2,
    "ep2_remat": TINY_MOE + ["model.remat=true"] + EP2,
    "sm_dp2": TINY_MOE + SHARD_MAP + DP2,
}
WORLD_B = {
    "de": TINY_MOE + DE,
    "ep4": TINY_MOE + EP4,
}
# The JAX mesh each case is held to, and the overrides of its model.
JAX_REF = {
    "dp2": ({"data": 2}, TINY_MOE),
    "ep2": ({"data": 1, "expert": 2}, TINY_MOE),
    "ep2_heavy": ({"data": 1, "expert": 2}, TINY_MOE + HEAVY),
    "ep2_remat": ({"data": 1, "expert": 2}, TINY_MOE),
    "sm_dp2": ({"data": 2}, TINY_MOE + SHARD_MAP),
    "de": ({"data": 2, "expert": 2}, TINY_MOE),
    "ep4": ({"data": 1, "expert": 4}, TINY_MOE),
}
METRICS = ("loss", "total_loss", "moe_aux_loss", "moe_drop_frac",
           "grad_norm")


def _builder(overrides, runtime, seed=0):
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    builder = StepBuilder(port_config(overrides=overrides), device="cpu",
                          runtime=runtime)
    return builder, builder.init_state(seed)


# ------------------------------------------------------------ the ranks

def _block(batch, builder):
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    n, r = (1, 0) if builder.data_group is None else (
        builder.data_group.size, builder.data_group.index)
    b = builder.config.data.global_batch_size // n
    return to_device({k: v[r * b:(r + 1) * b] for k, v in batch.items()},
                     torch.device("cpu"))


def _whole(state, tensors=None) -> dict:
    tensors = state.model.state_dict() if tensors is None else tensors
    if state.ep is not None:
        tensors = state.ep.whole(tensors)
    return {k: v.detach().clone() for k, v in tensors.items()}


def _run(overrides, runtime) -> dict:
    from distributed_tensorflow_framework_torch.data import get_dataset

    builder, state = _builder(overrides, runtime)
    ds = get_dataset(builder.config.data)
    at_rest = {k: tuple(p.shape) for k, p in state.model.named_parameters()}
    metrics = []
    for _ in range(STEPS):
        m = builder.global_metrics(builder.train_step(
            state, _block(next(ds), builder)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "tensors": _whole(state),
            "at_rest": at_rest, "ddp": state.ddp is not None,
            "ep": None if state.ep is None else state.ep.sharded,
            "stats": sum(getattr(m, "stats", None) is not None
                         for m in state.model.modules()),
            "eval": {k: float(v) for k, v in builder.eval_step(
                state, _block(next(ds), builder)).items()}}


def _checkpoints(workdir, runtime) -> dict:
    """A checkpoint written at ``expert: 2`` read by one process, and one
    written by one process read at ``expert: 2``; each side then takes
    one more step."""
    import torch.distributed as dist

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.data import get_dataset

    over = TINY_MOE + ["optimizer.ema_decay=0.9"]
    builder, state = _builder(over + EP2, runtime)
    ds = get_dataset(builder.config.data)
    batches = [next(ds) for _ in range(3)]
    for b in batches[:2]:
        builder.train_step(state, _block(b, builder))
    # Restored across expert sizes and into one process: allow_reshard.
    ck = dataclasses.replace(builder.config.checkpoint,
                             directory=f"{workdir}/ck_ep", async_save=False,
                             allow_reshard=True)
    manager = CheckpointManager(ck, runtime=runtime)
    manager.save(2, state)
    manager.close()
    whole = _whole(state)
    ema = _whole(state, state.ema_params)
    out = {}
    builder.train_step(state, _block(batches[2], builder))
    out["ep_next"] = _whole(state)
    dist.barrier()
    if runtime.process_index == 0:
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
        manager = CheckpointManager(dataclasses.replace(
            ck, directory=f"{workdir}/ck_one"), runtime=None)
        manager.save(3, one)
        manager.close()
        out["one_saved"] = _whole(one)
        out["one_saved_ema"] = {k: v.clone() for k, v in
                                one.ema_params.items()}
    dist.barrier()
    _, fresh = _builder(over + EP2, runtime, seed=2)
    manager = CheckpointManager(dataclasses.replace(
        ck, directory=f"{workdir}/ck_one"), runtime=runtime)
    out["into_ep"] = manager.restore(fresh)
    manager.close()
    out["ep_restored"] = _whole(fresh)
    out["ep_restored_ema"] = _whole(fresh, fresh.ema_params)
    out["ep_parts"] = {k: p.detach().clone()
                       for k, p in fresh.model.named_parameters()}
    return out


def _trainer(workdir, runtime) -> dict:
    import json

    from distributed_tensorflow_framework_torch.train import hooks
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    logs = f"{workdir}/trainer_logs"
    cfg = port_config(overrides=TINY_MOE + EP2 + [
        "train.log_interval=1", "train.eval_steps=2"])
    trainer = Trainer(cfg, device="cpu", log_dir=logs, runtime=runtime)
    trainer.build()
    armed = any(isinstance(h, hooks.MoECollapseHook)
                for h in trainer.default_hooks())
    final = trainer.train()
    result = trainer.evaluate()
    trainer.writer.close()
    out = {"final": final, "eval": result, "armed": armed}
    if runtime.is_chief:
        with open(f"{logs}/events.jsonl") as fh:
            events = [json.loads(line) for line in fh]
        out["run_meta"] = next(e for e in events
                               if e["kind"] == "run_meta")["extra"]
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
        out["ckpt"] = _checkpoints(workdir, runtime)
        out["trainer"] = _trainer(workdir, runtime)
    runtime.shutdown()
    torch.save(out, os.path.join(workdir,
                                 f"{world}{runtime.process_index}.pt"))


# ------------------------------------------------------- the test side


def _start(workdir: str, world: str, n: int) -> Gang:
    return Gang([HERE, workdir, world],
                [os.path.join(workdir, f"{world}{rank}.log")
                 for rank in range(n)])


def _collect(workdir: str, world: str, gang: Gang) -> list:
    gang.join(timeout=300)
    return [torch.load(os.path.join(workdir, f"{world}{r}.pt"),
                       weights_only=False) for r in range(len(gang.logs))]


def _port_init():
    from distributed_tensorflow_framework_torch.models.convert import to_flax
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    state = StepBuilder(port_config(overrides=TINY_MOE),
                        device="cpu").init_state(0)
    return to_flax(state.model)


def _jax_steps(sizes, overrides, init):
    """The JAX StepBuilder's step on a mesh of ``sizes`` over the port's
    global batches, from the port's initial parameters: the metrics of
    each step and the parameters after the last."""
    import jax

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
    )
    from distributed_tensorflow_framework_tpu.core.config import (
        MeshConfig,
        load_config,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.train.step import StepBuilder

    n = int(np.prod(list(sizes.values())))
    mesh = create_mesh(MeshConfig(**sizes), devices=jax.devices()[:n])
    builder = StepBuilder(load_config(overrides=overrides), mesh)
    ds = get_dataset(port_config(overrides=overrides).data)
    batches = [next(ds) for _ in range(STEPS)]
    state = builder.init_state(0, to_global(batches[0], mesh))
    state = state.replace(params=jax.tree.map(
        lambda x, ref: jax.device_put(x, ref.sharding), init, state.params))
    step = builder.make_train_step(to_global(batches[0], mesh))
    metrics = []
    for batch in batches:
        state, m = step(state, to_global(batch, mesh))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    specs = flatten_tree(jax.tree.map(
        lambda a: tuple(a.sharding.spec), state.params))
    return metrics, flatten_tree(jax.device_get(state.params)), specs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run while this process computes the JAX references."""
    workdir = str(tmp_path_factory.mktemp("moe_ep"))
    procs = {"a": _start(workdir, "a", 2)}
    init = _port_init()
    refs = {}
    for name, (sizes, over) in JAX_REF.items():
        if name in WORLD_A:
            refs[name] = _jax_steps(sizes, over, init)
    out = {"a": _collect(workdir, "a", procs["a"])}
    procs["b"] = _start(workdir, "b", 4)
    for name, (sizes, over) in JAX_REF.items():
        if name in WORLD_B:
            refs[name] = _jax_steps(sizes, over, init)
    out["b"] = _collect(workdir, "b", procs["b"])
    out["jax"] = refs
    return out


def _model():
    from distributed_tensorflow_framework_torch.models import get_model

    return get_model(port_config(overrides=TINY_MOE).model, device="cpu")


def _flax(tensors):
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        to_flax,
    )

    return flatten_tree(to_flax(_model(), tensors))


@pytest.mark.parametrize("world, case", [
    ("a", "dp2"), ("a", "ep2"), ("a", "ep2_heavy"), ("a", "ep2_remat"),
    ("a", "sm_dp2"), ("b", "de"), ("b", "ep4")])
def test_step_matches_the_jax_step(worlds, world, case):
    """Loss, the MoE metrics and grad_norm at both steps, and every
    parameter after them, against the JAX step on the same mesh; every
    rank the same."""
    want_m, want_p, _ = worlds["jax"][case]
    ranks = worlds[world]
    for r in ranks:
        got = r["steps"][case]
        for i, (g, w) in enumerate(zip(got["metrics"], want_m)):
            for k in METRICS:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL,
                                           err_msg=f"step {i} {k}")
            assert ("moe_zloss" in g) == ("moe_zloss" in w)
        ours = _flax(got["tensors"])
        assert set(ours) == set(want_p)
        for path, w in want_p.items():
            np.testing.assert_allclose(ours[path], w, rtol=RTOL, atol=1e-6,
                                       err_msg=str(path))
        assert got["metrics"] == ranks[0]["steps"][case]["metrics"]
        for k, v in got["tensors"].items():
            assert torch.equal(v, ranks[0]["steps"][case]["tensors"][k]), k


@pytest.mark.parametrize("world, case, n", [
    ("a", "ep2", 2), ("a", "ep2_heavy", 2), ("a", "ep2_remat", 2),
    ("b", "de", 2), ("b", "ep4", 4)])
def test_each_rank_holds_its_experts(worlds, world, case, n):
    """Each rank holds E/n of every MoE layer's experts, the layout JAX
    gives ``wi``/``wo`` (E over ``expert``); DDP runs over the
    data-parallel ranks, the router statistics are summed over them."""
    _, _, specs = worlds["jax"][case]
    assert specs[("layer1", "moe", "wi")][0] == "expert"
    assert specs[("layer1", "moe", "wo")][0] == "expert"
    for r in worlds[world]:
        got = r["steps"][case]
        assert got["ep"] == 2 and got["ddp"] and got["stats"] == 1
        assert got["at_rest"]["layer1.moe.wi"] == (4 // n, 32, 64)
        assert got["at_rest"]["layer1.moe.wo"] == (4 // n, 64, 32)
        assert got["at_rest"]["layer1.moe.gate.weight"] == (4, 32)
        assert np.isfinite(got["eval"]["loss_sum"])


def test_data_parallel_and_shard_map_keep_experts_whole(worlds):
    for r in worlds["a"]:
        dp, sm = r["steps"]["dp2"], r["steps"]["sm_dp2"]
        assert dp["ep"] is None and dp["ddp"] and dp["stats"] == 1
        assert sm["ep"] is None and not sm["ddp"] and sm["stats"] == 0
        assert dp["at_rest"]["layer1.moe.wi"] == (4, 32, 64)
    # Under shard_map each replica routes its own rows: another loss than
    # the jit step's global routing.
    jit, sm = (worlds["a"][0]["steps"][c]["metrics"][0]["moe_aux_loss"]
               for c in ("dp2", "sm_dp2"))
    assert jit != sm


def test_checkpoint_round_trips_across_expert_sizes(worlds):
    a0, a1 = worlds["a"]
    ck = a0["ckpt"]
    assert ck["into_one"] == 2 and ck["one_equal"] and ck["one_ema_equal"]
    for k, v in ck["one_next"].items():
        np.testing.assert_allclose(ck["ep_next"][k], v, rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    for i, r in enumerate((a0, a1)):
        c = r["ckpt"]
        assert c["into_ep"] == 3
        for k, v in a0["ckpt"]["one_saved"].items():
            assert torch.equal(c["ep_restored"][k], v), k
            part = v if ".moe.w" not in k else v.chunk(2)[i]
            assert torch.equal(c["ep_parts"][k], part), k
        for k, v in a0["ckpt"]["one_saved_ema"].items():
            assert torch.equal(c["ep_restored_ema"][k], v), k


def test_trainer_names_the_expert_split(worlds):
    a0, a1 = worlds["a"]
    t = a0["trainer"]
    assert t["armed"] and a1["trainer"]["armed"]
    assert t["run_meta"]["expert_parallel"] == 2
    assert t["run_meta"]["ep_sharded_leaves"] == 2
    assert t["run_meta"]["ddp"] is True
    for key in ("loss", "moe_aux_loss", "moe_drop_frac", "grad_norm"):
        assert t["final"][key] == a1["trainer"]["final"][key]
        assert np.isfinite(t["final"][key])
    assert t["eval"] == a1["trainer"]["eval"]
    assert t["eval"]["eval_examples"] > 0


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
