"""Mixture-of-Experts on the composed meshes: experts beside ``fsdp``,
``model`` and ``seq``, and MoE beside tensor parallelism and the ring,
against the JAX package's ``jit`` step.

Three worlds of gloo ranks, each rank a child process running this file
with the gang environment of core/cluster.py (torch alone), train the
tiny MoE BERT of tests/test_torch_moe.py (f32, 4 experts every second
layer, top-2, capacity 1.25, sorted dispatch, SGD with momentum and
clipping 1.0) for two steps:

  * world A, four ranks: ``{expert: 2, fsdp: 2}``; ``{expert: 2, seq: 2}``
    with ring attention; the same at capacity 0.5 with the dense
    dispatcher, which drops tokens (about half of the assignments);
    ``{data: 2, model: 2}``;
  * world M, two ranks: ``{model: 2}``;
  * world B, eight ranks: ``{data: 2, expert: 2, model: 2}`` (the mesh of
    the JAX package's ``tests/test_moe.py::test_moe_bert_trains_dp_ep_tp``),
    ``{expert: 2, fsdp: 2, model: 2}`` and ``{expert: 2, model: 2, seq:
    2}`` with ring attention; and at ``{expert: 2, fsdp: 2, model: 2}``
    the checkpoint round trips: written at the mesh and read by one
    process, written by one process and read at the mesh (both under
    ``checkpoint.allow_reshard``; refused with MeshTopologyError without
    it), and the composed checkpoint exported and served.

In this process the JAX StepBuilder runs the same steps on a mesh of the
same sizes over as many CPU devices, from the port's initial parameters
and on the port's global batches.

Tolerances: losses, the MoE metrics and grad_norm rtol 1e-5; every
parameter after 2 steps rtol 1e-5 (atol 1e-6); each rank's parts are the
blocks of the whole tensors that JAX's partition specs give its
coordinates, exactly; the ranks' agreement, the checkpoints and the
restored parts exactly; the served logits within the serving test's
1e-5.
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
from tests.test_torch_moe_ep import _jax_steps

HERE = os.path.abspath(__file__)
RTOL = 1e-5
METRICS = ("loss", "total_loss", "moe_aux_loss", "moe_drop_frac",
           "grad_norm")
RING = ["model.attention_impl=ring"]
TIGHT = ["model.capacity_factor=0.5", "model.moe_dispatch=dense"]
# name → (the mesh, the overrides of the model beside it).
CASES = {
    "ef": ({"data": 1, "expert": 2, "fsdp": 2}, []),
    "es": ({"data": 1, "expert": 2, "seq": 2}, RING),
    "es_tight": ({"data": 1, "expert": 2, "seq": 2}, RING + TIGHT),
    "dm": ({"data": 2, "model": 2}, []),
    "m2": ({"data": 1, "model": 2}, []),
    "dem": ({"data": 2, "expert": 2, "model": 2}, []),
    "efm": ({"data": 1, "expert": 2, "fsdp": 2, "model": 2}, []),
    "ems": ({"data": 1, "expert": 2, "model": 2, "seq": 2}, RING),
}
WORLDS = {"a": (4, ["ef", "es", "es_tight", "dm"]), "m": (2, ["m2"]),
          "b": (8, ["dem", "efm", "ems"])}


def overrides(name: str, base=TINY_MOE) -> list[str]:
    sizes, extra = CASES[name]
    return base + extra + [f"mesh.{a}={v}" for a, v in sizes.items()]


# ------------------------------------------------------------ the ranks

def builder_for(over, runtime, seed=0):
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    builder = StepBuilder(port_config(overrides=over), device="cpu",
                          runtime=runtime)
    return builder, builder.init_state(seed)


def block(batch, builder):
    """This rank's block of a global batch: its data-parallel index's
    rows (the ranks along ``seq`` and ``model`` take the same ones)."""
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    n, r = (1, 0) if builder.data_group is None else (
        builder.data_group.size, builder.data_group.index)
    b = builder.config.data.global_batch_size // n
    return to_device({k: v[r * b:(r + 1) * b] for k, v in batch.items()},
                     torch.device("cpu"))


def whole(state, tensors=None) -> dict:
    """``tensors`` (default the model's) gathered whole: the inverse of
    the cuts (tensor, expert, FSDP), the last first."""
    from distributed_tensorflow_framework_torch.parallel.sharding import (
        DimSharding,
    )

    tensors = dict(state.model.state_dict() if tensors is None else tensors)
    fsdp = state.layout if (isinstance(state.layout, DimSharding)
                            and state.layout.at_rest) else None
    for layout in (fsdp, state.ep, state.tp):
        if layout is not None:
            tensors = layout.whole(tensors)
    return {k: v.detach().clone() for k, v in tensors.items()}


def parts(state) -> dict:
    """What this rank holds of each parameter at rest: the tensors the
    optimizer updates."""
    from distributed_tensorflow_framework_torch.parallel.sharding import (
        DimSharding,
    )

    held = (state.layout.params if isinstance(state.layout, DimSharding)
            else dict(state.model.named_parameters()))
    return {k: t.detach().clone() for k, t in held.items()}


def run(over, runtime, steps=2) -> dict:
    from distributed_tensorflow_framework_torch.core import mesh as mesh_lib
    from distributed_tensorflow_framework_torch.data import get_dataset

    builder, state = builder_for(over, runtime)
    rt = builder.runtime
    ds = get_dataset(builder.config.data)
    metrics = []
    for _ in range(steps):
        m = builder.global_metrics(builder.train_step(
            state, block(next(ds), builder)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "tensors": whole(state),
            "parts": parts(state),
            "coords": mesh_lib._coords(rt.sizes, rt.process_index),
            "eval": {k: float(v) for k, v in builder.eval_step(
                state, block(next(ds), builder)).items()}}


def checkpoints(workdir, runtime, over, name) -> dict:
    """A checkpoint written at the mesh of ``over`` read by one process,
    and one written by one process read at the mesh (allow_reshard), the
    same restore refused without it; each side then takes one more step.
    Rank 0 exports the mesh's checkpoint and serves it."""
    import torch.distributed as dist

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.ckpt.reshard import (
        MeshTopologyError,
    )
    from distributed_tensorflow_framework_torch.data import get_dataset

    over = over + ["optimizer.ema_decay=0.9"]
    # One process: no mesh, so no ZeRO-1 either.
    one_over = [o for o in over if not o.startswith(
        ("mesh.", "optimizer.zero_sharding"))]
    builder, state = builder_for(over, runtime)
    ds = get_dataset(builder.config.data)
    batches = [next(ds) for _ in range(3)]
    for b in batches[:2]:
        builder.train_step(state, block(b, builder))
    ck = dataclasses.replace(builder.config.checkpoint,
                             directory=f"{workdir}/ck_{name}",
                             async_save=False, allow_reshard=True)
    manager = CheckpointManager(ck, runtime=runtime)
    manager.save(2, state)
    manager.close()
    saved, saved_ema = whole(state), whole(state, state.ema_params)
    builder.train_step(state, block(batches[2], builder))
    out = {"mesh_next": whole(state)}
    dist.barrier()
    if runtime.process_index == 0:
        one_builder, one = builder_for(one_over, None, seed=1)
        manager = CheckpointManager(dataclasses.replace(ck), runtime=None)
        out["into_one"] = manager.restore(one)
        manager.close()
        out["one_equal"] = all(torch.equal(one.model.state_dict()[k], v)
                               for k, v in saved.items())
        out["one_ema_equal"] = all(torch.equal(one.ema_params[k], v)
                                   for k, v in saved_ema.items())
        one_builder.train_step(one, block(batches[2], one_builder))
        out["one_next"] = whole(one)
        manager = CheckpointManager(dataclasses.replace(
            ck, directory=f"{workdir}/ck_{name}_one"), runtime=None)
        manager.save(3, one)
        manager.close()
        out["one_saved"] = whole(one)
        out["one_saved_ema"] = {k: v.clone()
                                for k, v in one.ema_params.items()}
        out["served"] = serve(workdir, one_over, saved, name)
    dist.barrier()
    _, fresh = builder_for(over, runtime, seed=2)
    one_dir = dataclasses.replace(ck, directory=f"{workdir}/ck_{name}_one")
    manager = CheckpointManager(dataclasses.replace(
        one_dir, allow_reshard=False), runtime=runtime)
    try:
        manager.restore(fresh)
        out["refused"] = None
    except MeshTopologyError as e:
        out["refused"] = str(e)
    manager.close()
    manager = CheckpointManager(one_dir, runtime=runtime)
    out["into_mesh"] = manager.restore(fresh)
    manager.close()
    out["mesh_restored"] = whole(fresh)
    out["mesh_restored_ema"] = whole(fresh, fresh.ema_params)
    out["mesh_parts"] = parts(fresh)
    return out


def serve(workdir, over, tensors, name) -> dict:
    """The mesh's checkpoint exported (``serve.allow_reshard``) and
    served: the engine's logits beside one process's model (of the
    one-process overrides ``over``) on the saved tensors."""
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.serve import engine as pe
    from distributed_tensorflow_framework_torch.serve import export as px

    cfg = port_config(overrides=over + [
        f"checkpoint.directory={workdir}/ck_{name}",
        "serve.allow_reshard=true", "serve.use_ema=false"])
    art = px.load_artifact(px.export_checkpoint(
        cfg, f"{workdir}/art_{name}", device="cpu"))
    eng = pe.InferenceEngine(art, cfg.serve, device="cpu")
    s = cfg.data.seq_len
    ids = np.random.default_rng(1).integers(
        0, cfg.model.vocab_size, (2, s)).astype(np.int32)
    try:
        got = eng.predict({"input_ids": ids}, timeout=60)
    finally:
        eng.drain(30)
    model = get_model(cfg.model, device="cpu")
    model.load_state_dict(tensors)
    model.eval()
    with torch.inference_mode():
        want = model(torch.from_numpy(ids).long(),
                     torch.ones(2, s, dtype=torch.long))
    if isinstance(want, dict):
        want = want["logits"]
    return {"step": art.step, "got": got, "want": want.numpy()}


def _rank_main(workdir: str, world: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    runtime = initialize_runtime(MeshConfig(data=-1), "cpu")
    out = {"steps": {n: run(overrides(n), runtime)
                     for n in WORLDS[world][1]}}
    if world == "b":
        out["ckpt"] = checkpoints(workdir, runtime, overrides("efm"), "efm")
    runtime.shutdown()
    torch.save(out, os.path.join(workdir,
                                 f"{world}{runtime.process_index}.pt"))


# ------------------------------------------------------- the test side


def port_init(over=TINY_MOE):
    """The port's initial parameters (seed 0) as a Flax tree."""
    from distributed_tensorflow_framework_torch.models.convert import to_flax

    _, state = builder_for(over, None)
    return to_flax(state.model)


def start(here, workdir: str, world: str, n: int) -> Gang:
    return Gang([here, workdir, world],
                [os.path.join(workdir, f"{world}{rank}.log")
                 for rank in range(n)])


def collect(workdir: str, world: str, gang: Gang) -> list:
    gang.join(timeout=600)
    return [torch.load(os.path.join(workdir, f"{world}{r}.pt"),
                       weights_only=False) for r in range(len(gang.logs))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds run while this process computes the JAX references."""
    workdir = str(tmp_path_factory.mktemp("compose_moe"))
    gangs = {w: start(HERE, workdir, w, WORLDS[w][0]) for w in ("a", "m")}
    init = port_init()
    refs = {}
    for w in ("a", "m", "b"):
        for name in WORLDS[w][1]:
            refs[name] = _jax_steps(CASES[name][0], overrides(name), init)
    out = {w: collect(workdir, w, g) for w, g in gangs.items()}
    out["b"] = collect(workdir, "b", start(HERE, workdir, "b", 8))
    out["jax"] = refs
    return out


def model_for(over):
    from distributed_tensorflow_framework_torch.models import get_model

    return get_model(port_config(overrides=over).model, device="cpu")


def flax_of(tensors, over=TINY_MOE):
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        to_flax,
    )

    return flatten_tree(to_flax(model_for(over), tensors))


def check_steps(ranks, want, *, metrics=METRICS, over=TINY_MOE):
    """Every rank's metrics and whole parameters against the JAX step's,
    and against rank 0's exactly."""
    want_m, want_p, _ = want
    for r in ranks:
        for i, (g, w) in enumerate(zip(r["metrics"], want_m)):
            for k in metrics:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL,
                                           err_msg=f"step {i} {k}")
        ours = flax_of(r["tensors"], over)
        assert set(ours) == set(want_p)
        for path, w in want_p.items():
            np.testing.assert_allclose(ours[path], w, rtol=RTOL, atol=1e-6,
                                       err_msg=str(path))
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in r["tensors"].items():
            assert torch.equal(v, ranks[0]["tensors"][k]), k


def check_parts(ranks, specs, over=TINY_MOE) -> int:
    """Each rank's parts against the blocks of the whole tensors at its
    coordinates under the JAX partition specs; returns how many leaves
    are split."""
    from distributed_tensorflow_framework_torch.models import convert

    layout = convert.flax_layout(model_for(over))
    split = set()
    for r in ranks:
        flat = flax_of(r["tensors"], over)
        for key, part in r["parts"].items():
            path, _ = layout[key]
            block = flat[path]
            for dim, axis in enumerate(specs[path]):
                if axis is None:
                    continue
                for a in (axis,) if isinstance(axis, str) else axis:
                    split.add(key)
                    block = convert.leaf_part(block, dim, _size(ranks, a),
                                              r["coords"][a])
            want = next(iter(convert.flax_to_state_dict(
                convert.unflatten_tree({path: block})).values()))
            assert tuple(part.shape) == tuple(want.shape), key
            assert torch.equal(part, want), key
    return len(split)


def _size(ranks, axis) -> int:
    return len({r["coords"][axis] for r in ranks})


@pytest.mark.parametrize("world, case", [
    ("a", "ef"), ("a", "es"), ("a", "es_tight"), ("a", "dm"), ("m", "m2"),
    ("b", "dem"), ("b", "efm"), ("b", "ems")])
def test_step_matches_the_jax_step(worlds, world, case):
    """Loss, the MoE metrics and grad_norm at both steps, and every
    parameter after them, against the JAX step on the same mesh."""
    check_steps([r["steps"][case] for r in worlds[world]],
                worlds["jax"][case])


@pytest.mark.parametrize("world, case", [
    ("a", "ef"), ("a", "es"), ("a", "dm"), ("m", "m2"), ("b", "dem"),
    ("b", "efm"), ("b", "ems")])
def test_each_rank_holds_the_jax_blocks(worlds, world, case):
    """The parts each rank holds (and updates) are the whole tensors'
    blocks that JAX's specs give its coordinates: ``wi``/``wo`` over
    ``expert`` and F over ``model`` (``MOE_RULES``), FSDP on the dim
    ``_apply_fsdp`` picks after them."""
    sizes = CASES[case][0]
    _, _, specs = worlds["jax"][case]
    wi = specs[("layer1", "moe", "wi")]
    assert (wi[:1] == ("expert",)) == (sizes.get("expert", 1) > 1)
    assert (wi[2:] == ("model",)) == (sizes.get("model", 1) > 1)
    assert ("fsdp" in wi) == (sizes.get("fsdp", 1) > 1)
    ranks = [r["steps"][case] for r in worlds[world]]
    split = sum(any(a is not None for a in s) for s in specs.values())
    assert check_parts(ranks, specs) == split > 0
    for r in ranks:
        assert np.isfinite(r["eval"]["loss_sum"])


def test_tight_capacity_under_the_ring_drops_jax_s_tokens(worlds):
    """At capacity 0.5 the ring's parts of each row claim the slots the
    whole row claims in JAX: the dropped fraction is JAX's, and about
    half of the assignments."""
    want_m, _, _ = worlds["jax"]["es_tight"]
    for r in worlds["a"]:
        for g, w in zip(r["steps"]["es_tight"]["metrics"], want_m):
            assert g["moe_drop_frac"] == pytest.approx(w["moe_drop_frac"],
                                                       rel=1e-6)
            assert g["moe_drop_frac"] > 0.3


def test_checkpoint_round_trips_at_the_composed_mesh(worlds):
    ranks = worlds["b"]
    ck = ranks[0]["ckpt"]
    assert ck["into_one"] == 2 and ck["one_equal"] and ck["one_ema_equal"]
    for k, v in ck["one_next"].items():
        np.testing.assert_allclose(ck["mesh_next"][k], v, rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    _, _, specs = worlds["jax"]["efm"]
    for r in ranks:
        c = r["ckpt"]
        assert c["into_mesh"] == 3
        assert "checkpoint.allow_reshard" in c["refused"]
        for k, v in ck["one_saved"].items():
            assert torch.equal(c["mesh_restored"][k], v), k
        for k, v in ck["one_saved_ema"].items():
            assert torch.equal(c["mesh_restored_ema"][k], v), k
    restored = [{"tensors": ck["one_saved"],
                 "parts": r["ckpt"]["mesh_parts"],
                 "coords": r["steps"]["efm"]["coords"]} for r in ranks]
    assert check_parts(restored, specs) == sum(
        any(a is not None for a in s) for s in specs.values())


def test_composed_checkpoint_exports_and_serves(worlds):
    served = worlds["b"][0]["ckpt"]["served"]
    assert served["step"] == 2
    assert served["got"].shape == (2, 32, 128)
    np.testing.assert_allclose(served["got"], served["want"], rtol=1e-5,
                               atol=1e-5)


def test_composed_meshes_pass_the_checks():
    """The compositions the port refused now build; the JAX package's
    refusals beside them still raise."""
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    for name, (sizes, _) in CASES.items():
        world = int(np.prod(list(sizes.values())))
        assert check_step_config(port_config(overrides=overrides(name)),
                                 world)["expert"] == sizes.get("expert", 1)
    with pytest.raises(ValueError, match="expert parallelism"):
        check_step_config(port_config(overrides=overrides("ef") + [
            "train.spmd_mode=shard_map"]), 4)
    with pytest.raises(ValueError, match="v1 pipeline"):
        check_step_config(port_config(overrides=TINY_MOE + [
            "mesh.data=1", "mesh.model=2", "mesh.pipe=2",
            "model.pipeline_stages=2"]), 4)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
