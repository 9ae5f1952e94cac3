"""The ring beside ``fsdp``, ``model`` and ZeRO-1, and a QKV whose heads
``mesh.model`` does not divide, against the JAX package's ``jit`` step.

Two worlds of gloo ranks, each rank a child process running this file
with the gang environment of core/cluster.py (torch alone), train a tiny
BERT (f32, 2 layers, width 64, 4 heads, 128-token rows, SGD with
momentum and clipping 1.0) for two steps:

  * world A, four ranks: ring attention at ``{fsdp: 2, seq: 2}``, at
    ``{model: 2, seq: 2}`` (each ``model`` rank rotates its own heads'
    K/V) and at ``{fsdp: 2, seq: 2}`` with ``optimizer.zero_sharding:
    jit`` (ZeRO-1); the plain attention at ``{model: 4}`` with 2 heads of
    32, the fused QKV and the separate query/key/value kernels (each rank
    holds a quarter of a head's columns); the ZeRO-1 checkpoint round
    trips;
  * world B, eight ranks: ring attention at ``{fsdp: 2, seq: 2, model:
    2}``, and its checkpoint round trips (tests/test_torch_compose_moe.py
    ``checkpoints``: written at the mesh and read by one process, written
    by one process and read at the mesh, refused without
    ``checkpoint.allow_reshard``, exported and served).

In this process the JAX StepBuilder runs the same steps on a mesh of the
same sizes over as many CPU devices, from the port's initial parameters
and on the port's global batches. JAX's ZeRO-1 needs ``fsdp > 1``: at
``{data: 2, seq: 2}`` it raises its own ValueError, and so does the
port.

Tolerances: losses and grad_norm rtol 1e-5; every parameter after 2
steps rtol 1e-5 (atol 1e-6); each rank's parts are the blocks of the
whole tensors that JAX's partition specs give its coordinates, exactly;
the ranks' agreement, the checkpoints and the restored parts exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from tests.test_torch_compose_moe import (
    check_parts,
    check_steps,
    checkpoints,
    collect,
    port_init,
    run,
    start,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401
from tests.test_torch_moe_ep import _jax_steps

HERE = os.path.abspath(__file__)
TINY = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=2", "model.num_heads=4", "model.mlp_dim=128",
    "model.max_seq_len=128", "model.dtype=float32",
    "model.attention_impl=ring", "model.dropout_rate=0.0",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=128",
    "data.global_batch_size=8", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.5", "optimizer.momentum=0.9",
    "optimizer.weight_decay=0.0", "optimizer.warmup_steps=0",
    "optimizer.schedule=constant", "optimizer.grad_clip_norm=1.0",
    "train.total_steps=2", "checkpoint.directory=",
    "resilience.rollback=false"]
ZERO1 = ["optimizer.zero_sharding=jit"]
HEADS2 = ["model.attention_impl=xla", "model.num_heads=2"]
FUSED = ["model.fused_qkv=true"]
UNFUSED = ["model.fused_qkv=false"]
METRICS = ("loss", "mlm_acc", "grad_norm")
# name → (the mesh, the overrides of the model beside it).
CASES = {
    "fs": ({"data": 1, "fsdp": 2, "seq": 2}, []),
    "ms": ({"data": 1, "model": 2, "seq": 2}, []),
    "fs_zero": ({"data": 1, "fsdp": 2, "seq": 2}, ZERO1),
    "m4_fused": ({"data": 1, "model": 4}, HEADS2 + FUSED),
    "m4_unfused": ({"data": 1, "model": 4}, HEADS2 + UNFUSED),
    "fsm": ({"data": 1, "fsdp": 2, "seq": 2, "model": 2}, []),
}
WORLDS = {"a": (4, ["fs", "ms", "fs_zero", "m4_fused", "m4_unfused"]),
          "b": (8, ["fsm"])}
CKPT = {"a": "fs_zero", "b": "fsm"}
# The case whose parameter specs give a case's parts: ZeRO-1's slots are
# the FSDP layout.
SPEC_OF = {"fs_zero": "fs"}


def overrides(name: str) -> list[str]:
    sizes, extra = CASES[name]
    return TINY + extra + [f"mesh.{a}={v}" for a, v in sizes.items()]


def model_over(name: str) -> list[str]:
    """The overrides that shape the case's parameters."""
    return TINY + [o for o in CASES[name][1] if o not in ZERO1]


def _rank_main(workdir: str, world: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    runtime = initialize_runtime(MeshConfig(data=-1), "cpu")
    out = {"steps": {n: run(overrides(n), runtime)
                     for n in WORLDS[world][1]}}
    name = CKPT[world]
    out["ckpt"] = checkpoints(workdir, runtime, overrides(name), name)
    runtime.shutdown()
    torch.save(out, os.path.join(workdir,
                                 f"{world}{runtime.process_index}.pt"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds run while this process computes the JAX references."""
    workdir = str(tmp_path_factory.mktemp("compose_ring"))
    gangs = {"a": start(HERE, workdir, "a", 4),
             "b": start(HERE, workdir, "b", 8)}
    refs = {}
    for name in CASES:
        refs[name] = _jax_steps(CASES[name][0], overrides(name),
                                port_init(model_over(name)))
    out = {w: collect(workdir, w, g) for w, g in gangs.items()}
    out["jax"] = refs
    return out


CASE_WORLD = [(w, n) for w, (_, names) in WORLDS.items() for n in names]


@pytest.mark.parametrize("world, case", CASE_WORLD)
def test_step_matches_the_jax_step(worlds, world, case):
    """Loss, mlm_acc and grad_norm at both steps, and every parameter
    after them, against the JAX step on the same mesh."""
    check_steps([r["steps"][case] for r in worlds[world]],
                worlds["jax"][case], metrics=METRICS,
                over=model_over(case))


@pytest.mark.parametrize("world, case", CASE_WORLD)
def test_each_rank_holds_the_jax_blocks(worlds, world, case):
    """The parts each rank holds and updates are the whole tensors'
    blocks that JAX's specs give its coordinates (ZeRO-1: the optimizer's
    parts of the whole parameters, in the FSDP layout of the same mesh,
    which JAX's ZeRO-1 gives the slots while its parameters stay
    replicated); with 2 heads over ``model`` 4 the QKV columns are split
    inside a head."""
    _, _, specs = worlds["jax"][SPEC_OF.get(case, case)]
    if case in SPEC_OF:
        assert not any(any(s) for s in worlds["jax"][case][2].values())
    ranks = [r["steps"][case] for r in worlds[world]]
    split = sum(any(a is not None for a in s) for s in specs.values())
    assert check_parts(ranks, specs, model_over(case)) == split > 0
    if case.startswith("m4"):
        proj = (("layer0", "attn", "qkv", "kernel") if case == "m4_fused"
                else ("layer0", "attn", "query", "kernel"))
        assert specs[proj][-1] == "model"
        for r in ranks:
            key = ("layer0.attn.qkv.weight" if case == "m4_fused"
                   else "layer0.attn.query.weight")
            assert r["parts"][key].shape[0] == (48 if case == "m4_fused"
                                                else 16)


@pytest.mark.parametrize("world", ["a", "b"])
def test_checkpoint_round_trips_at_the_composed_mesh(worlds, world):
    name = CKPT[world]
    ranks = worlds[world]
    ck = ranks[0]["ckpt"]
    assert ck["into_one"] == 2 and ck["one_equal"] and ck["one_ema_equal"]
    for k, v in ck["one_next"].items():
        np.testing.assert_allclose(ck["mesh_next"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for r in ranks:
        c = r["ckpt"]
        assert c["into_mesh"] == 3
        assert "checkpoint.allow_reshard" in c["refused"]
        for k, v in ck["one_saved"].items():
            assert torch.equal(c["mesh_restored"][k], v), k
        for k, v in ck["one_saved_ema"].items():
            assert torch.equal(c["mesh_restored_ema"][k], v), k
    _, _, specs = worlds["jax"][SPEC_OF.get(name, name)]
    restored = [{"tensors": ck["one_saved"],
                 "parts": r["ckpt"]["mesh_parts"],
                 "coords": r["steps"][name]["coords"]} for r in ranks]
    assert check_parts(restored, specs, model_over(name)) == sum(
        any(a is not None for a in s) for s in specs.values())
    served = ck["served"]
    assert served["step"] == 2 and served["got"].shape == (2, 128, 512)
    np.testing.assert_allclose(served["got"], served["want"], rtol=1e-5,
                               atol=1e-5)


def test_ring_compositions_pass_the_checks():
    """The compositions the port refused now build; the JAX package's
    refusals beside them still raise with its messages: ZeRO-1 without
    ``fsdp``, ring attention under ``shard_map``."""
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    for name, (sizes, _) in CASES.items():
        world = int(np.prod(list(sizes.values())))
        assert check_step_config(port_config(overrides=overrides(name)),
                                 world)["seq"] == sizes.get("seq", 1)
    with pytest.raises(ValueError, match="set mesh.fsdp > 1"):
        check_step_config(port_config(overrides=TINY + ZERO1 + [
            "mesh.data=2", "mesh.seq=2"]), 4)
    with pytest.raises(ValueError, match="context mesh"):
        check_step_config(port_config(overrides=overrides("fs") + [
            "train.spmd_mode=shard_map"]), 4)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
