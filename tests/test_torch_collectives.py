"""Explicit collectives (parallel/collectives.py, parallel/quantization.py,
the transports of core/mesh.py) and the error-feedback residual in the
training state and the checkpoint, against the JAX package.

One world of two gloo ranks, each a child process that runs this file
with the gang environment of core/cluster.py and imports torch alone:

  * every collective in every wire mode on seeded per-rank inputs, first
    on gloo's native ops, then on the ``all_reduce`` transport that gloo
    takes for CUDA tensors (forced here on CPU tensors), each under a
    tally;
  * one step of LeNet-5 with each wire and of a small ResNet (the
    BatchNorm ``pmean``), each under a tally;
  * two steps of LeNet-5 on the int8 wire with error feedback, a
    chief-written checkpoint, and a restore into fresh states.

In this process the JAX package runs the same inputs under ``shard_map``
on a ``data=2`` mesh over two of conftest's eight CPU devices.

Tolerances: the codec, the f32 and int8 reductions, the gathers and the
new residuals are bit-equal to JAX's (the same f32 operations in the same
order; a sum over two ranks has one order). A bf16 sum of two ranks is
one f32 add rounded to bf16 in gloo, where XLA may round twice, so the
pure-bf16 reductions are held within one bf16 ulp of JAX's. The forced
transport is bit-equal to the native ops. Tallies are equal dicts.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from distributed_tensorflow_framework_torch.parallel import quantization as qz
from tests.test_torch_gang import run_gang
from tests.test_torch_hygiene import torch_threads  # noqa: F401

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
BLOCK = 64
LEAVES = {"w": (37, 11), "b": (5,), "s": (), "e": (300,)}
GATHER_SHAPE = (6, 10)
SCATTER_SHAPE = (4, 6)

LENET = [
    "model.name=lenet5", "model.dtype=float32", "data.name=synthetic_images",
    "data.image_size=28", "data.channels=1", "data.seed=4",
    "data.global_batch_size=8", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.1", "optimizer.momentum=0.9",
    "optimizer.weight_decay=0.001", "optimizer.warmup_steps=1",
    "optimizer.schedule=cosine", "optimizer.grad_clip_norm=0.0",
    "train.total_steps=3", "train.label_smoothing=0.1",
    "checkpoint.directory=", "resilience.rollback=false",
    "train.spmd_mode=shard_map", f"parallel.collective_block_size={BLOCK}"]
SMALL_RESNET = [o for o in LENET if not o.startswith(("model.", "data."))] + [
    "model.name=resnet18_cifar", "model.dtype=float32",
    "data.name=synthetic_images", "data.image_size=32", "data.channels=3",
    "data.seed=2", "data.global_batch_size=8"]
WIRES = {"f32": [], "bf16": ["parallel.collective_dtype=bfloat16"],
         "int8": ["parallel.collective_dtype=int8"]}
INT8_EF = LENET + WIRES["int8"]


def _inputs() -> dict:
    """Every rank's inputs, stacked on a leading rank axis: gradients of
    wildly different magnitudes on the two ranks, a residual, and the
    operands of the gather and the scatter."""
    rng = np.random.default_rng(0)
    scale = np.array([1e-2, 1e2], np.float32)

    def draw(shape):
        x = rng.standard_normal((2,) + shape).astype(np.float32)
        return x * scale.reshape((2,) + (1,) * len(shape))

    return {"g": {k: draw(s) for k, s in LEAVES.items()},
            "r": {k: rng.standard_normal((2,) + s).astype(np.float32)
                  * np.float32(1e-3) for k, s in LEAVES.items()},
            "x_gather": draw(GATHER_SHAPE), "x_scatter": draw(SCATTER_SHAPE)}


def _gather_cases():
    return [(w, axis, tiled) for w in ("", "bfloat16", "int8")
            for axis, tiled in ((0, True), (1, True), (0, False))]


def _scatter_cases():
    return [(w, axis) for w in ("", "bfloat16", "int8") for axis in (0, 1)]


def _port_cases(inp: dict, rt) -> dict:
    """Each collective in each mode on this rank's inputs: {case: (the
    result nest, its tally)}."""
    g, r = inp["g"], inp["r"]
    calls = {
        "pmean_wire": lambda: coll.allreduce_gradients(g, rt),
        "bf16_f32": lambda: coll.allreduce_gradients(
            g, rt, compute_dtype="bfloat16"),
        "bf16_wire": lambda: coll.allreduce_gradients(
            g, rt, compute_dtype="bfloat16", accumulate_f32=False),
        "int8": lambda: coll.allreduce_gradients(
            g, rt, compute_dtype="int8", block_size=BLOCK),
        "int8_ef": lambda: list(coll.allreduce_gradients_ef(
            g, r, rt, block_size=BLOCK)),
        "psum": lambda: coll.psum(g, rt),
        "pmean": lambda: coll.pmean(g, rt),
    }
    for w, axis, tiled in _gather_cases():
        calls[f"all_gather_{w or 'none'}_{axis}_{tiled}"] = functools.partial(
            coll.all_gather, inp["x_gather"], rt, axis=axis, tiled=tiled,
            wire_dtype=w, block_size=BLOCK)
    for w, axis in _scatter_cases():
        calls[f"reduce_scatter_{w or 'none'}_{axis}"] = functools.partial(
            coll.reduce_scatter, inp["x_scatter"], rt, scatter_axis=axis,
            wire_dtype=w, block_size=BLOCK)
    out = {}
    for name, call in calls.items():
        with coll.tally() as t:
            result = call()
        out[name] = (result, t.summary())
    return out


def _jax_cases() -> dict:
    """The same cases through the JAX wrappers under shard_map on a data=2
    mesh: {case: (each rank's result stacked on axis 0, tally)}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_tensorflow_framework_tpu.parallel import (
        collectives as jcoll,
    )

    mesh = _jax_mesh()
    inp = _inputs()

    def run(fn, *args):
        def body(*xs):
            out = fn(*[jax.tree.map(lambda v: v[0], x) for x in xs])
            return jax.tree.map(lambda v: v[None], out)

        mapped = jcoll.shard_map(body, mesh=mesh,
                                 in_specs=tuple(P("data") for _ in args),
                                 out_specs=P("data"), check_vma=False)
        with jcoll.tally() as t:
            out = jax.jit(mapped)(*args)
        return jax.tree.map(np.asarray, out), t.summary()

    axes = ("data",)
    g, r = inp["g"], inp["r"]
    out = {
        "pmean_wire": run(lambda x: jcoll.allreduce_gradients(x, axes), g),
        "bf16_f32": run(lambda x: jcoll.allreduce_gradients(
            x, axes, compute_dtype=jnp.bfloat16), g),
        "bf16_wire": run(lambda x: jcoll.allreduce_gradients(
            x, axes, compute_dtype=jnp.bfloat16, accumulate_f32=False), g),
        "int8": run(lambda x: jcoll.allreduce_gradients(
            x, axes, compute_dtype=jnp.int8, block_size=BLOCK), g),
        "int8_ef": run(lambda x, y: list(jcoll.allreduce_gradients_ef(
            x, y, axes, block_size=BLOCK)), g, r),
        "psum": run(lambda x: jcoll.psum(x, axes), g),
        "pmean": run(lambda x: jcoll.pmean(x, axes), g),
    }
    for w, axis, tiled in _gather_cases():
        out[f"all_gather_{w or 'none'}_{axis}_{tiled}"] = run(
            lambda x, w=w, axis=axis, tiled=tiled: jcoll.all_gather(
                x, "data", axis=axis, tiled=tiled, wire_dtype=w or None,
                block_size=BLOCK), inp["x_gather"])
    for w, axis in _scatter_cases():
        out[f"reduce_scatter_{w or 'none'}_{axis}"] = run(
            lambda x, w=w, axis=axis: jcoll.reduce_scatter(
                x, "data", scatter_axis=axis, wire_dtype=w or None,
                block_size=BLOCK), inp["x_scatter"])
    return out


def _jax_mesh():
    import jax

    from distributed_tensorflow_framework_tpu.core.config import MeshConfig
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh

    return create_mesh(MeshConfig(data=2), devices=jax.devices()[:2])


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree


def _flat(tree) -> list:
    """The arrays of a nest, dicts in key order (JAX's pytree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [] if tree is None else [np.asarray(tree)]


# ------------------------------------------------------------ the ranks

def _step_tally(overrides, runtime, steps=1, model_fn=None):
    """``steps`` shard_map steps of a case on this rank's block of the
    global batches; the first step's tally, and the builder and state."""
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train import step as port_step

    config = port_config(overrides=overrides)
    saved = port_step.get_model
    if model_fn is not None:
        port_step.get_model = model_fn
    try:
        builder = port_step.StepBuilder(config, device="cpu",
                                        runtime=runtime)
        state = builder.init_state(0)
    finally:
        port_step.get_model = saved
    world = 1 if runtime is None else runtime.process_count
    rank = 0 if runtime is None else runtime.process_index
    ds = get_dataset(config.data)
    summary = None
    for _ in range(steps):
        batch = next(ds)
        b = config.data.global_batch_size // world
        block = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        with coll.tally() as t:
            builder.train_step(state, to_device(block, torch.device("cpu")))
        summary = summary or t.summary()
    return summary, builder, state


def _small_resnet(config, *, device, generator=None, in_channels=None,
                  precision=None):
    from distributed_tensorflow_framework_torch.models.resnet import ResNet

    model = ResNet((1, 1), 10, width=8, cifar_stem=True,
                   dtype=torch.float32)
    model.init_weights(generator)
    return model.to(device).eval()


def _checkpoint_roundtrip(workdir, runtime) -> dict:
    """Two int8 error-feedback steps of LeNet, a save by the chief at
    step 2, and a restore into a fresh state on every rank."""
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    _, builder, state = _step_tally(INT8_EF, runtime, steps=2)
    cfg = dataclasses.replace(builder.config.checkpoint,
                              directory=f"{workdir}/ckpt_ef",
                              async_save=False)
    manager = CheckpointManager(cfg, runtime=runtime)
    manager.save(2, state)
    fresh = builder.init_state(1)
    restored = manager.restore(fresh)
    manager.close()
    return {"restored": restored,
            "live": {k: v.clone() for k, v in
                     state.collective_residual.items()},
            "back": {k: v.clone() for k, v in
                     fresh.collective_residual.items()},
            "params_equal": all(
                torch.equal(a, b) for a, b in
                zip(state.model.state_dict().values(),
                    fresh.model.state_dict().values()))}


def _rank_main(workdir: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    runtime = initialize_runtime(MeshConfig(), "cpu")
    rank = runtime.process_index
    inp = {k: ({n: torch.tensor(a[rank]) for n, a in v.items()}
               if isinstance(v, dict) else torch.tensor(v[rank]))
           for k, v in _inputs().items()}
    out = {"backend": runtime.backend, "rank": rank,
           "index": coll.linear_axis_index(runtime),
           "transport": runtime.collective_transport("cpu"),
           "native": _numpy(_port_cases(inp, runtime))}
    # gloo's transport for CUDA tensors, forced on CPU tensors.
    runtime.collective_transport = lambda device: "all_reduce"
    out["forced"] = _numpy(_port_cases(inp, runtime))
    del runtime.collective_transport
    out["tally"] = {f"lenet_{w}": _step_tally(LENET + over, runtime)[0]
                    for w, over in WIRES.items()}
    out["tally"]["resnet"] = _step_tally(SMALL_RESNET, runtime,
                                         model_fn=_small_resnet)[0]
    out["ckpt"] = _numpy(_checkpoint_roundtrip(workdir, runtime))
    runtime.shutdown()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(_jsonable(out), fh)


def _jsonable(tree):
    if isinstance(tree, np.ndarray):
        return {"__array__": tree.tolist(), "dtype": str(tree.dtype),
                "shape": list(tree.shape)}
    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jsonable(v) for v in tree]
    return tree


def _from_json(tree):
    if isinstance(tree, dict) and "__array__" in tree:
        return np.asarray(tree["__array__"], dtype=tree["dtype"]).reshape(
            tree["shape"])
    if isinstance(tree, dict):
        return {k: _from_json(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_json(v) for v in tree]
    return tree


# ------------------------------------------------------- the test side


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("coll"))
    run_gang([HERE, workdir],
             [os.path.join(workdir, f"rank{rank}.log")
              for rank in range(2)],
             timeout=240)
    out = []
    for rank in range(2):
        with open(os.path.join(workdir, f"rank{rank}.json")) as fh:
            out.append(_from_json(json.load(fh)))
    return {"dir": workdir, "ranks": out}


@pytest.fixture(scope="module")
def jax_cases():
    return _jax_cases()


# -------------------------------------------------------------- the codec

def _codec_input() -> np.ndarray:
    """Blocks of 64: seeded normals at several scales, an all-zero block,
    a block of exact .5 ties (its max is 127, so its scale is 1.0) and one
    whose every element maps to ±127."""
    rng = np.random.default_rng(5)
    normal = (rng.standard_normal((4, BLOCK))
              * np.array([1e-3, 1.0, 1e3, 7.0])[:, None])
    ties = np.concatenate([[127.0, -127.0], np.arange(-30.5, 31.0, 1.0)])
    assert ties.size == BLOCK
    clamp = np.where(np.arange(BLOCK) % 2, 3.75, -3.75)
    return np.concatenate([normal.ravel(), np.zeros(BLOCK), ties,
                           clamp]).astype(np.float32)


def test_codec_is_bit_equal_to_jax():
    import jax.numpy as jnp

    from distributed_tensorflow_framework_tpu.parallel import (
        quantization as jq,
    )

    x = _codec_input()
    q, s = qz.quantize_blockwise(torch.from_numpy(x), BLOCK)
    jq_, js = jq.quantize_blockwise(jnp.asarray(x), BLOCK)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        qz.dequantize_blockwise(q, s, BLOCK).numpy(),
        np.asarray(jq.dequantize_blockwise(jq_, js, BLOCK)))
    np.testing.assert_array_equal(
        qz.quantization_error(torch.from_numpy(x), BLOCK).numpy(),
        np.asarray(jq.quantization_error(jnp.asarray(x), BLOCK)))
    blocks = q.numpy().reshape(-1, BLOCK)
    # The zero block: zeros at scale 1; the ties round half to even; the
    # last block sits at ±127.
    assert not blocks[4].any() and s.numpy()[4] == 1.0
    assert s.numpy()[5] == 1.0
    np.testing.assert_array_equal(blocks[5][2:], np.round(x[5 * BLOCK + 2:
                                                            6 * BLOCK]))
    assert set(np.abs(blocks[6])) == {127}


def test_codec_error_bound():
    """Per element, ``|x − D(Q(x))| <= maxabs/254`` of its block."""
    x = torch.from_numpy(_codec_input())
    err = qz.quantization_error(x, BLOCK).abs().view(-1, BLOCK)
    maxabs = x.abs().view(-1, BLOCK).amax(dim=1, keepdim=True)
    assert bool((err <= maxabs / 254 * (1 + 1e-6)).all())


def test_codec_refuses_an_unpadded_input():
    with pytest.raises(ValueError, match="padded to a multiple"):
        qz.quantize_blockwise(torch.ones(BLOCK + 1), BLOCK)


# -------------------------------------------------------- the collectives

EXACT = ["pmean_wire", "bf16_f32", "int8", "int8_ef", "psum", "pmean"] + [
    f"all_gather_{w or 'none'}_{a}_{t}" for w, a, t in _gather_cases()] + [
    f"reduce_scatter_{w or 'none'}_{a}" for w, a in _scatter_cases()
    if w != "bfloat16"]
NARROW = ["bf16_wire"] + [f"reduce_scatter_bfloat16_{a}" for a in (0, 1)]


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (2^-7 of the binade)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("case", EXACT)
def test_collective_matches_jax_bit_for_bit(ranks, jax_cases, case):
    want, want_tally = jax_cases[case]
    ref = _flat(want)
    for rank in ranks["ranks"]:
        got, tally = rank["native"][case]
        flat = _flat(got)
        assert len(flat) == len(ref)
        for a, b in zip(flat, ref):
            np.testing.assert_array_equal(a, b[rank["rank"]])
        assert tally == want_tally


@pytest.mark.parametrize("case", NARROW)
def test_bf16_reduction_within_one_ulp_of_jax(ranks, jax_cases, case):
    want, want_tally = jax_cases[case]
    for rank in ranks["ranks"]:
        got, tally = rank["native"][case]
        for a, b in zip(_flat(got), _flat(want)):
            b = b[rank["rank"]]
            assert np.all(np.abs(a - b) <= _bf16_ulp(b)), case
        assert tally == want_tally


@pytest.mark.parametrize("case", EXACT + NARROW)
def test_all_reduce_transport_equals_the_native_ops(ranks, case):
    """The transport gloo takes for CUDA tensors (all_reduce over
    zero-filled int32 slots), forced on CPU tensors, gives the native
    ops' bits and tally."""
    for rank in ranks["ranks"]:
        assert rank["transport"] == "native"
        native, forced = rank["native"][case], rank["forced"][case]
        for a, b in zip(_flat(forced[0]), _flat(native[0])):
            np.testing.assert_array_equal(a, b)
        assert forced[1] == native[1]


def test_linear_axis_index_is_the_rank(ranks):
    assert [r["index"] for r in ranks["ranks"]] == [0, 1]
    assert [r["backend"] for r in ranks["ranks"]] == ["gloo", "gloo"]


def test_f32_accum_single_rounding(ranks):
    """bf16 with f32 accumulation: the error against the exact f32 mean is
    one bf16 rounding of the mean, and no worse anywhere than the pure
    bf16 reduction on the same data."""
    g = _inputs()["g"]
    rank = ranks["ranks"][0]
    got = rank["native"]["bf16_f32"][0]
    wire = rank["native"]["bf16_wire"][0]
    err_f32 = err_wire = 0.0
    for k, x in g.items():
        exact = x.mean(axis=0)
        one_rounding = np.abs(exact - torch.tensor(exact).to(
            torch.bfloat16).float().numpy())
        err = np.abs(got[k] - exact)
        assert np.all(err <= one_rounding + 1e-6 * np.abs(exact) + 1e-12)
        err_f32 += err.sum()
        err_wire += np.abs(wire[k] - exact).sum()
    assert err_f32 <= err_wire + 1e-12


def test_int8_single_step_error_bound(ranks):
    """One int8 all-reduce: each element within one block rounding on the
    scatter and one on the gather of the exact mean, each at most
    maxabs/254."""
    g = _inputs()["g"]
    for rank in ranks["ranks"]:
        got = rank["native"]["int8"][0]
        for k, x in g.items():
            bound = 2 * np.abs(x).max() / 254 + 1e-6
            assert np.abs(got[k] - x.mean(axis=0)).max() <= bound, k


def test_int8_residual_sums_to_the_missed_mean(ranks):
    """Summed over the ranks, the new residuals are n × (true mean of the
    compensated gradients − the mean every rank received)."""
    inp = _inputs()
    rows = [r["native"]["int8_ef"][0] for r in ranks["ranks"]]
    for k in LEAVES:
        compensated = (inp["g"][k] + inp["r"][k]).astype(np.float64)
        missed = compensated.mean(axis=0) - rows[0][0][k]
        total = rows[0][1][k].astype(np.float64) + rows[1][1][k]
        np.testing.assert_allclose(total, 2 * missed, rtol=1e-5,
                                   atol=1e-4 * np.abs(compensated).max())
        np.testing.assert_array_equal(rows[0][0][k], rows[1][0][k])


# -------------------------------------------------------------- the tally

def _jax_step_tally(overrides, resnet=False) -> dict:
    """The JAX StepBuilder's shard_map step on data=2, lowered under a
    tally (trace only, as tests/test_compressed_allreduce.py does)."""
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_tpu.core.config import load_config
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.parallel import (
        collectives as jcoll,
    )
    from distributed_tensorflow_framework_tpu.train.step import StepBuilder

    mesh = _jax_mesh()
    builder = StepBuilder(load_config(overrides=overrides + ["mesh.data=2"]),
                          mesh)
    if resnet:
        import jax.numpy as jnp

        from distributed_tensorflow_framework_tpu.models.resnet import (
            ResNet as JaxResNet,
        )

        builder.model = JaxResNet(stage_sizes=(1, 1), width=8,
                                  num_classes=10, dtype=jnp.float32,
                                  cifar_stem=True, bn_axis_name=("data",
                                                                 "fsdp"))
    batch = to_global(next(get_dataset(port_config(
        overrides=overrides).data)), mesh)
    state = builder.init_state(0, batch)
    step = builder.make_train_step(batch)
    with jcoll.tally() as t:
        step.lower(state, batch)
    return t.summary()


@pytest.mark.parametrize("case", [f"lenet_{w}" for w in WIRES] + ["resnet"])
def test_step_tally_equals_jax(ranks, case):
    over = (SMALL_RESNET if case == "resnet"
            else LENET + WIRES[case.split("_")[1]])
    want = _jax_step_tally(over, resnet=case == "resnet")
    for rank in ranks["ranks"]:
        assert rank["tally"][case] == want


def test_int8_wire_bytes_drop_3x_dp(ranks):
    """The data-parallel recipe's int8 wire moves at most a third of the
    f32 bytes it stands for. (The dp+fsdp half waits for FSDP, A10.)"""
    q8 = ranks["ranks"][0]["tally"]["lenet_int8"]
    f32 = ranks["ranks"][0]["tally"]["lenet_f32"]
    assert q8["total_bytes"] * 3 <= q8["total_logical_bytes"]
    assert "allreduce_grads_q8_scatter_bytes" in q8
    assert "allreduce_grads_q8_gather_bytes" in q8
    assert f32["total_bytes"] / q8["total_bytes"] >= 3.0


def test_old_knob_routes_to_new_knob():
    """train.grad_allreduce_dtype=bfloat16 (deprecated) and
    parallel.collective_dtype=bfloat16 give the same collective traffic."""
    old = _step_tally(LENET + ["train.grad_allreduce_dtype=bfloat16"],
                      None)[0]
    new = _step_tally(LENET + WIRES["bf16"], None)[0]
    assert old == new
    assert old["total_bytes"] < old["total_logical_bytes"]


# ----------------------------------------------------------- the residual

def test_residual_roundtrip_same_ranks_bit_exact(ranks):
    for rank in ranks["ranks"]:
        ck = rank["ckpt"]
        assert ck["restored"] == 2 and ck["params_equal"]
        assert any(np.abs(v).max() > 0 for v in ck["live"].values())
        for k, v in ck["live"].items():
            np.testing.assert_array_equal(ck["back"][k], v)
    a, b = (r["ckpt"]["live"] for r in ranks["ranks"])
    assert any(not np.array_equal(a[k], b[k]) for k in a)


def _restore_into(directory, overrides):
    import dataclasses

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    _, builder, state = _step_tally(overrides, None)
    # Two ranks' checkpoints come into one process: a change of mesh.
    cfg = dataclasses.replace(builder.config.checkpoint, directory=directory,
                              async_save=False, allow_reshard=True)
    manager = CheckpointManager(cfg)
    try:
        assert manager.restore(state) is not None
    finally:
        manager.close()
    return state


def test_residual_folds_two_ranks_onto_one(ranks):
    """A single process restoring the two ranks' checkpoint holds the sum
    of their rows (ckpt/reshard.py keeps each leaf's sum)."""
    directory = f"{ranks['dir']}/ckpt_ef"
    stored = torch.load(f"{directory}/2/state.pt",
                        weights_only=True)["collective_residual"]
    rows = [r["ckpt"]["live"] for r in ranks["ranks"]]
    for k, v in stored.items():
        assert v.shape[0] == 2
        np.testing.assert_array_equal(v[0].numpy(), rows[0][k])
        np.testing.assert_array_equal(v[1].numpy(), rows[1][k])
    state = _restore_into(directory, INT8_EF)
    for k, v in stored.items():
        assert torch.equal(state.collective_residual[k], v[0] + v[1]), k


def test_fold_residual_other_counts():
    from distributed_tensorflow_framework_torch.ckpt.reshard import (
        fold_residual,
    )

    rows = {"w": torch.arange(24.0).reshape(6, 2, 2)}
    even = fold_residual(rows, 3)["w"]
    assert even.shape == (3, 2, 2)
    assert torch.equal(even[0], rows["w"][0] + rows["w"][1])
    odd = fold_residual(rows, 4)["w"]
    assert torch.equal(odd[0], rows["w"].sum(0)) and not odd[1:].any()
    assert torch.equal(odd.sum(0), rows["w"].sum(0))


def test_checkpoint_without_residual_restores_zeros(ranks, tmp_path):
    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    _, builder, plain = _step_tally(LENET, None)
    cfg = port_config(overrides=LENET + [
        f"checkpoint.directory={tmp_path}", "checkpoint.async_save=false"])
    manager = CheckpointManager(cfg.checkpoint)
    manager.save(1, plain)
    manager.close()
    state = _restore_into(str(tmp_path), INT8_EF)
    assert state.collective_residual
    assert not any(v.any() for v in state.collective_residual.values())


def test_run_without_residual_drops_the_stored_one(ranks):
    state = _restore_into(f"{ranks['dir']}/ckpt_ef", LENET)
    assert state.collective_residual == {}
    assert "collective_residual" not in state.state_dict()


def test_ladder_rollback_restores_the_residual():
    from distributed_tensorflow_framework_torch.core.config import (
        ResilienceConfig,
    )
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.anomaly import (
        RecoveryManager,
    )

    _, builder, state = _step_tally(INT8_EF, None)
    manager = RecoveryManager(ResilienceConfig())
    manager.take_snapshot(1, state, force=True)
    saved = {k: v.clone() for k, v in state.collective_residual.items()}
    batch = next(get_dataset(builder.config.data))
    builder.train_step(state, to_device(batch, torch.device("cpu")))
    assert any(not torch.equal(saved[k], v)
               for k, v in state.collective_residual.items())
    state, snap = manager.rollback(state, from_step=2)
    assert snap.step == 1
    for k, v in saved.items():
        assert torch.equal(state.collective_residual[k], v), k


TINY_BERT = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=32",
    "model.num_layers=2", "model.num_heads=2", "model.mlp_dim=64",
    "model.max_seq_len=32", "model.dtype=float32", "model.dropout_rate=0.0",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=32",
    "data.global_batch_size=4", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "train.total_steps=1",
    "resilience.rollback=false", "train.spmd_mode=shard_map",
    "parallel.collective_dtype=int8", "serve.seq_buckets=[32]",
    "serve.max_batch_size=2"]


def test_export_drops_the_residual_and_serves(tmp_path):
    """Export from a checkpoint that holds a residual writes the model
    alone, and the engine serves it as it serves any export."""
    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        export_checkpoint,
        load_artifact,
    )

    over = TINY_BERT + [f"checkpoint.directory={tmp_path}/ckpt",
                        "checkpoint.async_save=false"]
    _, builder, state = _step_tally(over, None)
    assert any(v.any() for v in state.collective_residual.values())
    manager = CheckpointManager(builder.config.checkpoint)
    manager.save(1, state)
    manager.close()
    assert "collective_residual" in torch.load(
        f"{tmp_path}/ckpt/1/state.pt", weights_only=True)
    out = export_checkpoint(builder.config, str(tmp_path / "art"),
                            device="cpu")
    art = load_artifact(out)
    want = state.model.state_dict()
    assert set(art.state_dict) == set(want)
    for k, v in want.items():
        assert torch.equal(torch.as_tensor(art.state_dict[k]), v), k
    engine = InferenceEngine(art, builder.config.serve, device="cpu")
    try:
        ids = np.random.default_rng(0).integers(0, 512, 32).astype(np.int32)
        logits = engine.predict({"input_ids": ids}, timeout=60)
    finally:
        engine.drain(30)
    model = state.model.eval()
    with torch.inference_mode():
        ref = model(torch.from_numpy(ids[None]).long(),
                    torch.ones(1, 32, dtype=torch.long)).numpy()
    np.testing.assert_allclose(logits, ref, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ the refusals

@pytest.mark.parametrize("overrides, error, match", [
    (["parallel.collective_dtype=int8"], ValueError, "explicit collective"),
    (["train.grad_allreduce_dtype=bfloat16"], ValueError,
     "explicit collective"),
    (["train.spmd_mode=shard_map", "train.grad_allreduce_accum=f16"],
     ValueError, "grad_allreduce_accum"),
    # FSDP and ZeRO are ported (A10): one process has no fsdp axis of 2,
    # and ZeRO over one replica is refused as the JAX package refuses it.
    (["train.spmd_mode=shard_map", "mesh.fsdp=2", "mesh.data=1"],
     ValueError, "needs 2 devices"),
    (["train.spmd_mode=shard_map", "optimizer.zero_sharding=shard_map"],
     ValueError, "silent no-op"),
    (["train.spmd_mode=pjit"], ValueError, "spmd_mode"),
])
def test_refusals(overrides, error, match):
    from distributed_tensorflow_framework_torch.train import step as port_step

    over = [o for o in LENET if not o.startswith("train.spmd_mode")]
    with pytest.raises(error, match=match):
        port_step.StepBuilder(port_config(overrides=over + overrides),
                              device="cpu")


if __name__ == "__main__":
    _rank_main(sys.argv[1])
