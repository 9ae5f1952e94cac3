"""The explicit-collective step (``train.spmd_mode: shard_map``,
train/step.py) across two ranks, against the JAX ``StepBuilder`` in
shard_map mode on a ``data=2`` mesh over two of conftest's eight CPU
devices, from the port's initial parameters on the same global batches.

Two gloo ranks in child processes (this file run as a script with the
gang environment of core/cluster.py) each take their block of every
global batch for 3 steps:

  * LeNet-5 in f32 with each wire: f32, bf16 with f32 accumulation, pure
    bf16, int8 with error feedback and without;
  * a tiny BERT (dropout 0) at ``grad_accum_steps=2`` whose two halves
    hold different masked-token counts: shard_map gives the mean of the
    ranks' means (each rank weights its micro-batches by its own masked
    tokens), which the DDP (jit) step of the same ranks does not;
  * a small ResNet with ``model.bn_cross_replica`` true and false.

Tolerances (f32), as tests/test_torch_ddp.py holds the jit step: loss and
accuracy rtol 1e-5, grad_norm rtol 1e-4, LeNet and ResNet parameters
within 1e-5 × lr, BERT's within 1e-3 × lr, running statistics within 1e-5
of each leaf's largest value. A narrow wire rounds gradients that agree
only to f32 noise, so an element may land one rounding step apart: bf16
one ulp (2^-8 of |g| <= 2^-8 × grad_norm), int8 one quantum on the
scatter and one on the gather (2 × 2/254 of the block's max <= grad_norm
× 2/127); SGD with momentum 0.9 carries such a step into the parameters
at most 1 + 0.9 + 0.81 < 3 times over 3 steps, so the parameters of the
wire cases are held within lr × (1e-5 + 3 × that step × the largest
grad_norm); grad_norm
within 2 such steps of the largest grad_norm (one element's step moves
the norm by at most the step), and the losses after the first step within
the largest grad_norm times that parameter tolerance (to first order, a
loss moves by |∇L| × |Δp|). At a world of 1, shard_map with no wire is
bit-equal to the jit step.
"""

import os
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import get_dataset
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.models.resnet import ResNet
from distributed_tensorflow_framework_torch.train import step as port_step
from tests.test_torch_gang import run_gang
from tests.test_torch_hygiene import torch_threads  # noqa: F401

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
STEPS = 3
SHARD_MAP = ["train.spmd_mode=shard_map", "parallel.collective_block_size=64"]
LENET = [
    "model.name=lenet5", "model.dtype=float32", "data.name=synthetic_images",
    "data.image_size=28", "data.channels=1", "data.seed=4",
    "data.global_batch_size=8", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.1", "optimizer.momentum=0.9",
    "optimizer.weight_decay=0.001", "optimizer.warmup_steps=1",
    "optimizer.schedule=cosine", "optimizer.grad_clip_norm=0.0",
    f"train.total_steps={STEPS}", "train.label_smoothing=0.1",
    "checkpoint.directory=", "resilience.rollback=false"]
SMALL_RESNET = [o for o in LENET if not o.startswith(("model.", "data."))] + [
    "model.name=resnet18_cifar", "model.dtype=float32",
    "data.name=synthetic_images", "data.image_size=32", "data.channels=3",
    "data.seed=2", "data.global_batch_size=8"]
TINY_BERT = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=2", "model.num_heads=4", "model.mlp_dim=128",
    "model.max_seq_len=128", "model.dtype=float32",
    "model.attention_impl=pallas", "model.dropout_rate=0.0",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=128",
    "data.global_batch_size=8", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=2",
    "optimizer.schedule=linear", "optimizer.weight_decay=0.01",
    "optimizer.grad_clip_norm=1.0", "optimizer.eps=1e-6",
    f"train.total_steps={STEPS}", "checkpoint.directory=",
    "resilience.rollback=false", "train.grad_accum_steps=2"]
# name → (overrides, the wire's rounding step relative to grad_norm).
CASES = {
    "lenet_f32": (LENET + SHARD_MAP, 0.0),
    "lenet_bf16": (LENET + SHARD_MAP + ["parallel.collective_dtype=bfloat16"],
                   2.0 ** -8),
    "lenet_bf16_wire": (LENET + SHARD_MAP + [
        "parallel.collective_dtype=bfloat16",
        "train.grad_allreduce_accum=wire"], 2.0 ** -8),
    "lenet_int8": (LENET + SHARD_MAP + ["parallel.collective_dtype=int8"],
                   2.0 / 127),
    "lenet_int8_no_ef": (LENET + SHARD_MAP + [
        "parallel.collective_dtype=int8", "parallel.error_feedback=false"],
        2.0 / 127),
    "bert": (TINY_BERT + SHARD_MAP, 0.0),
    "resnet_bn_global": (SMALL_RESNET + SHARD_MAP, 0.0),
    "resnet_bn_local": (SMALL_RESNET + SHARD_MAP
                        + ["model.bn_cross_replica=false"], 0.0),
}
# The DDP (jit) step of the same BERT ranks, which the shard_map step must
# not equal: its MLM loss divides by the masked tokens of the global batch.
JIT_BERT = TINY_BERT


def _small_resnet(config, *, device, generator=None, in_channels=None,
                  precision=None):
    """What the port builds for ``resnet18_cifar`` here: stages (1, 1),
    width 8, the CIFAR stem (as tests/test_torch_ddp.py)."""
    model = ResNet((1, 1), 10, width=8, cifar_stem=True,
                   dtype=torch.float32)
    model.init_weights(generator)
    return model.to(device).eval()


def _with_model(name, fn, *args):
    saved = port_step.get_model
    if name.startswith("resnet"):
        port_step.get_model = _small_resnet
    try:
        return fn(*args)
    finally:
        port_step.get_model = saved


def _global_batches(config):
    ds = get_dataset(config.data)
    return [next(ds) for _ in range(STEPS)]


def _port_steps(overrides, runtime=None) -> dict:
    """STEPS port steps, each rank on its block of the global batches:
    the metrics of every step (global_metrics: the shard_map metrics are
    the ranks' mean already), the final tensors and residual."""
    config = port_config(overrides=overrides)
    builder = port_step.StepBuilder(config, device="cpu", runtime=runtime)
    state = builder.init_state(0)
    world = 1 if runtime is None else runtime.process_count
    rank = 0 if runtime is None else runtime.process_index
    metrics = []
    for batch in _global_batches(config):
        b = config.data.global_batch_size // world
        block = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        m = builder.global_metrics(builder.train_step(
            state, to_device(block, torch.device("cpu"))))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "tensors": {k: v.detach().clone()
                        for k, v in state.model.state_dict().items()},
            "residual": {k: v.clone() for k, v in
                         state.collective_residual.items()}}


def _rank_main(workdir: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    runtime = initialize_runtime(MeshConfig(), "cpu")
    out = {"backend": runtime.backend,
           "steps": {n: _with_model(n, _port_steps, over, runtime)
                     for n, (over, _) in CASES.items()},
           "bert_jit": _port_steps(JIT_BERT, runtime)}
    runtime.shutdown()
    torch.save(out, os.path.join(workdir,
                                 f"rank{runtime.process_index}.pt"))


# ------------------------------------------------------- the test side


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("shard_map"))
    run_gang([HERE, workdir],
             [os.path.join(workdir, f"rank{rank}.log")
              for rank in range(2)],
             timeout=300)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=True) for r in range(2)]


def _jax_steps(name, port_init) -> tuple[dict, list]:
    """The JAX StepBuilder in shard_map mode on a data=2 mesh over the
    same global batches, from the port's initial parameters and
    statistics."""
    import jax

    from distributed_tensorflow_framework_torch.models.convert import (
        batch_stats_to_flax,
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

    overrides = CASES[name][0]
    config = port_config(overrides=overrides)
    jcfg = load_config(overrides=overrides + ["mesh.data=2"])
    mesh = create_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    builder = StepBuilder(jcfg, mesh)
    if name.startswith("resnet"):
        import jax.numpy as jnp

        from distributed_tensorflow_framework_tpu.models.resnet import (
            ResNet as JaxResNet,
        )

        builder.model = JaxResNet(
            stage_sizes=(1, 1), width=8, num_classes=10, dtype=jnp.float32,
            cifar_stem=True, bn_axis_name=(
                ("data", "fsdp") if config.model.bn_cross_replica else None))
    batches = _global_batches(config)
    state = builder.init_state(0, to_global(batches[0], mesh))
    model = _with_model(name, lambda: port_step.get_model(
        config.model, device="cpu", in_channels=(
            None if name == "bert" else config.data.channels)))
    model.load_state_dict(port_init)

    def placed(tree, like):
        return jax.tree.map(lambda x, ref: jax.device_put(x, ref.sharding),
                            tree, like)

    state = state.replace(params=placed(to_flax(model), state.params))
    if name.startswith("resnet"):
        state = state.replace(batch_stats=placed(batch_stats_to_flax(model),
                                                 state.batch_stats))
    step = builder.make_train_step(to_global(batches[0], mesh))
    metrics = []
    for batch in batches:
        state, m = step(state, to_global(batch, mesh))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    out = {"metrics": metrics,
           "params": flatten_tree(jax.device_get(state.params))}
    if name.startswith("resnet"):
        out["stats"] = flatten_tree(jax.device_get(state.batch_stats))
    return out, batches


def _port_tree(name, tensors):
    from distributed_tensorflow_framework_torch.models.convert import (
        batch_stats_to_flax,
        flatten_tree,
        to_flax,
    )

    config = port_config(overrides=CASES[name][0])
    model = _with_model(name, lambda: port_step.get_model(
        config.model, device="cpu", in_channels=(
            None if name == "bert" else config.data.channels)))
    model.load_state_dict(tensors)
    return (flatten_tree(to_flax(model)),
            flatten_tree(batch_stats_to_flax(model))
            if name.startswith("resnet") else {})


def _init(name):
    return _with_model(name, lambda: port_step.StepBuilder(
        port_config(overrides=CASES[name][0]), device="cpu").init_state(0)
        .model.state_dict())


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_the_jax_shard_map_step(ranks, name):
    ref, batches = _jax_steps(name, _init(name))
    overrides, step = CASES[name]
    lr = port_config(overrides=overrides).optimizer.learning_rate
    if name == "bert":
        halves = [[int((b["targets"][h * 4:(h + 1) * 4] >= 0).sum())
                   for h in range(2)] for b in batches]
        assert all(a != b for a, b in halves), halves
    top = max(m["grad_norm"] for m in ref["metrics"])
    atol = lr * ((1e-3 if name == "bert" else 1e-5) + 3 * step * top)
    got = [r["steps"][name] for r in ranks]
    for a, b in zip(got[0]["tensors"].values(), got[1]["tensors"].values()):
        assert torch.equal(a, b)
    for r in got:
        for i, (g, w) in enumerate(zip(r["metrics"], ref["metrics"])):
            for key in ("loss", "mlm_acc", "top1"):
                if key in w:
                    np.testing.assert_allclose(
                        g[key], w[key], rtol=1e-5,
                        atol=1e-7 + (top * atol if step and i else 0.0),
                        err_msg=f"step {i} {key}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-4, atol=2 * step * top,
                                       err_msg=f"step {i}")
        params, stats = _port_tree(name, r["tensors"])
        for path, want in ref["params"].items():
            np.testing.assert_allclose(params[path], want, rtol=0,
                                       atol=atol, err_msg=f"param {path}")
        for path, want in ref.get("stats", {}).items():
            err = np.abs(stats[path] - want).max()
            assert err <= 1e-5 * np.abs(want).max(), f"{path}: {err:.2e}"


def test_bert_shard_map_differs_from_the_jit_step(ranks):
    """Mean of the ranks' means (shard_map) against the global masked-token
    weight (DDP): other losses and parameters on the same batches."""
    for r in ranks:
        sm, jit = r["steps"]["bert"], r["bert_jit"]
        assert all(abs(a["loss"] - b["loss"]) > 1e-6 for a, b in
                   zip(sm["metrics"][1:], jit["metrics"][1:]))
        assert any(not torch.equal(a, jit["tensors"][k])
                   for k, a in sm["tensors"].items())


def test_bn_cross_replica_changes_the_statistics(ranks):
    glob, local = (ranks[0]["steps"][n]["tensors"] for n in
                   ("resnet_bn_global", "resnet_bn_local"))
    keys = [k for k in glob if k.endswith("running_mean")]
    assert keys and any(not torch.equal(glob[k], local[k]) for k in keys)
    for r in ranks:
        assert r["backend"] == "gloo"


def test_int8_residual_lives_in_the_state(ranks):
    for r in ranks:
        res = r["steps"]["lenet_int8"]["residual"]
        # One f32 row per parameter (LeNet has no buffers).
        assert set(res) == set(r["steps"]["lenet_int8"]["tensors"])
        assert all(v.dtype == torch.float32 for v in res.values())
        assert any(v.abs().max() > 0 for v in res.values())
        assert r["steps"]["lenet_int8_no_ef"]["residual"] == {}
        assert r["steps"]["lenet_bf16"]["residual"] == {}


@pytest.mark.parametrize("name", ["lenet_f32", "bert", "resnet_bn_global"])
def test_world_one_shard_map_is_the_jit_step(name):
    """One process: shard_map with no wire gives the jit step's metrics
    and tensors bit for bit (test_train_lenet.py's jit/shard_map
    agreement, exact here)."""
    overrides = CASES[name][0]
    jit = [o for o in overrides if not o.startswith("train.spmd_mode")]
    a = _with_model(name, _port_steps, overrides)
    b = _with_model(name, _port_steps, jit)
    assert a["metrics"] == b["metrics"]
    for k, v in b["tensors"].items():
        assert torch.equal(a["tensors"][k], v), k


if __name__ == "__main__":
    _rank_main(sys.argv[1])
