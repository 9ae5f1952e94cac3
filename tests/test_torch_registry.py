"""The PyTorch port's extension points: ``register_model`` and
``register_dataset``, on the CPU.

Mirrors ``tests/test_registry.py``: duplicate and shadowing registrations
are rejected with the JAX package's messages, a registered pair resolves,
a custom model + dataset pair drives the port's whole ``Trainer``
(checkpoint restore and exact eval included), and the built-in name
patterns are reserved. The custom pair is held against its JAX twin:
the same MLP weights (drawn once with numpy, the Flax tree mapped onto
the port's state_dict by models/convert.py) and the same numpy batches
through three StepBuilder steps, loss and parameters within f32 rtol
1e-5. Besides: the precision pack refused on a custom model, and
``decode_support_reason`` on a custom, a MoE and a pipelined config,
each with the JAX package's text.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from distributed_tensorflow_framework_torch import data as port_data
from distributed_tensorflow_framework_torch import models as port_models
from distributed_tensorflow_framework_torch.core.config import (
    DataConfig,
    ModelConfig,
)
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_load_config,
)
from distributed_tensorflow_framework_torch.data import pipeline as port_pipe
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.models.convert import (
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.models.layers import Dense
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_torch.train.step import (
    StepBuilder,
    task_for_model,
)
from distributed_tensorflow_framework_tpu import data as jax_data
from distributed_tensorflow_framework_tpu import models as jax_models
from distributed_tensorflow_framework_tpu.core.config import (
    MeshConfig,
)
from distributed_tensorflow_framework_tpu.core.config import (
    load_config as jax_load_config,
)
from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
from distributed_tensorflow_framework_tpu.data import pipeline as jax_pipe
from distributed_tensorflow_framework_tpu.data.infeed import to_global
from distributed_tensorflow_framework_tpu.train.step import (
    StepBuilder as JaxStepBuilder,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401

N_EVAL = 37
IMAGE = 8
HIDDEN = 32
# The JAX twins' names: the JAX registry is process-global, and
# tests/test_registry.py registers "tiny_mlp"/"toy_blobs" there.
JAX_MODEL, JAX_DATA = "tiny_mlp_twin", "toy_blobs_twin"


def _mlp_tree(num_classes: int) -> dict:
    """The MLP's weights as a Flax tree, from numpy (seed 0)."""
    rng = np.random.default_rng(0)
    dims = [(IMAGE * IMAGE, HIDDEN), (HIDDEN, num_classes)]
    return {f"Dense_{i}": {
        "kernel": (rng.standard_normal(d) / np.sqrt(d[0])).astype(np.float32),
        "bias": np.zeros(d[1], np.float32)} for i, d in enumerate(dims)}


class TinyMLP(nn.Module):
    """The port model: its layer names are the Flax auto-names, so
    models/convert.py maps the twin's tree onto it."""

    def __init__(self, num_classes: int, device=None):
        super().__init__()
        self.Dense_0 = Dense(IMAGE * IMAGE, HIDDEN, dtype=torch.float32,
                             device=device)
        self.Dense_1 = Dense(HIDDEN, num_classes, dtype=torch.float32,
                             device=device)

    def forward(self, x, *, train: bool = True):
        del train  # no dropout or BatchNorm
        x = x.reshape(x.shape[0], -1).float()
        return self.Dense_1(torch.relu(self.Dense_0(x)))


class JaxTinyMLP(fnn.Module):
    num_classes: int

    @fnn.compact
    def __call__(self, x, *, train: bool = True):
        tree = _mlp_tree(self.num_classes)

        def const(name, leaf):
            return lambda *_: jnp.asarray(tree[name][leaf])

        x = x.reshape((x.shape[0], -1)).astype(jnp.float32)
        x = fnn.relu(fnn.Dense(HIDDEN, kernel_init=const("Dense_0", "kernel"),
                               bias_init=const("Dense_0", "bias"))(x))
        return fnn.Dense(self.num_classes,
                         kernel_init=const("Dense_1", "kernel"),
                         bias_init=const("Dense_1", "bias"))(x)


def _make_dataset(pipe):
    """The toy_blobs factory over one package's pipeline module: images
    whose class is the sign of their mean."""

    def arrays(config, n, seed):
        rng = np.random.default_rng(seed)
        images = rng.standard_normal(
            (n, config.image_size, config.image_size, 1)).astype(np.float32)
        return images, (images.mean(axis=(1, 2, 3)) > 0).astype(np.int32)

    def build(config, process_index, process_count, *, train=True):
        b = pipe.host_batch_size(config.global_batch_size, process_count)
        if not train:
            images, labels = arrays(config, N_EVAL, seed=99)
            return pipe.finite_array_eval(
                images, labels, batch=b, process_index=process_index,
                process_count=process_count,
                out_dtype=pipe.image_np_dtype(config.image_dtype))

        def make_iter(state):
            state.setdefault("batch", 0)
            while True:
                i = state["batch"]
                images, labels = arrays(config, b,
                                        (config.seed, process_index, i))
                state["batch"] = i + 1
                yield {"image": images, "label": labels}

        return pipe.HostDataset(
            make_iter,
            element_spec={
                "image": ((b, config.image_size, config.image_size, 1),
                          np.float32),
                "label": ((b,), np.int32)},
            initial_state={"batch": 0})

    return build


@pytest.fixture(scope="module", autouse=True)
def _register():
    @port_models.register_model("tiny_mlp")
    def build_model(config, *, device=None, generator=None):
        model = TinyMLP(config.num_classes, device=device)
        model.load_state_dict(flax_to_state_dict(
            _mlp_tree(config.num_classes)))
        return model

    port_data.register_dataset("toy_blobs")(_make_dataset(port_pipe))
    jax_models.register_model(JAX_MODEL)(
        lambda config, **kw: JaxTinyMLP(num_classes=config.num_classes))
    jax_data.register_dataset(JAX_DATA)(_make_dataset(jax_pipe))
    yield
    # Registries are process-global with no unregister API.
    port_models._CUSTOM_MODELS.pop("tiny_mlp", None)
    port_data._CUSTOM_DATASETS.pop("toy_blobs", None)
    jax_models._CUSTOM_MODELS.pop(JAX_MODEL, None)
    jax_data._CUSTOM_DATASETS.pop(JAX_DATA, None)


def _messages(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("register, name", [
    ("model", "tiny_mlp"), ("model", "resnet50"), ("model", "BERT"),
    ("dataset", "toy_blobs"), ("dataset", "imagenet"),
    ("dataset", "mnist")])
def test_duplicate_and_shadow_registrations_rejected(register, name):
    """The port refuses what the JAX package refuses, with its text (the
    JAX side checked under the twin's name where the name is taken)."""
    port = {"model": port_models.register_model,
            "dataset": port_data.register_dataset}[register]
    ref = {"model": jax_models.register_model,
           "dataset": jax_data.register_dataset}[register]
    twin = {"tiny_mlp": JAX_MODEL, "toy_blobs": JAX_DATA}.get(name, name)
    got = _messages(lambda: port(name)(lambda *a, **kw: None))
    want = _messages(lambda: ref(twin)(lambda *a, **kw: None))
    assert got == want.replace(repr(twin), repr(name))
    assert "already registered" in got or "shadows a built-in" in got


def test_unknown_task_rejected():
    assert (_messages(lambda: port_models.register_model("x", task="seq"))
            == _messages(lambda: jax_models.register_model("x",
                                                           task="seq")))


def test_registered_pair_resolves():
    model = port_models.get_model(
        ModelConfig(name="tiny_mlp", num_classes=2), device="cpu")
    assert isinstance(model, TinyMLP) and not model.training
    assert model.Dense_1.weight.shape == (2, HIDDEN)
    assert task_for_model("tiny_mlp") == "classification"
    assert port_models.custom_model_task("TINY_MLP") == "classification"
    assert port_models.custom_model_task("bert") is None
    ds = port_data.get_dataset(DataConfig(
        name="toy_blobs", global_batch_size=8, image_size=IMAGE,
        channels=1))
    batch = next(ds)
    assert batch["image"].shape == (8, IMAGE, IMAGE, 1)
    # The forward gets train= from the module's mode.
    seen = []
    model.register_forward_pre_hook(
        lambda m, a, kw: seen.append(kw["train"]), with_kwargs=True)
    model(torch.zeros(1, IMAGE, IMAGE, 1))
    model.train()(torch.zeros(1, IMAGE, IMAGE, 1))
    assert seen == [False, True]


def _configs(**extra):
    over = ["mesh.data=1", "model.num_classes=2", "model.dtype=float32",
            "data.global_batch_size=16", f"data.image_size={IMAGE}",
            "data.channels=1", "data.seed=5",
            "optimizer.name=sgd_momentum", "optimizer.learning_rate=0.1",
            "optimizer.warmup_steps=0", "optimizer.schedule=constant",
            "optimizer.grad_clip_norm=0.0", "train.total_steps=3",
            "train.log_interval=1", "checkpoint.directory=",
            "resilience.rollback=false",
            *(f"{k}={v}" for k, v in extra.items())]
    return (port_load_config(overrides=over + ["model.name=tiny_mlp",
                                               "data.name=toy_blobs"]),
            jax_load_config(overrides=over + [f"model.name={JAX_MODEL}",
                                              f"data.name={JAX_DATA}"]))


def test_custom_pair_steps_match_the_jax_twin():
    """Three StepBuilder steps of the custom pair against the JAX
    StepBuilder's on the twin: the same weights, batches, losses and
    parameters."""
    pcfg, jcfg = _configs()
    ds = port_data.get_dataset(pcfg.data)
    jds = jax_data.get_dataset(jcfg.data)
    batches = [next(ds) for _ in range(3)]
    for got, want in zip(batches, (next(jds) for _ in range(3))):
        np.testing.assert_array_equal(got["image"], want["image"])
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jbuilder = JaxStepBuilder(jcfg, mesh)
    jstate = jbuilder.init_state(0, to_global(batches[0], mesh))
    jstep = jbuilder.make_train_step(to_global(batches[0], mesh))
    pbuilder = StepBuilder(pcfg, device="cpu")
    pstate = pbuilder.init_state(0)
    for i, host in enumerate(batches):
        jstate, jm = jstep(jstate, to_global(host, mesh))
        pm = pbuilder.train_step(pstate, to_device(host, torch.device("cpu")))
        jm = jax.device_get(jm)
        for key in ("loss", "top1", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), jm[key], rtol=1e-5,
                                       err_msg=f"step {i} {key}")
        ours = flatten_tree(to_flax(pstate.model))
        for path, ref in flatten_tree(
                jax.device_get(jstate.params)).items():
            np.testing.assert_allclose(ours[path], ref, rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"step {i} {path}")


def test_custom_pair_through_full_trainer(tmp_path):
    """The custom pair drives the port's whole runtime: the loss falls on
    the learnable rule, a checkpoint auto-restores, and the exact eval
    covers the custom validation set once, bit for bit after a restart."""
    ckpt = str(tmp_path / "ck")
    pcfg, _ = _configs(**{"data.global_batch_size": 64,
                          "train.total_steps": 60,
                          "train.log_interval": 20,
                          "checkpoint.directory": ckpt,
                          "checkpoint.save_interval_steps": 30,
                          "checkpoint.async_save": "false"})
    t = Trainer(pcfg, device="cpu")
    metrics = t.train()
    assert metrics["loss"] < 0.4, metrics  # the rule was learned
    results = t.evaluate()
    assert results["eval_examples"] == N_EVAL  # the full set, once
    assert results["eval_top1"] > 0.8
    t2 = Trainer(pcfg, device="cpu")
    t2.build()
    assert t2.host_step == 60
    assert t2.evaluate() == results


def test_builtin_name_patterns_reserved():
    with pytest.raises(ValueError, match="shadows a built-in"):
        port_models.register_model("resnet7")(lambda config, **kw: None)
    with pytest.raises(ValueError, match="shadows a built-in"):
        port_data.register_dataset("synthetic_foo")(lambda *a, **kw: None)
    for name in ("lenet-5", "inceptionv3", "resnet-34_cifar", "bert_base"):
        assert (port_models._is_builtin_model_name(name)
                == jax_models._is_builtin_model_name(name) is True)
    for name in ("tiny_mlp", "resnet", "lenet6", "my_bert"):
        assert (port_models._is_builtin_model_name(name)
                == jax_models._is_builtin_model_name(name))
    for name in ("synthetic", "text_mlm", "cifar10", "cifar100", "toy"):
        assert (port_data._is_builtin_dataset_name(name)
                == jax_data._is_builtin_dataset_name(name))


@pytest.mark.parametrize("knob", ["precision.activation_dtype=bf16",
                                  "precision.matmul_dtype=int8",
                                  "precision.remat_policy=save_nothing"])
def test_precision_pack_refused_on_a_custom_model(knob):
    pcfg = port_load_config(overrides=[knob, "model.name=tiny_mlp"])
    jcfg = jax_load_config(overrides=[knob, f"model.name={JAX_MODEL}"])
    with pytest.raises(ValueError) as got:
        port_models.get_model(pcfg.model, device="cpu",
                              precision=pcfg.precision)
    with pytest.raises(ValueError) as want:
        jax_models.get_model(jcfg.model, precision=jcfg.precision)
    assert str(got.value) == str(want.value).replace(JAX_MODEL, "tiny_mlp")
    with pytest.raises(ValueError, match="not threaded through custom"):
        StepBuilder(pcfg, device="cpu")


@pytest.mark.parametrize("over", [
    ["model.name=tiny_mlp"], ["model.name=resnet50"],
    ["model.name=bert", "model.num_experts=4"],
    ["model.name=bert", "model.pipeline_stages=2"], ["model.name=bert"]])
def test_decode_support_reason_matches_jax(over):
    pcfg = port_load_config(overrides=over)
    jover = [o.replace("tiny_mlp", JAX_MODEL) for o in over]
    jcfg = jax_load_config(overrides=jover)
    got = port_models.decode_support_reason(pcfg.model)
    want = jax_models.decode_support_reason(jcfg.model)
    assert got == (want and want.replace(JAX_MODEL, "tiny_mlp"))
    assert (got is None) == (over == ["model.name=bert"])
