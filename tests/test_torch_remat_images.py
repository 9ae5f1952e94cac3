"""Activation remat on the image models and the save policies
(models/remat.py; ``model.remat``, ``model.remat_policy`` and
``precision.remat_policy`` on ResNet, Inception-v3 and BERT) against the
port's own models without remat and against the JAX package's
``nn.remat``.

Mirrors ``tests/test_remat.py``. The recompute of a checkpointed block
leaves the BatchNorm running statistics alone, as JAX's ``nn.remat``
drops the replay's update; so on the CPU a model with remat, under any
policy, gives the logits, gradients and statistics of the model without
it bit for bit: the recompute runs the same kernels on the same inputs.
A ``TorchDispatchMode`` counts what the backward replays: every matrix
product under ``save_nothing``, none under ``dots_saveable``, no
convolution under ``conv_saved``.

Tolerances against the JAX models with remat (f32): the small ResNet's
train logits, gradients and statistics within 1e-5 of their largest
value, as tests/test_torch_image_models.py holds the model without remat
(JAX's own remat-against-none tolerance, tests/test_remat.py:146, is
rtol 1e-6, atol 1e-7, which the port meets exactly); an Inception block's
output and gradients at rtol 1e-4, atol 1e-5 (tests/test_remat.py:77).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_tensorflow_framework_torch.core.config import (
    ModelConfig as PortModelConfig,
    PrecisionConfig as PortPrecision,
)
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.models import inception
from distributed_tensorflow_framework_torch.models import layers as L
from distributed_tensorflow_framework_torch.models.bert import BertForMLM
from distributed_tensorflow_framework_torch.models.convert import (
    batch_stats_to_flax,
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.models.resnet import ResNet
from distributed_tensorflow_framework_tpu.core.config import (
    ModelConfig as JaxModelConfig,
)
from distributed_tensorflow_framework_tpu.models import get_model as jax_model
from distributed_tensorflow_framework_tpu.models.inception import (
    InceptionA as JaxInceptionA,
)
from distributed_tensorflow_framework_tpu.models.resnet import (
    ResNet as JaxResNet,
)
from tests.test_torch_bert import TINY
from tests.test_torch_image_models import _random_variables
from tests.test_torch_hygiene import torch_threads  # noqa: F401

aten = torch.ops.aten


def _run(model, x, generator=None):
    """Train-mode logits (the aux logits folded in), the gradients of
    their squared mean and the buffers after the step."""
    model.train()
    kw = {} if generator is None else {"dropout_generator": generator}
    out = model(x, **kw)
    if isinstance(out, dict):
        out = out["logits"] + out.get("aux_logits", 0.0)
    (out.float() ** 2).mean().backward()
    return (out.detach().clone(),
            {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()})


def _assert_same(a, b, what):
    assert torch.equal(a[0], b[0]), f"{what}: logits"
    for part, name in ((1, "grad"), (2, "buffer")):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), f"{what}: {name} {k}"


IMAGE_SIZE = {"resnet": 32, "inception": 75}


@pytest.mark.parametrize("override", [
    {"name": "inception_v3", "remat": True},
    {"name": "resnet50", "remat": True},
    {"name": "resnet101", "remat": True},
    {"name": "inception-v3", "remat": True},
    {"name": "resnet18_cifar", "remat": True},
])
def test_remat_models_build_and_equal_no_remat(override):
    """Each configuration JAX builds with remat builds here, and its
    train step (logits, gradients, BatchNorm statistics) equals the
    model's without remat bit for bit."""
    kw = dict(TINY, **override, num_classes=10, dtype="float32")
    jax_model(JaxModelConfig(**kw))
    size = IMAGE_SIZE["inception" if "inception" in kw["name"]
                      else "resnet"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32))
    runs = []
    for remat in (False, True):
        model = get_model(PortModelConfig(**dict(kw, remat=remat)),
                          device="cpu",
                          generator=torch.Generator().manual_seed(0))
        assert model.remat is remat
        if "inception" in kw["name"]:
            model.dropout_rate = 0.0
        runs.append(_run(model, x))
    _assert_same(runs[1], runs[0], kw["name"])


@pytest.mark.parametrize("name", ["resnet50", "inception_v3"])
def test_remat_models_step_through_the_step_builder(name):
    """One StepBuilder step of the model with ``model.remat`` and with
    ``precision.remat_policy`` equals the step without, parameters and
    statistics included."""
    from distributed_tensorflow_framework_torch.core.config import (
        load_config,
    )
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    size = IMAGE_SIZE["inception" if "inception" in name else "resnet"]
    base = [f"model.name={name}", "model.num_classes=10",
            "model.dtype=float32", "model.dropout_rate=0.0",
            "data.name=synthetic_images", f"data.image_size={size}",
            "data.global_batch_size=2", "mesh.data=1",
            "optimizer.name=sgd_momentum", "optimizer.warmup_steps=0"]
    arms = [[], ["model.remat=true"],
            ["model.remat=true", "precision.remat_policy=dots_saveable"]]
    out = []
    for extra in arms:
        cfg = load_config(overrides=base + extra)
        builder = StepBuilder(cfg, device="cpu")
        state = builder.init_state(0)
        batch = to_device(next(get_dataset(cfg.data)), torch.device("cpu"))
        m = builder.train_step(state, batch)
        out.append((float(m["loss"]), state.model.state_dict()))
    for loss, tensors in out[1:]:
        assert loss == out[0][0]
        for k, v in out[0][1].items():
            assert torch.equal(tensors[k], v), k


POLICIES = {"full": dict(remat=True),
            "conv_saved": dict(remat=True, remat_policy="conv_saved"),
            "save_nothing": dict(remat=True, ckpt_policy="save_nothing"),
            "dots_saveable": dict(remat=True, ckpt_policy="dots_saveable")}


def _jax_policy(kw):
    from jax.ad_checkpoint import checkpoint_policies

    policy = kw.get("ckpt_policy")
    return {"remat": True, "remat_policy": kw.get("remat_policy", "full"),
            "ckpt_policy": None if policy is None else {
                "save_nothing": checkpoint_policies.nothing_saveable,
                "dots_saveable": checkpoint_policies.dots_saveable}[policy]}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_small_resnet_remat_matches_jax_remat(policy):
    """A small ResNet (CIFAR stem, stages (1, 1), width 8) under each
    policy: bit-equal to the port's model without remat, and within the
    port-against-Flax tolerance of JAX's model with the same remat."""
    kw = POLICIES[policy]
    jm = JaxResNet(stage_sizes=(1, 1), width=8, num_classes=10,
                   dtype=jnp.float32, cifar_stem=True, **_jax_policy(kw))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    variables = _random_variables(jm, x, 4, train=False)
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        logits, new = jm.apply({"params": p, "batch_stats": stats}, x,
                               train=True, mutable=["batch_stats"])
        return (logits ** 2).mean(), (logits, new["batch_stats"])

    (_, (jlogits, jstats)), jgrads = jax.device_get(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params))
    runs = []
    for remat in (False, True):
        pm = ResNet((1, 1), 10, width=8, dtype=torch.float32,
                    cifar_stem=True, **(kw if remat else {}))
        pm.load_state_dict(flax_to_state_dict(params, stats))
        runs.append(_run(pm, torch.from_numpy(x)))
        if remat:
            model = pm
    _assert_same(runs[1], runs[0], policy)
    logits, grads, _ = runs[1]
    scale = np.abs(np.asarray(jlogits)).max()
    assert np.abs(logits.numpy() - jlogits).max() <= 1e-5 * scale
    ours = flatten_tree(batch_stats_to_flax(model))
    for path, ref in flatten_tree(jstats).items():
        assert np.abs(ours[path] - ref).max() <= 1e-5 * np.abs(ref).max()
    g_ours = flatten_tree(to_flax(model, grads))
    g_ref = flatten_tree(jgrads)
    top = max(np.abs(g).max() for g in g_ref.values())
    for path, ref in g_ref.items():
        assert np.abs(g_ours[path] - ref).max() <= 1e-5 * top, path


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_inception_block_remat_matches_jax_remat(policy):
    """One InceptionA block under remat against JAX's ``nn.remat`` of it
    (tests/test_remat.py's block parity): output, gradients and
    statistics; and bit-equal to the port's block without remat."""
    from jax.ad_checkpoint import checkpoint_policies

    from distributed_tensorflow_framework_torch.models import remat

    rng = np.random.default_rng(0)
    xb = rng.standard_normal((2, 17, 17, 64)).astype(np.float32)
    jpolicy = (None if policy is None else checkpoint_policies.dots_saveable)
    plain = JaxInceptionA(32, train=True, dtype=jnp.float32)
    jm = (fnn.remat(JaxInceptionA, policy=jpolicy)
          (32, train=True, dtype=jnp.float32))
    variables = _random_variables(plain, xb, 5)
    stats = variables["batch_stats"]

    def loss_fn(p):
        y, new = jm.apply({"params": p, "batch_stats": stats}, xb,
                          mutable=["batch_stats"])
        return (y ** 2).mean(), (y, new["batch_stats"])

    (_, (jy, jstats)), jgrads = jax.device_get(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"]))
    runs = []
    for use in (False, True):
        block = inception.InceptionA(64, 32, dtype=torch.float32)
        block.load_state_dict(flax_to_state_dict(variables["params"],
                                                 stats))
        block.train()
        x = L.nhwc_to_nchw(torch.from_numpy(xb))
        y = (remat.checkpoint(block, x, policy=policy) if use else block(x))
        (y ** 2).mean().backward()
        runs.append((y.detach().permute(0, 2, 3, 1).clone(),
                     {k: p.grad.clone() for k, p in block.named_parameters()},
                     {k: b.clone() for k, b in block.named_buffers()}))
    _assert_same(runs[1], runs[0], f"InceptionA {policy}")
    np.testing.assert_allclose(runs[1][0].numpy(), jy, rtol=1e-4, atol=1e-5)
    ours = flatten_tree(to_flax(block, runs[1][1]))
    for path, ref in flatten_tree(jgrads).items():
        np.testing.assert_allclose(ours[path], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))
    ours = flatten_tree(batch_stats_to_flax(block))
    for path, ref in flatten_tree(jstats).items():
        np.testing.assert_allclose(ours[path], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _replayed(model, x, ops, **kw):
    """How many calls of ``ops`` the backward makes beyond a model
    without remat's backward: the recompute's."""
    counts = []
    for remat in (False, True):
        m = model(remat)
        m.train()
        out = m(x, **kw)
        out = out["logits"] if isinstance(out, dict) else out
        with _Count() as c:
            out.float().sum().backward()
        counts.append(sum(c.counts.get(op, 0) for op in ops))
    return counts[1] - counts[0]


DOTS = (aten.mm.default, aten.addmm.default, aten.bmm.default,
        aten.baddbmm.default)


@pytest.mark.parametrize("policy, replays", [
    (None, "all"), ("save_nothing", "all"), ("dots_saveable", "none")])
def test_bert_policy_replays_the_products_it_should(policy, replays):
    """Under save_nothing the backward replays every matrix product of the
    encoder layers' forwards; under dots_saveable none (the xla
    attention's products are dots too, as JAX's einsums are)."""
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 16)))

    def model(remat):
        m = BertForMLM(vocab_size=64, hidden_size=32, num_layers=2,
                       num_heads=2, mlp_dim=64, max_seq_len=16,
                       dtype=torch.float32, attention_impl="xla",
                       remat=remat, ckpt_policy=policy)
        m.init_weights(torch.Generator().manual_seed(0))
        return m

    with _Count() as fwd:
        model(False).train()(ids)
    per_layer_dots = sum(fwd.counts.get(op, 0) for op in DOTS)
    got = _replayed(model, ids, DOTS)
    # Every encoder product is replayed: all but the MLM head's.
    head = 2  # mlm_transform and the tied projection
    assert got == ((per_layer_dots - head) if replays == "all" else 0)


@pytest.mark.parametrize("policy, conv_replays", [
    ("full", True), ("conv_saved", False)])
def test_resnet_conv_saved_replays_no_convolution(policy, conv_replays):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))

    def model(remat):
        m = ResNet((1, 1), 10, width=8, dtype=torch.float32, cifar_stem=True,
                   remat=remat, remat_policy=policy)
        m.init_weights(torch.Generator().manual_seed(0))
        return m

    convs = _replayed(model, x, [aten.convolution.default])
    assert (convs > 0) is conv_replays
    bns = _replayed(model, x, [aten.native_batch_norm.default,
                               aten._native_batch_norm_legit.default])
    assert bns > 0


@pytest.mark.parametrize("policy", [None, "save_nothing", "dots_saveable"])
def test_bert_remat_with_dropout_is_bit_equal(policy):
    """The trap of the selective contexts: BERT's recompute replays its
    dropout masks from the caller's generator on both sides of the
    composed contexts, so with dropout 0.1 the gradients and the
    generator's state after the step are those without remat."""
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 16)))
    runs, states = [], []
    for remat in (False, True):
        m = BertForMLM(vocab_size=64, hidden_size=32, num_layers=2,
                       num_heads=2, mlp_dim=64, max_seq_len=16,
                       dropout_rate=0.1, dtype=torch.float32,
                       attention_impl="pallas", remat=remat,
                       ckpt_policy=policy)
        m.init_weights(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(7)
        runs.append(_run(m, ids, generator=gen))
        states.append(gen.get_state())
    _assert_same(runs[1], runs[0], f"bert {policy}")
    assert torch.equal(states[0], states[1])


def test_remat_is_inert_without_grad():
    """Under no_grad (eval, serving) the blocks run plainly: no
    checkpoint, and train-mode statistics move once."""
    x = torch.randn(2, 16, 16, 3)
    models = []
    for remat in (False, True):
        m = ResNet((1, 1), 10, width=8, dtype=torch.float32, cifar_stem=True,
                   remat=remat)
        m.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            m.train()(x)
        models.append(m)
    for (k, a), b in zip(models[0].named_buffers(), models[1].buffers()):
        assert torch.equal(a, b), k


def test_precision_policy_threads_into_the_models():
    prec = PortPrecision(remat_policy="dots_saveable")
    meta = torch.device("meta")
    from distributed_tensorflow_framework_torch.models import build_model

    resnet = build_model(PortModelConfig(name="resnet50", remat=True),
                         device=meta, precision=prec)
    assert resnet.block_policy == "dots_saveable"
    assert build_model(PortModelConfig(
        name="resnet50", remat=True, remat_policy="conv_saved"),
        device=meta).block_policy == "conv_saved"
    inc = build_model(PortModelConfig(name="inception_v3", remat=True),
                      device=meta, precision=prec)
    assert inc.ckpt_policy == "dots_saveable"
    bert = build_model(PortModelConfig(name="bert", remat=True),
                       device=meta, precision=prec)
    assert bert.ckpt_policy == "dots_saveable"


@pytest.mark.parametrize("policy", ["save_nothing", "dots_saveable"])
def test_tiny_bert_steps_with_a_remat_policy_equal_the_plain_steps(policy):
    """``precision.remat_policy`` beside ``model.remat`` on the tiny BERT
    of tests/test_torch_remat.py (dropout 0.1): JAX's get_model builds it,
    and two StepBuilder steps give the losses and parameters of the steps
    without remat, bit for bit."""
    import dataclasses

    from distributed_tensorflow_framework_torch.core.config import (
        load_config,
    )
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder
    from distributed_tensorflow_framework_tpu.core.config import (
        PrecisionConfig as JaxPrecision,
    )
    from tests.test_torch_remat import TINY_BERT as REMAT_BERT

    arms = {"plain": [], "policy": ["model.remat=true",
                                    f"precision.remat_policy={policy}"]}
    out = {}
    for name, extra in arms.items():
        cfg = load_config(overrides=REMAT_BERT + extra)
        if name == "policy":
            jax_model(JaxModelConfig(**dataclasses.asdict(cfg.model)),
                      precision=JaxPrecision(
                          **dataclasses.asdict(cfg.precision)))
        builder = StepBuilder(cfg, device="cpu")
        state = builder.init_state(0)
        ds = get_dataset(cfg.data)
        losses = [float(builder.train_step(state, to_device(
            next(ds), torch.device("cpu")))["loss"]) for _ in range(2)]
        out[name] = (losses, state.model.state_dict())
    assert out["policy"][0] == out["plain"][0]
    for k, v in out["plain"][1].items():
        assert torch.equal(out["policy"][1][k], v), k
