"""The port's image models (LeNet-5, ResNet; Inception-v3 and the image
StepBuilder steps at the end, from helpers in test_torch_inception.py and
test_torch_train_image.py) against the JAX package's.

The same numpy inputs and the same weights (carried by models/convert.py)
go through the Flax module and the port's. A small ResNet
(``stage_sizes=(1, 1)``, width 8) is built directly in both packages with
each of its three stems, on 32×32 inputs, so that the stride-2 convs pad
asymmetrically (XLA SAME) and the stem's max-pool does too. The weights
are drawn with numpy from the Flax shapes (no BN scale is zero, so every
gradient is alive), and each JAX reference is one jitted call.

Tolerances, with their reasons (all f32):
  * forward outputs (train and eval mode): within 1e-5 of the largest
    |logit| — f32 convolutions and reductions summed in other orders
    (observed ≤ 1.1e-6);
  * the updated ``batch_stats``: within 1e-5 of each leaf's largest value
    (observed ≤ 4.3e-6; the variance is E[x²] − E[x]² in Flax and a
    Welford sum in torch);
  * gradients: within 1e-5 of the step's largest gradient;
  * the convert round trip and the decay mask: exact;
  * the space-to-depth stem against the 7×7/s2 conv: rtol 1e-5, atol
    1e-5 (the products are reassociated), as tests/test_s2d_stem.py.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_tensorflow_framework_torch.core.config import (
    ModelConfig as PortModelConfig,
)
from distributed_tensorflow_framework_torch.models import (
    build_model,
    get_model,
)
from distributed_tensorflow_framework_torch.models import layers as L
from distributed_tensorflow_framework_torch.models.convert import (
    batch_stats_to_flax,
    flatten_tree,
    flax_layout,
    flax_stats_layout,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.models.lenet import LeNet5
from distributed_tensorflow_framework_torch.models.resnet import (
    ResNet,
    make_resnet,
)
from distributed_tensorflow_framework_torch.train import losses as port_losses
from distributed_tensorflow_framework_torch.train.optimizers import (
    decay_mask,
)
from distributed_tensorflow_framework_tpu.models import layers as jax_layers
from distributed_tensorflow_framework_tpu.models.lenet import (
    LeNet5 as JaxLeNet5,
)
from distributed_tensorflow_framework_tpu.models.resnet import (
    ResNet as JaxResNet,
)
from distributed_tensorflow_framework_tpu.train import losses as jax_losses
from distributed_tensorflow_framework_tpu.train import (
    optimizers as jax_optimizers,
)
from tests.test_torch_inception import (
    _three_steps_with_the_aux_loss_match_the_jax_step_builder,
    _train_and_eval_match_flax,
)
from tests.test_torch_train_image import (  # small_resnet: a fixture
    _three_steps_match_the_jax_step_builder,
    small_resnet,  # noqa: F401
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401

STEMS = {"cifar": dict(cifar_stem=True), "7x7": {},
         "s2d": dict(space_to_depth_stem=True)}


def _random_variables(module, x, seed, **kw):
    """Flax variables for ``module`` on input ``x``, drawn with numpy from
    the shapes alone (``jax.eval_shape``: nothing is compiled): kernels
    normal with std √(1/fan_in), BN scales 1 ± 0.1, biases ± 0.1, running
    means ± 0.1 and variances in [0.5, 1.5]. No BN scale is zero, so
    every gradient is alive."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), x, **kw))

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            std = (1.0 / np.prod(s.shape[:-1])) ** 0.5
            a = std * rng.standard_normal(s.shape)
        elif name in ("scale", "var"):
            a = 1.0 + (0.1 if name == "scale" else 0.5) * (
                2 * rng.random(s.shape) - 1)
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(got, ref, scale, what):
    err = np.abs(np.asarray(got) - np.asarray(ref)).max()
    assert err <= 1e-5 * scale, f"{what}: {err:.2e} of {scale:.2e}"


# ------------------------------------------------------------ the traps

@pytest.mark.parametrize("size, kernel, stride", [
    (32, 3, 2), (224, 7, 2), (112, 3, 2), (16, 1, 2), (32, 3, 1),
    (28, 5, 1), (7, 3, 2)])
def test_same_pads_are_xla_s(size, kernel, stride):
    ref = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert L.same_pads(size, kernel, stride) == tuple(ref[0])


def test_stride2_same_conv_pads_asymmetrically_like_flax():
    """Trap 1: a 3×3/s2 SAME conv on 32×32 pads (0, 1). The port's Conv
    equals Flax's; a symmetric ``padding=1`` conv with the same weight
    gives another output of the same shape."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    conv = fnn.Conv(8, (3, 3), strides=(2, 2), padding="SAME",
                    use_bias=False)
    params = _random_variables(conv, x, 0)
    ref = np.asarray(conv.apply(params, x)).transpose(0, 3, 1, 2)
    port = L.Conv(3, 8, (3, 3), strides=(2, 2))
    port.load_state_dict(flax_to_state_dict(params["params"]))
    xt = L.nhwc_to_nchw(torch.from_numpy(x))
    got = port(xt).detach().numpy()
    assert got.shape == ref.shape == (2, 8, 16, 16)
    _close(got, ref, np.abs(ref).max(), "SAME conv")
    symmetric = F.conv2d(xt, port.weight, stride=2, padding=1).detach()
    assert symmetric.shape == got.shape
    assert np.abs(symmetric.numpy() - ref).max() > 1e-2


def test_batchnorm_running_var_is_biased_like_flax():
    """Trap 2: Flax's running variance takes the biased batch variance;
    ``F.batch_norm``'s own update takes the unbiased one. The port's
    BatchNorm equals Flax's output and updated ``batch_stats``."""
    rng = np.random.default_rng(1)
    x = (2 + 3 * rng.standard_normal((4, 3, 3, 5))).astype(np.float32)
    bn = jax_layers.BatchNorm(use_running_average=False)
    variables = _random_variables(bn, x, 2)
    ref, new = bn.apply(variables, x, mutable=["batch_stats"])
    port = L.BatchNorm(5).train()
    port.load_state_dict({k.removeprefix("bn."): v for k, v in
                          flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]).items()})
    xt = L.nhwc_to_nchw(torch.from_numpy(x))
    got = port(xt).detach().permute(0, 2, 3, 1).numpy()
    _close(got, ref, np.abs(np.asarray(ref)).max(), "BN output")
    ref_var = np.asarray(new["batch_stats"]["bn"]["var"])
    _close(port.running_var.numpy(), ref_var, ref_var.max(), "running var")
    _close(port.running_mean.numpy(), new["batch_stats"]["bn"]["mean"],
           np.abs(np.asarray(new["batch_stats"]["bn"]["mean"])).max(),
           "running mean")
    unbiased = torch.from_numpy(variables["batch_stats"]["bn"]["var"].copy())
    F.batch_norm(xt, torch.zeros(5), unbiased, training=True, momentum=0.1)
    assert np.abs(unbiased.numpy() - ref_var).max() > 1e-2


# ------------------------------------------------------ models vs Flax

def _resnet_pair(stem):
    jm = JaxResNet(stage_sizes=(1, 1), width=8, num_classes=10,
                   dtype=jnp.float32, **STEMS[stem])
    pm = ResNet((1, 1), 10, width=8, dtype=torch.float32, **STEMS[stem])
    return jm, pm


@pytest.mark.parametrize("stem", sorted(STEMS))
def test_small_resnet_matches_flax(stem):
    """Train-mode logits, gradients and updated ``batch_stats``, then the
    eval-mode logits on those statistics, for each stem."""
    jm, pm = _resnet_pair(stem)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 7, 3, 9], np.int32)
    variables = _random_variables(jm, x, 4, train=False)
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        logits, new = jm.apply({"params": p, "batch_stats": stats}, x,
                               train=True, mutable=["batch_stats"])
        loss, _ = jax_losses.classification_loss(logits, labels)
        return loss, (logits, new["batch_stats"])

    @jax.jit
    def reference(p):
        (loss, (logits, new)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        return loss, logits, new, grads, jm.apply(
            {"params": p, "batch_stats": new}, x, train=False)

    jloss, jlogits, jstats, jgrads, jeval = jax.device_get(
        reference(params))

    pm.load_state_dict(flax_to_state_dict(params, stats))
    pm.train()
    logits = pm(torch.from_numpy(x))
    loss, _ = port_losses.classification_loss(logits,
                                              torch.from_numpy(labels))
    loss.backward()
    scale = np.abs(np.asarray(jlogits)).max()
    _close(logits.detach().numpy(), jlogits, scale, "train logits")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    ours = flatten_tree(batch_stats_to_flax(pm))
    for path, ref in flatten_tree(jax.device_get(jstats)).items():
        _close(ours[path], ref, np.abs(ref).max(), f"stats {path}")
    g_ours = flatten_tree(to_flax(pm, {k: p.grad for k, p in
                                       pm.named_parameters()}))
    g_ref = flatten_tree(jax.device_get(jgrads))
    assert g_ours.keys() == g_ref.keys()
    top = max(np.abs(g).max() for g in g_ref.values())
    for path, ref in g_ref.items():
        _close(g_ours[path], ref, top, f"grad {path}")
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    _close(got, jeval, np.abs(np.asarray(jeval)).max(), "eval logits")


def test_lenet_matches_flax():
    """Forward and gradients; fc1 reads its 400 inputs in the Flax (h, w,
    c) order, so the Flax kernel carries over unpermuted."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 28, 28, 1)).astype(np.float32)
    labels = np.array([0, 4, 2, 8], np.int32)
    jm = JaxLeNet5(num_classes=10)
    params = _random_variables(jm, x, 6)["params"]

    def loss_fn(p):
        logits = jm.apply({"params": p}, x)
        return jax_losses.classification_loss(logits, labels)[0], logits

    (_, jlogits), jgrads = jax.device_get(jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params))
    pm = LeNet5(10)
    pm.load_state_dict(flax_to_state_dict(params))
    logits = pm(torch.from_numpy(x))
    port_losses.classification_loss(
        logits, torch.from_numpy(labels))[0].backward()
    _close(logits.detach().numpy(), jlogits,
           np.abs(np.asarray(jlogits)).max(), "logits")
    g_ours = flatten_tree(to_flax(pm, {k: p.grad for k, p in
                                       pm.named_parameters()}))
    g_ref = flatten_tree(jax.device_get(jgrads))
    top = max(np.abs(g).max() for g in g_ref.values())
    for path, ref in g_ref.items():
        _close(g_ours[path], ref, top, f"grad {path}")
    # A channel-major flatten would read fc1's rows in another order.
    assert flax_layout(pm)["fc1.weight"] == (("fc1", "kernel"), (400, 120))


@pytest.mark.parametrize("which", ["lenet", "resnet"])
def test_convert_round_trip_is_exact(which):
    """Flax tree → state_dict → Flax tree, parameters and batch_stats,
    with the Flax names and shapes of the JAX module's own tree."""
    if which == "lenet":
        jm, pm = JaxLeNet5(num_classes=10), LeNet5(10)
        x = np.zeros((1, 28, 28, 1), np.float32)
    else:
        jm, pm = _resnet_pair("s2d")
        x = np.zeros((1, 32, 32, 3), np.float32)
    variables = jax.eval_shape(lambda: jm.init(jax.random.key(0), x,
                                               train=False))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), variables["params"])
    stats = jax.tree.map(lambda s: rng.random(s.shape).astype(np.float32),
                         variables.get("batch_stats", {}))
    pm.load_state_dict(flax_to_state_dict(params, stats))
    for ref, got in ((params, to_flax(pm)), (stats, batch_stats_to_flax(pm))):
        ref, got = flatten_tree(ref), flatten_tree(got)
        assert ref.keys() == got.keys()
        for path in ref:
            np.testing.assert_array_equal(got[path], ref[path])
    assert len(flax_stats_layout(pm)) == 2 * sum(
        isinstance(m, L.BatchNorm) for m in pm.modules())


@pytest.mark.parametrize("which", ["lenet", "resnet"])
def test_decay_mask_matches_jax(which):
    """Conv and dense kernels decay; biases and every BN leaf do not."""
    pm = LeNet5(10) if which == "lenet" else _resnet_pair("7x7")[1]
    ours = {flax_layout(pm)[k][0]: v for k, v in decay_mask(pm).items()}
    ref = flatten_tree(jax_optimizers.decay_mask_tree(to_flax(pm)))
    assert ours == {path: bool(v) for path, v in ref.items()}
    assert any(ours.values()) and not all(ours.values())


# ------------------------------------------------------ the port alone

def test_golden_parameter_counts():
    def count(model):
        return sum(p.numel() for p in model.parameters())

    assert count(LeNet5(10)) == 61_706
    assert count(make_resnet(50, 1000, device="meta")) == 25_557_032
    s2d = make_resnet(50, 1000, space_to_depth_stem=True, device="meta")
    assert count(s2d) == 25_557_032 - 9_408 + 12_288


def test_resnet_init_is_the_jax_recipe():
    """He-normal convs (std √(2/fan_out)), zero gamma on each block's last
    BN, unit gamma elsewhere, zero running mean and unit running var."""
    model = get_model(PortModelConfig(name="resnet50_cifar", num_classes=10,
                                      dtype="float32"), device="cpu")
    w = model.stage3_block1.conv2.conv.weight
    np.testing.assert_allclose(w.std().item(), (2 / (9 * 256)) ** 0.5,
                               rtol=0.05)
    block = model.stage1_block2
    assert (block.conv3.bn.weight == 0).all()
    assert (block.conv1.bn.weight == 1).all()
    assert (block.conv1.bn.running_var == 1).all()
    assert not block.conv1.bn.running_mean.any()
    assert model.stage1_block1.proj is not None and block.proj is None
    assert not model.training


def test_space_to_depth_layout():
    x = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(2, 4, 4, 3)
    y = L.space_to_depth(x, 2)
    assert y.shape == (2, 2, 2, 12)
    for di in range(2):
        for dj in range(2):
            for c in range(3):
                torch.testing.assert_close(y[..., (di * 2 + dj) * 3 + c],
                                           x[:, di::2, dj::2, c])
    with pytest.raises(ValueError):
        L.space_to_depth(torch.zeros(1, 5, 4, 3), 2)


def _s2d_kernel(w7):
    """(7,7,C,F) → the (4,4,4C,F) kernel of the equivalent s2d conv
    (tests/test_s2d_stem.py)."""
    c, f = w7.shape[2:]
    w8 = np.zeros((8, 8, c, f), w7.dtype)
    w8[:7, :7] = w7
    ws2d = np.zeros((4, 4, 4 * c, f), w7.dtype)
    for a in range(4):
        for e in range(4):
            for bi in range(2):
                for bj in range(2):
                    k = (bi * 2 + bj) * c
                    ws2d[a, e, k:k + c] = w8[2 * a + bi, 2 * e + bj]
    return ws2d


def test_s2d_conv_reproduces_the_7x7_stride2_conv():
    """The s2d stem's 4×4/s1 conv, padded ((1,2),(1,2)), on the
    space-to-depth input equals the 7×7/s2 SAME conv (pads (2, 3) at 224,
    (2, 3) at 32)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    w7 = rng.standard_normal((7, 7, 3, 16)).astype(np.float32)
    conv7 = L.Conv(3, 16, (7, 7), strides=(2, 2))
    conv4 = L.Conv(12, 16, (4, 4), padding=((1, 2), (1, 2)))
    conv7.load_state_dict(flax_to_state_dict({"kernel": w7}))
    conv4.load_state_dict(flax_to_state_dict({"kernel": _s2d_kernel(w7)}))
    ref = conv7(L.nhwc_to_nchw(x))
    got = conv4(L.nhwc_to_nchw(L.space_to_depth(x, 2)))
    assert ref.shape == got.shape == (2, 16, 16, 16)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_max_pool_same_pads_with_minus_infinity():
    """3×3/s2 SAME on 8×8 pads (0, 1) with −inf: an all-negative input
    pools to its own values, never to a pad."""
    x = -1 - torch.rand(1, 2, 8, 8)
    y = L.max_pool_same(x, 3, 2)
    assert y.shape == (1, 2, 4, 4)
    assert (y < -1).all()
    torch.testing.assert_close(y[..., 0, 0], x[..., :3, :3].amax((-1, -2)))
    torch.testing.assert_close(y[..., 3, 3], x[..., 6:, 6:].amax((-1, -2)))


@pytest.mark.parametrize("kw, err, match", [
    (dict(name="lenet5", space_to_depth_stem=True), ValueError,
     "space_to_depth_stem"),
    (dict(name="resnet50_cifar", space_to_depth_stem=True), ValueError,
     "ImageNet stem"),
    (dict(name="lenet5", remat=True), ValueError, "model.remat"),
    (dict(name="resnet50", remat_policy="conv_saved"), ValueError,
     "remat_policy"),
    (dict(name="resnet51"), ValueError, "depth"),
    (dict(name="vgg16"), ValueError, "Unknown model"),
])
def test_get_model_refusals(kw, err, match):
    with pytest.raises(err, match=match):
        get_model(PortModelConfig(**kw), device="cpu")


@pytest.mark.parametrize("name, cifar, blocks", [
    ("lenet", None, 0), ("lenet-5", None, 0), ("resnet18", False, 8),
    ("resnet-50_cifar", True, 16), ("ResNet101", False, 33)])
def test_build_model_dispatches_like_jax(name, cifar, blocks):
    model = build_model(PortModelConfig(name=name, dtype="float32"),
                        device=torch.device("meta"))
    assert isinstance(model, LeNet5 if cifar is None else ResNet)
    if cifar is not None:
        assert model.cifar_stem == cifar
        assert len(model.block_names) == blocks


# Inception-v3 against Flax and the image StepBuilder steps against the
# JAX StepBuilder: the helpers, and their tolerances, are in
# tests/test_torch_inception.py and tests/test_torch_train_image.py. They
# run from this file, which holds many tests, because xdist's
# ``--dist loadfile`` hands out the files with the fewest tests last, and
# these ~10 minutes of work, run from files of a few tests, held the end of
# the suite's run.


@pytest.mark.parametrize("size, batch", [(75, 4), (139, 3), (299, 2)])
def test_train_and_eval_match_flax(size, batch):
    """Inception-v3 in train mode: logits, aux logits, the updated
    batch_stats and every gradient of a loss on both heads, against Flax
    in f64 beside Flax in f32; eval mode: the logits (no aux head) against
    Flax's f32."""
    _train_and_eval_match_flax(size, batch)


def test_three_steps_with_the_aux_loss_match_the_jax_step_builder(
        monkeypatch):
    """Inception-v3 with config 4's optimizer and label smoothing at 75 x
    75: the port's StepBuilder against the JAX StepBuilder in f64, beside
    the JAX StepBuilder in f32, from the same initial variables."""
    _three_steps_with_the_aux_loss_match_the_jax_step_builder(monkeypatch)


@pytest.mark.parametrize("model, accum", [("lenet", 1), ("resnet", 1),
                                          ("resnet", 2)])
def test_three_steps_match_the_jax_step_builder(request, model, accum):
    """LeNet-5 and the small ResNet: three StepBuilder steps against the
    JAX StepBuilder's (SGD with momentum, label smoothing, accumulation)."""
    _three_steps_match_the_jax_step_builder(request, model, accum)
