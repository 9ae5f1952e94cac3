"""The precision pack (``precision.*``; models/layers.py
``quantized_matmul``, ``QuantDense``, ``QuantConv``, models/__init__.py
``check_precision``) against the JAX package.

Mirrors ``tests/test_precision.py`` (its bf16, int8 and checkpoint arms;
the fused update is tests/test_torch_fused_update.py's) and the JAX
``get_model``'s refusals. Inputs are seeded numpy arrays; the JAX
functions run jitted on the CPU.

Two findings about the reference are reproduced, not "fixed":

  * ``quantized_matmul``'s gradient flows through the block scales alone
    (``rint``, ``clip`` and the int8 casts carry none), so ``dx`` and
    ``dw`` are nonzero only at each block's max-abs elements: 2 per row
    of ``dx`` at K = 300 and block 256. It is not a straight-through
    estimator.
  * under ``jit`` XLA computes ``amax / 127.0`` as ``amax · f32(1/127)``,
    which differs from a true division on some values; and it fuses each
    block's rescale into the sum over blocks as one FMA.

Tolerances. Exact: ``quantized_matmul``, ``QuantDense`` and ``QuantConv``
forwards against the jitted JAX functions (the same f32 operations in
XLA's order), the block scales, the nonzero pattern of the gradients,
remat-free refusals. The gradients: rtol 1e-6 with an absolute floor of
1e-6 of the tensor's largest element — the products' sums over N (for
``dx``) and M (for ``dw``) run in other orders than XLA's, and cancel
(``assert_allclose`` below). ConvBN under int8 in train mode: the conv
output exact, the BatchNorm after it within 1e-5 of the largest value
(the f32 statistics summed in other orders). The LeNet steps against the
JAX StepBuilder: f32 losses rtol 1e-5; the bf16 and int8 arms' losses
within 5e-3, as tests/test_precision.py pins bf16 against f32 (bf16
convolutions round in other places on the two sides, and a rounding
that moves a value across an int8 step moves the product by a
quantum).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.cli import train as port_cli
from distributed_tensorflow_framework_torch.core.config import (
    ModelConfig as PortModelConfig,
    PrecisionConfig as PortPrecision,
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.models import build_model
from distributed_tensorflow_framework_torch.models import layers as L
from distributed_tensorflow_framework_torch.models.convert import (
    flatten_tree,
    flax_to_state_dict,
)
from distributed_tensorflow_framework_tpu.core.config import (
    ModelConfig as JaxModelConfig,
    PrecisionConfig as JaxPrecision,
)
from distributed_tensorflow_framework_tpu.models import get_model as jax_model
from distributed_tensorflow_framework_tpu.models import layers as jax_layers
from tests.test_torch_hygiene import torch_threads  # noqa: F401
from tests.test_torch_train import CLI_TINY, TINY_BERT, _cli_args

GRAD_RTOL = 1e-6


def _grads_close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(ref).max(),
                               err_msg=what)


def _jax_qm(block):
    def f(x, w):
        return jax_layers.quantized_matmul(x, w, block_size=block)
    return jax.jit(f)


def _jax_qm_grads(block, g):
    def loss(x, w):
        return jnp.sum(jax_layers.quantized_matmul(x, w, block_size=block)
                       * g)
    return jax.jit(jax.grad(loss, argnums=(0, 1)))


def _port_qm(x, w, g, block):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = L.quantized_matmul(xt, wt, block)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _operands(m, k, n, seed, lead=()):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(lead + (m, k))
         * np.logspace(-2, 2, m)[:, None]).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    g = rng.standard_normal(lead + (m, n)).astype(np.float32)
    return x, w, g


# ------------------------------------------------------ quantized_matmul

@pytest.mark.parametrize("m, k, n, block, lead", [
    (4, 300, 5, 256, ()), (64, 1000, 37, 256, ()), (33, 400, 120, 256, ()),
    (7, 64, 3, 16, (2,)), (20, 256, 84, 256, ())])
def test_quantized_matmul_is_the_jitted_jax_function(m, k, n, block, lead):
    x, w, g = _operands(m, k, n, 0, lead)
    y, dx, dw = _port_qm(x, w, g, block)
    ref = np.asarray(_jax_qm(block)(x, w))
    np.testing.assert_array_equal(y, ref)
    rdx, rdw = (np.asarray(a) for a in _jax_qm_grads(block, g)(x, w))
    np.testing.assert_array_equal(dx != 0, rdx != 0)
    np.testing.assert_array_equal(dw != 0, rdw != 0)
    _grads_close(dx, rdx, "dx")
    _grads_close(dw, rdw, "dw")


def test_quantized_matmul_gradient_reaches_only_the_block_maxima():
    """Finding 1: at K = 300 and block 256 (two blocks, the second padded)
    ``dx`` has exactly one nonzero per block of each row, at that block's
    max-abs element, and ``dw`` one per block of each column."""
    x, w, g = _operands(4, 300, 5, 1)
    _, dx, dw = _port_qm(x, w, g, 256)
    rdx, rdw = (np.asarray(a) for a in _jax_qm_grads(256, g)(x, w))
    assert ((dx != 0).sum(axis=1) == 2).all()
    assert ((dw != 0).sum(axis=0) == 2).all()
    np.testing.assert_array_equal(dx != 0, rdx != 0)
    np.testing.assert_array_equal(dw != 0, rdw != 0)
    for lo, hi in ((0, 256), (256, 300)):
        assert (np.abs(x[:, lo:hi]).argmax(1) == (dx[:, lo:hi] != 0).argmax(
            1)).all()
        assert (np.abs(w[lo:hi]).argmax(0) == (dw[lo:hi] != 0).argmax(
            0)).all()


def test_block_scales_are_xlas_reciprocal_multiply():
    """Finding 2: the jitted ``where(amax > 0, amax / 127.0, 1.0)`` is
    ``amax · f32(1/127)``; a true division differs on some values."""
    amax = np.abs(np.random.default_rng(2).standard_normal(200_000)
                  ).astype(np.float32)
    amax[:3] = 0.0
    ref = np.asarray(jax.jit(
        lambda a: jnp.where(a > 0.0, a / 127.0, 1.0))(amax))
    got = L._block_scales(torch.from_numpy(amax)).numpy()
    np.testing.assert_array_equal(got, ref)
    true = np.where(amax > 0, (amax.astype(np.float64) / 127.0).astype(
        np.float32), np.float32(1.0))
    assert (true != ref).sum() > 1000
    assert (got[:3] == 1.0).all()


def test_int_block_products_are_exact_at_the_largest_sums():
    """±127 operands over a whole block of 256: the f32 product is the
    integer one (|sum| ≤ 4,129,024 < 2²⁴)."""
    rng = np.random.default_rng(4)
    xq = rng.choice([-127.0, 127.0], (24, 3, 256)).astype(np.float32)
    wq = rng.choice([-127.0, 127.0], (3, 256, 9)).astype(np.float32)
    xq[0, 0], wq[0, :, 0] = 127.0, 127.0
    got = L.block_products(torch.from_numpy(xq), torch.from_numpy(wq))
    want = np.einsum("mbk,bkn->mbn", xq.astype(np.int64),
                     wq.astype(np.int64))
    assert want[0, 0, 0] == 256 * 127 * 127
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def test_quantized_matmul_error_bound():
    """JAX tests/test_precision.py's bound: each block's product is off by
    at most (bx·|w| + bw·|x| + bx·bw/254)·block/254 summed over blocks."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((32, 500)) *
         np.logspace(-1, 1, 32)[:, None]).astype(np.float32)
    w = rng.standard_normal((500, 24)).astype(np.float32)
    block = 64
    exact = x @ w
    got = L.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             block).numpy()
    nb = -(-x.shape[1] // block)
    xp = np.pad(x, ((0, 0), (0, nb * block - x.shape[1])))
    wp = np.pad(w, ((0, nb * block - w.shape[0]), (0, 0)))
    xb = xp.reshape(x.shape[0], nb, block)
    wb = wp.reshape(nb, block, w.shape[1])
    bx = np.abs(xb).max(axis=2)
    bw = np.abs(wb).max(axis=1)
    cross = (np.einsum("mb,bn->mn", bx, np.abs(wb).sum(axis=1))
             + np.einsum("mbk,bn->mn", np.abs(xb), bw)
             + block * np.einsum("mb,bn->mn", bx, bw) / 254) / 254
    err = np.abs(got - exact)
    assert (err <= cross + 1e-5).all(), float((err - cross).max())
    assert err.max() / np.abs(exact).max() < 0.05


def test_quantized_matmul_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="quantized_matmul"):
        L.quantized_matmul(torch.zeros(2, 5), torch.zeros(4, 3))


# -------------------------------------------------- QuantDense, QuantConv

@pytest.mark.parametrize("features, dtype", [(84, "float32"),
                                             (120, "bfloat16")])
def test_quant_dense_matches_jax(features, dtype):
    """The Dense parameters (so models/convert.py carries them as they
    are), the forward bit for bit, the gradients within GRAD_RTOL."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 400)).astype(np.float32)
    jd = jax_layers.QuantDense(features, dtype=jnp.dtype(dtype))
    variables = jax.tree.map(np.asarray, jd.init(jax.random.key(0), x))
    variables["params"]["bias"] = rng.standard_normal(
        features).astype(np.float32)
    g = rng.standard_normal((6, features)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jd.apply({"params": p}, x).astype(jnp.float32) * g)

    ref = np.asarray(jax.jit(jd.apply)(variables, x).astype(jnp.float32))
    rgrads, rdx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables["params"], x)
    port = L.QuantDense(400, features, dtype=getattr(torch, dtype))
    assert isinstance(port, L.Dense)
    port.load_state_dict(flax_to_state_dict(variables["params"]))
    xt = torch.tensor(x, requires_grad=True)
    y = port(xt)
    (y.float() * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.float().detach().numpy(), ref)
    _grads_close(port.weight.grad.t().numpy(), rgrads["kernel"], "kernel")
    _grads_close(port.bias.grad.numpy(), rgrads["bias"], "bias")
    _grads_close(xt.grad.numpy(), rdx, "dx")


CONVS = {
    "3x3_s1_same": ((3, 3), (1, 1), "SAME", 8, 16, 9),
    "3x3_s2_same": ((3, 3), (2, 2), "SAME", 40, 8, 9),
    "1x1_s2_valid": ((1, 1), (2, 2), "VALID", 300, 12, 8),
    "3x3_s1_valid": ((3, 3), (1, 1), "VALID", 30, 8, 7),
    "s2d_stem": ((4, 4), (1, 1), ((1, 2), (1, 2)), 12, 16, 8),
    "7x7_s2_same": ((7, 7), (2, 2), "SAME", 3, 8, 16),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_quant_conv_matches_jax(case):
    """The im2col contraction in (cin, kh, kw) order on the same blocks as
    JAX's: the forward bit for bit at stride 1 and 2, SAME, VALID and the
    s2d stem's explicit pads; the gradients within GRAD_RTOL."""
    kernel, strides, padding, cin, cout, hw = CONVS[case]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    jc = jax_layers.QuantConv(cout, kernel, strides=strides, padding=padding)
    variables = jax.tree.map(np.asarray, jc.init(jax.random.key(0), x))
    ref = np.asarray(jax.jit(jc.apply)(variables, x))
    g = rng.standard_normal(ref.shape).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jc.apply({"params": p}, x) * g)

    rgrads, rdx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        variables["params"], x)
    port = L.QuantConv(cin, cout, kernel, strides=strides, padding=padding)
    assert isinstance(port, L.Conv)
    port.load_state_dict(flax_to_state_dict(variables["params"]))
    xt = torch.tensor(x, requires_grad=True)
    y = port(L.nhwc_to_nchw(xt)).permute(0, 2, 3, 1)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), ref)
    _grads_close(port.weight.grad.permute(2, 3, 1, 0).numpy(),
                 rgrads["kernel"], "kernel")
    _grads_close(xt.grad.numpy(), rdx, "dx")


def test_convbn_int8_matches_jax_in_train_mode():
    """ConvBN(matmul_dtype="int8"): the QuantConv under the conv's own
    parameter, the marker, then BatchNorm and ReLU; output and updated
    statistics against Flax."""
    from distributed_tensorflow_framework_torch.models.convert import (
        batch_stats_to_flax,
    )

    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 8, 8, 16)).astype(np.float32)
    jm = jax_layers.ConvBN(24, (3, 3), strides=(2, 2), matmul_dtype="int8")
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(1), x))
    ref, new = jax.jit(lambda v, x: jm.apply(v, x, mutable=["batch_stats"]))(
        variables, x)
    port = L.ConvBN(16, 24, (3, 3), strides=(2, 2), matmul_dtype="int8")
    assert isinstance(port.conv, L.QuantConv)
    port.load_state_dict({k.removeprefix("convbn."): v for k, v in
                          flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]).items()})
    port.train()
    got = port(L.nhwc_to_nchw(torch.from_numpy(x))).detach().permute(
        0, 2, 3, 1).numpy()
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    ours = flatten_tree(batch_stats_to_flax(port))
    for path, r in flatten_tree(jax.device_get(new["batch_stats"])).items():
        assert np.abs(ours[path] - r).max() <= 1e-5 * np.abs(r).max(), path


def test_int8_models_quantize_what_jax_quantizes():
    """LeNet's fc1 and fc2 and every ResNet ConvBN take the int8 codec;
    LeNet's logits and the ResNet classifier stay f32; the parameters
    are the f32 layout of the model without int8, name for name."""
    prec = PortPrecision(matmul_dtype="int8")
    meta = torch.device("meta")
    lenet = build_model(PortModelConfig(name="lenet5"), device=meta,
                        precision=prec)
    assert isinstance(lenet.fc1, L.QuantDense)
    assert isinstance(lenet.fc2, L.QuantDense)
    assert type(lenet.logits) is L.Dense
    resnet = build_model(PortModelConfig(name="resnet18_cifar"), device=meta,
                         precision=prec)
    convs = [m for m in resnet.modules() if isinstance(m, L.Conv)]
    assert convs and all(isinstance(c, L.QuantConv) for c in convs)
    assert type(resnet.classifier) is L.Dense
    for name in ("lenet5", "resnet18_cifar"):
        plain = build_model(PortModelConfig(name=name), device=meta)
        quant = build_model(PortModelConfig(name=name), device=meta,
                            precision=prec)
        assert ({k: (v.shape, v.dtype) for k, v in plain.state_dict().items()}
                == {k: (v.shape, v.dtype)
                    for k, v in quant.state_dict().items()})


# ------------------------------------------------------- the precision steps

LENET_STEPS = [
    "model.name=lenet5", "model.dtype=float32", "data.name=synthetic_images",
    "data.image_size=28", "data.channels=1", "data.seed=0",
    "data.global_batch_size=16", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.05", "optimizer.weight_decay=1e-4",
    "optimizer.warmup_steps=0", "optimizer.grad_clip_norm=0.0",
    "train.total_steps=3", "mesh.data=1"]
ARMS = {"f32": [], "bf16": ["precision.activation_dtype=bf16"],
        "int8": ["precision.activation_dtype=bf16",
                 "precision.matmul_dtype=int8"]}
LOSS_ATOL = {"f32": 0.0, "bf16": 5e-3, "int8": 5e-3}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_lenet_steps_match_the_jax_step(arm):
    """tests/test_precision.py's arms: three LeNet steps from the same
    parameters on the same batches through the JAX StepBuilder and the
    port's; the masters stay f32."""
    from distributed_tensorflow_framework_torch.data import (
        get_dataset as port_dataset,
    )
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder
    from distributed_tensorflow_framework_tpu.core.config import (
        MeshConfig,
        load_config as jax_config,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.train.step import (
        StepBuilder as JaxStepBuilder,
    )

    over = LENET_STEPS + ARMS[arm]
    pcfg, jcfg = port_config(overrides=over), jax_config(overrides=over)
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jbuilder = JaxStepBuilder(jcfg, mesh)
    ds = port_dataset(pcfg.data)
    batches = [next(ds) for _ in range(3)]
    jstate = jbuilder.init_state(0, to_global(batches[0], mesh))
    jstep = jbuilder.make_train_step(to_global(batches[0], mesh))
    pbuilder = StepBuilder(pcfg, device="cpu")
    pstate = pbuilder.init_state(0)
    pstate.model.load_state_dict(flax_to_state_dict(
        jax.device_get(jstate.params)))
    for i, host in enumerate(batches):
        jstate, jm = jstep(jstate, to_global(host, mesh))
        pm = pbuilder.train_step(pstate, to_device(host, torch.device("cpu")))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, atol=LOSS_ATOL[arm],
                                   err_msg=f"step {i}")
        assert np.isfinite(float(pm["grad_norm"]))
    assert {p.dtype for p in pstate.model.parameters()} == {torch.float32}


@pytest.mark.parametrize("override, outcome", [
    ("precision.remat_policy=dots_saveable", "requires model.remat"),
    ("precision.remat_policy=save_nothing", "requires model.remat"),
    ("precision.activation_dtype=bf16", None),
    ("precision.matmul_dtype=int8", "dense/conv image models"),
])
def test_precision_knobs_on_tiny_bert(override, outcome):
    """Each knob alone on the tiny BERT CLI run: it trains, or it raises
    the JAX package's ValueError where JAX's get_model raises it."""
    cfg = port_config(overrides=TINY_BERT + [override])
    jprec = JaxPrecision(**dataclasses.asdict(cfg.precision))
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg.model))
    if outcome is None:
        jax_model(jcfg, precision=jprec)
        assert port_cli.main(_cli_args(CLI_TINY + [override],
                                       "--device", "cpu")) == 0
        return
    with pytest.raises(ValueError, match=outcome):
        jax_model(jcfg, precision=jprec)
    with pytest.raises(ValueError, match=outcome):
        port_cli.main(_cli_args(TINY_BERT + ["checkpoint.directory=",
                                             "resilience.rollback=false",
                                             override], "--device", "cpu"))


REFUSALS = [
    (dict(name="bert"), dict(matmul_dtype="int8"), "dense/conv"),
    (dict(name="inception_v3"), dict(matmul_dtype="int8"), "dense/conv"),
    (dict(name="resnet50", remat=True, remat_policy="conv_saved"),
     dict(remat_policy="dots_saveable"), "conflicts"),
    (dict(name="resnet50"), dict(remat_policy="save_nothing"),
     "requires model.remat"),
    (dict(name="inception_v3"), dict(remat_policy="dots_saveable"),
     "requires model.remat"),
    (dict(name="lenet5", remat=True), dict(remat_policy="dots_saveable"),
     "model.remat is only supported"),
]


@pytest.mark.parametrize("model, precision, match", REFUSALS)
def test_precision_refusals_match_jax(model, precision, match):
    with pytest.raises(ValueError, match=match):
        jax_model(JaxModelConfig(**model),
                  precision=JaxPrecision(**precision))
    with pytest.raises(ValueError, match=match):
        build_model(PortModelConfig(**model), device=torch.device("meta"),
                    precision=PortPrecision(**precision))


@pytest.mark.parametrize("model, precision", [
    (dict(name="bert", pipeline_stages=2), dict(remat_policy="save_nothing")),
    (dict(name="resnet50", remat=True), dict(remat_policy="dots_saveable")),
    (dict(name="inception_v3", remat=True),
     dict(remat_policy="save_nothing")),
    (dict(name="resnet18"), dict(matmul_dtype="int8",
                                 activation_dtype="f32")),
])
def test_precision_configs_jax_builds_also_build(model, precision):
    """Pipeline stages need no model.remat for a policy; the policies and
    int8 on the models JAX wires them for."""
    mesh = None
    if model.get("pipeline_stages"):
        from distributed_tensorflow_framework_tpu.core.config import (
            MeshConfig,
        )
        from distributed_tensorflow_framework_tpu.core.mesh import (
            create_mesh,
        )

        mesh = create_mesh(MeshConfig(data=1, pipe=2),
                           devices=jax.devices()[:2])
    jax_model(JaxModelConfig(**model), precision=JaxPrecision(**precision),
              mesh=mesh)
    from distributed_tensorflow_framework_torch.models import (
        check_precision,
    )

    check_precision(PortModelConfig(**model), PortPrecision(**precision))
    if model["name"] != "bert":
        build_model(PortModelConfig(**model), device=torch.device("meta"),
                    precision=PortPrecision(**precision))


@pytest.mark.parametrize("dtype, activation", [("bfloat16", "f32"),
                                               ("float32", "bf16")])
def test_activation_dtype_overrides_model_dtype(dtype, activation):
    """The tiny BERT under ``activation_dtype`` is the model whose
    ``model.dtype`` says the same, bit for bit, and the JAX model under
    the same precision computes in that dtype."""
    base = port_config(overrides=TINY_BERT + [f"model.dtype={dtype}"])
    want = {"f32": "float32", "bf16": "bfloat16"}[activation]
    jm = jax_model(JaxModelConfig(**dataclasses.asdict(base.model)),
                   precision=JaxPrecision(activation_dtype=activation))
    assert jnp.dtype(jm.dtype) == jnp.dtype(want)
    from distributed_tensorflow_framework_torch.models import get_model

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    ours = get_model(base.model, device="cpu", generator=gen(),
                     precision=PortPrecision(activation_dtype=activation))
    ref = get_model(dataclasses.replace(base.model, dtype=want),
                    device="cpu", generator=gen())
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        0, base.model.vocab_size, (2, 32)))
    with torch.no_grad():
        assert torch.equal(ours(ids), ref(ids))
    assert ours.head.dtype == getattr(torch, want)


@pytest.mark.parametrize("precision", [
    ["precision.activation_dtype=bf16"],
    ["precision.activation_dtype=bf16", "precision.matmul_dtype=int8"]])
def test_checkpoints_are_precision_policy_independent(tmp_path, precision):
    """A run under the bf16 policy (and int8 products) saves f32 masters,
    and a run with no precision block restores them bit for bit (JAX
    tests/test_precision.py)."""
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    over = LENET_STEPS + [
        "train.total_steps=4", f"checkpoint.directory={tmp_path}",
        "checkpoint.save_interval_steps=4", "checkpoint.async_save=false",
        "train.eval_steps=0", "resilience.rollback=false"]
    trainer = Trainer(port_config(overrides=over + precision), device="cpu")
    trainer.train()
    saved = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    trainer.writer.close()
    assert {v.dtype for v in saved.values()} == {torch.float32}
    plain = Trainer(port_config(overrides=over), device="cpu")
    plain.build()
    assert plain.state.step == 4
    for k, v in plain.state.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    plain.writer.close()


def test_int8_resnet_step_is_finite():
    """A small ResNet (CIFAR stem) under int8 and bf16 takes a step with
    finite metrics, its masters f32."""
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    cfg = port_config(overrides=[
        "model.name=resnet18_cifar", "model.num_classes=10",
        "data.name=synthetic_images", "data.image_size=8",
        "data.global_batch_size=4", "mesh.data=1",
        *ARMS["int8"]])
    builder = StepBuilder(cfg, device="cpu")
    state = builder.init_state(0)
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cpu"))
    m = builder.train_step(state, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
