"""The port's Inception-v3 (models/inception.py) and its aux loss
(train/step.py) against the JAX package's.

The same numpy inputs and weights (drawn from the Flax shapes, carried by
models/convert.py) go through the Flax ``InceptionV3`` and the port's,
both at dropout 0 (dropout masks come from torch generators in the port,
a deliberate difference; ROADMAP.md queue C). Sizes: 75 x 75, where the
aux head pools and convolves SAME (its map is 3 x 3, then 1 x 1), 139 x
139 (the pool VALID on 7 x 7, the conv SAME on 1 x 1) and the canonical
299 x 299 (both VALID: 17 -> 5 -> 1), in train and eval mode.

Tolerances, with their reasons. Eval mode (BN on running statistics) is
well conditioned: the port's f32 logits within 1e-5 of the largest |logit|
of Flax's f32 ones (observed below 1e-6). Train mode is not: through 94
BatchNorms over few samples, and back, an f32 rounding anywhere grows,
so Flax's own f32 pass lands 2e-4 to 4e-3 of the largest logit and 2-9% of
the largest gradient from the same Flax model run in f64 (the gradients of
the stem, the longest path, the furthest; the port's BatchNorm with Flax's
E[x²] − E[x]² in place of its own variance moves none of this). So in
train mode the exact answer is Flax's model in f64 (``jax.enable_x64``),
and the port's f32 logits, aux logits, updated ``batch_stats`` (per leaf,
over its largest value) and gradients (over the largest) may sit no
further from it than RATIO times Flax's f32, or within FLOOR. The
StepBuilder steps hold the same way: the port's loss, aux loss, total loss
and grad_norm at every step, and the parameters and statistics after three
steps, against the JAX StepBuilder run in f64, beside the JAX StepBuilder
in f32; and ``total_loss`` is ``loss + 0.4 aux_loss`` (rtol 1e-6). The
parameter count and the convert round trip are exact.

The train/eval comparison at the three sizes and the StepBuilder's steps
are run by tests/test_torch_image_models.py from the helpers here: a file
with few tests is handed out last under xdist's ``--dist loadfile``
(files go out most tests first), and these ~6 minutes of work ended the
suite's run minutes after every other file.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    ModelConfig as PortModelConfig,
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import (
    get_dataset as port_dataset,
)
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.models import inception
from distributed_tensorflow_framework_torch.models.convert import (
    batch_stats_to_flax,
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.train import step as port_step
from distributed_tensorflow_framework_torch.train.step import StepBuilder
from distributed_tensorflow_framework_tpu.core.config import (
    MeshConfig,
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
from distributed_tensorflow_framework_tpu.data.infeed import to_global
from distributed_tensorflow_framework_tpu.models.inception import (
    InceptionV3 as JaxInception,
)
from distributed_tensorflow_framework_tpu.train.step import (
    StepBuilder as JaxStepBuilder,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401

CLASSES = 10
EVAL_TOL = 1e-5
RATIO = 3.0
FLOOR = 1e-5


def _random_variables(module, x, seed):
    """Flax variables drawn with numpy from the shapes alone: kernels
    normal with std √(1/fan_in), BN scales 1 ± 0.1, biases ± 0.1, running
    means ± 0.1 and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, x,
        train=False))

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
    assert err <= EVAL_TOL * scale, f"{what}: {err:.2e} of {scale:.2e}"


def _as64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _distance(got: dict, truth: dict) -> dict:
    """Per quantity, the largest |got - truth| over its scale: logits over
    their largest value, each statistics leaf over its own, gradients
    over the largest gradient."""
    out = {k: np.abs(got[k] - truth[k]).max() / np.abs(truth[k]).max()
           for k in ("logits", "aux_logits")}
    stats, want = flatten_tree(got["stats"]), flatten_tree(truth["stats"])
    out["stats"] = max(np.abs(stats[p] - w).max() / np.abs(w).max()
                       for p, w in want.items())
    grads, want = flatten_tree(got["grads"]), flatten_tree(truth["grads"])
    top = max(np.abs(w).max() for w in want.values())
    out["grads"] = max(np.abs(grads[p] - w).max() / top
                       for p, w in want.items())
    return out


def _assert_no_further(port: dict, ref: dict, what: str) -> None:
    for key, d in port.items():
        assert d <= RATIO * ref[key] + FLOOR, (
            f"{what} {key}: the port is {d:.2e} from f64, Flax's f32 "
            f"{ref[key]:.2e}")


def _models():
    jm = JaxInception(num_classes=CLASSES, dtype=jnp.float32,
                      dropout_rate=0.0)
    pm = inception.InceptionV3(CLASSES, dropout_rate=0.0,
                               dtype=torch.float32)
    return jm, pm


def test_parameter_count_equals_jax():
    """27,161,264 at 1000 classes with the aux head (the JAX test's pin,
    torchvision's count; 23,834,568 of them outside the aux head), from
    ``jax.eval_shape`` of the Flax init: nothing is computed."""
    shapes = jax.eval_shape(lambda: JaxInception(num_classes=1000).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        jnp.zeros((1, 299, 299, 3)), train=False))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree.leaves(shapes["params"]))
    model = get_model(PortModelConfig(name="inception_v3", num_classes=1000,
                                      dtype="float32"), device="cpu")
    got = sum(p.numel() for p in model.parameters())
    aux = sum(p.numel() for n, p in model.named_parameters()
              if n.startswith("aux_"))
    assert got == want == 27_161_264
    assert got - aux == 23_834_568


def _flax_run(variables, x, w, dtype) -> dict:
    """Flax's train-mode logits, aux logits, updated batch_stats and the
    gradients of a loss on both heads, and its eval logits, computed in
    ``dtype`` (float64 under ``jax.enable_x64``)."""
    jm = JaxInception(num_classes=CLASSES, dtype=dtype, dropout_rate=0.0)
    v = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
    xj = jnp.asarray(x, dtype)

    def loss_fn(params):
        out, state = jm.apply({**v, "params": params}, xj, train=True,
                              mutable=["batch_stats"])
        loss = (jnp.sum(out["logits"] * w[0])
                + jnp.sum(out["aux_logits"] * w[1]))
        return loss, (out, state["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    evals = jax.jit(lambda v: jm.apply(v, xj, train=False))(v)
    return _as64({"logits": out["logits"], "aux_logits": out["aux_logits"],
                  "stats": stats, "grads": grads, "eval": evals})


def _train_and_eval_match_flax(size, batch):
    """Train mode: logits, aux logits, the updated batch_stats and every
    gradient of a loss on both heads, against Flax in f64 beside Flax in
    f32; eval mode: the logits (no aux head) against Flax's f32
    (tests/test_torch_image_models.py runs it at each size)."""
    jm, pm = _models()
    rng = np.random.default_rng(size)
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    variables = _random_variables(jm, x, size)
    w = rng.standard_normal((2, batch, CLASSES)).astype(np.float32)
    ref = _flax_run(variables, x, w, jnp.float32)
    with jax.enable_x64(True):
        truth = _flax_run(variables, x, w, jnp.float64)

    pm.load_state_dict(flax_to_state_dict(variables["params"],
                                          variables["batch_stats"]))
    pm.train()
    out = pm(torch.from_numpy(x))
    loss = ((out["logits"] * torch.from_numpy(w[0])).sum()
            + (out["aux_logits"] * torch.from_numpy(w[1])).sum())
    loss.backward()
    port = _as64({"logits": out["logits"].detach().numpy(),
                  "aux_logits": out["aux_logits"].detach().numpy(),
                  "stats": batch_stats_to_flax(pm),
                  "grads": to_flax(pm, {k: p.grad for k, p in
                                        pm.named_parameters()})})
    assert set(flatten_tree(port["grads"])) == set(flatten_tree(
        ref["grads"]))
    _assert_no_further(_distance(port, truth), _distance(ref, truth),
                       f"{size}x{size} train")

    pm.load_state_dict(flax_to_state_dict(variables["params"],
                                          variables["batch_stats"]))
    pm.eval()
    with torch.no_grad():
        logits = pm(torch.from_numpy(x))
    assert isinstance(logits, torch.Tensor)
    _close(logits.numpy(), ref["eval"], np.abs(ref["eval"]).max(),
           "eval logits")


def test_convert_round_trip():
    jm, pm = _models()
    x = np.zeros((1, 75, 75, 3), np.float32)
    variables = _random_variables(jm, x, 0)
    pm.load_state_dict(flax_to_state_dict(variables["params"],
                                          variables["batch_stats"]))
    for got, want in ((to_flax(pm), variables["params"]),
                      (batch_stats_to_flax(pm), variables["batch_stats"])):
        got, want = flatten_tree(got), flatten_tree(jax.device_get(want))
        assert got.keys() == want.keys()
        for path in want:
            np.testing.assert_array_equal(got[path], want[path])


def test_dropout_draws_from_the_generator_it_is_given():
    """Train mode at dropout 0.2: the same generator state gives the same
    logits, another gives others; no generator raises (the port never
    draws from the global RNG); eval mode ignores dropout."""
    model = inception.InceptionV3(CLASSES, dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    model.train()
    x = torch.randn(2, 75, 75, 3)

    def run(seed):
        return model(x, dropout_generator=torch.Generator().manual_seed(
            seed))["logits"]

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="dropout_generator"):
        model(x)
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)


STEPS = ["mesh.data=1", "model.name=inception_v3",
         f"model.num_classes={CLASSES}", "model.dtype=float32",
         "data.name=synthetic_images", "data.seed=2", "data.image_size=75",
         "data.channels=3", f"data.num_classes={CLASSES}",
         "data.global_batch_size=8", "optimizer.name=rmsprop",
         "optimizer.learning_rate=0.0001", "optimizer.rms_decay=0.9",
         "optimizer.momentum=0.9", "optimizer.eps=1.0",
         "optimizer.weight_decay=0.00004", "optimizer.warmup_steps=1",
         "optimizer.schedule=cosine", "train.total_steps=3",
         "train.label_smoothing=0.1"]
STEP_METRICS = ("loss", "aux_loss", "total_loss", "grad_norm")


def _jax_steps(jcfg, mesh, batches, init, dtype) -> dict:
    """The JAX StepBuilder's metrics at each step and its parameters and
    statistics after the last, from ``init`` (its f32 initial state, on
    the host) computed in ``dtype``."""
    builder = JaxStepBuilder(jcfg, mesh)
    builder.model = JaxInception(num_classes=CLASSES, dtype=dtype,
                                 dropout_rate=0.0)
    # Copies: the step donates its state.
    state = jax.tree.map(
        lambda a: (a.astype(dtype) + 0 if jnp.issubdtype(a.dtype,
                                                         jnp.floating)
                   else a.copy()) if isinstance(a, jax.Array) else a, init)
    step = builder.make_train_step(to_global(batches[0], mesh))
    metrics = []
    for host in batches:
        state, m = step(state, to_global(host, mesh))
        metrics.append({k: float(m[k]) for k in STEP_METRICS})
    return {"metrics": metrics, "params": _as64(state.params),
            "stats": _as64(state.batch_stats)}


def _step_distance(got: dict, truth: dict) -> dict:
    out = {k: max(abs(g[k] - t[k]) / abs(t[k]) for g, t in
                  zip(got["metrics"], truth["metrics"]))
           for k in STEP_METRICS}
    for key in ("params", "stats"):
        want, have = flatten_tree(truth[key]), flatten_tree(got[key])
        out[key] = max(np.abs(have[p] - w).max() / max(np.abs(w).max(),
                                                        1e-12)
                       for p, w in want.items())
    return out


def _three_steps_with_the_aux_loss_match_the_jax_step_builder(
        monkeypatch):
    """Config 4's optimizer (RMSProp, eps 1.0) and label smoothing at 75 x
    75: the port's StepBuilder against the JAX StepBuilder in f64, beside
    the JAX StepBuilder in f32, from the same initial variables. The
    learning rate is cut to 1e-4: at init the gradient norm is ~2,400,
    and at config 4's rate the third step's loss already differs by 10%
    between any two of the three runs."""
    pcfg, jcfg = port_config(overrides=STEPS), jax_config(overrides=STEPS)
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    ds = port_dataset(pcfg.data)
    batches = [next(ds) for _ in range(3)]
    builder = JaxStepBuilder(jcfg, mesh)
    builder.model = _models()[0]
    init = builder.init_state(0, to_global(batches[0], mesh))
    init = jax.tree.map(lambda a: a.copy() if isinstance(a, jax.Array)
                        else a, init)
    start = flax_to_state_dict(jax.device_get(init.params),
                               jax.device_get(init.batch_stats))
    ref = _jax_steps(jcfg, mesh, batches, init, jnp.float32)
    with jax.enable_x64(True):
        truth = _jax_steps(jcfg, mesh, batches, init, jnp.float64)

    monkeypatch.setattr(port_step, "get_model", lambda config, **kw: (
        _models()[1].to(kw["device"])))
    pbuilder = StepBuilder(pcfg, device="cpu")
    pstate = pbuilder.init_state(0)
    pstate.model.load_state_dict(start)
    metrics = []
    for host in batches:
        m = pbuilder.train_step(pstate, to_device(host, torch.device("cpu")))
        np.testing.assert_allclose(
            float(m["total_loss"]),
            float(m["loss"]) + 0.4 * float(m["aux_loss"]), rtol=1e-6)
        metrics.append({k: float(m[k]) for k in STEP_METRICS})
    port = {"metrics": metrics, "params": _as64(to_flax(pstate.model)),
            "stats": _as64(batch_stats_to_flax(pstate.model))}
    _assert_no_further(_step_distance(port, truth),
                       _step_distance(ref, truth), "StepBuilder")
    evals = pbuilder.eval_step(pstate, to_device(batches[0],
                                                 torch.device("cpu")))
    assert np.isfinite(float(evals["loss_sum"]))
