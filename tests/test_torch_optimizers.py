"""The port's optimizers and parameter EMA against optax and the JAX step.

Each optimizer of ``train/optimizers.py`` runs five steps on LeNet-5's
parameter tree (conv and dense kernels that decay, biases that do not)
with the same numpy gradients on both sides: through the port's
``Optimizer`` on the model, and through the JAX package's optax chain on
the Flax tree. The schedule warms up over two steps and then decays
(cosine), so the learning rate changes under every rule; the global-norm
clip (1.0) is triggered at the gradient scale used. Mirrors
tests/test_optimizers.py and tests/test_ema.py.

Tolerances, with their reasons:
  * parameters after each step: rtol 1e-5 and an atol of 1e-5 × the
    base learning rate — the same f32 update rounded in another order —
    and 1e-4 × it for Adam, whose m̂/(√v̂ + ε) rounds differently in optax
    and torch.optim and is divided by a √v̂ as small as the gradients
    (observed 1.8e-5 × lr);
  * the EMA decay schedule: exact (both f32); the EMA after a step:
    rtol 1e-6 (e·d + p·(1 − d) in f32, the two products added in one
    order on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.models.convert import (
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.train import optimizers as opt
from distributed_tensorflow_framework_torch.train.step import StepBuilder
from distributed_tensorflow_framework_tpu.core.config import (
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.train import (
    optimizers as jax_optimizers,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401

BASE = ["model.name=lenet5", "model.dtype=float32",
        "optimizer.learning_rate=0.1", "optimizer.schedule=cosine",
        "optimizer.warmup_steps=2", "optimizer.grad_clip_norm=1.0",
        "optimizer.weight_decay=0.01"]

CASES = {
    "sgd": ["optimizer.name=sgd", "optimizer.momentum=0.0"],
    "sgd_momentum": ["optimizer.name=sgd_momentum",
                     "optimizer.momentum=0.9"],
    "nesterov": ["optimizer.name=momentum", "optimizer.momentum=0.9",
                 "optimizer.nesterov=true"],
    "adam": ["optimizer.name=adam", "optimizer.learning_rate=1e-3"],
    "rmsprop_momentum": ["optimizer.name=rmsprop", "optimizer.momentum=0.9",
                         "optimizer.eps=1.0", "optimizer.rms_decay=0.9"],
    "rmsprop": ["optimizer.name=rmsprop", "optimizer.momentum=0.0",
                "optimizer.eps=1e-3", "optimizer.learning_rate=1e-3"],
    "lars": ["optimizer.name=lars", "optimizer.momentum=0.9",
             "optimizer.learning_rate=2.0"],
}


ATOL = {"adam": 1e-4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax_over_five_steps(case):
    over = BASE + CASES[case]
    pcfg, jcfg = port_config(overrides=over), jax_config(overrides=over)
    model = get_model(pcfg.model, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    total = 10
    optimizer, schedule = opt.make_optimizer(pcfg.optimizer, total, model)
    tx, jsched = jax_optimizers.make_optimizer(jcfg.optimizer, total)
    params = jax.tree.map(jnp.asarray, to_flax(model))
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    named = dict(model.named_parameters())
    rng = np.random.default_rng(4)
    clipped = 0
    for step in range(5):
        grads = jax.tree.map(lambda p: (0.05 * rng.standard_normal(
            p.shape)).astype(np.float32), to_flax(model))
        for key, g in flax_to_state_dict(grads).items():
            named[key].grad = g.clone()
        norm = opt.global_norm([p.grad for p in named.values()])
        clipped += float(norm) > pcfg.optimizer.grad_clip_norm
        optimizer.step(norm)
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads),
                                    opt_state, params)
        params = optax.apply_updates(params, updates)
        lr = float(jsched(step))
        np.testing.assert_allclose(schedule(step), lr, rtol=1e-6)
        ours = flatten_tree(to_flax(model))
        for path, ref in flatten_tree(jax.device_get(params)).items():
            np.testing.assert_allclose(
                ours[path], ref, rtol=1e-5,
                atol=ATOL.get(case, 1e-5) * pcfg.optimizer.learning_rate,
                err_msg=f"{case} step {step} {path}")
    assert clipped == 5
    assert optimizer.count == 5


def test_rmsprop_starts_its_slot_at_one_with_eps_inside_the_root():
    """One step from ν = 1 with ε = 1: u = g/√(0.9 + 0.1·g² + 1), where
    torch.optim.RMSprop would give g/(√(0.1·g²) + 1)."""
    cfg = port_config(overrides=["optimizer.name=rmsprop",
                                 "optimizer.momentum=0.0",
                                 "optimizer.eps=1.0",
                                 "optimizer.learning_rate=1.0",
                                 "optimizer.schedule=constant",
                                 "optimizer.grad_clip_norm=0.0"])
    w = torch.nn.Parameter(torch.zeros(3))
    inner = opt._inner(cfg.optimizer, [{"params": [w],
                                        "weight_decay": 0.0}])
    g = torch.tensor([0.5, -2.0, 4.0])
    w.grad = g.clone()
    inner.param_groups[0]["lr"] = 1.0
    inner.step()
    torch.testing.assert_close(w.detach(),
                               -g / torch.sqrt(0.9 + 0.1 * g * g + 1.0))


def test_unknown_optimizer_raises():
    cfg = port_config(overrides=["optimizer.name=adagrad"])
    model = get_model(port_config(overrides=BASE).model, device="cpu")
    with pytest.raises(ValueError, match="Unknown optimizer"):
        opt.make_optimizer(cfg.optimizer, 10, model)


# ------------------------------------------------------------------ EMA

@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_ema_decay_schedule_matches_the_jax_formula(decay):
    for t in (0, 1, 5, 80, 10_000):
        tj = jnp.float32(t)
        ref = jnp.minimum(decay, (1.0 + tj) / (10.0 + tj))
        assert opt.ema_decay_at(decay, t) == np.float32(ref)


EMA_CFG = ["model.name=lenet5", "model.dtype=float32",
           "data.name=synthetic_images", "data.global_batch_size=8",
           "data.image_size=28", "data.channels=1",
           "optimizer.name=sgd_momentum", "optimizer.learning_rate=0.05",
           "optimizer.ema_decay=0.9", "train.total_steps=5",
           "checkpoint.directory=", "resilience.rollback=false"]


def _ema_builder(*extra):
    from distributed_tensorflow_framework_torch.data import get_dataset

    cfg = port_config(overrides=EMA_CFG + list(extra))
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cpu"))
    return StepBuilder(cfg, device="cpu"), batch


def test_ema_update_formula():
    """The EMA starts at the parameters; after step 0 (d = min(0.9,
    1/10) = 0.1) it is 0.1·p0 + 0.9·p1, as tests/test_ema.py holds the
    JAX step to."""
    builder, batch = _ema_builder()
    state = builder.init_state(0)
    p0 = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    for k, e in state.ema_params.items():
        torch.testing.assert_close(e, p0[k], rtol=0, atol=0)
    builder.train_step(state, batch)
    for k, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema_params[k],
                                   0.1 * p0[k] + 0.9 * p.detach(),
                                   rtol=1e-6, atol=1e-7)


def test_eval_reads_the_ema_when_asked():
    """``train.eval_use_ema`` (default on) evaluates the EMA parameters;
    off, the live ones. The reference copies the EMA into the model."""
    builder, batch = _ema_builder()
    live_builder, _ = _ema_builder("train.eval_use_ema=false")
    state = builder.init_state(0)
    for _ in range(2):
        builder.train_step(state, batch)
    got = builder.eval_step(state, batch)["loss_sum"]
    plain = live_builder.eval_step(state, batch)["loss_sum"]
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            p.copy_(state.ema_params[k])
    ema = live_builder.eval_step(state, batch)["loss_sum"]
    assert plain != ema
    assert got == ema
    assert state.model.training
