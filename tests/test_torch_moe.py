"""Mixture-of-Experts in one process (models/moe.py, the MoE BERT, the
step's loss and metrics, the collapse hook, serving) against the JAX
package.

Mirrors ``tests/test_moe.py``: the routing (the sorted and dense
dispatchers' tables against JAX's, exactly, for top-1/2/3 at four
capacities), the layer (outputs, aux and gradients through both
dispatchers, the z-loss on and off, the dropped fraction, the top-1
router's task gradient, the ValueErrors), the experts' initialisation
(fan_in E·H and E·F), the MoE BERT's logits and aux against the Flax
model, its metrics through remat, and the train step at one process
against the JAX ``jit`` step in f32: loss, metrics and every gradient at
``moe_aux_weight`` 0.01 and 1.0 (at 1.0 an error in the aux gradient
shows), and two steps with accumulation. ``MoECollapseHook`` mirrors
``tests/test_telemetry.py``'s two hook tests; an MoE artifact serves the
model's logits; the step's refusals beside the other mesh axes.

Inputs come from numpy seeds; gate logits are drawn without near-ties
(a tie would route by rounding). Tolerances: the tables exactly; the
combine weights and the balance loss rtol 1e-6; the layer and the model
in f32 rtol 1e-5; gradients rtol 1e-5 with an atol of 1e-6 of the
largest entry of the leaf (the layer) or of the tree (the model, where
the key bias's gradient is zero in exact arithmetic).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.models import moe as pm
from distributed_tensorflow_framework_torch.models.convert import (
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_tpu.models import moe as jm
from tests.test_torch_hygiene import torch_threads  # noqa: F401

E = 4
TINY_MOE = [
    "model.name=bert", "model.vocab_size=128", "model.hidden_size=32",
    "model.num_layers=2", "model.num_heads=2", "model.mlp_dim=64",
    "model.max_seq_len=32", "model.dtype=float32",
    "model.attention_impl=xla", "model.dropout_rate=0.0",
    f"model.num_experts={E}", "model.moe_every=2", "model.expert_topk=2",
    "model.capacity_factor=1.25", "model.moe_dispatch=sorted",
    "data.name=synthetic_mlm", "data.vocab_size=128", "data.seq_len=32",
    "data.global_batch_size=8", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.5", "optimizer.momentum=0.9",
    "optimizer.weight_decay=0.0", "optimizer.warmup_steps=0",
    "optimizer.schedule=constant", "optimizer.grad_clip_norm=1.0",
    "train.total_steps=2", "checkpoint.directory=",
    "resilience.rollback=false"]
RTOL = 1e-5


def _logits(seed, b=2, s=32, e=E, gap=1e-3):
    """Gate logits whose probabilities have no near-ties in any token."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, e)).astype(np.float32)
    while True:
        srt = np.sort(x, axis=-1)
        bad = (np.diff(srt, axis=-1) < gap).any(axis=-1)
        if not bad.any():
            return x
        x[bad] = rng.standard_normal((int(bad.sum()), e))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("topk", [1, 2, 3])
def test_routing_tables_equal_jax(topk, cf):
    logits = _logits(10 * topk + int(4 * cf))
    cap = pm.capacity_for(logits.shape[1], E, topk, cf)
    assert cap == max(topk, int(math.ceil(topk * 32 / E * cf)))
    want = jm.topk_dispatch_sorted(jnp.asarray(logits), topk, cap)
    got = pm.topk_dispatch_sorted(_t(logits), topk, cap)
    for name, g, w in zip(("token_table", "table_valid", "expert_a",
                           "pos_a"), got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got[5]), float(want[5]), rtol=1e-6)
    d_want = jm.topk_dispatch(jnp.asarray(logits), topk, cap)
    d_got = pm.topk_dispatch(_t(logits), topk, cap)
    np.testing.assert_array_equal(d_got[0].numpy(), np.asarray(d_want[0]))
    np.testing.assert_allclose(d_got[1].numpy(), np.asarray(d_want[1]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(d_got[2]), float(d_want[2]),
                               rtol=1e-6)
    # The dense one-hots rebuilt from the sorted tables.
    b, s = logits.shape[:2]
    rebuilt = np.zeros((b, s, E, cap), np.float32)
    bi, ei, ci = np.nonzero(got[1].numpy())
    rebuilt[bi, got[0].numpy()[bi, ei, ci], ei, ci] = 1.0
    np.testing.assert_array_equal(rebuilt, d_got[0].numpy())
    if cf <= 0.5:
        assert got[1].sum() < b * s * topk  # drops in play


def test_balanced_aux_is_one():
    _, _, aux = pm.topk_dispatch(torch.zeros(2, 16, E), 2, 16)
    assert abs(float(aux) - 1.0) < 1e-6


def test_topk_outside_experts_and_bad_dispatch_raise():
    with pytest.raises(ValueError, match="num_experts"):
        pm.topk_dispatch(torch.zeros(1, 4, 2), 3, 4)
    with pytest.raises(ValueError, match="num_experts"):
        pm.topk_dispatch_sorted(torch.zeros(1, 4, 2), 0, 4)
    with pytest.raises(ValueError, match="'sorted' or 'dense'"):
        pm.MoEMlp(8, E, 16, dispatch_impl="einsum")
    with pytest.raises(ValueError, match="num_experts"):
        pm.MoEMlp(8, 2, 16, topk=3)


# ------------------------------------------------------------ the layer

def _layer_pair(topk, cf, impl, zloss, h=16, f=32, seed=0):
    jl = jm.MoEMlp(num_experts=E, mlp_dim=f, topk=topk, capacity_factor=cf,
                   dispatch_impl=impl, zloss_weight=zloss, dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, 16, h)).astype(
        np.float32)
    params = jax.device_get(jl.init(jax.random.key(seed),
                                    jnp.asarray(x))["params"])
    layer = pm.MoEMlp(h, E, f, topk=topk, capacity_factor=cf,
                      dispatch_impl=impl, zloss_weight=zloss,
                      dtype=torch.float32)
    layer.load_state_dict(flax_to_state_dict(params))
    return jl, params, layer, x


@pytest.mark.parametrize("impl", ["sorted", "dense"])
@pytest.mark.parametrize("topk, zloss", [(2, 0.0), (2, 0.1), (1, 0.0)])
def test_layer_outputs_and_grads_equal_jax(impl, topk, zloss):
    jl, params, layer, x = _layer_pair(topk, 0.75, impl, zloss)

    def loss_fn(p):
        out, aux = jl.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out ** 2) + 0.5 * aux["aux_loss"], (out, aux)

    (_, (out_j, aux_j)), g_j = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    out, aux = layer(_t(x))
    (out.square().sum() + 0.5 * aux["aux_loss"]).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=1e-6)
    for k in ("aux_loss", "zloss", "drop_frac"):
        np.testing.assert_allclose(aux[k].item(), float(aux_j[k]),
                                   rtol=RTOL, atol=1e-7, err_msg=k)
    assert (aux["zloss"].item() > 0) == bool(zloss)
    assert aux["drop_frac"].item() > 0  # capacity 0.75 drops
    want = flax_to_state_dict(jax.device_get(g_j))
    for k, p in layer.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=RTOL,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_sorted_and_dense_layers_agree():
    _, _, sorted_, x = _layer_pair(2, 0.75, "sorted", 0.1)
    dense = pm.MoEMlp(16, E, 32, topk=2, capacity_factor=0.75,
                      dispatch_impl="dense", zloss_weight=0.1,
                      dtype=torch.float32)
    dense.load_state_dict(sorted_.state_dict())
    outs = [m(_t(x)) for m in (sorted_, dense)]
    np.testing.assert_allclose(outs[0][0].detach(), outs[1][0].detach(),
                               rtol=RTOL, atol=1e-6)
    for k in ("aux_loss", "zloss", "drop_frac"):
        assert float(outs[0][1][k]) == pytest.approx(float(outs[1][1][k]),
                                                     rel=1e-6)


def test_top1_router_gets_task_gradient():
    """Switch top-1 scales by the raw gate probability: the router gets a
    task gradient (normalised weights would be identically 1)."""
    _, _, layer, x = _layer_pair(1, 1.25, "sorted", 0.0)
    out, _ = layer(_t(x))
    out.square().sum().backward()
    assert float(layer.gate.weight.grad.abs().sum()) > 1e-4


def test_drop_frac_diagnostic():
    def drop(cf):
        _, _, layer, x = _layer_pair(1, cf, "sorted", 0.0)
        out, aux = layer(_t(x))
        assert out.shape == x.shape
        return float(aux["drop_frac"])

    assert drop(4.0) == 0.0
    assert drop(0.25) > 0.2


def test_zloss_is_the_mean_squared_logsumexp():
    _, _, layer, x = _layer_pair(2, 1.25, "sorted", 0.1)
    _, aux = layer(_t(x))
    logits = _t(x) @ layer.gate.weight.detach().T
    want = torch.logsumexp(logits, -1).square().mean()
    assert float(aux["zloss"]) == pytest.approx(float(want), rel=1e-6)
    layer.zloss_weight = 0.0
    _, off = layer(_t(x))
    assert float(aux["aux_loss"] - off["aux_loss"]) == pytest.approx(
        0.1 * float(want), rel=1e-5)


def test_expert_init_follows_fan_in_e_h():
    """``wi`` (E, H, F) draws with std 1/sqrt(E·H), ``wo`` 1/sqrt(E·F), as
    the JAX initialiser counts the leading E as receptive field."""
    h, f = 128, 256
    layer = pm.MoEMlp(h, E, f, dtype=torch.float32)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    jl = jm.MoEMlp(num_experts=E, mlp_dim=f, dtype=jnp.float32)
    ref = jax.device_get(jl.init(jax.random.key(0),
                                 jnp.zeros((1, 4, h)))["params"])
    for name, fan_in in (("wi", E * h), ("wo", E * f)):
        got = getattr(layer, name).detach().numpy()
        assert got.shape == ref[name].shape
        np.testing.assert_allclose(got.std(), 1 / math.sqrt(fan_in),
                                   rtol=0.02)
        np.testing.assert_allclose(got.std(), np.asarray(ref[name]).std(),
                                   rtol=0.03)


# ------------------------------------------------------------ the model

def _jax_bert(cfg, **over):
    from distributed_tensorflow_framework_tpu.core.config import ModelConfig
    from distributed_tensorflow_framework_tpu.models import (
        get_model as jax_model,
    )

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in dataclasses.asdict(cfg.model).items()
          if k in fields}
    return jax_model(ModelConfig(**{**kw, **over}))


def _port_bert(overrides, **over):
    from distributed_tensorflow_framework_torch.models import get_model

    cfg = port_config(overrides=overrides)
    model_cfg = dataclasses.replace(cfg.model, **over)
    return cfg, get_model(model_cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("dispatch", ["sorted", "dense"])
def test_moe_bert_logits_and_aux_equal_jax(dispatch):
    cfg, model = _port_bert(TINY_MOE, moe_dispatch=dispatch,
                            moe_zloss_weight=0.1)
    assert [k for k in model.state_dict() if ".moe." in k] == [
        "layer1.moe.wi", "layer1.moe.wo", "layer1.moe.gate.weight"]
    ids = np.random.default_rng(5).integers(0, 128, (3, 32))
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    out = model(_t(ids), _t(mask))
    ref = _jax_bert(cfg, moe_dispatch=dispatch, moe_zloss_weight=0.1).apply(
        {"params": to_flax(model)}, jnp.asarray(ids), jnp.asarray(mask),
        train=False)
    assert set(out) == set(ref) == {"logits", "moe_aux_loss",
                                    "moe_drop_frac", "moe_zloss"}
    for k in out:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=RTOL,
                                   atol=1e-5, err_msg=k)


def test_moe_metrics_survive_remat():
    cfg, plain = _port_bert(TINY_MOE, capacity_factor=0.5,
                            moe_zloss_weight=0.1)
    _, remat = _port_bert(TINY_MOE, capacity_factor=0.5,
                          moe_zloss_weight=0.1, remat=True)
    remat.load_state_dict(plain.state_dict())
    ids = _t(np.random.default_rng(0).integers(1, 128, (2, 32)))
    outs, grads = [], []
    for m in (plain, remat):
        m.train()
        out = m(ids, dropout_generator=torch.Generator().manual_seed(0))
        (out["logits"].square().mean() + 0.01 * out["moe_aux_loss"]
         + out["moe_zloss"]).backward()
        outs.append(out)
        grads.append({k: p.grad for k, p in m.named_parameters()})
    for key in ("logits", "moe_aux_loss", "moe_drop_frac", "moe_zloss"):
        np.testing.assert_allclose(outs[1][key].detach(),
                                   outs[0][key].detach(), rtol=1e-6,
                                   err_msg=key)
    assert 0.0 < float(outs[1]["moe_drop_frac"]) <= 1.0
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[1][k], g, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# ------------------------------------------------------------ the step

def _batches(cfg, n):
    from distributed_tensorflow_framework_torch.data import get_dataset

    ds = get_dataset(cfg.data)
    return [next(ds) for _ in range(n)]


def _jax_builder(overrides, port_init):
    from distributed_tensorflow_framework_tpu.core.config import (
        MeshConfig,
        load_config,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.train.step import StepBuilder

    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    builder = StepBuilder(load_config(overrides=overrides), mesh)
    batch = _batches(port_config(overrides=overrides), 1)[0]
    state = builder.init_state(0, to_global(batch, mesh))
    state = state.replace(params=jax.tree.map(
        lambda x, ref: jax.device_put(x, ref.sharding), port_init,
        state.params))
    return builder, state, mesh


def _port_builder(overrides):
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    builder = StepBuilder(port_config(overrides=overrides), device="cpu")
    return builder, builder.init_state(0)


def _to_port(batch):
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    return to_device(batch, torch.device("cpu"))


@pytest.mark.parametrize("aux_weight", [0.01, 1.0])
def test_micro_step_grads_equal_jax(aux_weight):
    """One micro-step's loss, metrics and every gradient against the JAX
    step's ``_microbatch_grads`` (f32, zloss armed)."""
    from distributed_tensorflow_framework_tpu.data.infeed import to_global

    over = TINY_MOE + [f"train.moe_aux_weight={aux_weight}",
                       "model.moe_zloss_weight=0.1"]
    builder, state = _port_builder(over)
    jb, jstate, mesh = _jax_builder(over, to_flax(state.model))
    batch = _batches(builder.config, 1)[0]
    g_j, m_j, _ = jax.jit(jb._microbatch_grads)(jstate,
                                                to_global(batch, mesh))
    state.optimizer.zero_grad()
    metrics = builder._micro_step(state, _to_port(batch), 1.0)
    assert set(metrics) == {"loss", "mlm_acc", "moe_aux_loss", "total_loss",
                            "moe_drop_frac", "moe_zloss"} == set(m_j)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(m_j[k]), rtol=RTOL,
                                   err_msg=k)
    want = flatten_tree(jax.device_get(g_j))
    got = flatten_tree(to_flax(state.model, {
        k: p.grad for k, p in state.model.named_parameters()}))
    assert set(got) == set(want)
    # A gradient that is zero in exact arithmetic (the key bias: softmax
    # ignores a shift shared by every key) is rounding noise on both
    # sides: the atol is relative to the largest gradient of the tree.
    top = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=RTOL, atol=1e-6 * top,
                                   err_msg=str(path))


@pytest.mark.parametrize("extra", [[], ["train.grad_accum_steps=2"]])
def test_two_steps_equal_the_jax_jit_step(extra):
    """Two optimizer steps (SGD with momentum, clipping at 1.0): the
    metrics and every parameter against the JAX jit step."""
    from distributed_tensorflow_framework_tpu.data.infeed import to_global

    over = TINY_MOE + extra
    builder, state = _port_builder(over)
    jb, jstate, mesh = _jax_builder(over, to_flax(state.model))
    batches = _batches(builder.config, 2)
    step = jb.make_train_step(to_global(batches[0], mesh))
    for batch in batches:
        jstate, m_j = step(jstate, to_global(batch, mesh))
        m = builder.train_step(state, _to_port(batch))
        for k in ("loss", "total_loss", "moe_aux_loss", "moe_drop_frac",
                  "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(m_j[k]),
                                       rtol=RTOL, err_msg=k)
    want = flatten_tree(jax.device_get(jstate.params))
    got = flatten_tree(to_flax(state.model))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=RTOL, atol=1e-6,
                                   err_msg=str(path))


def test_eval_step_keeps_the_logits():
    builder, state = _port_builder(TINY_MOE)
    batch = _to_port(_batches(builder.config, 1)[0])
    sums = builder.eval_step(state, batch)
    assert set(sums) == {"loss_sum", "mlm_acc_sum", "weight_sum"}
    assert np.isfinite(float(sums["loss_sum"]))


@pytest.mark.parametrize("mesh, world, exc, match", [
    (["mesh.data=1", "mesh.expert=2", "train.spmd_mode=shard_map"], 2,
     ValueError, "expert parallelism"),
    (["mesh.data=1", "mesh.expert=2", "mesh.fsdp=2"], 4,
     NotImplementedError, "A8 \\(experts beside fsdp/model/seq\\)"),
    (["mesh.data=1", "mesh.expert=2", "mesh.model=2"], 4,
     NotImplementedError, "A8 \\(experts beside fsdp/model/seq\\)"),
    (["mesh.data=1", "mesh.expert=2", "mesh.seq=2"], 4,
     NotImplementedError, "A8 \\(experts beside fsdp/model/seq\\)"),
    (["mesh.data=1", "mesh.model=2"], 2,
     NotImplementedError, "A8 \\(experts beside fsdp/model/seq\\)"),
    (["mesh.data=1", "mesh.seq=2", "model.attention_impl=ring"], 2,
     NotImplementedError, "A8 \\(experts beside fsdp/model/seq\\)"),
    (["mesh.data=1", "mesh.expert=2", "mesh.pipe=2",
      "model.pipeline_stages=2"], 4, ValueError, "v1 pipeline"),
])
def test_refusals(mesh, world, exc, match):
    """The JAX package's refusals raise its errors. The cases marked with
    the NotImplementedError this port raised before it carried them
    (experts beside ``fsdp``, ``model`` or ``seq``; MoE beside tensor
    parallelism or the ring) now pass the step's checks:
    tests/test_torch_compose_moe.py trains them against the JAX step."""
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    cfg = port_config(overrides=TINY_MOE + mesh)
    if exc is NotImplementedError:
        sizes = check_step_config(cfg, world)
        assert math.prod(sizes.values()) == world
        return
    with pytest.raises(exc, match=match):
        check_step_config(cfg, world)


def test_expert_axis_passes_the_checks():
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    for mesh, world in ((["mesh.data=1", "mesh.expert=2"], 2),
                        (["mesh.data=2", "mesh.expert=2"], 4),
                        (["mesh.data=1", "mesh.expert=-1"], 4)):
        sizes = check_step_config(port_config(overrides=TINY_MOE + mesh),
                                  world)
        assert sizes["expert"] == world // sizes["data"]


def test_shard_map_refusal_is_jax_s():
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )
    from distributed_tensorflow_framework_tpu.core.config import load_config
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.train.step import (
        StepBuilder as JaxStepBuilder,
    )

    over = TINY_MOE + ["mesh.data=1", "mesh.expert=2",
                       "train.spmd_mode=shard_map"]
    with pytest.raises(ValueError) as ours:
        check_step_config(port_config(overrides=over), 2)
    jcfg = load_config(overrides=over)
    with pytest.raises(ValueError) as theirs:
        JaxStepBuilder(jcfg, create_mesh(jcfg.mesh,
                                         devices=jax.devices()[:2]))
    assert str(ours.value) == str(theirs.value)


def test_expert_layout_is_jax_infer_param_specs():
    """``MOE_RULES`` put ``wi``/``wo``'s E over ``expert`` (the rest of
    the tree replicated), as JAX's ``infer_param_specs`` does."""
    from distributed_tensorflow_framework_torch.models.convert import (
        flax_layout,
    )
    from distributed_tensorflow_framework_torch.parallel import (
        sharding as shd,
    )
    from distributed_tensorflow_framework_tpu.core.config import MeshConfig
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.parallel import (
        sharding as jshd,
    )

    _, model = _port_bert(TINY_MOE)
    assert shd.MOE_RULES == jshd.MOE_RULES
    for sizes in ({"expert": 2}, {"data": 2, "expert": 2}, {"expert": 4},
                  {"fsdp": 2}):
        n = int(np.prod(list(sizes.values())))
        mesh = create_mesh(MeshConfig(**{"data": 1, **sizes}),
                           devices=jax.devices()[:n])
        specs = flatten_tree(jax.tree.map(
            lambda s: s, jshd.infer_param_specs(to_flax(model), mesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        ours = shd.infer_param_specs(model, sizes)
        split = 0
        for key, (path, shape) in flax_layout(model).items():
            want = tuple(specs[path]) + (None,) * (len(shape)
                                                   - len(specs[path]))
            assert ours[key] == want, (sizes, key)
            split += "expert" in want
        assert split == (0 if "expert" not in sizes else 2)


# ------------------------------------------------------------ the hook

def _trainer_stub(tmp_path):
    from types import SimpleNamespace

    from distributed_tensorflow_framework_torch.core import telemetry

    events = str(tmp_path / "events.jsonl")
    return SimpleNamespace(writer=SimpleNamespace(
        telemetry=telemetry.TelemetryWriter(events, run_id="hook-run")),
        _events_path=events)


def _health(trainer):
    trainer.writer.telemetry.close()
    with open(trainer._events_path) as fh:
        return [e for e in map(json.loads, fh) if e["kind"] == "health"]


def test_moe_collapse_hook_fires_on_induced_collapse(tmp_path):
    from distributed_tensorflow_framework_torch.train import hooks

    hook = hooks.MoECollapseHook(patience=2)
    trainer = _trainer_stub(tmp_path)
    for step in (1, 2, 3):
        hook.after_step(trainer, step, {"moe_drop_frac": 0.01,
                                        "moe_aux_loss": 1.02})
    assert hook.fired_steps == []
    hook.after_step(trainer, 4, {"moe_drop_frac": 0.7, "moe_aux_loss": 5.0})
    assert hook.fired_steps == []
    hook.after_step(trainer, 5, {"moe_drop_frac": 0.72, "moe_aux_loss": 5.5})
    assert hook.fired_steps == [5]
    evs = _health(trainer)
    assert len(evs) == 1
    h = evs[0]["health"]
    assert h["warning"] == "moe_collapse" and h["streak"] == 2
    assert h["moe_drop_frac_value"] == pytest.approx(0.72)
    assert h["moe_aux_loss_value"] == pytest.approx(5.5)


def test_moe_collapse_streak_resets_on_recovery(tmp_path):
    from distributed_tensorflow_framework_torch.train import hooks

    hook = hooks.MoECollapseHook(patience=2)
    trainer = _trainer_stub(tmp_path)
    hook.after_step(trainer, 1, {"moe_drop_frac": 0.9})
    hook.after_step(trainer, 2, {"moe_drop_frac": 0.0})
    hook.after_step(trainer, 3, {"moe_drop_frac": 0.9})
    hook.after_step(trainer, 4, None)
    assert hook.fired_steps == []
    assert _health(trainer) == []


def test_trainer_arms_the_hook_and_logs_moe_metrics(tmp_path):
    from distributed_tensorflow_framework_torch.train import hooks
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    cfg = port_config(overrides=TINY_MOE + [
        "train.log_interval=1", "train.eval_steps=1",
        "model.dropout_rate=0.1", "model.remat=true"])
    trainer = Trainer(cfg, device="cpu", log_dir=str(tmp_path))
    trainer.build()
    assert any(isinstance(h, hooks.MoECollapseHook)
               for h in trainer.default_hooks())
    final = trainer.train()
    trainer.writer.close()
    for k in ("loss", "moe_aux_loss", "total_loss", "moe_drop_frac"):
        assert np.isfinite(final[k]), k
    assert 0.0 <= final["moe_drop_frac"] <= 1.0
    with open(tmp_path / "events.jsonl") as fh:
        meta = next(e for e in map(json.loads, fh)
                    if e["kind"] == "run_meta")["extra"]
    assert meta["expert_parallel"] == 1 and meta["ep_sharded_leaves"] == 0


# ------------------------------------------------------------ serving

def test_moe_artifact_serves_the_model_logits(tmp_path):
    from distributed_tensorflow_framework_torch.serve import engine as pe
    from distributed_tensorflow_framework_torch.serve import export as px

    cfg, model = _port_bert(TINY_MOE)
    cfg = port_config(overrides=TINY_MOE + ["serve.seq_buckets=[16,32]"])
    art = px.load_artifact(px.save_artifact(
        str(tmp_path / "art"), model_config=cfg.model, task="mlm",
        params=to_flax(model), step=3,
        input_spec=px.input_spec_for(cfg, "mlm")))
    eng = pe.InferenceEngine(art, cfg.serve, device="cpu")
    try:
        ids = np.random.default_rng(1).integers(0, 128, (2, 32)).astype(
            np.int32)
        got = eng.predict({"input_ids": ids}, timeout=60)
    finally:
        eng.drain(30)
    with torch.inference_mode():
        want = model(_t(ids).long(), torch.ones(2, 32, dtype=torch.long))
    assert got.shape == (2, 32, 128)
    np.testing.assert_allclose(got, want["logits"].numpy(), rtol=1e-5,
                               atol=1e-5)
