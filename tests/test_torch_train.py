"""PyTorch port of the BERT-MLM training slice vs the JAX package.

Each piece gets the same numpy inputs (made from a seed) on both sides:
the synthetic MLM stream and the masking, the MLM loss and metric sums,
the schedules, the AdamW chain and its decay mask, and a tiny BERT taking
three optimizer steps through the JAX ``StepBuilder`` (Pallas in interpret
mode) and the port's (flash attention's plain PyTorch versions on the
CPU), from the same parameters carried across by models/convert.py.

Tolerances, with their reasons:
  * the data stream and the decay mask: exact (same numpy calls, same rule);
  * losses and metric sums: rtol 1e-6 — f32 log-softmax summed in another
    order;
  * schedules: rtol 1e-6 and atol 1e-6 × the base rate — optax evaluates
    in f32, the port in f64;
  * AdamW over 5 steps on identical gradients: rtol 1e-5 and an atol of
    1e-3 × lr — one update moves a parameter by ~lr, and f32 rounding of
    m̂/(√v̂+ε) differs in the last bits between optax and torch.optim;
  * the tiny BERT: loss rtol 1e-5 and grad_norm rtol 1e-4 (f32 sums of
    the same products in other orders); gradients leaf by leaf within
    1e-5 of the step's largest gradient (observed 2e-6), an absolute bound
    because the key-projection bias has a gradient that is zero in exact
    arithmetic and f32 noise on both sides; parameters within an atol of
    1e-3 × lr, because Adam divides each gradient by √v̂ + ε, so that noise
    moves a parameter by up to noise/ε × lr (observed 6e-4 × lr at
    ε = 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_framework_torch.cli import train as port_cli
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import (
    get_dataset as port_dataset,
)
from distributed_tensorflow_framework_torch.data import text_mlm as port_text
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.models.convert import (
    flatten_tree,
    flax_layout,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.train import losses as port_losses
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_torch.train.optimizers import (
    decay_mask,
    make_optimizer,
)
from distributed_tensorflow_framework_torch.train.schedules import (
    make_schedule,
)
from distributed_tensorflow_framework_torch.train.step import StepBuilder
from distributed_tensorflow_framework_tpu.core.config import (
    MeshConfig,
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
from distributed_tensorflow_framework_tpu.data import get_dataset as jax_dataset
from distributed_tensorflow_framework_tpu.data import text_mlm as jax_text
from distributed_tensorflow_framework_tpu.data.infeed import to_global
from distributed_tensorflow_framework_tpu.train import losses as jax_losses
from distributed_tensorflow_framework_tpu.train import (
    optimizers as jax_optimizers,
)
from distributed_tensorflow_framework_tpu.train import schedules as jax_sched
from distributed_tensorflow_framework_tpu.train.step import (
    StepBuilder as JaxStepBuilder,
)

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
    "train.total_steps=3", "mesh.data=1",
]
NO_CKPT = ["checkpoint.directory=", "resilience.rollback=false"]


def _both(overrides):
    return port_config(overrides=overrides), jax_config(overrides=overrides)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("name", ["synthetic_mlm", "text_mlm"])
def test_synthetic_mlm_stream_is_bit_identical(name):
    over = [f"data.name={name}", "data.seq_len=64", "data.vocab_size=700",
            "data.global_batch_size=4", "data.seed=3"]
    pcfg, jcfg = _both(over)
    pds, jds = port_dataset(pcfg.data), jax_dataset(jcfg.data)
    for _ in range(3):
        a, b = next(pds), next(jds)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_stream_state_restores_like_jax():
    pcfg, _ = _both(["data.name=synthetic_mlm", "data.seq_len=16",
                     "data.global_batch_size=2"])
    ds = port_dataset(pcfg.data)
    start = ds.state()
    first = next(ds)
    next(ds)
    ds.restore(start)
    np.testing.assert_array_equal(next(ds)["input_ids"], first["input_ids"])


def test_apply_mlm_mask_is_bit_identical():
    tokens = np.random.default_rng(0).integers(0, 2000, (4, 64)).astype(
        np.int32)
    tokens[:, 0] = port_text.CLS_ID
    a = port_text.apply_mlm_mask(tokens, np.random.default_rng(1), 0.15, 2000)
    b = jax_text.apply_mlm_mask(tokens, np.random.default_rng(1), 0.15, 2000)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_tfrecords_in_data_dir_are_read(tmp_path):
    """The layout that the port once refused (MLM TFRecords under
    data.data_dir) is read now, into the JAX package's batches."""
    from distributed_tensorflow_framework_torch.data import progression

    rows = np.random.default_rng(0).integers(1000, 2000, (6, 16))
    progression.write_tfrecords(
        str(tmp_path / "train-00000.tfrecord"),
        (progression.encode_example(r) for r in rows))
    pcfg, jcfg = _both(["data.name=text_mlm", f"data.data_dir={tmp_path}",
                        "data.seq_len=16", "data.global_batch_size=2",
                        "data.shuffle_buffer=1", "data.vocab_size=2000"])
    pds, jds = port_dataset(pcfg.data), jax_dataset(jcfg.data)
    for _ in range(4):
        a, b = next(pds), next(jds)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


def test_to_device_keeps_values_and_dtypes():
    batch = {"a": np.arange(6, dtype=np.int32).reshape(2, 3)}
    out = to_device(batch, torch.device("cpu"))
    assert out["a"].dtype == torch.int32
    np.testing.assert_array_equal(out["a"].numpy(), batch["a"])


# ---------------------------------------------------------------- losses

def _logits_targets(seed, all_unmasked=False):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((4, 16, 50))).astype(np.float32)
    targets = rng.integers(0, 50, (4, 16)).astype(np.int32)
    targets[rng.random((4, 16)) > 0.3] = -1
    if all_unmasked:
        targets[:] = -1
    return logits, targets


@pytest.mark.parametrize("all_unmasked", [False, True])
def test_mlm_loss_matches_jax(all_unmasked):
    logits, targets = _logits_targets(1, all_unmasked)
    loss, m = port_losses.mlm_loss(torch.from_numpy(logits),
                                   torch.from_numpy(targets))
    jloss, jm = jax_losses.mlm_loss(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(m["mlm_acc"].item(), float(jm["mlm_acc"]),
                               rtol=1e-6)


def test_mlm_metrics_sums_match_jax():
    logits, targets = _logits_targets(2)
    weight = np.array([1, 1, 0, 1], np.float32)
    got = port_losses.mlm_metrics_sums(torch.from_numpy(logits),
                                       torch.from_numpy(targets),
                                       torch.from_numpy(weight))
    ref = jax_losses.mlm_metrics_sums(jnp.asarray(logits),
                                      jnp.asarray(targets),
                                      jnp.asarray(weight))
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(got[key].item(), float(ref[key]),
                                   rtol=1e-6)


# ------------------------------------------------------------- schedules

@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear",
                                      "staircase"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_schedules_match_optax(schedule, warmup):
    over = [f"optimizer.schedule={schedule}",
            f"optimizer.warmup_steps={warmup}",
            "optimizer.learning_rate=0.5", "optimizer.decay_factor=0.1",
            "optimizer.boundaries=[30,60,60]"]
    pcfg, jcfg = _both(over)
    total = 100
    ours = make_schedule(pcfg.optimizer, total)
    ref = jax_sched.make_schedule(jcfg.optimizer, total)
    steps = sorted({0, 1, warmup - 1, warmup, warmup + 1, 29, 30, 31, 59, 60,
                    61, 99, 100, 150} - {-1})
    for step in steps:
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-6 * 0.5, err_msg=f"step {step}")


# ------------------------------------------------------------- optimizer

def _tiny_model(overrides=()):
    pcfg = port_config(overrides=TINY_BERT + list(overrides))
    return pcfg, get_model(pcfg.model, device="cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_decay_mask_matches_jax_leaf_by_leaf(fused):
    _, model = _tiny_model([f"model.fused_qkv={str(fused).lower()}"])
    ours = {flax_layout(model)[k][0]: v for k, v in decay_mask(model).items()}
    ref = flatten_tree(jax_optimizers.decay_mask_tree(to_flax(model)))
    assert ours == {path: bool(v) for path, v in ref.items()}
    assert ours[("embed_block", "embed", "embedding")]
    assert ours[("embed_block", "pos_embedding")]
    assert not ours[("head", "mlm_bias")]


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # clip idle / triggered
def test_adamw_chain_matches_optax(grad_scale):
    pcfg, model = _tiny_model()
    jcfg = jax_config(overrides=TINY_BERT)
    total, lr = 10, pcfg.optimizer.learning_rate
    opt, _ = make_optimizer(pcfg.optimizer, total, model)
    tx, _ = jax_optimizers.make_optimizer(jcfg.optimizer, total)
    params = jax.tree.map(jnp.asarray, to_flax(model))
    opt_state = tx.init(params)
    rng = np.random.default_rng(4)
    named = dict(model.named_parameters())
    for step in range(5):
        grads = jax.tree.map(lambda p: (grad_scale * rng.standard_normal(
            p.shape)).astype(np.float32), to_flax(model))
        for key, g in flax_to_state_dict(grads).items():
            named[key].grad = g.clone()
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in named.values()))
        opt.step(norm)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        ours = flatten_tree(to_flax(model))
        for path, ref in flatten_tree(jax.device_get(params)).items():
            np.testing.assert_allclose(ours[path], ref, rtol=1e-5,
                                       atol=1e-3 * lr,
                                       err_msg=f"step {step} {path}")


def test_other_optimizers_raise():
    """The optimizers of the JAX package are ported
    (tests/test_torch_optimizers.py); a name it does not know raises."""
    pcfg, model = _tiny_model(["optimizer.name=adafactor"])
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer(pcfg.optimizer, 10, model)


# ------------------------------------------------------ the train step

def _jax_builder(jcfg):
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    return JaxStepBuilder(jcfg, mesh), mesh


def _port_grads(builder, state, batch):
    """The step's gradients before clipping, keyed by state_dict name."""
    state.optimizer.zero_grad()
    builder._micro_step(state, batch, 1.0)
    return {k: p.grad.clone() for k, p in state.model.named_parameters()}


@pytest.mark.parametrize("fused", [True, False])
def test_tiny_bert_three_steps_match_jax_step_builder(fused):
    over = TINY_BERT + [f"model.fused_qkv={str(fused).lower()}"]
    pcfg, jcfg = _both(over)
    jbuilder, mesh = _jax_builder(jcfg)
    ds = jax_dataset(jcfg.data)
    batches = [next(ds) for _ in range(3)]
    jstate = jbuilder.init_state(0, to_global(batches[0], mesh))
    jstep = jbuilder.make_train_step(to_global(batches[0], mesh))
    jgrads = jax.jit(jbuilder._microbatch_grads)

    pbuilder = StepBuilder(pcfg, device="cpu")
    pstate = pbuilder.init_state(0)
    pstate.model.load_state_dict(flax_to_state_dict(
        jax.device_get(jstate.params)))
    lr = pcfg.optimizer.learning_rate
    for i, host in enumerate(batches):
        jbatch = to_global(host, mesh)
        tbatch = to_device(host, torch.device("cpu"))
        g_ref = flatten_tree(jax.device_get(jgrads(jstate, jbatch)[0]))
        g_ours = flatten_tree(to_flax(pstate.model, _port_grads(
            pbuilder, pstate, tbatch)))
        top = max(np.abs(g).max() for g in g_ref.values())
        for path, ref in g_ref.items():
            err = np.abs(g_ours[path] - ref).max()
            assert err <= 1e-5 * top, f"step {i} grad {path}: {err:.2e}"
        jstate, jm = jstep(jstate, jbatch)
        pm = pbuilder.train_step(pstate, tbatch)
        jm = jax.device_get(jm)
        np.testing.assert_allclose(float(pm["loss"]), jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(float(pm["mlm_acc"]), jm["mlm_acc"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(pm["grad_norm"]), jm["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(pm["learning_rate"],
                                   jm["learning_rate"], rtol=1e-6)
        ours = flatten_tree(to_flax(pstate.model))
        for path, ref in flatten_tree(jax.device_get(jstate.params)).items():
            np.testing.assert_allclose(ours[path], ref, rtol=0,
                                       atol=1e-3 * lr,
                                       err_msg=f"step {i} param {path}")
    assert pstate.step == 3


def test_grad_accum_matches_full_batch():
    """grad_accum_steps=2 weights each micro-batch by its masked-token
    count, which reproduces the full-batch gradient and metrics."""
    over = TINY_BERT + ["optimizer.grad_clip_norm=0",
                        "optimizer.warmup_steps=0"]
    results = []
    for accum in (1, 2):
        cfg = port_config(overrides=over + [f"train.grad_accum_steps={accum}"])
        builder = StepBuilder(cfg, device="cpu")
        state = builder.init_state(0)
        batch = to_device(next(port_dataset(cfg.data)), torch.device("cpu"))
        metrics = builder.train_step(state, batch)
        results.append((metrics, {k: p.detach().clone() for k, p in
                                  state.model.named_parameters()}))
    (m1, p1), (m2, p2) = results
    for key in ("loss", "mlm_acc", "grad_norm"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=1e-5)
    lr = 1e-3
    for key in p1:
        torch.testing.assert_close(p2[key], p1[key], rtol=0, atol=2 * lr)


def test_grad_accum_must_divide_the_batch():
    cfg = port_config(overrides=TINY_BERT + ["train.grad_accum_steps=3"])
    builder = StepBuilder(cfg, device="cpu")
    state = builder.init_state(0)
    batch = to_device(next(port_dataset(cfg.data)), torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        builder.train_step(state, batch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_keep_scaling_matches_flax(dtype):
    """Kept values equal Flax ``nn.Dropout``'s bit for bit (Flax divides by
    keep_prob rounded to the activation dtype); the masks come from
    different generators, so only positions both keep are compared."""
    import flax.linen as fnn

    from distributed_tensorflow_framework_torch.models.bert import dropout

    x = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = fnn.Dropout(0.1, deterministic=False).apply(
        {}, jnp.asarray(x).astype(jdt), rngs={"dropout": jax.random.key(0)})
    got = dropout(torch.from_numpy(x).to(tdt), 0.1,
                  torch.Generator().manual_seed(0), training=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    both = (ref != 0) & (got != 0)
    assert both.mean() > 0.75
    np.testing.assert_array_equal(got[both], ref[both])
    assert 0.05 < (got == 0).mean() < 0.15


def test_dropout_draws_from_the_trainer_generator():
    """With dropout on, two states seeded alike take identical steps, and
    eval mode is deterministic (dropout is the identity there)."""
    cfg = port_config(overrides=TINY_BERT + ["model.dropout_rate=0.1"])
    builder = StepBuilder(cfg, device="cpu")
    batch = to_device(next(port_dataset(cfg.data)), torch.device("cpu"))
    losses = [float(builder.train_step(builder.init_state(0), batch)["loss"])
              for _ in range(2)]
    assert losses[0] == losses[1]
    state = builder.init_state(0)
    evals = [builder.eval_step(state, batch)["loss_sum"].item()
             for _ in range(2)]
    assert evals[0] == evals[1]
    assert state.model.training  # eval_step hands it back in train()


# -------------------------------------------------------- loop and CLI

CLI_TINY = TINY_BERT + NO_CKPT + [
    "train.total_steps=4", "train.log_interval=2", "train.eval_steps=2",
    "train.eval_interval=2"]


def _cli_args(overrides, *extra):
    return [*extra, *sum((["--set", o] for o in overrides), [])]


def test_cli_trains_end_to_end_on_cpu(tmp_path):
    import json

    rc = port_cli.main(_cli_args(CLI_TINY, "--device", "cpu", "--log-dir",
                                 str(tmp_path)))
    assert rc == 0
    events = [json.loads(line) for line in
              (tmp_path / "events.jsonl").read_text().splitlines()]
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "run_meta"
    train = [e for e in events if e["kind"] == "train_step"]
    assert [e["step"] for e in train] == [2, 4]
    for e in train:
        assert np.isfinite(e["metrics"]["loss"])
        assert set(e["metrics"]) >= {"loss", "mlm_acc", "grad_norm",
                                     "learning_rate"}
        assert "examples_per_sec" in e["throughput"]
    assert [e["step"] for e in events if e["kind"] == "eval"] == [2, 4, 4]


def test_trainer_evaluate_is_repeatable():
    cfg = port_config(overrides=CLI_TINY)
    trainer = Trainer(cfg, device="cpu")
    first = trainer.evaluate()
    assert first == trainer.evaluate()
    assert first["eval_examples"] > 0


def test_cli_print_config_touches_no_device(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_cli.main(["--print-config", "--set", "train.seed=7"]) == 0
    assert "seed: 7" in capsys.readouterr().out


@pytest.mark.parametrize("override, item", [
    ("train.profile_stop=5", "A16"),
    ("train.compilation_cache_dir=/tmp/xla", "A16"),
    ("mesh.pipe=2", "A12"),
    ("mesh.expert=2", "A8 \\(expert parallel\\)"),
    ("precision.remat_policy=save_nothing", "A13"),
    ("model.num_experts=4", "A8"),
    ("precision.matmul_dtype=int8", "A13"),
])
def test_unported_knobs_raise(override, item):
    over = TINY_BERT + NO_CKPT + [override]
    with pytest.raises(NotImplementedError, match=item):
        port_cli.main(_cli_args(over, "--device", "cpu"))


LONG_TINY = ["mesh.seq=1", "model.attention_impl=pallas",
             "checkpoint.directory=", "resilience.rollback=false",
             "model.vocab_size=512", "data.vocab_size=512",
             "model.hidden_size=32", "model.num_layers=2",
             "model.num_heads=2", "model.mlp_dim=64",
             "model.max_seq_len=384", "data.seq_len=384",
             "data.global_batch_size=2", "train.grad_accum_steps=2",
             "train.total_steps=2", "train.log_interval=1"]


@pytest.mark.parametrize("fused, route", [(False, "stream"),
                                          (True, "fused")])
def test_cli_trains_the_long_context_config_on_the_streaming_route(
        tmp_path, monkeypatch, fused, route):
    """configs/bert_long_ring.yaml (remat, bf16, dropout) at tiny width on
    one CPU device, with the streaming thresholds forced small (s = 384
    over MAX_SEQ_VMEM = 128): the forward takes the streaming plain
    version, every backward the streaming route, and the run ends with
    finite metrics."""
    import json
    import pathlib

    from distributed_tensorflow_framework_torch.ops import (
        flash_attention as fa,
    )

    monkeypatch.setattr(fa, "MAX_SEQ_VMEM", 128)
    monkeypatch.setattr(fa, "BLOCK_Q_KB", 128)
    monkeypatch.setattr(fa, "BLOCK_K_KB", 128)
    monkeypatch.setattr(fa, "FUSED_BWD", fused)
    routes, streamed = [], []
    route_fn, kb_fn = fa.backward_route, fa.flash_attention_kb_reference
    monkeypatch.setattr(fa, "backward_route", lambda q, k: routes.append(
        route_fn(q, k)) or routes[-1])
    monkeypatch.setattr(fa, "flash_attention_kb_reference",
                        lambda *a: streamed.append(1) or kb_fn(*a))
    config = pathlib.Path(__file__).resolve().parents[1] / "configs"
    rc = port_cli.main(["--config", str(config / "bert_long_ring.yaml"),
                        "--device", "cpu", "--log-dir", str(tmp_path),
                        *sum((["--set", o] for o in LONG_TINY), [])])
    assert rc == 0
    # 2 steps x 2 micro-batches x 2 layers; the forward runs twice per
    # layer (forward and recompute), the backward once.
    assert routes == [route] * 8
    assert len(streamed) == 16
    train = [json.loads(line) for line in
             (tmp_path / "events.jsonl").read_text().splitlines()
             if json.loads(line)["kind"] == "train_step"]
    assert [e["step"] for e in train] == [1, 2]
    for e in train:
        assert all(np.isfinite(v) for v in e["metrics"].values())


def test_eval_only_raises():
    """--eval-only restores a checkpoint to evaluate; with no checkpoint
    directory there is none, and it raises (tests/test_torch_ckpt.py
    evaluates a restored one)."""
    with pytest.raises(ValueError, match="--eval-only needs a committed"):
        port_cli.main(_cli_args(CLI_TINY, "--device", "cpu", "--eval-only"))
