"""The port's MLM record pipeline and exact eval against the JAX package.

The records are written here with ``tf.io.TFRecordWriter``. With
``shuffle_buffer=1`` tf's shuffle is the identity, so the port's stream
(``data/text_mlm.py`` over ``data/tfdata.py`` and the native reader) must
equal the JAX ``make_mlm`` (tf.data) batch for batch, every array equal,
and the iterator states equal as JSON: unpacked, packed 4:1 (with a
backlog case), the exact eval stream with its padded tail, and the native
path against JAX's native path. Then: resume mid-stream, the guards, a
wrong-length record, and with shuffle on, each epoch a permutation of the
JAX epoch's records (tf's shuffle order itself is not reproduced).
Mirrors ``tests/test_mlm_pipeline.py``.

The trainer half mirrors ``tests/test_packed_attention.py:154`` and
``tests/test_exact_eval.py``: a tiny BERT (weights carried across by
models/convert.py) takes one packed step from records on both sides (the
JAX side through Pallas in interpret mode, the port's through the plain
versions on the CPU), with the tolerances of
``tests/test_torch_train.py`` (loss rtol 1e-5, gradients within 1e-5 of
the largest); and the exact eval over a finite record set gives JAX
``Trainer.evaluate``'s ``eval_examples`` exactly and its metrics within
rtol 1e-5 (f32 sums of the same products in other orders).
"""

import json
import os

import jax
import numpy as np
import pytest
import tensorflow as tf
import torch

from distributed_tensorflow_framework_torch.core import telemetry
from distributed_tensorflow_framework_torch.core.config import (
    DataConfig,
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import packing
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.data.text_mlm import make_mlm
from distributed_tensorflow_framework_torch.models.convert import (
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_torch.train.step import StepBuilder
from distributed_tensorflow_framework_tpu.core.config import (
    DataConfig as JaxDataConfig,
    MeshConfig,
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.core.mesh import (
    create_mesh,
    initialize_runtime,
)
from distributed_tensorflow_framework_tpu.data.infeed import to_global
from distributed_tensorflow_framework_tpu.data.text_mlm import (
    make_mlm as jax_make_mlm,
)
from distributed_tensorflow_framework_tpu.train import Trainer as JaxTrainer
from distributed_tensorflow_framework_tpu.train.step import (
    StepBuilder as JaxStepBuilder,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401

SEQ = 32


def _write(root, sizes, lengths, seed):
    """One file per entry of ``sizes``; each record a document of a length
    drawn from ``lengths`` (lo, hi), zero-padded to SEQ."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for f, n in enumerate(sizes):
        with tf.io.TFRecordWriter(os.path.join(root,
                                               f"mlm-{f:03d}.tfrecord")) as w:
            for _ in range(n):
                ids = np.zeros(SEQ, np.int64)
                k = int(rng.integers(lengths[0], lengths[1] + 1))
                ids[:k] = rng.integers(1000, 2000, k)
                w.write(tf.train.Example(features=tf.train.Features(feature={
                    "input_ids": tf.train.Feature(
                        int64_list=tf.train.Int64List(value=ids)),
                })).SerializeToString())
    return str(root)


@pytest.fixture(scope="module")
def short_docs(tmp_path_factory):
    """60 documents of 3..12 tokens in 3 uneven files."""
    return _write(tmp_path_factory.mktemp("short"), (20, 13, 27), (3, 12), 0)


@pytest.fixture(scope="module")
def long_docs(tmp_path_factory):
    """Documents of 16..32 tokens: 4:1 packing overflows the row budget."""
    return _write(tmp_path_factory.mktemp("long"), (30, 30), (16, 32), 1)


def _cfgs(root, **kw):
    base = dict(name="text_mlm", data_dir=root, global_batch_size=4,
                seq_len=SEQ, shuffle_buffer=1, seed=11, vocab_size=2000)
    base.update(kw)
    return DataConfig(**base), JaxDataConfig(**base)


def _pair(root, *, train=True, **kw):
    pcfg, jcfg = _cfgs(root, **kw)
    return (make_mlm(pcfg, 0, 1, train=train),
            jax_make_mlm(jcfg, 0, 1, train=train))


def _json(state):
    return json.dumps(state, sort_keys=True)


def _assert_streams_equal(ours, ref, n):
    assert ours.element_spec == ref.element_spec
    assert _json(ours.state()) == _json(ref.state())
    for i in range(n):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys(), i
        for key in a:
            assert a[key].dtype == b[key].dtype, (i, key)
            np.testing.assert_array_equal(a[key], b[key],
                                          err_msg=f"batch {i} {key}")
        assert _json(ours.state()) == _json(ref.state()), i


def test_unpacked_stream_equals_jax(short_docs):
    # 15 batches an epoch: 20 cross into the second.
    _assert_streams_equal(*_pair(short_docs), 20)


def test_packed_stream_equals_jax(short_docs):
    ours, ref = _pair(short_docs, pack_factor=4)
    assert "segment_ids" in ours.element_spec
    _assert_streams_equal(ours, ref, 12)
    assert ours.state()["carry"] is not None


def test_packed_backlog_and_carry_equal_jax(long_docs, caplog):
    """Long documents overflow 4:1 packing, so the carry rides the state;
    restored under pack_factor 2, that carry is a backlog of more than two
    raw batches, and the next batches pack from the carry alone."""
    ours, ref = _pair(long_docs, pack_factor=4)
    _assert_streams_equal(ours, ref, 6)
    state = json.loads(_json(ours.state()))
    assert len(state["carry"]) >= 2 * 4
    ours, ref = _pair(long_docs, pack_factor=2)
    ours.restore(state)
    ref.restore(state)
    _assert_streams_equal(ours, ref, 6)
    assert "sequence packing backlog" in caplog.text


def test_exact_eval_stream_equals_jax(short_docs):
    ours, ref = _pair(short_docs, train=False, global_batch_size=8)
    assert ours.cardinality == ref.cardinality == 8  # ceil(60 / 8)
    _assert_streams_equal(ours, ref, 8)
    with pytest.raises(StopIteration):
        next(ours)
    ours.restore({"inner": {"batches": 0, "seed": 0}})
    batches = [next(ours) for _ in range(8)]
    tail = batches[-1]["attention_mask"]
    assert tail[:4].any(axis=1).all() and not tail[4:].any()
    assert sum(int(b["attention_mask"].any(axis=1).sum())
               for b in batches) == 60


def test_native_stream_equals_jax_native(short_docs):
    ours, ref = _pair(short_docs, use_native_reader=True)
    # 60 records in file order, 15 batches an epoch: 20 cross into epoch 2.
    _assert_streams_equal(ours, ref, 20)
    assert ours.state()["epoch"] == 1


@pytest.mark.parametrize("kw", [dict(pack_factor=4),
                                dict(use_native_reader=True),
                                dict(shuffle_buffer=16)])
def test_resume_mid_stream_equals_uninterrupted(short_docs, kw):
    pcfg, _ = _cfgs(short_docs, **kw)
    ds = make_mlm(pcfg, 0, 1)
    for _ in range(7):
        next(ds)
    saved = json.loads(_json(ds.state()))  # the checkpoint's round trip
    want = [next(ds) for _ in range(9)]
    resumed = make_mlm(pcfg, 0, 1)
    resumed.restore(saved)
    for a, b in zip(want, (next(resumed) for _ in range(9))):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_guards(short_docs):
    pcfg, _ = _cfgs(short_docs)
    with pytest.raises(ValueError, match="3 TFRecord file"):
        make_mlm(pcfg, 0, 4)
    pcfg, _ = _cfgs(short_docs, use_native_reader=True)
    with pytest.raises(ValueError, match="3 TFRecord file"):
        make_mlm(pcfg, 0, 4)
    with pytest.raises(ValueError, match="no exact-eval path"):
        make_mlm(pcfg, 0, 1, train=False)
    pcfg, _ = _cfgs(short_docs, use_native_reader=True, pack_factor=4)
    with pytest.raises(ValueError, match="pack_factor"):
        make_mlm(pcfg, 0, 1)
    pcfg, _ = _cfgs(short_docs, global_batch_size=64, use_native_reader=True)
    with pytest.raises(RuntimeError, match="shard too small"):
        next(make_mlm(pcfg, 0, 1))
    pcfg, _ = _cfgs(short_docs, global_batch_size=8)
    with pytest.raises(RuntimeError, match="needs the process group"):
        make_mlm(pcfg, 0, 2, train=False)


def test_wrong_length_record_raises(tmp_path):
    root = _write(tmp_path / "wrong", (3,), (4, 8), 2)
    with tf.io.TFRecordWriter(os.path.join(root, "mlm-001.tfrecord")) as w:
        w.write(tf.train.Example(features=tf.train.Features(feature={
            "input_ids": tf.train.Feature(int64_list=tf.train.Int64List(
                value=[5] * (SEQ - 1)))})).SerializeToString())
    pcfg, _ = _cfgs(root, global_batch_size=2)
    with pytest.raises(ValueError, match=f"mlm-001.tfrecord: record 0 holds "
                                         f"{SEQ - 1} values"):
        for _ in range(3):
            next(make_mlm(pcfg, 0, 1, train=False))


def _tokens(batch):
    """The unmasked rows of an unpacked batch: targets hold the original
    token wherever the masker changed one."""
    t = np.where(batch["targets"] >= 0, batch["targets"], batch["input_ids"])
    return [tuple(row) for row in t]


def test_shuffled_epochs_permute_the_jax_epoch(short_docs):
    """shuffle_buffer 16 over 60 records: each epoch (15 batches) holds
    exactly the JAX epoch's records in another order, rebuilding the
    dataset gives the same order, and the epochs differ."""
    _, jcfg = _cfgs(short_docs)
    ref = jax_make_mlm(jcfg, 0, 1)
    jax_epoch = sum((_tokens(next(ref)) for _ in range(15)), [])
    pcfg, _ = _cfgs(short_docs, shuffle_buffer=16)
    runs = []
    for _ in range(2):
        ds = make_mlm(pcfg, 0, 1)
        runs.append([sum((_tokens(next(ds)) for _ in range(15)), [])
                     for _ in range(2)])
    assert runs[0] == runs[1]
    first, second = runs[0]
    assert sorted(first) == sorted(second) == sorted(jax_epoch)
    assert first != jax_epoch and first != second


# ------------------------------------------------------------- trainer

TINY_BERT = [
    "model.name=bert", "model.vocab_size=2048", "model.hidden_size=32",
    "model.num_layers=2", "model.num_heads=2", "model.mlp_dim=64",
    "model.max_seq_len=32", "model.dtype=float32", "model.dropout_rate=0.0",
    "data.name=text_mlm", "data.vocab_size=2048", "data.seq_len=32",
    "data.global_batch_size=4", "data.shuffle_buffer=1", "data.seed=3",
    "optimizer.name=adamw", "optimizer.learning_rate=1e-3",
    "optimizer.warmup_steps=2", "optimizer.grad_clip_norm=1.0",
    "mesh.data=1", "checkpoint.directory=", "resilience.rollback=false",
]


def test_packed_step_from_records_matches_jax_step_builder(short_docs):
    over = TINY_BERT + ["model.attention_impl=pallas", "data.pack_factor=4",
                        f"data.data_dir={short_docs}"]
    pcfg, jcfg = port_config(overrides=over), jax_config(overrides=over)
    host = next(make_mlm(pcfg.data, 0, 1))
    np.testing.assert_array_equal(
        host["segment_ids"], next(jax_make_mlm(jcfg.data, 0, 1))[
            "segment_ids"])
    assert host["segment_ids"].max() > 1  # rows hold several documents
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jbuilder = JaxStepBuilder(jcfg, mesh)
    jbatch = to_global(host, mesh)
    jstate = jbuilder.init_state(0, jbatch)
    params = jax.device_get(jstate.params)  # the step donates the state
    jgrads = jax.device_get(jax.jit(jbuilder._microbatch_grads)(
        jstate, jbatch)[0])
    _, jm = jbuilder.make_train_step(jbatch)(jstate, jbatch)

    builder = StepBuilder(pcfg, device="cpu")
    state = builder.init_state(0)
    state.model.load_state_dict(flax_to_state_dict(params))
    batch = to_device(host, torch.device("cpu"))
    state.optimizer.zero_grad()
    builder._micro_step(state, batch, 1.0)
    ours = flatten_tree(to_flax(state.model, {
        k: p.grad for k, p in state.model.named_parameters()}))
    ref = flatten_tree(jgrads)
    top = max(np.abs(g).max() for g in ref.values())
    for path, g in ref.items():
        assert np.abs(ours[path] - g).max() <= 1e-5 * top, path
    pm = builder.train_step(state, batch)
    jm = jax.device_get(jm)
    np.testing.assert_allclose(float(pm["loss"]), jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(pm["grad_norm"]), jm["grad_norm"],
                               rtol=1e-4)


@pytest.fixture(scope="module")
def eval_docs(tmp_path_factory):
    """37 evaluation documents in 2 files: 5 batches of 8, the last with
    5 real rows."""
    return _write(tmp_path_factory.mktemp("eval"), (20, 17), (3, 30), 4)


def test_exact_eval_matches_jax_trainer(short_docs, eval_docs, tmp_path):
    over = TINY_BERT + [
        "model.attention_impl=xla", f"data.data_dir={short_docs}",
        "data.pack_factor=4", "eval_data.name=text_mlm",
        f"eval_data.data_dir={eval_docs}", "eval_data.seq_len=32",
        "eval_data.vocab_size=2048", "eval_data.global_batch_size=8",
        "eval_data.seed=5", "train.total_steps=2", "train.log_interval=1",
        "train.eval_steps=2"]
    jt = JaxTrainer(jax_config(overrides=over),
                    initialize_runtime(MeshConfig(data=1),
                                       devices=jax.devices()[:1]))
    jt.build()
    ref = jt.evaluate()
    pt = Trainer(port_config(overrides=over), device="cpu",
                 log_dir=str(tmp_path))
    pt.build()
    pt.state.model.load_state_dict(flax_to_state_dict(
        jax.device_get(jt.state.params)))
    ours = pt.evaluate()
    assert pt._eval_ds.cardinality == 5
    # Every record once: the masked positions of all 37 documents.
    masked = 0
    ds = make_mlm(pt.config.eval_data, 0, 1, train=False)
    for _ in range(5):
        masked += int((next(ds)["targets"] >= 0).sum())
    assert ours["eval_examples"] == ref["eval_examples"] == masked
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5,
                                   err_msg=key)
    # eval_steps=2 below the cardinality truncates, and says so.
    assert pt.evaluate(num_batches=2)["eval_examples"] < masked
    assert pt.evaluate(num_batches=50) == ours


def test_trainer_emits_the_packing_census(short_docs, tmp_path):
    over = TINY_BERT + ["model.attention_impl=pallas", "data.pack_factor=4",
                        f"data.data_dir={short_docs}", "train.total_steps=4",
                        "train.log_interval=2", "train.eval_steps=0"]
    trainer = Trainer(port_config(overrides=over), device="cpu",
                      log_dir=str(tmp_path))
    trainer.train()
    trainer.writer.close()
    with open(tmp_path / "events.jsonl") as fh:
        events = [json.loads(line) for line in fh]
    census = [e for e in events if e["kind"] == telemetry.KIND_DATA_PACKING]
    assert [e["step"] for e in census] == [2, 4]
    real = padded = 0
    ds = make_mlm(trainer.config.data, 0, 1)
    for _ in range(4):
        mask = next(ds)["attention_mask"]
        real += int(mask.sum())
        padded += int(mask.size - mask.sum())
    assert census[-1]["metrics"] == packing.packing_stats(real, padded)
    assert census[-1]["metrics"]["packing_efficiency"] > 0.8
