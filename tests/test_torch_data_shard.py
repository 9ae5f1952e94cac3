"""Per-rank data: the port's ``data/shard.py`` assignment and plan, and the
five input pipelines at ranks 0 and 1 of 2, against the JAX package.

Mirrors ``tests/test_data_shard.py``: ``ShardAssignment`` (from the gang
environment, with its refusals) and ``shard_plan`` equal the JAX ones on
the same inputs; each rank's stream of the synthetic MLM and image
pipelines, MNIST (npz), CIFAR-10 (pickled batches, with its host-local
augmentation) and the MLM TFRecords equals the JAX factory's called with
the same process index and count; and with block sharding the ranks'
blocks of MNIST tile the one-process global batch. Exact, except
standardised pixels, which numpy's f32 ``std`` moves by about 1e-7 with
heap alignment in both packages: within 1e-6.
"""

import os
import pickle

import numpy as np
import pytest

from distributed_tensorflow_framework_torch.core import cluster
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import (
    get_dataset as port_dataset,
)
from distributed_tensorflow_framework_torch.data import shard
from distributed_tensorflow_framework_tpu.core.config import (
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.data import (
    get_dataset as jax_dataset,
)
from distributed_tensorflow_framework_tpu.data import shard as jax_shard
from tests.test_torch_hygiene import torch_threads  # noqa: F401


def _error(fn, *args, **kwargs):
    """The result, or the refusal's type and hint (the messages say
    "ranks" where the JAX package says "hosts")."""
    try:
        return fn(*args, **kwargs)
    except (shard.DataShardError, jax_shard.DataShardError) as e:
        return ("DataShardError", e.hint)


@pytest.mark.parametrize("env", [
    {}, {cluster.ENV_NUM_PROCESSES: "2", cluster.ENV_PROCESS_ID: "1"},
    {cluster.ENV_NUM_PROCESSES: "4"}, {cluster.ENV_PROCESS_ID: "0"},
    {cluster.ENV_NUM_PROCESSES: "2", cluster.ENV_PROCESS_ID: "2"},
    {cluster.ENV_NUM_PROCESSES: "x", cluster.ENV_PROCESS_ID: "0"},
    {cluster.ENV_NUM_PROCESSES: "0"},
])
def test_assignment_from_env_matches_jax(env):
    ours = _error(shard.ShardAssignment.from_env, env)
    ref = _error(jax_shard.ShardAssignment.from_env, env)
    if isinstance(ref, tuple):
        assert ours == ref
    else:
        assert (ours.process_index, ours.process_count) == \
            (ref.process_index, ref.process_count)


@pytest.mark.parametrize("index, count, batch, dp, mode", [
    (0, 1, 8, None, "block"), (1, 2, 8, 2, "block"), (3, 4, 32, 8, "stride"),
    (0, 2, 7, 2, "block"), (1, 2, 8, 3, "block"), (0, 4, 8, 0, "block"),
])
def test_shard_plan_matches_jax(index, count, batch, dp, mode):
    ours = _error(shard.shard_plan, shard.ShardAssignment(index, count),
                  global_batch=batch, data_parallel=dp, shard_mode=mode)
    ref = _error(jax_shard.shard_plan,
                 jax_shard.ShardAssignment(index, count),
                 global_batch=batch, data_parallel=dp, shard_mode=mode)
    assert ours == ref


def _write_mnist(root, n_train=24, n_test=9, seed=0):
    rng = np.random.default_rng(seed)
    np.savez(os.path.join(root, "mnist.npz"),
             x_train=rng.integers(0, 256, (n_train, 28, 28), np.uint8),
             y_train=rng.integers(0, 10, n_train, np.uint8),
             x_test=rng.integers(0, 256, (n_test, 28, 28), np.uint8),
             y_test=rng.integers(0, 10, n_test, np.uint8))


def _write_cifar(root, per_batch=8, n_test=9, seed=0):
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        n = n_test if name == "test_batch" else per_batch
        with open(os.path.join(base, name), "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, fh)


def _write_mlm(root, n_files=3, rows=12, seq=16, seed=0):
    from distributed_tensorflow_framework_torch.data import progression

    rng = np.random.default_rng(seed)
    for i in range(n_files):
        progression.write_tfrecords(
            os.path.join(root, f"train-{i:05d}.tfrecord"),
            (progression.encode_example(r) for r in
             rng.integers(1000, 2000, (rows, seq))))


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        if key == "image" and a[key].dtype == np.float32:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a[key], b[key])


STREAMS = {
    "synthetic_mlm": ["data.name=synthetic_mlm", "data.seq_len=32",
                      "data.vocab_size=700"],
    "synthetic_images": ["data.name=synthetic_images", "data.image_size=8",
                         "data.channels=3", "data.num_classes=10"],
    "mnist": ["data.name=mnist", "data.image_size=28", "data.channels=1"],
    "mnist_stride": ["data.name=mnist", "data.image_size=28",
                     "data.channels=1", "data.shard_mode=stride"],
    "cifar10": ["data.name=cifar10", "data.image_size=32",
                "data.channels=3"],
    "text_mlm": ["data.name=text_mlm", "data.seq_len=16",
                 "data.vocab_size=2000", "data.shuffle_buffer=1"],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("rank", [0, 1])
def test_rank_streams_match_the_jax_factories(name, rank, tmp_path):
    if name.startswith("mnist"):
        _write_mnist(tmp_path)
    elif name == "cifar10":
        _write_cifar(tmp_path)
    elif name == "text_mlm":
        _write_mlm(tmp_path)
    over = STREAMS[name] + [f"data.data_dir={tmp_path}", "data.seed=3",
                            "data.global_batch_size=8"]
    kw = dict(process_index=rank, process_count=2)
    ours = port_dataset(port_config(overrides=over).data, **kw)
    ref = jax_dataset(jax_config(overrides=over).data, **kw)
    for _ in range(4):
        a, b = next(ours), next(ref)
        assert a[next(iter(a))].shape[0] == 4
        _assert_equal(a, b)


def test_rank_blocks_tile_the_global_batch(tmp_path):
    """Block sharding: global batch i is perm[i*B:(i+1)*B] and rank h
    reads block h of it, so the two ranks' batches are the one-process
    batch, in order, at every step and across the epoch boundary."""
    _write_mnist(tmp_path)
    over = STREAMS["mnist"] + [f"data.data_dir={tmp_path}",
                               "data.global_batch_size=8"]
    cfg = port_config(overrides=over).data
    whole = port_dataset(cfg)
    ranks = [port_dataset(cfg, process_index=r, process_count=2)
             for r in range(2)]
    for _ in range(5):
        want = next(whole)
        got = [next(ds) for ds in ranks]
        for key in want:
            np.testing.assert_array_equal(
                np.concatenate([g[key] for g in got]), want[key])
