"""CIFAR-10 pipeline: the port's copy of ``data/cifar.py`` (config 2).

Reads the python-pickle batches of ``cifar-10-batches-py`` under
``data.data_dir``. Train: the epoch shuffle and the block (or stride)
sharding of data/mnist.py, then the reference recipe's augmentation —
reflect pad 4, a random 32×32 crop and a random horizontal flip, drawn
from ``host_rng(seed, ROLE_AUGMENT, epoch, batch, process_index)`` — and
per-image standardisation. The JAX package crops image by image in a
Python loop; here one gather does the whole batch, with the same draws
and the same arrays bit for bit. Eval: the test batch once, standardised,
tail padded (``finite_array_eval``). With no directory it falls back to
synthetic data, with a warning.
"""

from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from distributed_tensorflow_framework_torch.core import prng
from distributed_tensorflow_framework_torch.core.config import DataConfig
from distributed_tensorflow_framework_torch.data import shard, synthetic
from distributed_tensorflow_framework_torch.data.pipeline import (
    HostDataset,
    cast_images,
    finite_array_eval,
    host_batch_size,
    image_np_dtype,
)

log = logging.getLogger(__name__)

PAD = 4
SIZE = 32


def _load(data_dir: str, train: bool) -> tuple[np.ndarray, np.ndarray]:
    base = os.path.join(data_dir, "cifar-10-batches-py")
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for name in names:
        with open(os.path.join(base, name), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"].reshape(-1, 3, SIZE, SIZE).transpose(0, 2, 3, 1))
        ys.append(np.asarray(d[b"labels"], dtype=np.int32))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def standardize(batch: np.ndarray) -> np.ndarray:
    mean = batch.mean(axis=(1, 2, 3), keepdims=True)
    std = batch.std(axis=(1, 2, 3), keepdims=True) + 1e-6
    return (batch - mean) / std


def crop_and_flip(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Reflect-pad by 4, crop 32×32 at offsets drawn in [0, 8] and flip
    half the images horizontally: the JAX loop's draws (offsets, then
    flips) and its output, as one fancy-index gather."""
    n = len(x)
    padded = np.pad(x, ((0, 0), (PAD, PAD), (PAD, PAD), (0, 0)),
                    mode="reflect")
    offs = rng.integers(0, 2 * PAD + 1, size=(n, 2))
    flips = rng.random(n) < 0.5
    ar = np.arange(SIZE)
    rows = offs[:, :1] + ar
    cols = offs[:, 1:] + np.where(flips[:, None], SIZE - 1 - ar, ar)
    return padded[np.arange(n)[:, None, None], rows[:, :, None],
                  cols[:, None, :]]


def make_cifar10(config: DataConfig, process_index: int, process_count: int,
                 *, train: bool = True) -> HostDataset:
    base = os.path.join(config.data_dir or "", "cifar-10-batches-py")
    if not (config.data_dir and os.path.isdir(base)):
        log.warning("CIFAR-10 not found at %r — synthetic fallback", base)
        return synthetic.synthetic_images(config, process_index,
                                          process_count)

    images, labels = _load(config.data_dir, train)
    b = host_batch_size(config.global_batch_size, process_count)
    n = len(images)
    out_dtype = image_np_dtype(config.image_dtype)

    if not train:
        return finite_array_eval(
            cast_images(standardize(images), out_dtype), labels, batch=b,
            process_index=process_index, process_count=process_count,
            out_dtype=out_dtype)

    block = config.shard_mode == "block"
    batches = shard.epoch_batches(n, b, process_count)

    def make_iter(state):
        state.setdefault("epoch", 0)
        state.setdefault("batch_in_epoch", 0)
        while True:
            rng = prng.host_rng(config.seed, prng.ROLE_DATA, state["epoch"])
            perm = rng.permutation(n)
            for i in range(state["batch_in_epoch"], batches):
                if block:
                    lo, hi = shard.block_bounds(i, b, process_index,
                                                process_count)
                    idx = perm[lo:hi]
                else:
                    idx = perm[process_index::process_count][i * b:
                                                             (i + 1) * b]
                # Host-local augmentation: process_index is in the draw.
                crop_rng = prng.host_rng(config.seed, prng.ROLE_AUGMENT,
                                         state["epoch"], i, process_index)
                x = crop_and_flip(images[idx], crop_rng)
                state["batch_in_epoch"] = i + 1
                yield {"image": cast_images(standardize(x), out_dtype),
                       "label": labels[idx]}
            state["epoch"] += 1
            state["batch_in_epoch"] = 0

    return HostDataset(
        make_iter,
        element_spec={"image": ((b, SIZE, SIZE, 3), out_dtype),
                      "label": ((b,), np.int32)},
        initial_state={"epoch": 0, "batch_in_epoch": 0},
        cardinality=batches,
        repartition=(shard.REPARTITION_INVARIANT if block
                     else shard.REPARTITION_NONE),
    )
