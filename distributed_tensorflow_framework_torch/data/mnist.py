"""MNIST pipeline: the port's copy of ``data/mnist.py`` (config 1).

Reads the keras-layout ``mnist.npz`` from ``data.data_dir`` and
standardises each image (zero mean, unit std, +1e-6). Train: a shuffle
per epoch from ``host_rng(seed, ROLE_DATA, epoch)``, shared by every host,
each host taking its block of every global batch (``shard_mode: block``,
restorable at any host count) or its strided share (``stride``); the
state is ``(epoch, batch_in_epoch)``. Eval: every test image once, the
tail zero-padded and weighted out (``finite_array_eval``). With no file
it falls back to synthetic MNIST-shaped data, with a warning.
"""

from __future__ import annotations

import logging
import os

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


def make_mnist(config: DataConfig, process_index: int, process_count: int,
               *, train: bool = True) -> HostDataset:
    path = os.path.join(config.data_dir or "", "mnist.npz")
    if not (config.data_dir and os.path.exists(path)):
        log.warning("MNIST not found at %r — using synthetic fallback", path)
        return synthetic.synthetic_images(config, process_index,
                                          process_count)

    with np.load(path) as d:
        if train:
            images, labels = d["x_train"], d["y_train"]
        else:
            images, labels = d["x_test"], d["y_test"]
    images = images.astype(np.float32)[..., None] / 255.0
    mean = images.mean(axis=(1, 2, 3), keepdims=True)
    std = images.std(axis=(1, 2, 3), keepdims=True) + 1e-6
    images = (images - mean) / std
    labels = labels.astype(np.int32)

    b = host_batch_size(config.global_batch_size, process_count)
    n = len(images)
    out_dtype = image_np_dtype(config.image_dtype)

    if not train:
        return finite_array_eval(
            cast_images(images, out_dtype), labels, batch=b,
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
                state["batch_in_epoch"] = i + 1
                yield {"image": cast_images(images[idx], out_dtype),
                       "label": labels[idx]}
            state["epoch"] += 1
            state["batch_in_epoch"] = 0

    return HostDataset(
        make_iter,
        element_spec={"image": ((b, 28, 28, 1), out_dtype),
                      "label": ((b,), np.int32)},
        initial_state={"epoch": 0, "batch_in_epoch": 0},
        cardinality=batches,
        repartition=(shard.REPARTITION_INVARIANT if block
                     else shard.REPARTITION_NONE),
    )
