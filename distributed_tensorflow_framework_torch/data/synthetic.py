"""Synthetic data: the port's copy of ``data/synthetic.py``.

The same numpy calls on the same ``host_rng`` seeds as the JAX package, so
the streams are bit-identical to it. ``synthetic_images``: standard-normal
NHWC images, each labelled by the argmax of its first ``num_classes``
pixels (learnable at any image size). ``synthetic_mlm``: targets hold the
original token at masked positions and -1 elsewhere.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from distributed_tensorflow_framework_torch.core import prng
from distributed_tensorflow_framework_torch.core.config import DataConfig
from distributed_tensorflow_framework_torch.data import shard
from distributed_tensorflow_framework_torch.data.pipeline import (
    HostDataset,
    cast_images,
    host_batch_size,
    image_np_dtype,
)


def synthetic_images(config: DataConfig, process_index: int,
                     process_count: int) -> HostDataset:
    b = host_batch_size(config.global_batch_size, process_count)
    h = w = config.image_size
    c = config.channels
    num_classes = config.num_classes
    out_dtype = image_np_dtype(config.image_dtype)

    def make_iter(state: dict[str, Any]):
        state.setdefault("step", 0)
        while True:
            rng = prng.host_rng(config.seed, prng.ROLE_DATA,
                                process_index, state["step"])
            images = rng.standard_normal((b, h, w, c), dtype=np.float32)
            labels = np.argmax(images.reshape(b, -1)[:, :num_classes],
                               axis=1).astype(np.int32)
            state["step"] += 1
            yield {"image": cast_images(images, out_dtype), "label": labels}

    return HostDataset(
        make_iter,
        element_spec={"image": ((b, h, w, c), out_dtype),
                      "label": ((b,), np.int32)},
        initial_state={"step": 0},
        repartition=shard.REPARTITION_INVARIANT,
    )


def synthetic_mlm(config: DataConfig, process_index: int,
                  process_count: int) -> HostDataset:
    b = host_batch_size(config.global_batch_size, process_count)
    s = config.seq_len
    vocab = config.vocab_size
    lo = min(1000, vocab // 2)  # keep low ids free for specials

    def make_iter(state: dict[str, Any]):
        state.setdefault("step", 0)
        # BERT's [MASK]=103 when it sits below the token range [lo, vocab);
        # otherwise id 0, which is always below lo >= 1.
        mask_id = 103 if lo > 103 else 0
        while True:
            rng = prng.host_rng(config.seed, prng.ROLE_DATA,
                                process_index, state["step"])
            tokens = rng.integers(lo, vocab, size=(b, s),
                                  dtype=np.int64).astype(np.int32)
            mask = rng.random((b, s)) < config.mask_prob
            mask[:, 0] = False
            input_ids = np.where(mask, mask_id, tokens)
            targets = np.where(mask, tokens, -1).astype(np.int32)
            state["step"] += 1
            yield {
                "input_ids": input_ids,
                "targets": targets,
                "attention_mask": np.ones((b, s), dtype=np.int32),
            }

    return HostDataset(
        make_iter,
        element_spec={
            "input_ids": ((b, s), np.int32),
            "targets": ((b, s), np.int32),
            "attention_mask": ((b, s), np.int32),
        },
        initial_state={"step": 0},
        repartition=shard.REPARTITION_INVARIANT,
    )
