"""Text MLM pipeline: BERT dynamic masking and the synthetic fallback.

The port's copy of ``data/text_mlm.py``. :func:`apply_mlm_mask` is the same
numpy masking (15% of positions; of those 80% → [MASK], 10% → a random
token, 10% kept). :func:`make_mlm` takes the JAX package's synthetic
fallback when ``data.data_dir`` holds no TFRecords; a directory that does
hold them raises, because the port reads no TFRecords yet (it has no
TensorFlow) and must not quietly train on synthetic data instead.
"""

from __future__ import annotations

import glob
import logging
import os

import numpy as np

from distributed_tensorflow_framework_torch.core.config import DataConfig
from distributed_tensorflow_framework_torch.data import synthetic
from distributed_tensorflow_framework_torch.data.pipeline import HostDataset

log = logging.getLogger(__name__)

MASK_ID = 103
CLS_ID = 101
SEP_ID = 102
VOCAB = 30522


def apply_mlm_mask(tokens: np.ndarray, rng: np.random.Generator,
                   mask_prob: float, vocab_size: int = VOCAB
                   ) -> tuple[np.ndarray, np.ndarray]:
    """BERT dynamic masking. tokens: (b, s) int32. Returns (inputs, targets);
    targets are -1 at unmasked positions. Random-replacement tokens are
    drawn from [lo, vocab_size) so they stay inside the embedding table."""
    special = (tokens == CLS_ID) | (tokens == SEP_ID) | (tokens == 0)
    candidates = ~special
    sel = (rng.random(tokens.shape) < mask_prob) & candidates
    action = rng.random(tokens.shape)
    inputs = tokens.copy()
    inputs[sel & (action < 0.8)] = MASK_ID
    rand_sel = sel & (action >= 0.8) & (action < 0.9)
    lo = min(1000, vocab_size // 2)
    inputs[rand_sel] = rng.integers(lo, vocab_size, size=int(rand_sel.sum()))
    targets = np.where(sel, tokens, -1).astype(np.int32)
    return inputs, targets


def make_mlm(config: DataConfig, process_index: int, process_count: int,
             *, train: bool = True) -> HostDataset:
    files = (sorted(glob.glob(os.path.join(config.data_dir, "*.tfrecord*")))
             if config.data_dir else [])
    if files:
        raise NotImplementedError(
            f"{len(files)} MLM TFRecord file(s) under {config.data_dir!r}: "
            f"the TFRecord MLM reader and sequence packing are not ported "
            f"yet — ROADMAP.md queue A item A7")
    log.warning("MLM TFRecords not found under %r — synthetic fallback",
                config.data_dir)
    if train and config.pack_factor > 1:
        log.warning(
            "data.pack_factor=%d is IGNORED on the synthetic fallback: "
            "synthetic rows are full-density with no segment ids, so "
            "training runs unpacked. Packing engages only on the TFRecord "
            "path (set data.data_dir).", config.pack_factor)
    return synthetic.synthetic_mlm(config, process_index, process_count)
