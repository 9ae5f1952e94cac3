"""Text MLM pipeline: pre-tokenized TFRecords, packing and BERT masking.

The port's copy of ``data/text_mlm.py``. Consumes pre-tokenized sequences
from TFRecords (an ``input_ids`` Int64List per record) and applies BERT's
dynamic masking on the host: 15% of positions, of which 80% → [MASK], 10%
→ a random token, 10% kept. The records are read by the native reader
(``data/native_reader.py``) in tf.data's order (``data/tfdata.py``), or,
with ``data.use_native_reader``, in file order. With ``data.pack_factor``
> 1 the train stream lays documents end-to-end (``data/packing.py``) and
carries per-row segment ids. Without records under ``data.data_dir`` it
takes the synthetic fallback. The iterator states equal the JAX
package's key for key, so ``data_iter.json`` has one shape in both.
"""

from __future__ import annotations

import glob
import logging
import os

import numpy as np

from distributed_tensorflow_framework_torch.core import prng
from distributed_tensorflow_framework_torch.core.config import DataConfig
from distributed_tensorflow_framework_torch.data import (
    packing,
    synthetic,
    tfdata,
)
from distributed_tensorflow_framework_torch.data.pipeline import (
    HostDataset,
    host_batch_size,
)

log = logging.getLogger(__name__)

MASK_ID = 103
CLS_ID = 101
SEP_ID = 102
VOCAB = 30522
FEATURE = "input_ids"


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
    if not files:
        log.warning("MLM TFRecords not found under %r — synthetic fallback",
                    config.data_dir)
        if train and config.pack_factor > 1:
            log.warning(
                "data.pack_factor=%d is IGNORED on the synthetic fallback: "
                "synthetic rows are full-density with no segment ids, so "
                "training runs unpacked. Packing engages only on the "
                "TFRecord path (set data.data_dir).", config.pack_factor)
        return synthetic.synthetic_mlm(config, process_index, process_count)

    if len(files) < process_count:
        # Both reader paths shard by file: the native path would re-read
        # one shard on several hosts, and the interleaved path would hand
        # some hosts an empty shard whose infeed never yields.
        raise ValueError(
            f"MLM reader: {len(files)} TFRecord file(s) for "
            f"{process_count} processes — sharding by file needs at least "
            f"one file per process. Provide more shards or fewer hosts.")

    if config.use_native_reader:
        if not train:
            # The native reader streams full batches in an endless epoch
            # loop, with no single-pass padded mode: exact eval (every
            # record once, tail included) cannot be honoured.
            raise ValueError(
                "use_native_reader has no exact-eval path — use the "
                "interleaved reader (use_native_reader=false) for "
                "evaluation")
        if config.pack_factor > 1:
            raise ValueError(
                "data.pack_factor>1 (sequence packing) is wired for the "
                "interleaved MLM path only — set use_native_reader=false")
        return _make_mlm_native(config, files, process_index, process_count)

    b = host_batch_size(config.global_batch_size, process_count)
    s = config.seq_len
    host_files = files[process_index::process_count]

    def make_tok_stream(seed: int):
        if train:
            rows = tfdata.train_rows(
                host_files, FEATURE, s, shuffle_buffer=config.shuffle_buffer,
                seed=seed, process_index=process_index)
        else:
            # Exact single-pass eval: keep the remainder, zero-padded to
            # the static batch. Pad rows are all-zero tokens, which the
            # masker treats as special (never selected): they add no
            # masked positions, hence nothing to the MLM metric sums.
            rows = tfdata.interleave_rows(host_files, FEATURE, s)
        for tokens in tfdata.batch_rows(rows, b, s, drop_remainder=train):
            yield {"tokens": tokens}

    if train:
        base = tfdata.skip_count_dataset(
            make_tok_stream, element_spec={"tokens": ((b, s), np.int32)})
        num_batches = None
    else:
        num_batches = tfdata.eval_batches_all_hosts(
            tfdata.count_records(host_files), b, process_count=process_count)
        base = tfdata.skip_count_dataset(
            make_tok_stream, element_spec={"tokens": ((b, s), np.int32)},
            cardinality=num_batches, pad_tail_to=num_batches)

    # Sequence packing (train only): each packed batch consumes
    # ``pack_factor`` raw record batches, lays the (zero-padded) documents
    # end-to-end into b rows and emits per-row segment ids for
    # block-diagonal attention. Eval streams stay unpacked: the exact-eval
    # contract counts real masked tokens either way, unpacked rows keep
    # per-document metrics comparable across configs, and a packed eval's
    # batch count would depend on the data, where exact eval across hosts
    # needs a count every host agrees on up front.
    pack = config.pack_factor if train else 1

    # Host-side dynamic masking, its rng keyed off a batch counter so that
    # restores re-create identical masks.
    def make_iter(state):
        base.restore(state.get("inner", base.state()))
        it = iter(base)
        while True:
            if pack > 1:
                # Leftover documents from the previous pack group ride in
                # the (JSON-serialisable) state, so overflow defers data
                # to the next batch instead of discarding it, and restores
                # replay identically.
                raws = []
                carry = state.get("carry")
                if carry:
                    # Stored trimmed to each doc's nonzero prefix (token 0
                    # is reserved padding) so snapshots stay small.
                    arr = np.zeros((len(carry), s), np.int32)
                    for j, doc in enumerate(carry):
                        arr[j, :len(doc)] = doc
                    raws.append(arr)
                # Throttle fresh intake by the backlog (in raw-batch
                # units) so a too-high pack_factor drains the carry
                # instead of growing it without bound: the packer only
                # absorbs ~b rows per step, so keep (carry + fresh)
                # around pack batches in all.
                n_fresh = max(0, pack - (len(carry) if carry else 0) // b)
                exhausted = False
                for _ in range(n_fresh):
                    try:
                        raws.append(next(it)["tokens"])
                    except StopIteration:
                        exhausted = True
                        break
                if not raws or sum(len(r) for r in raws) == 0:
                    return
                tokens, seg_ids, leftover = packing.pack_documents(
                    np.concatenate(raws, axis=0), b, s)
                state["carry"] = [
                    doc[:int(np.count_nonzero(doc))].tolist()
                    for doc in leftover
                ]
                if n_fresh == 0 and not exhausted:
                    log.warning(
                        "sequence packing backlog: %d carried docs — "
                        "pack_factor=%d overflows the row budget; this "
                        "batch packs from the carry alone (consider "
                        "lowering data.pack_factor)", len(leftover), pack)
            else:
                try:
                    tokens = next(it)["tokens"]
                except StopIteration:
                    return
                seg_ids = None
            state["inner"] = base.state()
            if train:
                # Real/padded-token census (data/packing.py counters): it
                # rides the state so every snapshot pairs a batch with the
                # cumulative census; the Trainer reads it off its data
                # snapshot to emit KIND_DATA_PACKING.
                packing.accumulate_counters(state, tokens)
            # Mask key from the EMITTED-batch counter, not the consumed
            # raw-batch count: a packed batch that drains the carry alone
            # consumes no raw batch, and keying off the inner counter
            # would replay the previous batch's mask positions.
            emitted = state.get("emitted", state["inner"].get("batches", 0))
            state["emitted"] = emitted + 1
            rng = prng.host_rng(config.seed, prng.ROLE_MASK, emitted,
                                process_index)
            inputs, targets = apply_mlm_mask(tokens, rng, config.mask_prob,
                                             config.vocab_size)
            out = {
                "input_ids": inputs,
                "targets": targets,
                "attention_mask": (tokens != 0).astype(np.int32),
            }
            if seg_ids is not None:
                out["segment_ids"] = seg_ids
            yield out

    element_spec = {
        "input_ids": ((b, s), np.int32),
        "targets": ((b, s), np.int32),
        "attention_mask": ((b, s), np.int32),
    }
    if pack > 1:
        element_spec["segment_ids"] = ((b, s), np.int32)
    return HostDataset(
        make_iter,
        element_spec=element_spec,
        initial_state={"inner": base.state()},
        cardinality=num_batches,
    )


def _make_mlm_native(config: DataConfig, files: list[str],
                     process_index: int, process_count: int) -> HostDataset:
    """MLM pipeline on the native reader in file order.

    The reader decodes the TFRecord framing and parses the Example in a
    native thread (a short record zero-padded, a long one cut at
    ``seq_len``); Python only applies the dynamic mask. Record order is
    file order (deterministic), so resume skips batches within the epoch.
    """
    from distributed_tensorflow_framework_torch.data.native_reader import (
        NativeRecordReader,
    )

    b = host_batch_size(config.global_batch_size, process_count)
    s = config.seq_len
    shard = files[process_index::process_count]  # non-empty: make_mlm guards

    def make_iter(state):
        state.setdefault("epoch", 0)
        state.setdefault("batch_in_epoch", 0)
        state.setdefault("total_batches", 0)
        while True:
            reader = NativeRecordReader(shard)
            try:
                skip = state["batch_in_epoch"]
                for i, tokens in enumerate(reader.batches_i32(FEATURE, b, s)):
                    if i < skip:
                        continue
                    rng = prng.host_rng(config.seed, prng.ROLE_MASK,
                                        state["epoch"], i, process_index)
                    inputs, targets = apply_mlm_mask(
                        tokens, rng, config.mask_prob, config.vocab_size)
                    state["batch_in_epoch"] = i + 1
                    state["total_batches"] += 1
                    yield {
                        "input_ids": inputs,
                        "targets": targets,
                        "attention_mask": (tokens != 0).astype(np.int32),
                    }
            finally:
                reader.close()
            if state["batch_in_epoch"] == 0 and skip == 0:
                raise RuntimeError(
                    f"native MLM shard {shard!r} yielded no full batch of "
                    f"{b} records — shard too small for this process count")
            state["epoch"] += 1
            state["batch_in_epoch"] = 0

    return HostDataset(
        make_iter,
        element_spec={
            "input_ids": ((b, s), np.int32),
            "targets": ((b, s), np.int32),
            "attention_mask": ((b, s), np.int32),
        },
        initial_state={"epoch": 0, "batch_in_epoch": 0, "total_batches": 0},
    )
