"""The tf.data semantics of the MLM record path, rebuilt over the native
reader. Uses no TensorFlow.

The port's counterpart of ``data/tfdata.py`` and of the tf.data graph in
``data/text_mlm.py``. The JAX package streams MLM records through
``TFRecordDataset`` → ``interleave(cycle_length=8, block_length=1,
deterministic=True)`` → ``parse_single_example`` with a
``FixedLenFeature([seq_len])`` → ``shuffle(...).repeat()`` →
``batch(...)``; this module gives the same record order and batches from
``data/native_reader.py``:

  * :func:`interleave` — one element from each open file in turn, an
    exhausted file's slot taken by the next file, as tf's interleave
    does; :func:`interleave_rows` reads the MLM feature through it, and a
    record whose feature holds another count than ``seq_len`` raises, as a
    ``FixedLenFeature`` does (data/imagenet.py interleaves raw records with
    :func:`file_records`).
  * :func:`shuffle_rows` — a buffer of ``buffer_size`` records with
    tf.data's buffer semantics (fill, draw a uniform slot, refill). Its
    draws come from ``core/prng.host_rng``, so the order differs from
    tf's (which cannot be reproduced without TensorFlow); a buffer of 1
    is the identity in both.
  * :func:`shuffled_epochs`, :func:`train_rows` / :func:`batch_rows` —
    ``shuffle().repeat()`` reshuffled each epoch, then ``batch(b)`` with or
    without the remainder (the tail zero-padded to ``b``).
  * :func:`skip_count_dataset` — the counterpart of
    ``tfdata_to_hostdataset``: the iterator state is ``{"batches",
    "seed"}``, and a restore rebuilds the (seed-deterministic) stream and
    skips ``batches`` batches. The skip-count is over this host's file
    shard, so the dataset is tagged ``repartition="none"``
    (data/shard.py).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np

from distributed_tensorflow_framework_torch.core import prng
from distributed_tensorflow_framework_torch.data import shard
from distributed_tensorflow_framework_torch.data.native_reader import (
    NativeRecordReader,
    count_records_native,
)
from distributed_tensorflow_framework_torch.data.pipeline import HostDataset

CYCLE_LENGTH = 8  # interleave(cycle_length=8) of the JAX MLM pipeline


def count_records(files: Sequence[str]) -> int:
    """Number of TFRecords across ``files`` (framing read and CRCs
    checked, no parse), cached per file tuple.

    For exact eval, call with THIS HOST'S file shard: the per-host batch
    count must reflect the records this host will stream.
    """
    return count_records_native(files)


def eval_batches_all_hosts(host_records: int, batch: int, *,
                           process_count: int = 1) -> int:
    """Per-rank eval batch count, equal on every rank: the largest
    ``ceil(records / batch)`` over the ranks (one ``all_reduce(MAX)`` over
    the default process group). Ranks whose file shard runs out first pad
    with zero-weight batches (``pad_tail_to``), so every record is read
    once and each rank runs the same number of eval steps."""
    mine = -(-host_records // batch)
    if process_count == 1:
        return mine
    from distributed_tensorflow_framework_torch.core import mesh

    return mesh.max_over_ranks(mine)


def _file_rows(path: str, key: str, width: int) -> Iterator[np.ndarray]:
    reader = NativeRecordReader([path])
    try:
        i = 0
        for rows, lengths in reader.rows_i32(key, width):
            for row, n in zip(rows, lengths):
                if n != width:
                    got = f"more than {width}" if n > width else str(int(n))
                    raise ValueError(
                        f"{path}: record {i} holds {got} values of {key!r}, "
                        f"where the fixed-length feature needs {width}")
                i += 1
                yield row
    finally:
        reader.close()


def file_records(path: str) -> Iterator[bytes]:
    """The raw records of one TFRecord file, in order."""
    reader = NativeRecordReader([path])
    try:
        yield from reader.records()
    finally:
        reader.close()


def interleave(files: Sequence[str], open_file: Callable[[str], Iterator],
               cycle_length: int = CYCLE_LENGTH) -> Iterator:
    """The elements of ``open_file(path)`` for each of ``files`` in the
    order of tf.data's ``Dataset.from_tensor_slices(files).interleave(
    open_file, cycle_length, block_length=1, deterministic=True)``.

    The cycle visits its slots in turn. An empty slot opens the next file
    (while files remain) and reads from it on the same visit; a slot whose
    file is exhausted is emptied and the cycle moves on, so the next file
    takes that slot on the cycle's next visit."""
    pending = iter(files)
    slots: list[Iterator | None] = [None] * cycle_length
    open_slots, out_of_files, i = 0, False, 0
    while not out_of_files or open_slots:
        slot = slots[i]
        if slot is not None:
            item = next(slot, None)
            if item is not None:
                yield item
            else:
                slots[i] = None
                open_slots -= 1
            i = (i + 1) % cycle_length
        elif not out_of_files:
            path = next(pending, None)
            if path is None:
                out_of_files = True
            else:
                slots[i] = open_file(path)
                open_slots += 1
        else:
            i = (i + 1) % cycle_length


def interleave_rows(files: Sequence[str], key: str, width: int
                    ) -> Iterator[np.ndarray]:
    """(width,) int32 rows of feature ``key`` in the order of the MLM
    pipeline's ``interleave(TFRecordDataset, cycle_length=8)``; a record
    whose feature holds another count than ``width`` raises."""
    return interleave(files, lambda path: _file_rows(path, key, width))


def shuffle_rows(rows: Iterable[np.ndarray], buffer_size: int,
                 rng: np.random.Generator) -> Iterator[np.ndarray]:
    """tf.data's shuffle-buffer semantics: fill ``buffer_size`` rows, then
    hand out a uniformly drawn slot and refill it from the stream; once
    the stream ends, the drained slot takes the buffer's last row. A
    buffer of 1 or less keeps the order."""
    it = iter(rows)
    if buffer_size <= 1:
        yield from it
        return
    buf = list(itertools.islice(it, buffer_size))
    while buf:
        j = int(rng.integers(len(buf)))
        out = buf[j]
        nxt = next(it, None)
        if nxt is not None:
            buf[j] = nxt
        else:
            buf[j] = buf[-1]
            buf.pop()
        yield out


def shuffled_epochs(make_epoch: Callable[[], Iterator], shuffle_buffer: int,
                    *, seed: int, process_index: int) -> Iterator:
    """``shuffle(shuffle_buffer).repeat()`` over the epochs that
    ``make_epoch()`` streams: each epoch reshuffled from ``host_rng(seed,
    ROLE_DATA, epoch, process_index)``. Ends, as tf's ``repeat()`` does,
    when an epoch yields nothing."""
    for epoch in itertools.count():
        rng = prng.host_rng(seed, prng.ROLE_DATA, epoch, process_index)
        empty = True
        for item in shuffle_rows(make_epoch(), shuffle_buffer, rng):
            empty = False
            yield item
        if empty:
            return


def train_rows(files: Sequence[str], key: str, width: int, *,
               shuffle_buffer: int, seed: int, process_index: int
               ) -> Iterator[np.ndarray]:
    """``interleave → shuffle(shuffle_buffer).repeat()`` of the MLM rows."""
    return shuffled_epochs(lambda: interleave_rows(files, key, width),
                           shuffle_buffer, seed=seed,
                           process_index=process_index)


def batch_rows(rows: Iterable[np.ndarray], batch: int, width: int, *,
               drop_remainder: bool) -> Iterator[np.ndarray]:
    """(batch, width) int32 batches; a short final batch is dropped, or
    zero-padded to ``batch`` rows when ``drop_remainder`` is false."""
    it = iter(rows)
    while True:
        chunk = list(itertools.islice(it, batch))
        if not chunk or (len(chunk) < batch and drop_remainder):
            return
        out = np.zeros((batch, width), np.int32)
        out[:len(chunk)] = chunk
        yield out


def skip_count_dataset(make_batches: Callable[[int], Iterator[dict]], *,
                       element_spec: dict,
                       cardinality: int | None = None,
                       pad_tail_to: int | None = None) -> HostDataset:
    """Wrap a factory ``seed → iterator of dict batches`` (deterministic
    given the seed) as a :class:`HostDataset` whose state is ``{"batches",
    "seed"}``; a restore rebuilds the stream and skips ``batches``.

    ``cardinality`` is the batches per epoch (None = infinite);
    ``pad_tail_to`` makes a finite stream that ends early emit all-zero
    batches up to that count."""

    def _zero_batch():
        return {k: np.zeros(shape, dtype)
                for k, (shape, dtype) in element_spec.items()}

    def make_iter(state: dict[str, Any]):
        state.setdefault("batches", 0)
        state.setdefault("seed", 0)
        it = make_batches(int(state["seed"]))
        for elem in itertools.islice(it, int(state["batches"]), None):
            state["batches"] += 1
            yield elem
        while pad_tail_to is not None and state["batches"] < pad_tail_to:
            state["batches"] += 1
            yield _zero_batch()

    return HostDataset(
        make_iter,
        element_spec=element_spec,
        initial_state={"batches": 0, "seed": 0},
        cardinality=cardinality,
        repartition=shard.REPARTITION_NONE,
    )
