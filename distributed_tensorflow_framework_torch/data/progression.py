"""Author a synthetic-grammar MLM corpus as pre-tokenized TFRecords.

The port's copy of ``scripts/make_progression_mlm.py``, with a TFRecord
writer of its own in place of TensorFlow's: the same numpy draws, the same
train/eval split and shard layout, and records byte for byte equal to
``tf.io.TFRecordWriter``'s. Sequences are arithmetic progressions
``tok[i] = base + i*stride (mod band)`` over a vocab band clear of the
special ids, so every masked token can be recovered from its context: a
model that learns the grammar approaches 100% masked accuracy.

Layout: ``<out>/train/mlm-XXX.tfrecord`` and ``<out>/eval/...``; point
``data.data_dir`` at train/ and ``eval_data.data_dir`` at eval/ (the MLM
reader globs every record file in its directory).

    python -m distributed_tensorflow_framework_torch.data.progression OUT \\
        [--seq-len 64] [--train-seqs 8192] [--eval-seqs 1024] \\
        [--shards 4] [--seed 0] [--min-doc N --max-doc M]

The CRCs go through the native reader's ``masked_crc32c``
(data/native_reader.py, built by ``g++`` at first use).
"""

from __future__ import annotations

import argparse
import os
import struct
from typing import Iterable

import numpy as np

from distributed_tensorflow_framework_torch.data.native_reader import (
    masked_crc32c,
)

BAND_LO, BAND = 1000, 499  # prime band width; clear of 0/CLS/SEP/MASK ids
FEATURE = "input_ids"
_GROUPS = np.arange(10, dtype=np.uint64)  # a 64-bit varint has <= 10 bytes


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _varints(values: np.ndarray) -> bytes:
    """Protobuf varints of int64 ``values`` (negatives as their 64-bit
    two's complement, ten bytes each), concatenated."""
    v = np.ascontiguousarray(values, np.int64).view(np.uint64)
    count = 1 + sum((v >= np.uint64(1) << np.uint64(7 * k)).astype(np.int64)
                    for k in range(1, 10))
    groups = (v[:, None] >> (_GROUPS * np.uint64(7))) & np.uint64(0x7F)
    idx = np.arange(10)[None, :]
    groups |= (idx < count[:, None] - 1).astype(np.uint64) << np.uint64(7)
    return groups[idx < count[:, None]].astype(np.uint8).tobytes()


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def int64_feature(values: np.ndarray) -> bytes:
    """A serialised ``Feature{int64_list{value}}``: Feature.int64_list = 3,
    Int64List.value = 1 (packed)."""
    values = np.asarray(values)
    return _field(3, _field(1, _varints(values)) if values.size else b"")


def bytes_feature(value: bytes) -> bytes:
    """A serialised ``Feature{bytes_list{value: [value]}}``:
    Feature.bytes_list = 1, BytesList.value = 1."""
    return _field(1, _field(1, value))


def example(features: dict[str, bytes]) -> bytes:
    """``tf.train.Example`` of serialised features, in the dict's order:
    Example.features = 1, Features.feature = 1 (a map entry: key = 1,
    value = 2)."""
    return _field(1, b"".join(
        _field(1, _field(1, key.encode()) + _field(2, feature))
        for key, feature in features.items()))


def encode_example(values: np.ndarray, key: str = FEATURE) -> bytes:
    """``tf.train.Example{features{feature{key: int64_list{value}}}}``
    serialised as TensorFlow serialises it."""
    return example({key: int64_feature(values)})


def write_tfrecords(path: str, payloads: Iterable[bytes]) -> None:
    """TFRecord framing: uint64 length, masked crc32c of the length,
    payload, masked crc32c of the payload (little-endian)."""
    with open(path, "wb") as fh:
        for data in payloads:
            length = struct.pack("<Q", len(data))
            fh.write(length + struct.pack("<I", masked_crc32c(length)) + data
                     + struct.pack("<I", masked_crc32c(data)))


def make_split(rng: np.random.Generator, n: int, seq_len: int,
               *, parity: int, min_doc: int = 0, max_doc: int = 0
               ) -> np.ndarray:
    """Sequences whose (base mod 2) == parity. Train takes parity 0 and
    eval parity 1, so the splits are disjoint sequence sets: a model can
    only score on eval by generalising the stride grammar, never by
    memorising training sequences.

    With ``min_doc``/``max_doc`` set, each row is a variable-length
    document (trailing-zero padded to ``seq_len``), the shape the
    sequence-packing pipeline (data.pack_factor) consumes."""
    base = rng.integers(0, BAND // 2, n) * 2 + parity
    stride = rng.integers(1, 4, n)
    idx = np.arange(seq_len)
    toks = (base[:, None] + idx[None, :] * stride[:, None]) % BAND + BAND_LO
    toks = toks.astype(np.int64)
    if max_doc:
        lengths = rng.integers(min_doc, max_doc + 1, n)
        toks *= (idx[None, :] < lengths[:, None])
    return toks


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out", help="output directory (train/ and eval/ inside)")
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--train-seqs", type=int, default=8192)
    p.add_argument("--eval-seqs", type=int, default=1024)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--min-doc", type=int, default=0,
                   help="variable-length docs: min real tokens per row")
    p.add_argument("--max-doc", type=int, default=0,
                   help="variable-length docs: max real tokens per row "
                        "(0 = full-width rows, no padding)")
    a = p.parse_args(argv)
    if a.min_doc and not a.max_doc:
        p.error("--min-doc needs --max-doc (0 disables variable-length "
                "docs entirely, silently ignoring the floor)")
    if a.max_doc and not 0 < a.min_doc <= a.max_doc <= a.seq_len:
        p.error(f"need 0 < min_doc <= max_doc <= seq_len, got "
                f"{a.min_doc}..{a.max_doc} vs {a.seq_len}")
    return a


def main(argv=None) -> int:
    a = parse_args(argv)
    rng = np.random.default_rng(a.seed)
    for split, n, shards, parity in (
            ("train", a.train_seqs, a.shards, 0),
            ("eval", a.eval_seqs, max(1, a.shards // 2), 1)):
        d = os.path.join(a.out, split)
        os.makedirs(d, exist_ok=True)
        seqs = make_split(rng, n, a.seq_len, parity=parity,
                          min_doc=a.min_doc, max_doc=a.max_doc)
        for s, part in enumerate(np.array_split(seqs, shards)):
            write_tfrecords(os.path.join(d, f"mlm-{s:03d}.tfrecord"),
                            (encode_example(row) for row in part))
        print(f"wrote {n} seqs (len {a.seq_len}) into {shards} shards "
              f"under {d}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
