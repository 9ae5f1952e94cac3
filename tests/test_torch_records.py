"""The port's native TFRecord reader and writer against TensorFlow's.

The records are written here with ``tf.io.TFRecordWriter``. The port's
reader (``native/record_reader.cc`` through ``data/native_reader.py``)
must give TensorFlow's raw record bytes, parse the Int64List feature as
``tf.io.parse_single_example`` does, name the file on a CRC mismatch,
shuffle deterministically, count records, and hold records to a fixed
length as a ``FixedLenFeature`` does. The port's writer
(``data/progression.py``) must give ``tf.io.TFRecordWriter``'s bytes and
``SerializeToString``'s Examples byte for byte, and its corpus must equal
``scripts/make_progression_mlm.py``'s record for record. Everything is
compared exactly. Mirrors ``tests/test_native_reader.py``.
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import tensorflow as tf

from distributed_tensorflow_framework_torch.data import (
    native_reader,
    progression,
    tfdata,
)
from distributed_tensorflow_framework_torch.data.native_reader import (
    NativeRecordReader,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _example(values, other=None):
    feature = {"input_ids": tf.train.Feature(
        int64_list=tf.train.Int64List(value=list(values)))}
    if other is not None:
        feature["other"] = tf.train.Feature(
            int64_list=tf.train.Int64List(value=list(other)))
    return tf.train.Example(features=tf.train.Features(
        feature=feature)).SerializeToString()


@pytest.fixture(scope="module")
def tfrecord_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    paths = []
    rng = np.random.default_rng(0)
    for shard in range(2):
        p = str(d / f"shard{shard}.tfrecord")
        with tf.io.TFRecordWriter(p) as w:
            for i in range(20):
                w.write(_example(rng.integers(0, 1000, 16).tolist(),
                                 other=[shard, i]))
        paths.append(p)
    return paths


def test_raw_records_match_tf(tfrecord_files):
    expected = [r.numpy() for r in tf.data.TFRecordDataset(tfrecord_files)]
    reader = NativeRecordReader(tfrecord_files)
    got = list(reader.records())
    reader.close()
    assert len(got) == len(expected) == 40
    assert got == expected


def test_example_parse_matches_tf(tfrecord_files):
    ds = tf.data.TFRecordDataset(tfrecord_files).map(
        lambda r: tf.io.parse_single_example(
            r, {"input_ids": tf.io.FixedLenFeature([16], tf.int64)}
        )["input_ids"]).batch(8, drop_remainder=True)
    expected = np.concatenate([b.numpy() for b in ds]).astype(np.int32)
    reader = NativeRecordReader(tfrecord_files)
    got = np.concatenate(list(reader.batches_i32("input_ids", 8, 16)))
    reader.close()
    np.testing.assert_array_equal(got, expected)
    reader = NativeRecordReader(tfrecord_files)
    chunks = list(reader.rows_i32("input_ids", 16, chunk=7))
    reader.close()
    assert [len(r) for r, _ in chunks] == [7] * 5 + [5]
    np.testing.assert_array_equal(np.concatenate([r for r, _ in chunks]),
                                  expected)
    assert all((n == 16).all() for _, n in chunks)


def test_rows_report_each_record_length(tmp_path):
    path = str(tmp_path / "lens.tfrecord")
    lists = [[5] * 4, [], [7] * 9, list(range(1, 7))]
    with tf.io.TFRecordWriter(path) as w:
        for values in lists:
            w.write(_example(values))
        w.write(tf.train.Example().SerializeToString())  # no feature at all
    reader = NativeRecordReader([path])
    ((rows, lengths),) = list(reader.rows_i32("input_ids", 6))
    reader.close()
    assert lengths.tolist() == [4, 0, 7, 6, 0]  # 7: more than the width 6
    assert rows[0].tolist() == [5] * 4 + [0, 0]
    assert rows[2].tolist() == [7] * 6
    assert rows[3].tolist() == list(range(1, 7))


def test_crc_detects_corruption_naming_the_file(tfrecord_files, tmp_path):
    with open(tfrecord_files[0], "rb") as fh:
        blob = bytearray(fh.read())
    blob[30] ^= 0xFF  # a payload byte of the first record
    bad = str(tmp_path / "corrupt.tfrecord")
    with open(bad, "wb") as fh:
        fh.write(bytes(blob))
    reader = NativeRecordReader([bad])
    with pytest.raises(RuntimeError, match="payload crc mismatch: .*corrupt"):
        list(reader.records())
    reader.close()
    with pytest.raises(RuntimeError, match="corrupt.tfrecord"):
        list(tfdata.interleave_rows([bad], "input_ids", 16))


def test_record_shuffle_window(tfrecord_files):
    def read_all(**kw):
        r = NativeRecordReader(tfrecord_files, **kw)
        out = list(r.records())
        r.close()
        return out

    plain = read_all()
    s7 = read_all(shuffle_window=16, shuffle_seed=7)
    s9 = read_all(shuffle_window=16, shuffle_seed=9)
    assert sorted(plain) == sorted(s7) == sorted(s9)
    assert s7 == read_all(shuffle_window=16, shuffle_seed=7)
    assert s7 != plain and s7 != s9
    r = NativeRecordReader(tfrecord_files, shuffle_window=16, shuffle_seed=7)
    assert r.skip_records(7) == 7
    assert list(r.records()) == s7[7:]
    r.close()
    r = NativeRecordReader(tfrecord_files, shuffle_window=16, shuffle_seed=7)
    assert r.skip_records(10_000) == 40
    r.close()


def test_count_records(tfrecord_files, tmp_path):
    assert tfdata.count_records(tfrecord_files) == 40
    assert tfdata.count_records(tfrecord_files[:1]) == 20
    empty = str(tmp_path / "empty.tfrecord")
    open(empty, "wb").close()
    assert tfdata.count_records([empty, *tfrecord_files]) == 40
    n = sum(1 for _ in tf.data.TFRecordDataset(tfrecord_files))
    assert n == tfdata.count_records(tuple(tfrecord_files))


def test_interleave_order_matches_tf(tmp_path):
    """Files of uneven lengths, one empty, more files than the cycle of 8
    (so exhausted slots are taken by later files): tf.data's deterministic
    parallel interleave and the port's give the same record order."""
    files, start = [], 0
    for i, n in enumerate([3, 0, 7, 1, 5, 2, 9, 4, 6, 2, 11]):
        path = str(tmp_path / f"f{i:02d}.tfrecord")
        with tf.io.TFRecordWriter(path) as w:
            for v in range(start, start + n):
                w.write(_example([v] * 4))
        start += n
        files.append(path)
    ds = tf.data.Dataset.from_tensor_slices(files).interleave(
        tf.data.TFRecordDataset, cycle_length=tfdata.CYCLE_LENGTH,
        num_parallel_calls=tf.data.AUTOTUNE, deterministic=True)
    want = [tf.io.parse_single_example(
        r, {"input_ids": tf.io.FixedLenFeature([4], tf.int64)}
    )["input_ids"].numpy()[0] for r in ds]
    got = [r[0] for r in tfdata.interleave_rows(files, "input_ids", 4)]
    assert got == want


def test_wrong_length_record_raises(tmp_path):
    path = str(tmp_path / "ragged.tfrecord")
    with tf.io.TFRecordWriter(path) as w:
        w.write(_example([3] * 8))
        w.write(_example([4] * 9))
    rows = tfdata.interleave_rows([path], "input_ids", 8)
    assert next(rows).tolist() == [3] * 8
    with pytest.raises(ValueError, match="ragged.tfrecord: record 1 holds "
                                         "more than 8 values"):
        next(rows)


@pytest.mark.parametrize("values", [
    [], [0], [1, 127, 128, 300, 16383, 16384, 2**31, 2**62, 2**63 - 1],
    [-1, -2**63, -300], list(range(1000, 1512)),
])
def test_example_bytes_equal_tf(values):
    assert progression.encode_example(np.array(values, np.int64)) == (
        _example(values))


def test_writer_bytes_equal_tf(tmp_path):
    rng = np.random.default_rng(3)
    rows = [rng.integers(-5, 5000, n) for n in (16, 0, 1, 300)]
    ours, ref = tmp_path / "ours.tfrecord", tmp_path / "ref.tfrecord"
    progression.write_tfrecords(str(ours), (progression.encode_example(r)
                                            for r in rows))
    with tf.io.TFRecordWriter(str(ref)) as w:
        for r in rows:
            w.write(_example(r.tolist()))
    assert ours.read_bytes() == ref.read_bytes()
    # The first record's length and payload CRCs, against tf's bytes.
    blob = ref.read_bytes()
    n = int.from_bytes(blob[:8], "little")
    assert native_reader.masked_crc32c(blob[:8]) == int.from_bytes(
        blob[8:12], "little")
    assert native_reader.masked_crc32c(blob[12:12 + n]) == int.from_bytes(
        blob[12 + n:16 + n], "little")


def _run_script_main(out, flags, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "make_progression_mlm", ROOT / "scripts" / "make_progression_mlm.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["make_progression_mlm.py", str(out),
                                      *flags])
    assert module.main() == 0


@pytest.mark.parametrize("flags", [
    ["--seq-len", "32", "--train-seqs", "50", "--eval-seqs", "13",
     "--shards", "4", "--seed", "5", "--min-doc", "4", "--max-doc", "20"],
    ["--seq-len", "16", "--train-seqs", "9", "--eval-seqs", "3",
     "--shards", "1"],
])
def test_progression_corpus_equals_the_script(tmp_path, monkeypatch, flags):
    _run_script_main(tmp_path / "tf", flags, monkeypatch)
    assert progression.main([str(tmp_path / "port"), *flags]) == 0
    ref = sorted(p.relative_to(tmp_path / "tf")
                 for p in (tmp_path / "tf").rglob("*.tfrecord"))
    ours = sorted(p.relative_to(tmp_path / "port")
                  for p in (tmp_path / "port").rglob("*.tfrecord"))
    assert ours == ref and ref
    for rel in ref:
        assert (tmp_path / "port" / rel).read_bytes() == (
            tmp_path / "tf" / rel).read_bytes(), rel


def test_progression_flag_checks():
    for bad in (["--min-doc", "4"], ["--min-doc", "9", "--max-doc", "5"],
                ["--seq-len", "8", "--min-doc", "1", "--max-doc", "9"]):
        with pytest.raises(SystemExit):
            progression.parse_args(["out", *bad])


def test_no_compiler_raises(monkeypatch, tmp_path):
    """Without g++ the reader is not built and nothing falls back."""
    monkeypatch.setattr(native_reader, "library_path",
                        lambda: tmp_path / "librecord_reader-x.so")
    monkeypatch.setattr(native_reader.shutil, "which", lambda name: None)
    with pytest.raises(native_reader.NativeBuildError, match="g\\+\\+ not "
                                                             "found"):
        native_reader._build()
