"""The port's ImageNet record pipeline (data/imagenet.py, the image half of
native/record_reader.cc, data/imagenet_records.py) against the JAX
package's and against TensorFlow.

Records are written with TensorFlow (JPEGs of several sizes from a seed,
1-based labels) in ``tmp_path``; both packages read them through
``make_imagenet`` with the same config. Tolerances, with their reasons:

* ``use_native_reader: true``: the port's batches EQUAL the JAX native
  path's, bit for bit (the same C++ and the same host_rng draws): images,
  labels, file order, the record-shuffle window, flips, eval padding and a
  resume after a skip. bf16 images compare as bits.
* the native decode against TF's decode + bilinear resize: mean |error|
  below 6 grey levels per image, the JAX test's bound (libjpeg's DCT
  scaling against a full decode).
* ``use_native_reader: false``, eval: the port's pixels against tf.data's
  ``decode_jpeg → central_crop(0.875) → resize(bicubic) → standardise``,
  within 1e-5 (f32). TF's ``decode_jpeg`` defaults to the fast integer
  IDCT (``dct_method=""`` is ``INTEGER_FAST``, checked below), which the
  port's decode sets; the bicubic kernel is TF's table of Keys' cubic
  (a = -0.5). Observed: equal.
* the tf.data path's train window: ``decode_window`` against TF's
  ``decode_and_crop_jpeg → resize(bicubic) → flip`` of the same window,
  within 1e-4 grey levels (observed: equal). Against ``decode_jpeg →
  crop_to_bounding_box`` of the whole frame both differ, by the same
  pixels: decoding a window alone upsamples the chroma at its edges from
  the window's own samples (up to ~11 grey levels on up to 1/8 of the
  pixels here), so the port is held to TF's decode_and_crop there. The
  crop draws themselves differ from TF's stateless Philox by design
  (ROADMAP.md queue C).
* the native decode against TF: at 48 x 48 (no frame here is twice that,
  so libjpeg decodes at full scale, as in the JAX test).
"""

import glob
import os

import numpy as np
import pytest

from distributed_tensorflow_framework_torch.core.config import (
    DataConfig as PortDataConfig,
)
from distributed_tensorflow_framework_torch.data import imagenet as port_in
from distributed_tensorflow_framework_torch.data import imagenet_records
from distributed_tensorflow_framework_torch.data import native_reader
from distributed_tensorflow_framework_torch.data.pipeline import is_bfloat16
from distributed_tensorflow_framework_tpu.core.config import (
    DataConfig as JaxDataConfig,
)
from distributed_tensorflow_framework_tpu.data import imagenet as jax_in
from tests.test_torch_hygiene import torch_threads  # noqa: F401

tf = pytest.importorskip("tensorflow")

TRAIN_FILES = (5, 7, 4)
EVAL_FILES = (5, 6)
SIZE = 32
MEAN = np.asarray(port_in.MEAN_RGB, np.float32)
STD = np.asarray(port_in.STDDEV_RGB, np.float32)
REFERENCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "distributed_tensorflow_framework_torch",
    "native", "jpeg_reference.npz")


def _example(jpeg: bytes, label: int) -> bytes:
    return tf.train.Example(features=tf.train.Features(feature={
        "image/encoded": tf.train.Feature(
            bytes_list=tf.train.BytesList(value=[jpeg])),
        "image/class/label": tf.train.Feature(
            int64_list=tf.train.Int64List(value=[label])),
    })).SerializeToString()


def _write(root, split, counts, rng, labels=None):
    """``split`` shards of seeded RGB JPEGs (36-90 px a side, noise on a
    smooth ramp) with labels 1.. (or ``labels``); returns the JPEGs."""
    jpegs, n = [], 0
    for f, count in enumerate(counts):
        path = os.path.join(root, f"{split}-{f:05d}-of-{len(counts):05d}")
        with tf.io.TFRecordWriter(path) as w:
            for _ in range(count):
                h, w_ = rng.integers(36, 91, 2)
                ramp = np.linspace(40, 200, w_)[None, :, None]
                img = np.clip(ramp + rng.normal(0, 30, (h, w_, 3)), 0, 255)
                jpeg = tf.io.encode_jpeg(img.astype(np.uint8)).numpy()
                label = n + 1 if labels is None else labels[n]
                w.write(_example(jpeg, label))
                jpegs.append(jpeg)
                n += 1
    return jpegs


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagenet"))
    rng = np.random.default_rng(7)
    train = _write(root, "train", TRAIN_FILES, rng)
    evals = _write(root, "validation", EVAL_FILES, rng)
    with open(os.path.join(root, "train-labels.txt"), "w") as fh:
        fh.write("a sidecar file the reader skips")
    return {"dir": root, "train": train, "eval": evals}


def _configs(root, **kw):
    base = dict(name="imagenet", data_dir=root, global_batch_size=4,
                image_size=SIZE, seed=3, num_classes=1000,
                shuffle_buffer=5)
    base.update(kw)
    return PortDataConfig(**base), JaxDataConfig(**base)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], np.asarray(b[key])
        if is_bfloat16(x.dtype):
            assert is_bfloat16(y.dtype) or y.dtype.name == "bfloat16"
            x, y = x.view(np.uint16), y.view(np.uint16)
        else:
            assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


# ------------------------------------------------- use_native_reader: true

@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shuffle_buffer", [1, 5])
def test_native_train_batches_equal_jax(records, image_dtype,
                                        shuffle_buffer):
    """Nine batches of four from 16 records: three epochs, each with its
    own file permutation, shuffle seed and crop seeds."""
    pcfg, jcfg = _configs(records["dir"], use_native_reader=True,
                          image_dtype=image_dtype,
                          shuffle_buffer=shuffle_buffer)
    port = port_in.make_imagenet(pcfg, 0, 1)
    ref = jax_in.make_imagenet(jcfg, 0, 1)
    for _ in range(9):
        _assert_batches_equal(next(port), next(ref))
    assert port.state() == ref.state()


@pytest.mark.parametrize("skip", [1, 3, 5])
def test_native_resume_after_a_skip_equals_jax(records, skip):
    """A restore ``skip`` batches in (mid-epoch and across an epoch) skips
    the consumed records natively and replays the rest of the stream."""
    pcfg, jcfg = _configs(records["dir"], use_native_reader=True)
    straight = port_in.make_imagenet(pcfg, 0, 1)
    want = [next(straight) for _ in range(skip + 2)][skip:]
    first = port_in.make_imagenet(pcfg, 0, 1)
    for _ in range(skip):
        next(first)
    resumed = port_in.make_imagenet(pcfg, 0, 1)
    resumed.restore(first.state())
    ref = jax_in.make_imagenet(jcfg, 0, 1)
    ref.restore(first.state())
    for w in want:
        got = next(resumed)
        _assert_batches_equal(got, w)
        _assert_batches_equal(got, next(ref))


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_native_eval_equals_jax(records, image_dtype):
    """Eleven validation records in batches of four: three batches, the
    last padded with weight 0; then a restore one batch in."""
    pcfg, jcfg = _configs(records["dir"], use_native_reader=True,
                          image_dtype=image_dtype)
    port = port_in.make_imagenet(pcfg, 0, 1, train=False)
    ref = jax_in.make_imagenet(jcfg, 0, 1, train=False)
    assert port.cardinality == ref.cardinality == 3
    got = list(port)
    for a, b in zip(got, ref):
        _assert_batches_equal(a, b)
    assert sum(float(b["weight"].sum()) for b in got) == sum(EVAL_FILES)
    again = port_in.make_imagenet(pcfg, 0, 1, train=False)
    again.restore({"batches": 1, "records": sum(EVAL_FILES)})
    for a, b in zip(again, got[1:]):
        _assert_batches_equal(a, b)


def test_native_decode_matches_tf(records):
    """The C++ decode and bilinear resize against TF's decode + bilinear
    resize of the same records: labels exact, pixels within the JAX
    test's mean bound (libjpeg's DCT-scaled decode against a full one)."""
    files = port_in.record_files(_configs(records["dir"])[0], True)
    reader = native_reader.NativeRecordReader(files)
    try:
        batches = list(reader.batches_images(4, 48, 48))
    finally:
        reader.close()
    images = np.concatenate([img for img, _ in batches])
    labels = np.concatenate([lab for _, lab in batches])
    np.testing.assert_array_equal(labels, np.arange(1, 17))
    for got, raw in zip(images, records["train"]):
        ref = tf.image.resize(tf.io.decode_jpeg(raw, channels=3),
                              [48, 48], method="bilinear").numpy()
        assert np.abs(got - ref).mean() < 6.0


# ------------------------------------------------ use_native_reader: false

def test_decode_jpeg_defaults_to_the_fast_integer_idct(records):
    """TF's ``decode_jpeg`` with its default ``dct_method`` ("") decodes as
    ``INTEGER_FAST`` (JDCT_IFAST), not ``INTEGER_ACCURATE``: the port's
    tf.data-path decode sets JDCT_IFAST."""
    raw = records["eval"][0]
    default = tf.io.decode_jpeg(raw, channels=3).numpy()
    fast = tf.io.decode_jpeg(raw, channels=3,
                             dct_method="INTEGER_FAST").numpy()
    accurate = tf.io.decode_jpeg(raw, channels=3,
                                 dct_method="INTEGER_ACCURATE").numpy()
    np.testing.assert_array_equal(default, fast)
    assert not np.array_equal(default, accurate)


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_tf_path_eval_pixels_match_tfdata(records, image_dtype):
    """The exact eval through both packages: the same interleaved record
    order, labels and weights, and pixels within 1e-5 (bf16: one ulp)."""
    pcfg, jcfg = _configs(records["dir"], image_dtype=image_dtype)
    port = port_in.make_imagenet(pcfg, 0, 1, train=False)
    ref = jax_in.make_imagenet(jcfg, 0, 1, train=False)
    assert port.cardinality == ref.cardinality == 3
    n = 0
    for a, b in zip(port, ref):
        for key in ("label", "weight"):
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))
        if image_dtype == "bfloat16":
            x = a["image"].view(np.int16).astype(np.int32)
            y = np.asarray(b["image"]).view(np.int16).astype(np.int32)
            assert np.abs(x - y).max() <= 1
        else:
            np.testing.assert_allclose(a["image"], np.asarray(b["image"]),
                                       rtol=0, atol=1e-5)
        n += 1
    assert n == 3


@pytest.mark.parametrize("seed", [0, 1, 2, 5, 11])
def test_tf_path_train_window_matches_tf_crop_and_bicubic(records, seed):
    """A distorted-crop window and flip drawn for a record, decoded and
    resized by the port, against TF's crop_to_bounding_box + bicubic
    resize (+ flip) of the same window; and the batch decode of that
    record with that seed is the same pixels, standardised."""
    raw = records["train"][seed]
    frame = tf.io.decode_jpeg(raw, channels=3)
    h, w = int(frame.shape[0]), int(frame.shape[1])
    (x, y, cw, ch), flip = native_reader.sample_crop(seed, w, h)
    area = cw * ch / (w * h)
    assert (0.08 * 0.95 <= area <= 1.0 and 0 <= x <= w - cw
            and 0 <= y <= h - ch)
    got = native_reader.decode_window(raw, (x, y, cw, ch), SIZE, SIZE,
                                      flip=flip)
    window = tf.image.decode_and_crop_jpeg(raw, [y, x, ch, cw], channels=3)
    whole = tf.image.crop_to_bounding_box(frame, y, x, ch, cw)
    ref, ref_whole = (tf.image.resize(im, [SIZE, SIZE], method="bicubic")
                      for im in (window, whole))
    if flip:
        ref, ref_whole = (tf.image.flip_left_right(im)
                          for im in (ref, ref_whole))
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.abs(got - ref_whole.numpy()),
                               np.abs(ref.numpy() - ref_whole.numpy()),
                               rtol=0, atol=1e-4)
    record = _example(raw, 1)
    images, labels = native_reader.decode_images(
        [record], SIZE, SIZE, crop_seeds=np.asarray([seed], np.uint64),
        mean=MEAN, std=STD)
    np.testing.assert_allclose(images[0], (got - MEAN) / STD, rtol=0,
                               atol=1e-5)
    assert labels.tolist() == [1]


def test_tf_path_train_stream_is_deterministic_and_resumes(records):
    pcfg, _ = _configs(records["dir"], image_dtype="bfloat16")
    a = port_in.make_imagenet(pcfg, 0, 1)
    first = [next(a) for _ in range(6)]
    assert first[0]["image"].shape == (4, SIZE, SIZE, 3)
    assert is_bfloat16(first[0]["image"].dtype)
    labels = np.concatenate([b["label"] for b in first[:4]])
    # 16 records a shuffled epoch: the first four batches are a
    # permutation of the 0-based labels, the next epoch reshuffles.
    assert sorted(labels.tolist()) == list(range(16))
    b = port_in.make_imagenet(pcfg, 0, 1)
    next(b)
    c = port_in.make_imagenet(pcfg, 0, 1)
    c.restore(b.state())
    for want in first[1:]:
        _assert_batches_equal(next(c), want)


def test_tf_path_eval_counts_every_record_once(records):
    pcfg, _ = _configs(records["dir"], global_batch_size=5)
    ds = port_in.make_imagenet(pcfg, 0, 1, train=False)
    batches = list(ds)
    assert ds.cardinality == len(batches) == 3
    kept = np.concatenate([b["label"][b["weight"] > 0] for b in batches])
    assert sorted(kept.tolist()) == list(range(sum(EVAL_FILES)))
    assert (np.asarray(batches[-1]["image"])[batches[-1]["weight"] == 0]
            == 0).all()


@pytest.mark.parametrize("native", [True, False])
def test_eval_counts_the_host_shard(records, native, monkeypatch):
    """Two validation files over two processes: each reads one file (5 or
    6 records) in batches of 5 (global 10), one batch or two. (The ranks
    then run the larger count, a maximum over their group:
    tests/test_torch_ddp.py.)"""
    monkeypatch.setattr(port_in.tfdata, "eval_batches_all_hosts",
                        lambda n, b, process_count: -(-n // b))
    pcfg, _ = _configs(records["dir"], global_batch_size=10,
                       use_native_reader=native)
    for rank, real, count in ((0, 5, 1), (1, 6, 2)):
        ds = port_in.make_imagenet(pcfg, rank, 2, train=False)
        batches = list(ds)
        assert ds.cardinality == len(batches) == count
        assert sum(float(b["weight"].sum()) for b in batches) == real


# ----------------------------------------------------- guards and failures

@pytest.fixture(scope="module")
def bad_labels(tmp_path_factory):
    out = {}
    rng = np.random.default_rng(1)
    for name, label in (("zero", 0), ("above", 11)):
        root = str(tmp_path_factory.mktemp(f"labels_{name}"))
        _write(root, "train", (4,), rng, labels=[1, 2, label, 3])
        _write(root, "validation", (4,), rng, labels=[1, 2, label, 3])
        out[name] = root
    return out


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("which", ["zero", "above"])
def test_labels_must_be_one_based_within_num_classes(bad_labels, native,
                                                     train, which):
    pcfg, _ = _configs(bad_labels[which], num_classes=10,
                       use_native_reader=native, shuffle_buffer=1)
    ds = port_in.make_imagenet(pcfg, 0, 1, train=train)
    with pytest.raises(ValueError, match=r"outside \[1, 10\]"):
        next(ds)


@pytest.mark.parametrize("native", [True, False])
def test_fewer_files_than_processes_raises(records, native):
    pcfg, _ = _configs(records["dir"], use_native_reader=native,
                       global_batch_size=12)
    with pytest.raises(ValueError, match="at least one file per process"):
        port_in.make_imagenet(pcfg, 0, 3, train=False)


@pytest.mark.parametrize("native", [True, False])
def test_a_bad_jpeg_raises_and_never_falls_back(tmp_path, native):
    with tf.io.TFRecordWriter(str(tmp_path / "train-00000-of-00001")) as w:
        for label in (1, 2, 3, 4):
            w.write(_example(b"\xff\xd8 not a jpeg", label))
    pcfg, _ = _configs(str(tmp_path), use_native_reader=native)
    ds = port_in.make_imagenet(pcfg, 0, 1)
    with pytest.raises((ValueError, RuntimeError),
                       match="decode|JPEG"):
        next(ds)


def test_a_build_without_a_codec_raises(monkeypatch):
    class NoCodec:
        def rr_jpeg_backend(self):
            return 0

    monkeypatch.setattr(native_reader, "load_library", lambda: NoCodec())
    with pytest.raises(native_reader.NativeBuildError, match="jpeglib.h"):
        native_reader.decode_images([b"x"], 8, 8)
    with pytest.raises(native_reader.NativeBuildError, match="nvjpeg.h"):
        native_reader.encode_jpeg(np.zeros((8, 8, 3), np.uint8))


# --------------------------------------------------- the TF-free writer

def test_writer_records_read_back_by_tfdata(tmp_path):
    out = str(tmp_path / "corpus")
    assert imagenet_records.main([out, "--train-images", "10",
                                  "--validation-images", "5",
                                  "--train-shards", "3",
                                  "--validation-shards", "2",
                                  "--num-classes", "7", "--threads",
                                  "2"]) == 0
    names = sorted(os.path.basename(p) for p in glob.glob(f"{out}/*"))
    assert names == [f"train-{i:05d}-of-00003" for i in range(3)] + [
        f"validation-{i:05d}-of-00002" for i in range(2)]
    feats = {"image/encoded": tf.io.FixedLenFeature([], tf.string),
             "image/class/label": tf.io.FixedLenFeature([], tf.int64)}
    seen = 0
    for path in sorted(glob.glob(f"{out}/train-*")):
        for rec in tf.data.TFRecordDataset(path):
            ex = tf.io.parse_single_example(rec, feats)
            label = int(ex["image/class/label"])
            assert 1 <= label <= 7
            img = tf.io.decode_jpeg(ex["image/encoded"], channels=3)
            short, long = sorted(img.shape[:2])
            assert 256 <= short <= 500 and long <= short * 4 / 3 + 1
            seen += 1
    assert seen == 10
    # The same corpus again: byte for byte, whatever the thread count.
    again = str(tmp_path / "again")
    imagenet_records.main([again, "--train-images", "10",
                           "--validation-images", "5", "--train-shards",
                           "3", "--validation-shards", "2",
                           "--num-classes", "7", "--threads", "1"])
    for name in names:
        with open(f"{out}/{name}", "rb") as a, open(f"{again}/{name}",
                                                    "rb") as b:
            assert a.read() == b.read(), name
    # And the port trains from it: labels 0-based, within the classes.
    pcfg, _ = _configs(out, num_classes=7, global_batch_size=2)
    batch = next(port_in.make_imagenet(pcfg, 0, 1))
    assert batch["label"].max() < 7 and batch["label"].min() >= 0


def test_codec_reference_is_this_build(records):
    """The committed codec reference (data/imagenet_records.py,
    ``--decode-reference``) holds what the libjpeg build makes of its
    JPEGs: the same transforms of the stored JPEGs give the stored pixels
    (kept as float16)."""
    assert native_reader.jpeg_backend() == "libjpeg"
    jpegs, want = imagenet_records.load_reference(REFERENCE)
    got = imagenet_records.reference_transforms(jpegs)
    for key in imagenet_records.REFERENCE_TRANSFORMS:
        np.testing.assert_array_equal(
            got[key].astype(np.float16).astype(np.float32), want[key],
            err_msg=key)
