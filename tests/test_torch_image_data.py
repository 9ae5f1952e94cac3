"""The port's image pipelines against the JAX package's, batch for batch.

Synthetic images, MNIST from a tiny ``mnist.npz`` and CIFAR-10 from tiny
pickle batches, all written in ``tmp_path`` with numpy from a seed, go
through both packages' ``get_dataset`` with the same config. The batches
must be EQUAL (same numpy draws, same arithmetic; the port's vectorised
crop gathers exactly what the JAX loop copies), with one exception:
standardised pixels (MNIST, CIFAR-10) may differ in the last bits. numpy's f32
``std`` reduces temporaries whose alignment follows the heap, and the
summation order of its SIMD loop follows the alignment, so either
package's standardised pixels move from one allocation pattern to
another (observed on 6% of the pixels of a CIFAR batch: a few ulps of
the mean, divided by the std, under 1e-6; the bound is 1e-6, or one bf16
ulp); the crops before standardisation are compared exactly. bf16
images are compared as bits: the JAX package's ``ml_dtypes.bfloat16``
array against the port's tagged uint16 array. Also: state and restore, the exact eval's padded tail, the
ImageNet fallback and an empty record file (refused, never replaced by the
fallback), and ``to_device`` of a bf16 batch.
"""

import logging
import os
import pickle

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import cifar as port_cifar
from distributed_tensorflow_framework_torch.data import (
    get_dataset as port_dataset,
)
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.data.pipeline import is_bfloat16
from distributed_tensorflow_framework_tpu.core.config import (
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.data import (
    get_dataset as jax_dataset,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401


def _write_mnist(root, n_train=40, n_test=10, seed=0):
    rng = np.random.default_rng(seed)
    np.savez(os.path.join(root, "mnist.npz"),
             x_train=rng.integers(0, 256, (n_train, 28, 28), np.uint8),
             y_train=rng.integers(0, 10, n_train, np.uint8),
             x_test=rng.integers(0, 256, (n_test, 28, 28), np.uint8),
             y_test=rng.integers(0, 10, n_test, np.uint8))


def _write_cifar(root, per_batch=8, n_test=10, seed=0):
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        n = n_test if name == "test_batch" else per_batch
        with open(os.path.join(base, name), "wb") as fh:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, fh)


def _assert_equal(a, b, standardized=False):
    """Equal batches. ``standardized``: the image pixels may differ by
    1e-6 in f32 (a few ulps of the mean over the std, about 1e-7), or by
    one unit in the last place of bf16."""
    assert a.keys() == b.keys()
    for key in a:
        x, y = a[key], b[key]
        if is_bfloat16(x.dtype):
            assert y.dtype.name == "bfloat16"
            x, y = x.view(np.int16), y.view(np.int16)
        else:
            assert x.dtype == y.dtype, key
        if key != "image" or not standardized:
            np.testing.assert_array_equal(x, y)
        elif x.dtype == np.int16:
            assert np.abs(x.astype(np.int32) - y).max() <= 1
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


def _both(over, train=True, process_index=0, process_count=1):
    pcfg, jcfg = port_config(overrides=over), jax_config(overrides=over)
    kw = dict(process_index=process_index, process_count=process_count,
              train=train)
    return port_dataset(pcfg.data, **kw), jax_dataset(jcfg.data, **kw)


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_synthetic_images_equal_jax(image_dtype):
    over = ["data.name=synthetic_images", "data.image_size=8",
            "data.channels=3", "data.num_classes=10", "data.seed=5",
            "data.global_batch_size=6", f"data.image_dtype={image_dtype}"]
    pds, jds = _both(over)
    for _ in range(3):
        _assert_equal(next(pds), next(jds))


@pytest.mark.parametrize("shard_mode, process_index", [
    ("block", 0), ("block", 1), ("stride", 1)])
def test_mnist_batches_equal_jax(tmp_path, shard_mode, process_index):
    """Two epochs of 40 images in global batches of 16 (two per epoch,
    the tail dropped), this host's half of each."""
    _write_mnist(tmp_path)
    over = ["data.name=mnist", f"data.data_dir={tmp_path}",
            "data.global_batch_size=16", f"data.shard_mode={shard_mode}"]
    pds, jds = _both(over, process_index=process_index, process_count=2)
    assert pds.cardinality == jds.cardinality == 2
    for _ in range(5):
        _assert_equal(next(pds), next(jds), standardized=True)
    assert pds.state() == jds.state()


@pytest.mark.parametrize("image_dtype", ["float32", "bfloat16"])
def test_cifar_batches_equal_jax(tmp_path, image_dtype):
    """Crops, flips and standardisation over two epochs of 40 images."""
    _write_cifar(tmp_path)
    over = ["data.name=cifar10", f"data.data_dir={tmp_path}",
            "data.image_size=32", "data.channels=3", "data.seed=3",
            "data.global_batch_size=16", f"data.image_dtype={image_dtype}"]
    pds, jds = _both(over)
    for _ in range(5):
        _assert_equal(next(pds), next(jds), standardized=True)


def test_cifar_crop_equals_the_jax_loop():
    """The gather against the JAX pipeline's per-image loop
    (``data/cifar.py:103-113``), bit for bit, on the same draws."""
    x = np.arange(2 * 32 * 32 * 3, dtype=np.float32).reshape(2, 32, 32, 3)
    rng = np.random.default_rng(0)
    out = port_cifar.crop_and_flip(x, rng)
    rng = np.random.default_rng(0)
    offs = rng.integers(0, 9, size=(2, 2))
    flips = rng.random(2) < 0.5
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    for j in range(2):
        oy, ox = offs[j]
        img = padded[j, oy:oy + 32, ox:ox + 32]
        np.testing.assert_array_equal(out[j], img[:, ::-1] if flips[j]
                                      else img)


@pytest.mark.parametrize("name, writer", [("mnist", _write_mnist),
                                          ("cifar10", _write_cifar)])
def test_exact_eval_pads_the_tail_like_jax(tmp_path, name, writer):
    """10 test images in batches of 4: three batches, the last holding two
    real rows and two zero rows of weight 0."""
    writer(tmp_path)
    over = [f"data.name={name}", f"data.data_dir={tmp_path}",
            "data.global_batch_size=4"]
    pds, jds = _both(over, train=False)
    assert pds.cardinality == jds.cardinality == 3
    batches = []
    for _ in range(3):
        a, b = next(pds), next(jds)
        _assert_equal(a, b, standardized=True)
        batches.append(a)
    with pytest.raises(StopIteration):
        next(pds)
    np.testing.assert_array_equal(batches[-1]["weight"], [1, 1, 0, 0])
    assert not batches[-1]["image"][2:].any()
    assert sum(b["weight"].sum() for b in batches) == 10


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def test_state_restores_mid_epoch(tmp_path, name):
    (_write_mnist if name == "mnist" else _write_cifar)(tmp_path)
    over = [f"data.name={name}", f"data.data_dir={tmp_path}",
            "data.global_batch_size=16"]
    ds = port_dataset(port_config(overrides=over).data)
    next(ds)
    saved = ds.state()
    assert (saved["epoch"], saved["batch_in_epoch"]) == (0, 1)
    want = [next(ds) for _ in range(3)]
    ds.restore(saved)
    for ref in want:
        _assert_equal(next(ds), ref)


@pytest.mark.parametrize("name, message", [
    ("mnist", "MNIST not found"), ("cifar10", "CIFAR-10 not found"),
    ("imagenet", "ImageNet TFRecords not found")])
def test_missing_data_falls_back_to_synthetic(tmp_path, caplog, name,
                                              message):
    over = [f"data.name={name}", f"data.data_dir={tmp_path}",
            "data.image_size=8", "data.channels=3", "model.num_classes=1000",
            "data.global_batch_size=4", "data.image_dtype=bfloat16"]
    with caplog.at_level(logging.WARNING):
        pds, jds = _both(over)
    assert message in caplog.text
    _assert_equal(next(pds), next(jds))


@pytest.mark.parametrize("native", [False, True])
def test_imagenet_records_are_refused(tmp_path, native):
    """A record file under data_dir is read, never replaced by the
    synthetic stream: one that holds no record is refused when the first
    batch is drawn (the reader itself: tests/test_torch_imagenet_records.py)."""
    (tmp_path / "train-00000-of-00001").write_bytes(b"")
    (tmp_path / "labels.txt").write_text("sidecar")
    cfg = port_config(overrides=["data.name=imagenet",
                                 "model.num_classes=1000",
                                 f"data.data_dir={tmp_path}",
                                 f"data.use_native_reader={native}"])
    ds = port_dataset(cfg.data)
    with pytest.raises(RuntimeError, match="no full batch"):
        next(ds)


def test_to_device_views_bf16_bits_as_bfloat16():
    cfg = port_config(overrides=["data.name=synthetic_images",
                                 "data.image_size=4", "data.channels=3",
                                 "data.global_batch_size=2",
                                 "data.image_dtype=bfloat16"])
    batch = next(port_dataset(cfg.data))
    out = to_device(batch, torch.device("cpu"))
    assert out["image"].dtype == torch.bfloat16
    assert out["label"].dtype == torch.int32
    cfg.data.image_dtype = "float32"
    ref = next(port_dataset(cfg.data))["image"]
    assert ref.dtype == np.float32
    torch.testing.assert_close(out["image"],
                               torch.from_numpy(ref).to(torch.bfloat16),
                               rtol=0, atol=0)
