"""ImageNet TFRecord pipeline: the port of ``data/imagenet.py``.

Records carry the canonical keys ``image/encoded`` (a JPEG) and
``image/class/label`` (1-based, shifted to 0-based here). The files are
``<data_dir>/train-*`` and ``validation-*`` (sidecar ``.txt``/``.json``/
``.yaml``/``.csv`` files ignored), and each process reads
``files[process_index::process_count]``: fewer files than processes raise
ValueError. Without record files the pipeline is the synthetic image
stream, with a warning, as in the JAX package. Files under ``data_dir``
never fall back: a reader that fails to build or a JPEG that fails to
decode raises.

The JPEG work runs in the native library (data/native_reader.py, C++
threads); Python orders the records and standardises nothing
(``(v - MEAN_RGB) / STDDEV_RGB`` is fused into the C++ output write).

* ``data.use_native_reader: true`` — the JAX native path, line for line:
  per epoch a file permutation and a record-shuffle seed from
  ``host_rng(seed, ROLE_DATA, epoch, process)``, a windowed record shuffle
  of ``shuffle_buffer`` in C++, per-image crop seeds from ``host_rng(seed,
  ROLE_AUGMENT, epoch, batch, process)`` (the distorted crop: area
  8-100%, aspect 3/4-4/3, 10 attempts, the full frame otherwise; a flip),
  a DCT-scaled partial decode and a bilinear resize. Its batches equal
  the JAX native path's bit for bit (tests/test_torch_imagenet_records.py).
  Resume skips the consumed records without decoding them. Eval: every
  record of the process's files once, in file order, the central 87.5%,
  padded with weights.
* ``data.use_native_reader: false`` (config 3 as written) — the JAX
  tf.data path's semantics without TensorFlow: ``interleave(cycle_length=
  16)`` over the files (data/tfdata.py), ``shuffle(shuffle_buffer)
  .repeat()`` reshuffled each epoch from ``host_rng(seed, ROLE_DATA,
  epoch, process)``, and the tf.data transforms (rr_decode_images): train
  draws the distorted crop from ``host_rng(seed, ROLE_AUGMENT, batch,
  process)`` seeds with the native path's sampler, decodes that window at
  full scale (decode_and_crop_jpeg), resizes it with TF's bicubic kernel
  and flips it; eval decodes the frame, takes tf.image.central_crop(0.875)
  and the same resize. Its eval pixels equal tf.data's (the CPU tests); the
  train draws differ from TF's stateless Philox (ROADMAP.md queue C).
  The iterator state is the batch count, and a restore re-reads the
  records up to it without decoding them.

Both eval streams hold the exact-eval contract: every record of the
process's files once, the final batch zero-padded with per-example
weights, and zero batches up to the largest batch count over the ranks
(``eval_batches_all_hosts``). Every stream is tagged REPARTITION_NONE: its
position counts records of this process's file shard.
"""

from __future__ import annotations

import glob
import itertools
import logging
import os
from typing import Iterator

import numpy as np

from distributed_tensorflow_framework_torch.core import prng
from distributed_tensorflow_framework_torch.core.config import DataConfig
from distributed_tensorflow_framework_torch.data import shard as data_shard
from distributed_tensorflow_framework_torch.data import synthetic, tfdata
from distributed_tensorflow_framework_torch.data.native_reader import (
    NativeRecordReader,
    count_records_native,
    decode_images,
)
from distributed_tensorflow_framework_torch.data.pipeline import (
    HostDataset,
    cast_images,
    host_batch_size,
    image_np_dtype,
)

log = logging.getLogger(__name__)

MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)
CYCLE_LENGTH = 16    # interleave(cycle_length=16) of the JAX tf.data path
CENTRAL_FRACTION = 0.875

_SIDECAR_EXTS = (".txt", ".json", ".yaml", ".csv")


def record_files(config: DataConfig, train: bool) -> list[str]:
    if not config.data_dir:
        return []
    sub = "train" if train else "validation"
    files = glob.glob(os.path.join(config.data_dir, f"{sub}-*"))
    return sorted(f for f in files if not f.lower().endswith(_SIDECAR_EXTS))


def make_imagenet(config: DataConfig, process_index: int, process_count: int,
                  *, train: bool = True) -> HostDataset:
    files = record_files(config, train)
    if not files:
        log.warning("ImageNet TFRecords not found under %r — synthetic "
                    "fallback", config.data_dir)
        return synthetic.synthetic_images(config, process_index,
                                          process_count)
    if len(files) < process_count:
        # An empty per-process file shard would leave that rank without
        # batches while its peers wait in a collective.
        raise ValueError(
            f"ImageNet reader: {len(files)} TFRecord file(s) for "
            f"{process_count} processes — sharding by file needs at least "
            f"one file per process.")
    if config.use_native_reader:
        if train:
            return _native_train(config, files, process_index, process_count)
        return _native_eval(config, files, process_index, process_count)
    if train:
        return _tf_train(config, files, process_index, process_count)
    return _tf_eval(config, files, process_index, process_count)


def _norm() -> tuple[np.ndarray, np.ndarray]:
    return (np.asarray(MEAN_RGB, np.float32),
            np.asarray(STDDEV_RGB, np.float32))


def _check_labels(labels: np.ndarray, num_classes: int, what: str) -> None:
    """An out-of-range label would NaN the loss through the cross
    entropy's gather: name the record problem instead."""
    if labels.size and (labels.min() < 1 or labels.max() > num_classes):
        raise ValueError(
            f"{what} label {int(labels.min())}...{int(labels.max())} "
            f"outside [1, {num_classes}] — records and data.num_classes "
            f"disagree")


def _spec(b: int, size: int, dtype, eval_: bool) -> dict:
    spec = {"image": ((b, size, size, 3), dtype), "label": ((b,), np.int32)}
    if eval_:
        spec["weight"] = ((b,), np.float32)
    return spec


def _eval_batch(images: np.ndarray, labels: np.ndarray, k: int,
                out_dtype) -> dict:
    """A padded eval batch: ``k`` real rows, zero rows after them with
    weight 0 and label 0 (a valid class, weighted out)."""
    b = len(labels)
    weight = np.zeros((b,), np.float32)
    weight[:k] = 1.0
    labels = labels - 1
    labels[k:] = 0
    images[k:] = 0.0
    return {"image": cast_images(images, out_dtype), "label": labels,
            "weight": weight}


def _zero_eval_batch(b: int, size: int, out_dtype) -> dict:
    return {"image": np.zeros((b, size, size, 3), out_dtype),
            "label": np.zeros((b,), np.int32),
            "weight": np.zeros((b,), np.float32)}


# ------------------------------------------------- use_native_reader: true

def _native_train(config: DataConfig, files: list[str], process_index: int,
                  process_count: int) -> HostDataset:
    """The JAX native train stream (``_make_imagenet_native``)."""
    b = host_batch_size(config.global_batch_size, process_count)
    size = config.image_size
    shard = files[process_index::process_count]
    out_dtype = image_np_dtype(config.image_dtype)
    mean, std = _norm()

    def make_iter(state):
        state.setdefault("epoch", 0)
        state.setdefault("batch_in_epoch", 0)
        while True:
            epoch = state["epoch"]
            skip = state["batch_in_epoch"]
            # The file order and the record-shuffle seed of the epoch come
            # from one per-epoch stream, so both replay on a resume.
            epoch_rng = prng.host_rng(config.seed, prng.ROLE_DATA, epoch,
                                      process_index)
            order = epoch_rng.permutation(len(shard))
            epoch_files = [shard[j] for j in order]
            shuffle_seed = int(epoch_rng.integers(0, 2**63, dtype=np.uint64))

            def seed_stream(epoch=epoch, start=skip):
                for i in itertools.count(start):
                    rng = prng.host_rng(config.seed, prng.ROLE_AUGMENT,
                                        epoch, i, process_index)
                    yield rng.integers(0, 2**63, size=b, dtype=np.uint64)

            reader = NativeRecordReader(epoch_files,
                                        shuffle_window=config.shuffle_buffer,
                                        shuffle_seed=shuffle_seed)
            try:
                if skip:
                    # Through the same shuffle window, without decoding.
                    got = reader.skip_records(skip * b)
                    if got < skip * b:
                        raise RuntimeError(
                            f"resume snapshot skips {skip * b} records but "
                            f"this host's shard holds only {got} — the "
                            f"shard set, process_count or batch size "
                            f"changed since the checkpoint was taken")
                batches = reader.batches_images(b, size, size,
                                                crop_seeds=seed_stream(),
                                                mean=mean, std=std)
                for i, (images, labels) in enumerate(batches, start=skip):
                    state["batch_in_epoch"] = i + 1
                    _check_labels(labels, config.num_classes, "record")
                    yield {"image": cast_images(images, out_dtype),
                           "label": labels - 1}
            finally:
                reader.close()
            if state["batch_in_epoch"] == 0 and skip == 0:
                raise RuntimeError(
                    f"native ImageNet shard {shard!r} yielded no full "
                    f"batch of {b} records")
            state["epoch"] += 1
            state["batch_in_epoch"] = 0

    return HostDataset(
        make_iter, element_spec=_spec(b, size, out_dtype, False),
        initial_state={"epoch": 0, "batch_in_epoch": 0},
        repartition=data_shard.REPARTITION_NONE)


def _native_eval(config: DataConfig, files: list[str], process_index: int,
                 process_count: int) -> HostDataset:
    """The JAX native exact eval (``_make_imagenet_native_eval``)."""
    b = host_batch_size(config.global_batch_size, process_count)
    size = config.image_size
    host_files = files[process_index::process_count]
    out_dtype = image_np_dtype(config.image_dtype)
    mean, std = _norm()
    total_records = count_records_native(host_files)
    num_batches = tfdata.eval_batches_all_hosts(
        total_records, b, process_count=process_count)

    def make_iter(state):
        state.setdefault("batches", 0)
        # The record count rides in the snapshot, so a resume detects a
        # shard set that changed since the checkpoint.
        state.setdefault("records", total_records)
        if state["records"] != total_records:
            raise RuntimeError(
                f"eval resume snapshot was taken over {state['records']} "
                f"records but this host's shard now holds {total_records} "
                f"— the shard set changed since the checkpoint was taken")
        reader = NativeRecordReader(host_files)
        try:
            if state["batches"]:
                reader.skip_records(state["batches"] * b)
            for images, labels, k in reader.batches_images_eval(
                    b, size, size, central_frac=CENTRAL_FRACTION, mean=mean,
                    std=std):
                _check_labels(labels[:k], config.num_classes, "eval record")
                state["batches"] += 1
                yield _eval_batch(images, labels, k, out_dtype)
        finally:
            reader.close()
        while state["batches"] < num_batches:
            state["batches"] += 1
            yield _zero_eval_batch(b, size, out_dtype)

    return HostDataset(
        make_iter, element_spec=_spec(b, size, out_dtype, True),
        initial_state={"batches": 0}, cardinality=num_batches,
        repartition=data_shard.REPARTITION_NONE)


# ------------------------------------------------ use_native_reader: false

def _interleaved(files: list[str]) -> Iterator[bytes]:
    return tfdata.interleave(files, tfdata.file_records, CYCLE_LENGTH)


def _tf_train(config: DataConfig, files: list[str], process_index: int,
              process_count: int) -> HostDataset:
    """The tf.data train stream: interleave, shuffle, repeat, the
    distorted crop at full scale, TF's bicubic resize, the flip."""
    b = host_batch_size(config.global_batch_size, process_count)
    size = config.image_size
    shard = files[process_index::process_count]
    out_dtype = image_np_dtype(config.image_dtype)
    mean, std = _norm()

    def make_iter(state):
        state.setdefault("batches", 0)
        records = tfdata.shuffled_epochs(
            lambda: _interleaved(shard), config.shuffle_buffer,
            seed=config.seed, process_index=process_index)
        skip = state["batches"] * b
        if skip and sum(1 for _ in itertools.islice(records, skip)) < skip:
            raise RuntimeError(
                f"resume snapshot skips {skip} records but this host's "
                f"shard {shard!r} holds none")
        for i in itertools.count(state["batches"]):
            chunk = list(itertools.islice(records, b))
            if len(chunk) < b:
                if i == 0:
                    raise RuntimeError(
                        f"ImageNet shard {shard!r} yielded no full batch of "
                        f"{b} records")
                return
            seeds = prng.host_rng(config.seed, prng.ROLE_AUGMENT, i,
                                  process_index).integers(
                0, 2**63, size=b, dtype=np.uint64)
            images, labels = decode_images(chunk, size, size,
                                           crop_seeds=seeds, mean=mean,
                                           std=std)
            _check_labels(labels, config.num_classes, "record")
            state["batches"] = i + 1
            yield {"image": cast_images(images, out_dtype),
                   "label": labels - 1}

    return HostDataset(
        make_iter, element_spec=_spec(b, size, out_dtype, False),
        initial_state={"batches": 0},
        repartition=data_shard.REPARTITION_NONE)


def _tf_eval(config: DataConfig, files: list[str], process_index: int,
             process_count: int) -> HostDataset:
    """The tf.data exact eval: interleave, the central crop of the whole
    frame, TF's bicubic resize, padded batches."""
    b = host_batch_size(config.global_batch_size, process_count)
    size = config.image_size
    host_files = files[process_index::process_count]
    out_dtype = image_np_dtype(config.image_dtype)
    mean, std = _norm()
    num_batches = tfdata.eval_batches_all_hosts(
        count_records_native(host_files), b, process_count=process_count)

    def make_iter(state):
        state.setdefault("batches", 0)
        records = _interleaved(host_files)
        for _ in itertools.islice(records, state["batches"] * b):
            pass
        while True:
            chunk = list(itertools.islice(records, b))
            if not chunk:
                break
            k = len(chunk)
            images = np.zeros((b, size, size, 3), np.float32)
            labels = np.zeros((b,), np.int32)
            images[:k], labels[:k] = decode_images(
                chunk, size, size, central_frac=CENTRAL_FRACTION, mean=mean,
                std=std)
            _check_labels(labels[:k], config.num_classes, "eval record")
            state["batches"] += 1
            yield _eval_batch(images, labels, k, out_dtype)
        while state["batches"] < num_batches:
            state["batches"] += 1
            yield _zero_eval_batch(b, size, out_dtype)

    return HostDataset(
        make_iter, element_spec=_spec(b, size, out_dtype, True),
        initial_state={"batches": 0}, cardinality=num_batches,
        repartition=data_shard.REPARTITION_NONE)
