"""Author an ImageNet-layout TFRecord corpus of seeded JPEGs, without
TensorFlow.

The port's TF-free counterpart of ``scripts/make_imagenet_tfrecords.py``:
records with the canonical keys ``image/encoded`` (a JPEG) and
``image/class/label`` (1-based), in shards ``train-XXXXX-of-NNNNN`` and
``validation-XXXXX-of-NNNNN``, framed by ``data/progression.py``'s
``write_tfrecords``. The JPEGs are encoded at ``--quality`` by the native
library's codec (data/native_reader.py: libjpeg, or nvJPEG where libjpeg
is absent). Images have ImageNet-like sizes (short side 256-500, aspect
3:4 to 4:3, portrait or landscape) and the label decides the image: each
class is an 8 x 8 colour template, and an image is its class's template
stretched to the frame at a random contrast under uniform noise, so a
model can learn the labels. Every image comes from ``(seed, split,
index)``, so the corpus does not depend on the thread count.

    python -m distributed_tensorflow_framework_torch.data.imagenet_records \\
        OUT [--train-images 4096] [--validation-images 1000] \\
        [--train-shards 8] [--validation-shards 2] [--num-classes 1000] \\
        [--seed 0] [--quality 90] [--threads 8]

``--decode-reference FILE`` writes instead the codec reference that
``chip_smoke.py`` holds another build's codec to: a few seeded JPEGs and
the pixels this build's transforms make of them.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import time

import numpy as np

from distributed_tensorflow_framework_torch.data import native_reader
from distributed_tensorflow_framework_torch.data.progression import (
    bytes_feature,
    example,
    int64_feature,
    write_tfrecords,
)

IMAGE_KEY = "image/encoded"
LABEL_KEY = "image/class/label"
SPLITS = {"train": 0, "validation": 1}
TEMPLATE = 8          # a class template is TEMPLATE x TEMPLATE x 3
SHORT_SIDE = (256, 500)
NOISE = 40            # uniform noise in [-NOISE, NOISE] grey levels


def class_templates(num_classes: int, seed: int) -> np.ndarray:
    """(num_classes, TEMPLATE, TEMPLATE, 3) colours in [0, 1)."""
    return np.random.default_rng((seed, 2)).random(
        (num_classes, TEMPLATE, TEMPLATE, 3), dtype=np.float32)


def render(template: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One (h, w, 3) uint8 image of ``template``'s class."""
    short = int(rng.integers(SHORT_SIDE[0], SHORT_SIDE[1] + 1))
    long = int(round(short * rng.uniform(1.0, 4.0 / 3.0)))
    h, w = (short, long) if rng.random() < 0.5 else (long, short)
    colours = (78.0 + 100.0 * rng.uniform(0.5, 1.0) * template).astype(
        np.int16)
    return _stretch_with_noise(colours, h, w, rng)


def _stretch_with_noise(colours: np.ndarray, h: int, w: int,
                        rng: np.random.Generator,
                        noise: int = NOISE) -> np.ndarray:
    """``colours`` (TEMPLATE, TEMPLATE, 3) int16 stretched to (h, w, 3)
    (nearest), plus uniform noise in [-noise, noise], clipped to uint8."""
    rows = np.arange(h) * TEMPLATE // h
    cols = np.arange(w) * TEMPLATE // w
    img = colours[rows][:, cols]
    img += rng.integers(-noise, noise + 1, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255, out=img).astype(np.uint8)


def image_record(templates: np.ndarray, seed: int, split: str, index: int,
                 quality: int) -> bytes:
    """The serialised Example of image ``index`` of ``split``."""
    rng = np.random.default_rng((seed, SPLITS[split], index))
    label = int(rng.integers(1, len(templates) + 1))
    jpeg = native_reader.encode_jpeg(render(templates[label - 1], rng),
                                     quality)
    return example({IMAGE_KEY: bytes_feature(jpeg),
                    LABEL_KEY: int64_feature([label])})


def write_split(out: str, split: str, images: int, shards: int, *,
                num_classes: int, seed: int, quality: int,
                threads: int) -> int:
    """Write ``images`` records of ``split`` into ``shards`` files under
    ``out``; returns the bytes written."""
    templates = class_templates(num_classes, seed)
    written = 0
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for s, idx in enumerate(np.array_split(np.arange(images), shards)):
            path = os.path.join(out, f"{split}-{s:05d}-of-{shards:05d}")
            write_tfrecords(path, pool.map(
                lambda i: image_record(templates, seed, split, int(i),
                                       quality), idx))
            written += os.path.getsize(path)
    return written


# The codec reference: REFERENCE_IMAGES seeded JPEGs (width, height) and
# what each transform makes of them at REFERENCE_SIZE, raw [0, 255]
# pixels: the native path's train (crop seeds) and eval, and the tf.data
# path's train and eval.
REFERENCE_FRAMES = ((333, 250), (250, 375), (300, 300), (420, 280))
REFERENCE_SIZE = 48
REFERENCE_NOISE = 12  # less noise than the corpus keeps the JPEGs small
REFERENCE_TRANSFORMS = ("native_train", "native_eval", "tf_train",
                        "tf_eval")


def reference_transforms(jpegs: list[bytes], seed: int = 0
                         ) -> dict[str, np.ndarray]:
    """Each transform of ``jpegs`` through this build's codec, f32 (n,
    REFERENCE_SIZE, REFERENCE_SIZE, 3) raw pixels."""
    import tempfile

    n, size = len(jpegs), REFERENCE_SIZE
    seeds = np.random.default_rng((seed, 3)).integers(0, 2**63, n,
                                                      dtype=np.uint64)
    records = [example({IMAGE_KEY: bytes_feature(j),
                        LABEL_KEY: int64_feature([1])}) for j in jpegs]
    out = {"tf_train": native_reader.decode_images(
               records, size, size, crop_seeds=seeds)[0],
           "tf_eval": native_reader.decode_images(records, size, size)[0]}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference-00000-of-00001")
        write_tfrecords(path, records)
        reader = native_reader.NativeRecordReader([path])
        try:
            out["native_train"] = next(reader.batches_images(
                n, size, size, crop_seeds=iter([seeds])))[0]
        finally:
            reader.close()
        reader = native_reader.NativeRecordReader([path])
        try:
            out["native_eval"] = next(reader.batches_images_eval(
                n, size, size))[0]
        finally:
            reader.close()
    return out


def decode_reference(seed: int = 0, quality: int = 90) -> dict:
    """The reference's JPEGs (encoded by this build) and their
    transforms, as arrays for ``np.savez_compressed``."""
    rng = np.random.default_rng((seed, 4))
    templates = class_templates(len(REFERENCE_FRAMES), seed)
    jpegs = []
    for i, (w, h) in enumerate(REFERENCE_FRAMES):
        colours = (78.0 + 100.0 * templates[i]).astype(np.int16)
        jpegs.append(native_reader.encode_jpeg(
            _stretch_with_noise(colours, h, w, rng, REFERENCE_NOISE),
            quality))
    out = {f"jpeg_{i}": np.frombuffer(j, np.uint8)
           for i, j in enumerate(jpegs)}
    out.update({k: v.astype(np.float16) for k, v in
                reference_transforms(jpegs, seed).items()})
    out["codec"] = np.asarray(native_reader.jpeg_backend())
    return out


def load_reference(path: str) -> tuple[list[bytes], dict[str, np.ndarray]]:
    """(the JPEGs, each transform's f32 pixels) of a written reference."""
    with np.load(path) as f:
        jpegs = [f[f"jpeg_{i}"].tobytes()
                 for i in range(len(REFERENCE_FRAMES))]
        return jpegs, {k: f[k].astype(np.float32)
                       for k in REFERENCE_TRANSFORMS}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out", help="output directory, or with "
                               "--decode-reference the .npz to write")
    p.add_argument("--train-images", type=int, default=4096)
    p.add_argument("--validation-images", type=int, default=1000)
    p.add_argument("--train-shards", type=int, default=8)
    p.add_argument("--validation-shards", type=int, default=2)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quality", type=int, default=90)
    p.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    p.add_argument("--decode-reference", action="store_true",
                   help="write the codec reference to OUT instead")
    a = p.parse_args(argv)
    for name in ("train_shards", "validation_shards", "num_classes",
                 "threads"):
        if getattr(a, name) < 1:
            p.error(f"--{name.replace('_', '-')} must be at least 1")
    if not 1 <= a.quality <= 100:
        p.error("--quality must be in [1, 100]")
    return a


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.decode_reference:
        np.savez_compressed(a.out, **decode_reference(a.seed, a.quality))
        print(f"wrote the {native_reader.jpeg_backend()} codec reference "
              f"to {a.out}")
        return 0
    os.makedirs(a.out, exist_ok=True)
    for split, n, shards in (
            ("train", a.train_images, a.train_shards),
            ("validation", a.validation_images, a.validation_shards)):
        t0 = time.perf_counter()
        size = write_split(a.out, split, n, shards,
                           num_classes=a.num_classes, seed=a.seed,
                           quality=a.quality, threads=a.threads)
        print(f"wrote {n} {split} images ({size / 1e6:.2f} MB) into "
              f"{shards} shards under {a.out} in "
              f"{time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
