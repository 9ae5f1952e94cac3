"""ctypes bindings for the native TFRecord reader (``native/record_reader.cc``).

The port's copy of ``data/native_reader.py``, plus the transforms of the
JAX package's tf.data image path and a JPEG encoder. The C++ source is
compiled by ``g++`` at first use (nothing is built when this module is
imported) with the JPEG codec :func:`jpeg_codec` finds (libjpeg, else the
CUDA toolkit's nvJPEG) into ``build/native/`` at the repository root,
under a file name that carries the hash of the source and the flags, so
an edited source never loads a stale library. There is no Python
fallback: without ``g++``, or when it fails, :func:`load_library` raises
:class:`NativeBuildError`; a build without a codec reads records, and its
image functions raise :class:`NativeBuildError` naming the missing files.

  * ``NativeRecordReader.records()``      — raw record payloads (bytes)
  * ``NativeRecordReader.batches_i32()``  — (batch, width) int32 arrays of
    a named Int64List feature, parsed in C++ (short rows zero-padded)
  * ``NativeRecordReader.rows_i32()``     — the same in chunks, with each
    record's value count, for the fixed-length checks of data/tfdata.py
  * ``NativeRecordReader.batches_images()`` / ``batches_images_eval()`` —
    the JAX native ImageNet path's decoded batches (DCT-scaled partial
    decode, bilinear resize)
  * ``decode_images(records, ...)`` — the tf.data path's transforms of
    serialized Examples (full-scale decode, TF's bicubic resize);
    ``decode_window`` and ``sample_crop`` expose its pieces
  * ``encode_jpeg(rgb, quality)``, ``count_records_native(paths)`` and
    ``masked_crc32c(data)``
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Iterator, Sequence

import numpy as np

log = logging.getLogger(__name__)

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "native" / (
    "record_reader.cc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
JPEG_BACKENDS = {0: "none", 1: "libjpeg", 2: "nvjpeg"}

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """``g++`` is missing or failed on the record reader's source, or the
    image functions were called in a build without a JPEG codec. The
    message carries the compiler's output or the missing files."""


def _cuda_home() -> pathlib.Path:
    return pathlib.Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def _nvjpeg_files() -> list[pathlib.Path]:
    cuda = _cuda_home()
    return [cuda / "include" / "nvjpeg.h",
            cuda / "include" / "cuda_runtime_api.h",
            cuda / "lib64" / "libnvjpeg.so", cuda / "lib64" / "libcudart.so"]


@functools.cache
def jpeg_codec() -> tuple[str, tuple[str, ...], tuple[str, ...]]:
    """(codec, compile flags, link flags) of the build: ``libjpeg`` where
    ``g++`` finds ``jpeglib.h`` (the JAX package's decoder); else
    ``nvjpeg``, the CUDA toolkit's (``CUDA_HOME``, default
    ``/usr/local/cuda``), when its headers and libraries are there; else
    ``none``, a build whose image functions raise naming the missing
    files. Decided once per process."""
    cxx = shutil.which("g++")
    if cxx is not None and subprocess.run(
            [cxx, "-E", "-x", "c++", "-"],
            input="#include <cstdio>\n#include <jpeglib.h>\n",
            capture_output=True, text=True).returncode == 0:
        return "libjpeg", (), ("-ljpeg",)
    if all(p.exists() for p in _nvjpeg_files()):
        lib = str(_cuda_home() / "lib64")
        return ("nvjpeg", ("-DRR_NVJPEG", f"-I{_cuda_home() / 'include'}"),
                (f"-L{lib}", f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart"))
    return "none", ("-DRR_NO_JPEG",), ()


def library_path() -> pathlib.Path:
    _, cflags, lflags = jpeg_codec()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + cflags + lflags).encode())
    return BUILD_DIR / f"librecord_reader-{h.hexdigest()[:16]}.so"


def _build() -> pathlib.Path:
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(
            "g++ not found on PATH — the native TFRecord reader is built "
            "from source at first use and has no Python fallback")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    _, cflags, lflags = jpeg_codec()
    cmd = [cxx, *CXX_FLAGS, *cflags, str(SOURCE), *lflags, "-o", str(tmp)]
    log.info("building native record reader: %s", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed on {SOURCE.name} (rc "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load_library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.rr_open.restype = ctypes.c_void_p
            lib.rr_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_long, ctypes.c_uint64]
            lib.rr_skip.restype = ctypes.c_long
            lib.rr_skip.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.rr_next_record.restype = ctypes.c_int
            lib.rr_next_record.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                ctypes.POINTER(ctypes.c_long)]
            lib.rr_free.restype = None
            lib.rr_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
            lib.rr_next_batch_i32.restype = ctypes.c_int
            lib.rr_next_batch_i32.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int]
            lib.rr_next_rows_i32.restype = ctypes.c_int
            lib.rr_next_rows_i32.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int]
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.rr_next_batch_images.restype = ctypes.c_int
            lib.rr_next_batch_images.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, f32p,
                i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, u64p, f32p, f32p]
            lib.rr_next_batch_images_eval.restype = ctypes.c_int
            lib.rr_next_batch_images_eval.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, f32p,
                i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, f32p, f32p]
            lib.rr_decode_images.restype = ctypes.c_int
            lib.rr_decode_images.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), u64p, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_char_p, f32p, i32p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, u64p,
                ctypes.c_float, f32p, f32p]
            lib.rr_decode_window.restype = ctypes.c_int
            lib.rr_decode_window.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, f32p]
            lib.rr_sample_crop.restype = ctypes.c_int
            lib.rr_sample_crop.argtypes = [ctypes.c_uint64, ctypes.c_int,
                                           ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)]
            lib.rr_encode_jpeg.restype = ctypes.c_int
            lib.rr_encode_jpeg.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
                ctypes.POINTER(ctypes.c_ulong)]
            lib.rr_jpeg_backend.restype = ctypes.c_int
            lib.rr_jpeg_backend.argtypes = []
            lib.rr_masked_crc32c.restype = ctypes.c_uint32
            lib.rr_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.rr_error.restype = ctypes.c_char_p
            lib.rr_error.argtypes = [ctypes.c_void_p]
            lib.rr_close.restype = None
            lib.rr_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def masked_crc32c(data: bytes) -> int:
    """The TFRecord framing checksum of ``data``: crc32c, rotated right by
    15 bits, plus 0xa282ead8."""
    return int(load_library().rr_masked_crc32c(data, len(data)))


def jpeg_backend() -> str:
    """The codec the loaded library was built with: ``libjpeg``,
    ``nvjpeg`` or ``none``."""
    return JPEG_BACKENDS[load_library().rr_jpeg_backend()]


def _image_library():
    """The library, for a function that decodes or encodes JPEGs; raises
    NativeBuildError when it was built without a codec."""
    lib = load_library()
    if lib.rr_jpeg_backend() == 0:
        raise NativeBuildError(
            "the native reader was built without a JPEG codec: g++ found no "
            "jpeglib.h (libjpeg or libjpeg-turbo headers) and the CUDA "
            "toolkit lacks one of " + ", ".join(
                str(p) for p in _nvjpeg_files() if not p.exists()))
    return lib


def _f32p(arr: np.ndarray | None):
    return (ctypes.POINTER(ctypes.c_float)() if arr is None
            else arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))


def _norm_arrays(mean, std) -> tuple[np.ndarray | None, np.ndarray | None]:
    """Per-channel (mean, std) as contiguous f32 arrays of 3, or two Nones.
    Exactly one of the pair is a caller bug: skipping the standardisation
    would feed raw pixels downstream."""
    if (mean is None) != (std is None):
        raise ValueError(
            "normalization needs BOTH mean and std (got only "
            + ("mean" if std is None else "std") + ")")
    if mean is None:
        return None, None
    mean_arr = np.ascontiguousarray(mean, np.float32)
    std_arr = np.ascontiguousarray(std, np.float32)
    if mean_arr.shape != (3,) or std_arr.shape != (3,):
        raise ValueError(f"mean and std need 3 channels, got "
                         f"{mean_arr.shape} and {std_arr.shape}")
    return mean_arr, std_arr


def decode_images(records: Sequence[bytes], height: int, width: int, *,
                  crop_seeds: np.ndarray | None = None,
                  central_frac: float = 0.875,
                  mean: np.ndarray | None = None,
                  std: np.ndarray | None = None, threads: int = 0,
                  image_key: str = "image/encoded",
                  label_key: str = "image/class/label"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(images f32 (n, height, width, 3), labels int32 (n,)) of serialized
    Examples through the JAX tf.data path's transforms, in C++ threads
    (``threads`` 0: eight). With ``crop_seeds`` ((n,) uint64) the train
    transform: each record's distorted-crop window and flip from its seed,
    the window alone decoded at full scale (decode_and_crop_jpeg); without,
    the eval transform: the frame decoded and tf.image.central_crop's
    ``central_frac`` window of it. Then TF's bicubic resize and, given
    ``mean``/``std``, ``(v - mean) / std``. Raises ValueError naming the
    first record that has no JPEG or label, or whose JPEG fails."""
    lib = _image_library()
    n = len(records)
    images = np.empty((n, height, width, 3), np.float32)
    labels = np.zeros((n,), np.int32)
    if n == 0:
        return images, labels
    mean_arr, std_arr = _norm_arrays(mean, std)
    recs = (ctypes.c_char_p * n)(*records)
    lens = np.asarray([len(r) for r in records], np.uint64)
    seeds = None
    if crop_seeds is not None:
        seeds = np.ascontiguousarray(crop_seeds, np.uint64)
        if seeds.shape != (n,):
            raise ValueError(f"crop_seeds {seeds.shape} for {n} records")
    rc = lib.rr_decode_images(
        recs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
        image_key.encode(), label_key.encode(), _f32p(images),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), height,
        width, threads,
        (ctypes.POINTER(ctypes.c_uint64)() if seeds is None
         else seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))),
        central_frac, _f32p(mean_arr), _f32p(std_arr))
    if rc < 0:
        raise ValueError(
            f"record {-rc - 1} of the batch: no {image_key!r} JPEG or "
            f"{label_key!r} label, or the JPEG does not decode")
    return images, labels


def decode_window(jpeg: bytes, window: tuple[int, int, int, int],
                  height: int, width: int, *, flip: bool = False
                  ) -> np.ndarray:
    """f32 (height, width, 3) raw pixels of ``jpeg``'s window ``(x, y, w,
    h)`` through the train transform: the window decoded alone at full
    scale, TF's bicubic resize, mirrored when ``flip``."""
    out = np.empty((height, width, 3), np.float32)
    cx, cy, cw, ch = window
    if _image_library().rr_decode_window(jpeg, len(jpeg), cx, cy, cw, ch,
                                       int(flip), height, width,
                                       _f32p(out)) != 0:
        raise ValueError(f"the JPEG does not decode, or the window "
                         f"{window} leaves its frame")
    return out


def sample_crop(seed: int, frame_width: int, frame_height: int
                ) -> tuple[tuple[int, int, int, int], bool]:
    """The distorted-crop window ``(x, y, w, h)`` and the flip that both
    image paths draw for a frame of that size from ``seed``."""
    window = (ctypes.c_int * 4)()
    flip = load_library().rr_sample_crop(seed, frame_width, frame_height,
                                         window)
    return tuple(window), bool(flip)


def encode_jpeg(rgb: np.ndarray, quality: int = 90) -> bytes:
    """Baseline JPEG bytes of an (h, w, 3) uint8 RGB image, libjpeg's
    encoder at ``quality`` (4:2:0 chroma)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"need (h, w, 3) RGB, got {rgb.shape}")
    lib = _image_library()
    buf = ctypes.POINTER(ctypes.c_char)()
    size = ctypes.c_ulong()
    if lib.rr_encode_jpeg(rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          rgb.shape[1], rgb.shape[0], quality,
                          ctypes.byref(buf), ctypes.byref(size)) != 0:
        raise ValueError(f"libjpeg could not encode a {rgb.shape} image")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.rr_free(buf)


# files-tuple → record count. Restores rebuild pipelines, so the count per
# shard set is taken once.
_COUNT_CACHE: dict[tuple[str, ...], int] = {}


def count_records_native(paths: Sequence[str]) -> int:
    """Number of records across ``paths`` (framing and CRCs checked, no
    parse), cached per file tuple."""
    key = tuple(paths)
    if key not in _COUNT_CACHE:
        reader = NativeRecordReader(key)
        try:
            _COUNT_CACHE[key] = reader.skip_records(2**62)
        finally:
            reader.close()
    return _COUNT_CACHE[key]


class NativeRecordReader:
    def __init__(self, paths: Sequence[str], prefetch: int = 256,
                 *, shuffle_window: int = 0, shuffle_seed: int = 0):
        """``shuffle_window > 1`` enables a windowed record-level shuffle
        (tf.data shuffle-buffer semantics) applied to every iterator of
        this handle, deterministic given ``shuffle_seed``. Memory cost is
        ``window`` raw records held in C++."""
        self._h = None
        self._lib = load_library()
        arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
        self._h = self._lib.rr_open(arr, len(paths), prefetch,
                                    shuffle_window, shuffle_seed)
        if not self._h:
            raise RuntimeError("rr_open failed")

    def _check_error(self):
        err = self._lib.rr_error(self._h)
        if err:
            raise RuntimeError(f"native reader: {err.decode()}")

    def skip_records(self, n: int) -> int:
        """Advance the (possibly shuffled) stream ``n`` records without
        parse or C-ABI copies — the resume fast-skip. Returns how many
        were actually skipped (short on EOF)."""
        got = self._lib.rr_skip(self._h, n)
        if got < 0:
            self._check_error()
            raise RuntimeError("native reader skip failed")
        return int(got)

    def records(self) -> Iterator[bytes]:
        buf = ctypes.POINTER(ctypes.c_char)()
        n = ctypes.c_long()
        while True:
            rc = self._lib.rr_next_record(self._h, ctypes.byref(buf),
                                          ctypes.byref(n))
            if rc < 0:
                self._check_error()
                raise RuntimeError("native reader failed")
            if rc == 0:
                return
            try:
                yield ctypes.string_at(buf, n.value)
            finally:
                self._lib.rr_free(buf)

    def batches_i32(self, key: str, batch: int, width: int
                    ) -> Iterator[np.ndarray]:
        """Full (batch, width) int32 batches of feature ``key``; a short
        record is zero-padded and a long one cut at ``width``. A final
        partial batch is dropped."""
        out = np.empty((batch, width), np.int32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while True:
            rc = self._lib.rr_next_batch_i32(self._h, key.encode(), ptr,
                                             batch, width)
            if rc < 0:
                self._check_error()
                raise RuntimeError(f"native reader parse error (rc={rc})")
            if rc == 0:
                return
            yield out.copy()

    def rows_i32(self, key: str, width: int, chunk: int = 64
                 ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """``(rows (k, width) int32, lengths (k,) int32)`` chunks of at
        most ``chunk`` records, in stream order, the last one short.
        ``lengths`` holds each record's value count for ``key``: 0 when
        it is missing, ``width + 1`` when it holds more than ``width``."""
        key_b = key.encode()
        while True:
            rows = np.empty((chunk, width), np.int32)
            lengths = np.empty((chunk,), np.int32)
            rc = self._lib.rr_next_rows_i32(
                self._h, key_b,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                chunk, width)
            if rc < 0:
                self._check_error()
                raise RuntimeError(f"native reader parse error (rc={rc})")
            if rc == 0:
                return
            yield rows[:rc], lengths[:rc]

    def batches_images(self, batch: int, height: int, width: int,
                       *, image_key: str = "image/encoded",
                       label_key: str = "image/class/label",
                       threads: int = 0,
                       crop_seeds: Iterator[np.ndarray] | None = None,
                       mean: np.ndarray | None = None,
                       std: np.ndarray | None = None,
                       ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """(images f32 (b,h,w,3), labels i32 (b,)) per full batch.

        JPEG decode and bilinear resize run in C++ worker threads. With
        ``crop_seeds`` (an iterator of (batch,) uint64 arrays, one per
        batch) each image gets the distorted crop and a random flip,
        decoded via partial IDCT (DCT scaling, crop/skip scanlines).
        ``mean``/``std`` (length 3) fuse the standardisation into the
        resize; without them the pixels are raw [0, 255]."""
        _image_library()
        images = np.empty((batch, height, width, 3), np.float32)
        labels = np.empty((batch,), np.int32)
        iptr = _f32p(images)
        lptr = labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        mean_arr, std_arr = _norm_arrays(mean, std)
        while True:
            seeds = None
            if crop_seeds is not None:
                seeds = np.ascontiguousarray(next(crop_seeds), np.uint64)
                if seeds.shape != (batch,):
                    raise ValueError(f"crop seeds {seeds.shape} for a "
                                     f"batch of {batch}")
            rc = self._lib.rr_next_batch_images(
                self._h, image_key.encode(), label_key.encode(), iptr, lptr,
                batch, height, width, threads,
                (ctypes.POINTER(ctypes.c_uint64)() if seeds is None else
                 seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))),
                _f32p(mean_arr), _f32p(std_arr))
            if rc < 0:
                self._check_error()
                raise RuntimeError(f"native image decode error (rc={rc})")
            if rc == 0:
                return
            yield images.copy(), labels.copy()

    def batches_images_eval(self, batch: int, height: int, width: int,
                            *, image_key: str = "image/encoded",
                            label_key: str = "image/class/label",
                            threads: int = 0, central_frac: float = 0.875,
                            mean: np.ndarray | None = None,
                            std: np.ndarray | None = None,
                            ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        """(images, labels, k) per batch of ONE pass: the central crop
        (``central_frac``, tf.image.central_crop's arithmetic) and the
        bilinear resize in C++. ``k <= batch`` real records; the final
        batch is zero-padded past ``k`` (labels 0), for the caller to
        weight out."""
        _image_library()
        images = np.empty((batch, height, width, 3), np.float32)
        labels = np.empty((batch,), np.int32)
        iptr = _f32p(images)
        lptr = labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        mean_arr, std_arr = _norm_arrays(mean, std)
        while True:
            rc = self._lib.rr_next_batch_images_eval(
                self._h, image_key.encode(), label_key.encode(), iptr, lptr,
                batch, height, width, threads, central_frac,
                _f32p(mean_arr), _f32p(std_arr))
            if rc < 0:
                self._check_error()
                raise RuntimeError(f"native eval decode error (rc={rc})")
            if rc == 0:
                return
            img, lab = images.copy(), labels.copy()
            if rc < batch:
                img[rc:] = 0.0
                lab[rc:] = 0
            yield img, lab, rc

    def close(self):
        if self._h:
            self._lib.rr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
