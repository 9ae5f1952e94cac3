"""ctypes bindings for the native TFRecord reader (``native/record_reader.cc``).

The port's copy of ``data/native_reader.py`` without the image methods.
The C++ source is compiled by ``g++`` at first use (nothing is built when
this module is imported) into ``build/native/`` at the repository root,
under a file name that carries the hash of the source and the flags, so an
edited source never loads a stale library. There is no Python fallback:
without ``g++``, or when it fails, :func:`load_library` raises
:class:`NativeBuildError`.

  * ``NativeRecordReader.records()``      — raw record payloads (bytes)
  * ``NativeRecordReader.batches_i32()``  — (batch, width) int32 arrays of
    a named Int64List feature, parsed in C++ (short rows zero-padded)
  * ``NativeRecordReader.rows_i32()``     — the same in chunks, with each
    record's value count, for the fixed-length checks of data/tfdata.py
  * ``count_records_native(paths)`` and ``masked_crc32c(data)``
"""

from __future__ import annotations

import ctypes
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

_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    """``g++`` is missing or failed on the record reader's source. The
    message carries the compiler's output."""


def library_path() -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
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
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
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

    def close(self):
        if self._h:
            self._lib.rr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
