"""Build and bind the port's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. Nothing is built when a
module is imported: a :class:`KernelLibrary` builds its source at first use,
into ``build/kernels/`` at the repository root, under a file name that
carries the hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header never loads a stale library.
:func:`build_all` compiles every source at once, one ``nvcc`` per source,
all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """nvcc is missing or failed on a kernel source. Raised by
    :func:`build_all` / :meth:`KernelLibrary.load`; the message carries the
    compiler's output."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a CUDA error (launch refused:
    bad arguments, too much shared memory, no device). Raised by the ops
    wrappers right after the launch."""


@dataclass
class BuildResult:
    source: pathlib.Path
    library: pathlib.Path
    seconds: float  # 0.0 for a library that was already built
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


def find_nvcc() -> str:
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        "nvcc not found (checked $CUDA_HOME/bin, /usr/local/cuda/bin, PATH) "
        "— the port's CUDA kernels are built from source at first use")


def library_path(source: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: list[pathlib.Path] | None = None) -> list[BuildResult]:
    """Compile ``sources`` (default: every ``csrc/*.cu``) in parallel.
    Already-built libraries are reused, with the compiler output kept
    beside them. Returns one result per source, in order. Raises
    KernelBuildError naming every source that failed."""
    sources = sorted(CSRC_DIR.glob("*.cu")) if sources is None else sources
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, results = [], []
    for src in sources:
        out = library_path(src)
        if out.exists():
            log = out.with_suffix(".log")
            results.append(BuildResult(src, out, 0.0, log.read_text()
                                       if log.exists() else "already built"))
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((len(results), src, out, tmp, proc, time.perf_counter()))
        results.append(None)
    failures = []
    for i, src, out, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src.name} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)  # read back when reused
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        results[i] = BuildResult(src, out, seconds, log)
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return results


class KernelLibrary:
    """One ``csrc`` source, built at first use and bound with ctypes.

    ``signatures`` maps each exported C function to ``(restype,
    argtypes)``; every pointer and the stream are ``c_void_p`` so ctypes
    never truncates them to 32 bits.
    """

    def __init__(self, source: str, signatures: dict[str, tuple]):
        self.source = CSRC_DIR / source
        self._signatures = signatures
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                (result,) = build_all([self.source])
                lib = ctypes.CDLL(str(result.library))
                for name, (restype, argtypes) in self._signatures.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                self._lib = lib
            return self._lib
