"""Stress the native record reader's end-of-file handshake.

Builds ``record_reader.cc`` (default: the port's,
``distributed_tensorflow_framework_torch/native/record_reader.cc``; any
other version with ``--source``) without a JPEG codec, and a small C++
driver that opens a reader on an empty record file and reads to EOF, over
and over. It starts ``--procs`` drivers together, each for ``--iters``
rounds under a ``--timeout``, and reports how many finished and how many
were still waiting when the time ran out: a reader whose worker thread
signals EOF without the queue's mutex loses the wakeup now and then, and
its consumer sleeps forever. More processes than cores make the race
likelier. Needs ``g++``. Example, the version before the fix against the
current one::

    git show 721b825:distributed_tensorflow_framework_torch/native/record_reader.cc > /tmp/old.cc
    python -m tools.reader_eof_stress --source /tmp/old.cc
    python -m tools.reader_eof_stress
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "distributed_tensorflow_framework_torch" / "native"
          / "record_reader.cc")
DRIVER = r"""
#include <cstdio>
#include <cstdlib>
#include <dlfcn.h>
typedef void* (*open_t)(const char**, int, int, long, unsigned long long);
typedef int (*next_t)(void*, char**, long*);
typedef void (*close_t)(void*);
int main(int argc, char** argv) {
  void* lib = dlopen(argv[1], RTLD_NOW);
  if (!lib) { std::fprintf(stderr, "%s\n", dlerror()); return 2; }
  open_t op = (open_t)dlsym(lib, "rr_open");
  next_t nx = (next_t)dlsym(lib, "rr_next_record");
  close_t cl = (close_t)dlsym(lib, "rr_close");
  const char* paths[1] = {argv[2]};
  long n = std::atol(argv[3]);
  for (long i = 0; i < n; ++i) {
    void* h = op(paths, 1, 4, 0, 0);
    char* buf;
    long len;
    if (nx(h, &buf, &len) != 0) return 3;  // an empty file: EOF at once
    cl(h);
  }
  return 0;
}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=str(SOURCE))
    ap.add_argument("--procs", type=int, default=12)
    ap.add_argument("--iters", type=int, default=300_000)
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    cxx = shutil.which("g++")
    if cxx is None:
        print("g++ not found", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        lib, driver = tmp / "libreader.so", tmp / "driver"
        (tmp / "driver.cc").write_text(DRIVER)
        (tmp / "empty.tfrecord").write_bytes(b"")
        subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                        "-pthread", "-DRR_NO_JPEG", args.source, "-o",
                        str(lib)], check=True)
        subprocess.run([cxx, "-O2", str(tmp / "driver.cc"), "-o",
                        str(driver), "-ldl"], check=True)
        procs = [subprocess.Popen([str(driver), str(lib),
                                   str(tmp / "empty.tfrecord"),
                                   str(args.iters)])
                 for _ in range(args.procs)]
        deadline = time.monotonic() + args.timeout
        for proc in procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        waiting = [p for p in procs if p.poll() is None]
        for proc in waiting:
            proc.kill()
            proc.wait()
        failed = sum(1 for p in procs if p not in waiting and p.returncode)
        print(f"{args.source}: {len(procs) - len(waiting) - failed} of "
              f"{len(procs)} processes read {args.iters} empty files to EOF "
              f"within {args.timeout:g} s, {len(waiting)} still waiting "
              f"(frozen), {failed} failed")
        return 1 if waiting or failed else 0


if __name__ == "__main__":
    sys.exit(main())
