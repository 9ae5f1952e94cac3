"""Host → device infeed: batches to tensors, prefetched, behind a watchdog.

The port's counterpart of ``data/infeed.py``. The JAX ``to_global`` lifts
each host's rows into one global array sharded over the mesh; the port
runs one process per GPU, so each rank moves its own block of the global
batch (its dataset's ``host_batch`` rows, data/shard.py) to its own card
and never assembles the global batch: DDP's gradient all-reduce and the
cross-rank BatchNorm (models/layers.py) see the ranks' blocks as one
batch.

:func:`to_device` moves one host batch of numpy arrays: on a CUDA device
each array goes through pinned memory with a non-blocking copy, so the
transfer is queued behind the work already on the stream instead of
stalling the host.

:func:`prefetch_to_device` keeps ``size`` batches in flight and yields
``(batch, iterator_state_snapshot)`` in pull order. The snapshot is the
dataset's state right after that batch was pulled — the state to
checkpoint with the step that trains on it, since the live
``dataset.state()`` has run ahead by the prefetch depth. With
``background=True`` (``data.async_infeed``) the pull and the transfer run
on a producer thread; otherwise on the training thread. With
``deadline_s > 0`` (``resilience.infeed_deadline_s``) a pull that outlasts
the deadline raises :class:`InfeedStallError`; the pull keeps running, and
the next ``next()`` waits for the same batch (the trainer retries with
backoff).
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
import queue as queue_mod
import threading
from typing import Mapping

import numpy as np
import torch

from distributed_tensorflow_framework_torch.data.pipeline import is_bfloat16

log = logging.getLogger(__name__)

_EOF = object()


class InfeedStallError(RuntimeError):
    """A pull exceeded the infeed watchdog deadline. The pull is still in
    flight: calling ``next()`` again waits for the SAME batch (nothing is
    skipped or pulled twice)."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        super().__init__(
            f"infeed pull exceeded the {deadline_s:g}s watchdog deadline "
            f"(the pull is still running; retry next() to keep waiting)")


def to_device(batch: Mapping[str, np.ndarray],
              device: torch.device) -> dict[str, torch.Tensor]:
    """Each array as a tensor on ``device``; a tagged bf16 image array
    (data/pipeline.py ``BFLOAT16``) becomes a ``torch.bfloat16`` tensor."""
    out = {}
    for key, value in batch.items():
        value = np.ascontiguousarray(value)
        if is_bfloat16(value.dtype):
            t = torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(value)
        if device.type == "cuda":
            # The caching host allocator keeps the pinned buffer alive
            # until the copy on the stream has finished.
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def _snapshot(dataset) -> dict:
    return dataset.state() if hasattr(dataset, "state") else {}


class _BackgroundInfeed:
    """Producer-thread prefetcher: the pull and the device transfer run off
    the training thread; the consumer sees items in pull order."""

    def __init__(self, dataset, device: torch.device, size: int,
                 deadline_s: float = 0.0):
        self._deadline_s = deadline_s
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max(size, 1))
        self._stop = threading.Event()
        self._done = False

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce():
            try:
                for host_batch in dataset:
                    if self._stop.is_set():
                        return
                    if not put((to_device(host_batch, device),
                                _snapshot(dataset))):
                        return
            except BaseException as e:  # re-raised on the consumer side
                put(e)
                return
            put(_EOF)

        self._thread = threading.Thread(target=produce, daemon=True,
                                        name="dtf-infeed-prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        if self._deadline_s > 0:
            try:
                item = self._q.get(timeout=self._deadline_s)
            except queue_mod.Empty:
                raise InfeedStallError(self._deadline_s) from None
        else:
            item = self._q.get()
        if item is _EOF:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        return item

    def watermark(self) -> int:
        """Batches pulled ahead of the consumer now (approximate: the
        producer may be mid-pull)."""
        return self._q.qsize()

    def close(self) -> None:
        # The producer must stop pulling from a dataset the caller may
        # restore or reuse next.
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue_mod.Empty:
                break
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            log.warning("infeed producer thread did not stop within 10s — "
                        "the dataset may see one more pull; avoid reusing "
                        "it until the pipeline unblocks")


class _SyncInfeed:
    """Same-thread prefetcher with a bounded lookahead. With a deadline,
    each pull runs on one persistent worker thread so that it can be
    timed; a timed-out pull stays pending and the next ``next()`` resumes
    waiting on it."""

    def __init__(self, dataset, device: torch.device, size: int,
                 deadline_s: float = 0.0):
        self._dataset = dataset
        self._device = device
        self._size = max(size, 1)
        self._deadline_s = deadline_s
        self._buf: collections.deque = collections.deque()
        self._primed = False
        self._eof = False
        self._pool = None
        self._pending = None
        if deadline_s > 0:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dtf-infeed-pull")

    def _pull_raw(self):
        if self._pool is None:
            return next(self._dataset, _EOF)
        if self._pending is None:
            self._pending = self._pool.submit(next, self._dataset, _EOF)
        try:
            item = self._pending.result(timeout=self._deadline_s)
        except concurrent.futures.TimeoutError:
            raise InfeedStallError(self._deadline_s) from None
        self._pending = None
        return item

    def _fill(self, n: int) -> None:
        for _ in range(n):
            item = self._pull_raw()
            if item is _EOF:
                self._eof = True
                return
            self._buf.append((to_device(item, self._device),
                              _snapshot(self._dataset)))

    def __iter__(self):
        return self

    def __next__(self):
        want = 1 if self._primed else self._size
        self._primed = True
        if not self._eof:
            try:
                self._fill(want)
            except InfeedStallError:
                if not self._buf:
                    raise
                # Buffered batches cover the consumer; the stalled pull
                # stays pending for the next call.
        if not self._buf:
            raise StopIteration
        return self._buf.popleft()

    def watermark(self) -> int:
        """Batches pulled ahead of the consumer (buffered, plus a pending
        pull)."""
        return len(self._buf) + (1 if self._pending is not None else 0)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)


def prefetch_to_device(dataset, device: torch.device, *, size: int = 2,
                       background: bool = False, deadline_s: float = 0.0):
    """A closable iterator of ``(batch on device, state snapshot)``,
    ``size`` batches ahead; see the module docstring."""
    cls = _BackgroundInfeed if background else _SyncInfeed
    return cls(dataset, torch.device(device), size, deadline_s)
