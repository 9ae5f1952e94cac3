"""Background checkpoint commit thread: the port's copy of
``ckpt/async_saver.py``.

One daemon worker thread, ``dtf-ckpt-saver``, executes one commit job at a
time (payload write → manifest hash → fsync → atomic commit, assembled by
ckpt/checkpoint.py). The training thread pays only the device → host copy
of the state.

  * **one in flight, ever**: ``submit`` blocks until the previous commit
    has landed, so saves never interleave or commit out of order;
  * **drain on exit**: ``wait`` blocks until the in-flight commit lands;
    the trainer's exit paths (final save, SIGTERM → rc 83) call it;
  * **no silent failure**: an exception in a job is re-raised on the
    training thread at the next ``submit``/``wait``/``close`` as
    :class:`AsyncSaverError`.

A SIGKILL at any point (``crash_in_save`` fires on this thread) leaves a
committed step or an uncommitted directory that restore quarantines,
because the manifest write itself is tmp + fsync + rename. Stdlib only.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

log = logging.getLogger(__name__)

THREAD_NAME = "dtf-ckpt-saver"


class AsyncSaverError(RuntimeError):
    """A background commit failed; carries the step and original error."""

    def __init__(self, step: int | None, cause: BaseException):
        super().__init__(
            f"background checkpoint save for step {step} failed: "
            f"{type(cause).__name__}: {cause}"
        )
        self.step = step
        self.__cause__ = cause


class AsyncSaver:
    """One background worker executing serialized checkpoint-commit jobs.

    The thread is started lazily on the first ``submit`` and is a daemon:
    a hard crash on the training thread must not hang process exit on a
    half-finished write (the manifest layer makes that write read as
    uncommitted — exactly the crash contract).
    """

    def __init__(self, *, name: str = THREAD_NAME):
        self._name = name
        self._cond = threading.Condition()
        self._job: Callable[[], None] | None = None
        self._job_step: int | None = None
        self._busy = False
        self._error: AsyncSaverError | None = None
        self._closed = False
        self._thread: threading.Thread | None = None
        # Observability counters (tests + telemetry sanity checks).
        self.submitted = 0
        self.completed = 0

    # ------------------------------------------------------------ client --
    def submit(self, job: Callable[[], None], *, step: int | None = None) -> float:
        """Queue one commit job; returns seconds spent blocked waiting for
        the previous commit to land (0.0 when the pipe was idle).

        Serialization contract: at most one job queued-or-running. A
        pending background failure is re-raised here instead of accepting
        more work on top of a broken pipe.
        """
        t0 = time.perf_counter()
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncSaver is closed")
            self._wait_idle_locked()
            self._raise_pending_locked()
            self._ensure_thread_locked()
            self._job, self._job_step = job, step
            self.submitted += 1
            self._cond.notify_all()
        return time.perf_counter() - t0

    def wait(self) -> None:
        """Barrier: block until no commit is queued or in flight, then
        re-raise any background failure. The exit/preemption flush."""
        with self._cond:
            self._wait_idle_locked()
            self._raise_pending_locked()

    @property
    def idle(self) -> bool:
        with self._cond:
            return self._job is None and not self._busy

    def close(self) -> None:
        """Drain, surface any pending failure, and stop the worker."""
        with self._cond:
            self._wait_idle_locked()
            self._closed = True
            self._cond.notify_all()
            error = self._error
            self._error = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if error is not None:
            raise error

    # ------------------------------------------------------------ worker --
    def _wait_idle_locked(self) -> None:
        while self._job is not None or self._busy:
            self._cond.wait()

    def _raise_pending_locked(self) -> None:
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name=self._name, daemon=True
            )
            self._thread.start()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while self._job is None and not self._closed:
                    self._cond.wait()
                if self._job is None and self._closed:
                    return
                job, step = self._job, self._job_step
                self._job, self._job_step = None, None
                self._busy = True
            try:
                job()
            except BaseException as e:  # surface on the training thread
                log.error("background checkpoint save for step %s failed",
                          step, exc_info=True)
                with self._cond:
                    # Keep the FIRST failure if several pile up before a
                    # barrier runs (the first is the root cause).
                    if self._error is None:
                        self._error = AsyncSaverError(step, e)
            finally:
                with self._cond:
                    self._busy = False
                    self.completed += 1
                    self._cond.notify_all()
