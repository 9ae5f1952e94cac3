"""The trainer's exit-code contract and graceful preemption.

The port's copy of the single-process part of ``core/supervision.py``:

  * ``GRACEFUL_PREEMPT_RC`` (83): SIGTERM honoured — the in-flight step
    finished, a checkpoint was saved, relaunch whenever;
  * ``ELASTIC_RESHARD_RC`` (84): the configured mesh does not fit the
    gang's ranks (``core/mesh.py:MeshSizeError``) — a topology change to
    refit to, not a crash;
  * ``ANOMALY_ESCALATION_RC`` (85): the in-process recovery ladder
    (train/anomaly.py) gave up after ``max_rollbacks`` consecutive
    rollbacks;
  * ``install_sigterm_handler`` arms a flag the train loop polls at step
    boundaries; a second SIGTERM kills outright. ``graceful_preemption``
    arms it for a block and puts the previous handler back after it, for
    callers that run the CLI in process (tests, ``chip_smoke.py``).

Gang supervision (the refit after rc 84), backoff and heartbeat reading
are ROADMAP.md queue A item A17. Stdlib only.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal

log = logging.getLogger(__name__)

GRACEFUL_PREEMPT_RC = 83
ELASTIC_RESHARD_RC = 84
ANOMALY_ESCALATION_RC = 85

_preempt_requested = False
_handler_installed = False


def preemption_requested() -> bool:
    return _preempt_requested


def reset_preemption() -> None:
    """Clear the flag (tests; an in-process relaunch)."""
    global _preempt_requested
    _preempt_requested = False


def _on_sigterm(signum, frame):
    global _preempt_requested
    if _preempt_requested:  # second TERM: the operator means it
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)
        return
    _preempt_requested = True
    log.warning("SIGTERM received — graceful preemption armed: finishing the "
                "in-flight step, saving a checkpoint, exiting rc=%d",
                GRACEFUL_PREEMPT_RC)


def install_sigterm_handler() -> bool:
    """Arm graceful preemption: the first SIGTERM sets the flag the train
    loop polls; a second restores the default disposition and re-sends
    itself, so a stuck shutdown can still be killed with plain TERM.
    Returns False (arming nothing) outside the main thread."""
    global _handler_installed
    if _handler_installed:
        return True
    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, AttributeError, OSError):
        return False
    _handler_installed = True
    return True


@contextlib.contextmanager
def graceful_preemption():
    """``install_sigterm_handler`` for the block; the handler that was
    there before is put back after it, unless it was already ours. The
    preemption flag is left as it is."""
    global _handler_installed
    try:
        previous = signal.getsignal(signal.SIGTERM)
    except (ValueError, AttributeError):
        previous = None
    armed = install_sigterm_handler()
    try:
        yield armed
    finally:
        if armed and previous is not None and previous is not _on_sigterm:
            try:
                signal.signal(signal.SIGTERM, previous)
                _handler_installed = False
            except (ValueError, OSError):
                pass
