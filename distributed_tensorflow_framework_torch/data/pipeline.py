"""Host dataset abstraction + save/restore of iterator position.

The port's copy of ``data/pipeline.py``, cut to what the single-card
training path uses: a :class:`HostDataset` yields dict batches of numpy
arrays of this process's share of the global batch, and its iterator state
is a small dict that ``restore`` rewinds to. Fault injection, data chaos
and the rollback skip record are not ported (ROADMAP.md queue A item A14).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

import numpy as np

Batch = Mapping[str, np.ndarray]


def host_batch_size(global_batch_size: int, process_count: int) -> int:
    """This host's share of the global batch; rejects non-divisible splits
    (a silent floor-divide would shrink the actual global batch)."""
    if global_batch_size % process_count:
        raise ValueError(
            f"global_batch_size {global_batch_size} not divisible by "
            f"process_count {process_count}")
    return global_batch_size // process_count


class HostDataset:
    """A restartable per-host batch stream.

    ``make_iter`` maps a state dict to an iterator of batches and must
    advance that SAME dict in place, so ``state()`` is always current;
    ``element_spec`` maps each key to (per-host batch shape, dtype);
    ``cardinality`` is batches per epoch, None for an infinite stream.
    """

    def __init__(self, make_iter: Callable[[dict[str, Any]], Iterator[Batch]],
                 *, element_spec: Mapping[str, tuple[tuple[int, ...], Any]],
                 initial_state: dict[str, Any] | None = None,
                 cardinality: int | None = None):
        self._make_iter = make_iter
        self.element_spec = dict(element_spec)
        self._state: dict[str, Any] = dict(initial_state or {})
        self._iter: Iterator[Batch] | None = None
        self.cardinality = cardinality

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        if self._iter is None:
            self._iter = self._make_iter(self._state)
        return next(self._iter)

    def state(self) -> dict[str, Any]:
        return dict(self._state)

    def restore(self, state: dict[str, Any]) -> None:
        self._state = dict(state)
        self._iter = None  # rebuilt lazily from the restored state
