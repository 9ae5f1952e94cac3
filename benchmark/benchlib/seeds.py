"""Seeds derived from the run's ``--seed``: one stream per purpose, and
per rank and batch where that applies, so that no two share bits."""

from __future__ import annotations

import numpy as np

WEIGHTS = 1
DROPOUT = 2
DATA = 3


def derive(seed: int, *tags: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` (or numpy), from
    ``(seed, *tags)`` through numpy's SeedSequence; any non-negative
    ``seed``, however large."""
    state = np.random.SeedSequence((int(seed), *map(int, tags)))
    return int(state.generate_state(1, np.uint64)[0]) & 0x7FFF_FFFF_FFFF_FFFF
