"""PRNG discipline: every random stream derives from the experiment seed.

The port's copy of ``core/prng.py``. Host side it is identical: data
pipelines draw from ``host_rng(seed, role, *context)``, a numpy generator
seeded with the whole derivation tuple, so the port's synthetic streams
are bit-identical to the JAX package's. Device side, where the JAX package
folds jax keys, the port seeds a ``torch.Generator`` per (seed, role):
parameter init and dropout. Those give other bits than JAX's keys; the
parity tests therefore carry parameters across and run without dropout.
"""

from __future__ import annotations

import numpy as np
import torch

ROLE_INIT = 0     # parameter init (device)
ROLE_DROPOUT = 1  # dropout / stochastic layers (device)
ROLE_DATA = 2     # data stream content + order (host)
ROLE_MASK = 3     # MLM dynamic masking (host)
ROLE_AUGMENT = 4  # per-example augmentation (host)


def host_rng(seed: int, role: int, *context: int) -> np.random.Generator:
    """Host-side generator for data pipelines."""
    return np.random.default_rng((seed, role, *context))


def torch_generator(seed: int, role: int, device: str | torch.device,
                    *context: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one role's stream, seeded
    from (seed, role, *context) through numpy's SeedSequence so roles (and
    the ranks of a gang, passed as context) never share a stream."""
    derived = np.random.SeedSequence((seed, role, *context)).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(
        int(derived) & 0x7FFF_FFFF_FFFF_FFFF)
