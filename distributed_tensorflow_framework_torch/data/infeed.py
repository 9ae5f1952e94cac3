"""Host → device infeed: one host batch of numpy arrays to tensors.

The single-card counterpart of ``data/infeed.py``'s ``to_global``: on a
CUDA device each array goes through pinned memory with a non-blocking copy,
so the transfer is queued behind the work already on the stream instead of
stalling the host. The background prefetcher, the stall watchdog and the
multi-host assembly are not ported (ROADMAP.md queue A items A1 and A14).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def to_device(batch: Mapping[str, np.ndarray],
              device: torch.device) -> dict[str, torch.Tensor]:
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            # The caching host allocator keeps the pinned buffer alive
            # until the copy on the stream has finished.
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out
