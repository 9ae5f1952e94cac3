"""Host dataset abstraction + save/restore of iterator position.

The port's copy of ``data/pipeline.py``, cut to what the single-card
training path uses: a :class:`HostDataset` yields dict batches of numpy
arrays of this process's share of the global batch, and its iterator state
is a small dict that ``restore`` rewinds to. :func:`finite_array_eval` is
the exact single-pass eval stream over in-memory image arrays.

bf16 images: numpy has no bfloat16 and the port does not use
``ml_dtypes``, so a bf16 image array is a uint16 array of the bf16 bits
whose dtype carries the metadata tag :data:`BFLOAT16` (the bits
``ml_dtypes.bfloat16`` would hold: round to nearest even, by torch).
``data/infeed.py:to_device`` views it as ``torch.bfloat16``; the host →
device copy moves half the bytes of f32, as in the JAX package. The state carries
``consumed``, the 1-based ordinal of the last batch handed out, and
``batches_skipped``, the ordinals a rollback decided not to train on
(train/anomaly.py), which a restored stream discards again.

Each pull is the ``infeed`` fault point and the ``data_chaos`` point of
core/faults.py, the latter for this rank alone (its ``JAX_PROCESS_ID``):
``corrupt_shard`` poisons every floating field of the pull to NaN, as the
JAX pipeline does; a batch with none (an MLM batch: token ids, targets
and the mask are integers) instead carries :data:`FAULT_SCALE_KEY`, a
NaN that the trainer multiplies into the step's loss (train/step.py
``fault_scale``), the route ``nan_grads`` takes, so the drill reaches
BERT where the JAX package's leaves the batch as it was. ``skew_shard``
sleeps, making this rank's reader the gang's straggler.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch

from distributed_tensorflow_framework_torch.core import faults

log = logging.getLogger(__name__)

Batch = Mapping[str, np.ndarray]

# A batch key the trainer pops and multiplies into the step's loss: how
# corrupt_shard poisons a batch without floating fields.
FAULT_SCALE_KEY = "fault_scale"

# uint16 bf16 bits, tagged so that to_device views them as torch.bfloat16.
BFLOAT16 = np.dtype(np.uint16, metadata={"torch_dtype": "bfloat16"})


def is_bfloat16(dtype: np.dtype) -> bool:
    return (dtype.metadata or {}).get("torch_dtype") == "bfloat16"


def image_np_dtype(image_dtype: str) -> np.dtype:
    """Host dtype for ``DataConfig.image_dtype`` ('float32' | 'bfloat16');
    the augmentation math stays f32 either way."""
    if image_dtype == "bfloat16":
        return BFLOAT16
    if image_dtype in ("float32", "f32"):
        return np.dtype(np.float32)
    raise ValueError(f"Unsupported image_dtype {image_dtype!r}")


def cast_images(images: np.ndarray, out_dtype: np.dtype) -> np.ndarray:
    """f32 images → ``out_dtype`` (``astype(copy=False)`` for f32; the
    tagged bf16 bits, rounded to nearest even, for :data:`BFLOAT16`)."""
    if not is_bfloat16(out_dtype):
        return images.astype(out_dtype, copy=False)
    bits = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy()
    return bits.view(BFLOAT16)


def finite_array_eval(images: np.ndarray, labels: np.ndarray, *, batch: int,
                      process_index: int, process_count: int,
                      out_dtype: np.dtype) -> "HostDataset":
    """Single-pass padded eval stream over in-memory arrays (``images``
    already in ``out_dtype``): every example once, this host's strided
    share, the final partial batch zero-padded to the static batch size
    with a per-example ``weight`` (1 real, 0 pad), so the eval step's
    weighted sums count the real examples only. Every host yields the
    same number of batches."""
    n = len(images)
    shard_idx = np.arange(n)[process_index::process_count]
    max_shard = -(-n // process_count)  # the largest host shard
    num_batches = -(-max_shard // batch)

    def make_iter(state):
        state.setdefault("batch", 0)
        for i in range(state["batch"], num_batches):
            idx = shard_idx[i * batch:(i + 1) * batch]
            k = len(idx)
            img = np.zeros((batch,) + images.shape[1:], dtype=out_dtype)
            lab = np.zeros((batch,), np.int32)
            w = np.zeros((batch,), np.float32)
            if k:
                img[:k] = images[idx]
                lab[:k] = labels[idx]
                w[:k] = 1.0
            state["batch"] = i + 1
            yield {"image": img, "label": lab, "weight": w}

    return HostDataset(
        make_iter,
        element_spec={
            "image": ((batch,) + tuple(images.shape[1:]), out_dtype),
            "label": ((batch,), np.int32),
            "weight": ((batch,), np.float32),
        },
        initial_state={"batch": 0},
        cardinality=num_batches,
    )


def host_batch_size(global_batch_size: int, process_count: int) -> int:
    """This host's share of the global batch; rejects non-divisible splits
    (a silent floor-divide would shrink the actual global batch)."""
    if global_batch_size % process_count:
        raise ValueError(
            f"global_batch_size {global_batch_size} not divisible by "
            f"process_count {process_count}")
    return global_batch_size // process_count


class HostDataset:
    """A restartable, checkpointable per-host batch stream.

    ``make_iter`` maps a state dict to an iterator of batches and must
    advance that SAME dict in place, so ``state()`` is always current.
    Nested state values are REBOUND, never mutated in place: ``state()``
    hands out shallow copies, so an in-place mutation would edit every
    snapshot already queued for a save. ``element_spec`` maps each key to
    (per-host batch shape, dtype); ``cardinality`` is batches per epoch,
    None for an infinite stream; ``repartition`` is the data/shard.py tag
    saying whether the state survives a change of host count.
    """

    def __init__(self, make_iter: Callable[[dict[str, Any]], Iterator[Batch]],
                 *, element_spec: Mapping[str, tuple[tuple[int, ...], Any]],
                 initial_state: dict[str, Any] | None = None,
                 cardinality: int | None = None,
                 repartition: str = "none"):
        self._make_iter = make_iter
        self.element_spec = dict(element_spec)
        self._state: dict[str, Any] = dict(initial_state or {})
        self._iter: Iterator[Batch] | None = None
        self.cardinality = cardinality
        self.repartition = repartition
        # Process-lifetime pull ordinal (1-based, not reset by restore):
        # what stall_infeed:S:P and corrupt_shard:K:P count.
        self._pulls = 0
        # This rank's index for the data_chaos point, read from the gang
        # environment at the first pull.
        self._chaos_worker: int | None = None

    def __iter__(self):
        return self

    def _chaos_worker_index(self) -> int:
        if self._chaos_worker is None:
            from distributed_tensorflow_framework_torch.data import shard

            self._chaos_worker = shard.ShardAssignment.from_env(
            ).process_index
        return self._chaos_worker

    def _apply_chaos(self, fault, batch: dict) -> None:
        """One matched data_chaos fault against a pulled batch (the module
        docstring)."""
        if fault.kind == "corrupt_shard":
            poisoned = []
            for k, v in batch.items():
                if np.issubdtype(np.asarray(v).dtype, np.floating):
                    batch[k] = np.full_like(v, np.nan)
                    poisoned.append(k)
            if not poisoned:
                batch[FAULT_SCALE_KEY] = np.array(np.nan, np.float32)
            log.warning("data_chaos: corrupt_shard poisoned %s of pull %d",
                        f"fields {poisoned}" if poisoned
                        else "the step's loss (no floating fields)",
                        self._pulls)
        elif fault.kind == "skew_shard":
            log.warning("data_chaos: skew_shard sleeping %.1fs at pull %d",
                        fault.seconds, self._pulls)
            time.sleep(fault.seconds)

    def _pull(self) -> Batch:
        self._pulls += 1
        faults.fire("infeed", step=self._pulls)
        if self._iter is None:
            self._iter = self._make_iter(self._state)
        batch = next(self._iter)
        self._state["consumed"] = int(self._state.get("consumed", 0)) + 1
        chaos = faults.fire("data_chaos", step=self._pulls,
                            worker=self._chaos_worker_index())
        if chaos:
            batch = dict(batch)
            for fault in chaos:
                self._apply_chaos(fault, batch)
        return batch

    def __next__(self) -> Batch:
        batch = self._pull()
        skipped = self._state.get("batches_skipped")
        if skipped:
            # A restore from before a rollback's skip region replays the
            # stream: discard the ordinals the rollback never trained on.
            skip = {int(o) for o in skipped}
            while int(self._state["consumed"]) in skip:
                log.info("discarding batch ordinal %d (recorded as skipped "
                         "by a rollback)", self._state["consumed"])
                batch = self._pull()
        return batch

    def state(self) -> dict[str, Any]:
        snap = dict(self._state)
        skipped = snap.get("batches_skipped")
        if skipped:
            # A restore of this snapshot resumes after `consumed`: skip
            # ordinals at or below it are dead weight.
            consumed = int(snap.get("consumed", 0))
            live = [int(o) for o in skipped if int(o) > consumed]
            if live:
                snap["batches_skipped"] = live
            else:
                snap.pop("batches_skipped", None)
        return snap

    def restore(self, state: dict[str, Any]) -> None:
        self._state = dict(state)
        self._iter = None  # rebuilt lazily from the restored state

    def record_skipped(self, ordinals) -> None:
        """Record consumed-batch ordinals a rollback skipped. REBINDS
        ``batches_skipped`` to the sorted union (never appends in place),
        so snapshots taken before the call keep their contents. A single
        rebind is atomic under the interpreter lock, and the prefetch
        thread's ``make_iter`` never touches this key."""
        merged = sorted({int(o) for o in self._state.get("batches_skipped",
                                                         ())}
                        | {int(o) for o in ordinals})
        if merged:
            self._state["batches_skipped"] = merged
