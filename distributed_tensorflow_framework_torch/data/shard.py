"""Data sharding across ranks, and the data-state commit records.

The port's copy of ``data/shard.py``. :class:`ShardAssignment` is a rank's
slot in the gang, read from the same discovery environment that forms the
process group (``core/cluster.py``), and :func:`shard_plan` validates its
slice of every global batch (recorded as a ``data_shard`` event); global
batch ``i`` is ``perm[i*B:(i+1)*B]`` and rank ``h`` reads block ``h`` of
it (:func:`block_bounds`). At every save the iterator state goes into the
checkpoint as JSON and a record of it, with its sha256, into the same
manifest as the weight hashes (``data_state_record``), so "where was the
data stream?" shares the integrity contract with "which bytes are the
weights?". At restore, ``check_restore_data`` digest-checks the restored
state against that record and decides whether a change of the process
count may reuse it. Stdlib only.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Mapping

from distributed_tensorflow_framework_torch.core import cluster

log = logging.getLogger(__name__)

# Manifest commit-record field for the saved iterator state.
DATA_RECORD_KEY = "data_state"
DATA_STATE_SCHEMA = "dtf-data-state/1"

# HostDataset.repartition values: "invariant" — restoring the state at any
# host count resumes the same global offset; "none" — the per-host stream
# depends on the host count, so a change of it must be refused.
REPARTITION_INVARIANT = "invariant"
REPARTITION_NONE = "none"


class DataShardError(ValueError):
    """A data-state contract violation: a restored state that fails its
    digest, or a host-count change a state cannot survive. ``hint`` names
    the knob that unblocks it."""

    def __init__(self, message: str, *, hint: str | None = None):
        if hint:
            message = f"{message}\n  hint: {hint}"
        super().__init__(message)
        self.hint = hint


@dataclass(frozen=True)
class ShardAssignment:
    """This rank's slot in the data-reading gang."""

    process_index: int
    process_count: int

    def __post_init__(self):
        if self.process_count < 1:
            raise DataShardError(f"process_count {self.process_count} < 1")
        if not 0 <= self.process_index < self.process_count:
            raise DataShardError(
                f"process_index {self.process_index} outside gang of "
                f"{self.process_count}")

    @classmethod
    def from_env(cls, environ: Mapping[str, str] | None = None
                 ) -> "ShardAssignment":
        """The assignment from the gang's discovery environment; without
        it, shard 0 of 1."""
        env = os.environ if environ is None else environ
        try:
            count = int(env.get(cluster.ENV_NUM_PROCESSES) or 1)
            index = int(env.get(cluster.ENV_PROCESS_ID) or 0)
        except ValueError as e:
            raise DataShardError(
                f"malformed gang discovery env: {e} "
                f"({cluster.ENV_NUM_PROCESSES}="
                f"{env.get(cluster.ENV_NUM_PROCESSES)!r}, "
                f"{cluster.ENV_PROCESS_ID}="
                f"{env.get(cluster.ENV_PROCESS_ID)!r})") from e
        return cls(process_index=index, process_count=count)


def shard_plan(assignment: ShardAssignment, *, global_batch: int,
               data_parallel: int | None = None,
               shard_mode: str = "block") -> dict:
    """Validate and describe this rank's slice of every global batch.
    ``data_parallel`` is the mesh's data-parallel extent, which must be a
    multiple of the process count."""
    p, n = assignment.process_index, assignment.process_count
    if global_batch % n:
        raise DataShardError(
            f"global_batch_size {global_batch} not divisible by "
            f"process_count {n}",
            hint="pick a global batch that is a multiple of the gang size")
    if data_parallel is not None and data_parallel > 0 and data_parallel % n:
        raise DataShardError(
            f"mesh data-parallel extent {data_parallel} not divisible by "
            f"process_count {n} — ranks would feed unequal numbers of "
            f"data-parallel rows",
            hint="size the mesh's data/fsdp axes as a multiple of the gang "
                 "size")
    return {
        "process_index": p,
        "process_count": n,
        "host_batch": global_batch // n,
        "global_batch": int(global_batch),
        "shard_mode": shard_mode,
        "data_parallel": data_parallel,
    }


def block_bounds(batch_index: int, host_batch: int, process_index: int,
                 process_count: int) -> tuple[int, int]:
    """``[lo, hi)`` into the epoch permutation for this host's block of
    global batch ``batch_index``: global batch ``i`` is
    ``perm[i*B : (i+1)*B]`` and host ``h`` takes rows ``[h*b, (h+1)*b)``
    of it, so the consumed prefix after ``k`` batches is ``perm[:k*B]`` at
    any host count."""
    lo = (batch_index * process_count + process_index) * host_batch
    return lo, lo + host_batch


def epoch_batches(n_examples: int, host_batch: int,
                  process_count: int) -> int:
    """Full global batches per epoch (the ragged tail is dropped)."""
    return n_examples // (host_batch * process_count)


def state_digest(state: Mapping[str, Any]) -> str:
    """sha256 over the canonical JSON of an iterator state: the same
    round trip the saved JSON takes, so save and restore agree."""
    canonical = json.dumps(state, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()


def _position(state: Mapping[str, Any]) -> dict:
    return {k: state[k] for k in
            ("epoch", "batch_in_epoch", "step", "batches", "consumed",
             "emitted")
            if k in state and isinstance(state[k], int)}


def data_state_record(state: Mapping[str, Any], *, process_count: int,
                      repartition: str = REPARTITION_NONE,
                      watermark: int = 0) -> dict:
    """The manifest commit record for one saved iterator state.
    ``watermark`` is the prefetch depth at save time (batches pulled ahead
    of the consumer): recorded for post-mortems, never folded into the
    restore position, since the saved state pairs with the last CONSUMED
    batch."""
    return {
        "schema": DATA_STATE_SCHEMA,
        "sha256": state_digest(state),
        "process_count": int(process_count),
        "repartition": repartition,
        "watermark": int(watermark),
        "position": _position(state),
    }


def check_restore_data(record: Mapping[str, Any] | None,
                       state: Mapping[str, Any], *,
                       process_count: int,
                       resume_strict: bool = True) -> dict | None:
    """Restore-time gate for a saved iterator state. Returns a plan
    (``action`` resume | repartition | forced) for a ``data_state`` event,
    or None for a checkpoint without a record; raises DataShardError on a
    digest mismatch or a host-count change the state cannot survive
    (``data.resume_strict=false`` turns both into warnings)."""
    if record is None:
        log.warning("checkpoint has no data-state commit record — restoring "
                    "the iterator state without an integrity check")
        return None
    if record.get("schema") != DATA_STATE_SCHEMA:
        raise DataShardError(
            f"unknown data-state record schema {record.get('schema')!r} "
            f"(this build reads {DATA_STATE_SCHEMA!r})")
    digest = state_digest(state)
    saved_digest = record.get("sha256")
    if digest != saved_digest:
        msg = (f"restored iterator state does not match its manifest commit "
               f"record: sha256 {digest[:12]}… vs recorded "
               f"{str(saved_digest)[:12]}…")
        if resume_strict:
            raise DataShardError(
                msg, hint="the data_iter payload was mutated after commit; "
                          "restore an older step, or set "
                          "data.resume_strict=false to proceed anyway")
        log.warning("%s — proceeding (data.resume_strict=false)", msg)
        return {"action": "forced", "reason": "digest_mismatch",
                "from_processes": record.get("process_count"),
                "to_processes": process_count}
    saved_count = int(record.get("process_count") or process_count)
    if saved_count == process_count:
        return {"action": "resume", "from_processes": saved_count,
                "to_processes": process_count,
                "watermark": record.get("watermark", 0)}
    if record.get("repartition") == REPARTITION_INVARIANT:
        log.info("repartitioning data state across host-count change "
                 "%d -> %d (host-count-invariant position %s)",
                 saved_count, process_count, record.get("position"))
        return {"action": "repartition", "from_processes": saved_count,
                "to_processes": process_count,
                "watermark": record.get("watermark", 0)}
    msg = (f"data state saved by {saved_count} process(es) cannot be "
           f"repartitioned onto {process_count}: this reader resumes by "
           f"per-host skip-count or file shard, which does not survive a "
           f"host-count change (position {record.get('position')})")
    if resume_strict:
        raise DataShardError(
            msg, hint="use a block-shardable reader, or set "
                      "data.resume_strict=false to resume the stream from "
                      "this state anyway (samples may replay or drop)")
    log.warning("%s — proceeding (data.resume_strict=false)", msg)
    return {"action": "forced", "reason": "host_count_change",
            "from_processes": saved_count, "to_processes": process_count}
