"""Checkpointing of the full training state: the port's counterpart of
``ckpt/checkpoint.py``'s ``CheckpointManager``.

A checkpoint is a step directory, committed by its integrity manifest
(ckpt/manifest.py) exactly as in the JAX package:

    <directory>/<step>/
      state.pt        — torch.save of the model's tensors (BatchNorm
                        running statistics included), the optimizer
                        (its inner torch optimizer's state_dict), the
                        dropout generator's state, the parameter EMA
                        when there is one and every rank's row of the
                        collective error-feedback residual when there is
                        one; read back with
                        ``torch.load(weights_only=True)``
      meta.json       — the step, the generator's device type, the
                        model's parameter names and, under ZeRO, the
                        row count of the stacked slots (``zero_rows``)
                        and whether they are grouped per bucket
                        (``zero_fused``)
      data_iter.json  — the data iterator's state (when given)
      manifest.json   — sha256 and size of each file above, plus the
                        data-state commit record (data/shard.py) and the
                        mesh record (ckpt/reshard.py ``state_topology``);
                        written last, by tmp + fsync + atomic rename

The JAX package writes orbax checkpoints, which need JAX; this format
needs only torch, and the port does not read orbax checkpoints (the
converter is ROADMAP.md queue A item A15).

  * ``save``: with ``checkpoint.async_save`` the training thread pays only
    the device → host copy of the state at the step boundary; the write,
    the hashing, the fsyncs and the commit run on the saver thread
    (ckpt/async_saver.py). Without it, the same commit runs inline. A new
    save waits for the previous commit. After each commit the oldest
    committed steps beyond ``max_to_keep`` are deleted.
  * ``latest_step``/``all_steps`` list committed steps only. A directory
    with step directories and no manifest anywhere is a store from before
    manifests: its steps are trusted unverified, with a warning.
  * ``restore`` with no step takes the newest step that verifies,
    quarantining (``<step>.corrupt``) every newer one that does not, with
    ``ckpt_quarantined`` and ``restore_fallback`` events; an explicit step
    that fails verification raises. A fused-QKV checkpoint restored into
    an unfused model (or the reverse) raises naming ``model.fused_qkv``.

Across ranks (a ``runtime`` of core/mesh.py with more than one): the
state is replicated, so the chief alone writes the step directory and its
manifest commit record; the other ranks write nothing and wait for the
commit at the trainer's exit barrier (core/cluster.py). Each rank's
dropout generator is its own, so at each save the chief collects them
(one ``broadcast`` per rank) into ``dropout_generators`` beside its own.
At restore the chief picks the newest verified step (quarantining as
above) and broadcasts it, and every rank loads that step; a rank takes
its own generator back when the gang has the size that saved it, and
keeps its freshly seeded stream (with a warning) when it has not. The
data-state record carries the process count, and ``check_restore_data``
gates a change of it.

The int8 error-feedback residual (train/state.py) is one f32 row per
rank: at each save the chief collects every rank's (one ``broadcast`` per
rank of the rows laid end to end) and stores them as ``(n, *shape)``
tensors. A restore follows the JAX package's rules: the same rank count
restores each rank's own row; another count folds the rows, keeping each
leaf's sum (ckpt/reshard.py); a checkpoint without one gives zeros, with
a warning; a run that does not use one drops the stored one, with a
warning. Export reads the model's tensors alone, so it never sees it.

A sharded state (train/state.py ``layout``) is written in the whole,
global layout the JAX package's orbax checkpoints hold, so that a
checkpoint does not depend on how the run that wrote it was sharded:
FSDP's parameters, slots and EMA and ZeRO-1's slots are gathered whole
(exact f32), and so are the tensor-parallel parts of the parameters, the
slots and the EMA, as orbax writes global arrays; ZeRO's slots are
stacked as ``(n, chunk)`` rows, row i data-parallel rank i's (every rank
takes part in the gathers; the chief writes). A restore cuts each rank's
part back out: its tensor-parallel part, its slice of that, or its row of
the stacked slots — refolded first (ckpt/reshard.py
``refold_zero_opt_state``) when another rank count saved them. So a
checkpoint resumes at any ``mesh.model``, in one process too. The
expert parts (train/state.py ``ep``) are gathered into whole (E, ...)
tensors the same way, their slots and EMA with them, and a restore cuts
each rank's experts back out, so a checkpoint resumes at any
``mesh.expert``. A
pipelined state (train/state.py ``pipe``) is written whole as well: every
stage's layers, slots and EMA gathered over ``pipe`` into a whole
BERT's layout, in the natural layer order whatever the schedule, so one
process, another schedule or another stage count reads it; a restore
keeps the rank's stage. FSDP,
ZeRO-1, tensor-parallel and replicated checkpoints restore into one
another, behind the mesh gate below; switching ZeRO
``shard_map`` on or off across a resume is refused with the JAX package's
ValueError, since the stacked and the whole slot layouts are different
optimizers' states, and so is switching ``precision.fused_update``,
whose slots are grouped per ZeRO bucket (``{"buckets": [...]}``,
meta.json ``zero_fused``), even though the bytes are the same. The other
precision levers leave the checkpoint alone: the parameters are f32
masters under any ``activation_dtype`` or ``matmul_dtype``, and restore
without a ``precision`` block.

The mesh gate (ckpt/reshard.py), as in the JAX package: after the
integrity checks and before any tensor is cut, a restore under another
mesh (``mesh.*`` sizes) than the record's raises
:class:`~ckpt.reshard.MeshTopologyError` unless ``checkpoint.allow_reshard``
is set; with it the cut and the refolds above run, the tensors about to
be loaded are validated against the run's (``validate_restored``) and a
``ckpt_resharded`` event is emitted. The chief decides and broadcasts its
verdict, so every rank takes the same branch. A manifest without a record
(written before the gate) restores with a warning. ``restore_model``
(export) gates on the serving mesh it is given the same way.

Per-save telemetry (``ckpt_save``): ``ckpt_save_blocked_ms`` is the time
the training thread spent in ``save`` (the wait for the previous commit
and the host copy); ``ckpt_save_total_ms`` is from ``save`` to the landed
commit. Async saves show blocked < total; sync saves blocked == total.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any

import torch

from distributed_tensorflow_framework_torch.ckpt import manifest as mf
from distributed_tensorflow_framework_torch.ckpt import reshard
from distributed_tensorflow_framework_torch.ckpt.async_saver import AsyncSaver
from distributed_tensorflow_framework_torch.ckpt.reshard import (
    fold_residual,
    refold_zero_opt_state,
)
from distributed_tensorflow_framework_torch.core import faults, telemetry
from distributed_tensorflow_framework_torch.core.config import CheckpointConfig
from distributed_tensorflow_framework_torch.data import shard as data_shard
from distributed_tensorflow_framework_torch.parallel.zero import ZeroUpdate
from distributed_tensorflow_framework_torch.train.optimizers import (
    BucketOptimizers,
)
from distributed_tensorflow_framework_torch.train.state import (
    TrainState,
    host_copy,
)

log = logging.getLogger(__name__)

CKPT_SCHEMA = "dtf-torch-ckpt/1"
STATE_FILE = "state.pt"
META_FILE = "meta.json"
DATA_FILE = "data_iter.json"


def _attention_layout(names) -> str | None:
    """'fused' / 'unfused' QKV projection layout of a set of parameter
    names, or None when the model has no attention projections. The fused
    module holds ``attn.qkv``, the unfused ``attn.{query,key,value}``
    (models/bert.py); the whole triple is required so a stray ``key`` part
    cannot misclassify."""
    parts = {part for name in names for part in name.split(".")}
    if "qkv" in parts:
        return "fused"
    if {"query", "key", "value"} <= parts:
        return "unfused"
    return None


def _write_durable(path: str, write) -> None:
    with open(path, "wb") as fh:
        write(fh)
        fh.flush()
        os.fsync(fh.fileno())


def _write_json(path: str, obj: Any) -> None:
    _write_durable(path, lambda fh: fh.write(
        json.dumps(obj, indent=1, sort_keys=True).encode()))


class CheckpointManager:
    def __init__(self, config: CheckpointConfig, *,
                 telemetry_writer: telemetry.TelemetryWriter | None = None,
                 runtime=None):
        if not config.directory:
            raise ValueError("CheckpointConfig.directory must be set")
        self.config = config
        self._telemetry = telemetry_writer
        self._runtime = runtime
        self.is_chief = runtime is None or runtime.is_chief
        self.process_count = 1 if runtime is None else runtime.process_count
        # The data state is the data-parallel ranks' (the ranks along
        # mesh.model read the same batches).
        self.data_count = 1 if runtime is None else runtime.data_group.size
        self._path = os.path.abspath(config.directory)
        os.makedirs(self._path, exist_ok=True)
        self._saver = AsyncSaver() if config.async_save else None
        self._watermark_source = None
        self._data_repartition = data_shard.REPARTITION_NONE
        self._data_resume_strict = True

    @property
    def directory(self) -> str:
        return self._path

    def set_data_sources(self, *, watermark_source=None,
                         repartition: str | None = None,
                         resume_strict: bool | None = None) -> None:
        """``watermark_source`` is the live infeed's ``watermark()``,
        recorded at each save (None clears it: a closed infeed must not be
        polled by a final save); ``repartition`` the dataset's tag;
        ``resume_strict`` the ``data.resume_strict`` knob of the restore
        gate."""
        self._watermark_source = watermark_source
        if repartition is not None:
            self._data_repartition = repartition
        if resume_strict is not None:
            self._data_resume_strict = bool(resume_strict)

    def _emit(self, kind: str, **fields: Any) -> None:
        if self._telemetry is not None:
            self._telemetry.emit(kind, **fields)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._path, str(step))

    # ------------------------------------------------------------- save --
    def _drain(self) -> None:
        """Barrier on the in-flight commit: every step listing and every
        new save funnels through here, and a background failure surfaces
        on the training thread."""
        if self._saver is not None:
            self._saver.wait()

    def _write_and_commit(self, step: int, host_state: dict,
                          dataset_state: dict | None, *, t_begin: float,
                          blocked_s: float | None, watermark: int,
                          topology: dict | None = None) -> None:
        """The whole durable commit: payload files, the ``ckpt_in_save``
        fault point, the manifest, the ``ckpt_committed`` fault point,
        garbage collection and telemetry. The same code on the saver
        thread or inline."""
        step_dir = self._step_dir(step)
        os.makedirs(step_dir)
        tensors = {k: host_state[k] for k in
                   ("model", "optimizer", "dropout_generator",
                    "dropout_generators", "ema", "collective_residual")
                   if k in host_state}
        _write_durable(os.path.join(step_dir, STATE_FILE),
                       lambda fh: torch.save(tensors, fh))
        _write_json(os.path.join(step_dir, META_FILE), {
            "schema": CKPT_SCHEMA, "step": int(host_state["step"]),
            "generator_device": host_state["generator_device"],
            "process_count": self.process_count,
            "params": list(host_state["model"]),
            **({"zero_rows": host_state["zero_rows"],
                "zero_fused": host_state["zero_fused"]}
               if "zero_rows" in host_state else {})})
        extra = {}
        if topology is not None:
            extra[reshard.MESH_RECORD_KEY] = topology
        if dataset_state is not None:
            _write_json(os.path.join(step_dir, DATA_FILE), dataset_state)
            extra[data_shard.DATA_RECORD_KEY] = data_shard.data_state_record(
                dataset_state, process_count=self.data_count,
                repartition=self._data_repartition, watermark=watermark)
        # A crash_in_save fault here leaves a written directory with no
        # manifest: the uncommitted step restore must refuse.
        faults.fire("ckpt_in_save", step=step)
        mf.write_manifest(step_dir, step, extra=extra or None)
        for fault in faults.fire("ckpt_committed", step=step):
            if fault.kind == "corrupt_ckpt":
                faults.corrupt_checkpoint_dir(step_dir)
        self._collect_garbage()
        total_ms = (time.perf_counter() - t_begin) * 1e3
        blocked_ms = total_ms if blocked_s is None else blocked_s * 1e3
        self._emit(telemetry.KIND_CKPT_SAVE, step=step,
                   metrics={"ckpt_save_blocked_ms": round(blocked_ms, 3),
                            "ckpt_save_total_ms": round(total_ms, 3)},
                   async_save=self._saver is not None)
        log.info("Saved checkpoint at step %d (%s, blocked %.0f ms / total "
                 "%.0f ms)", step,
                 "async" if self._saver is not None else "sync",
                 blocked_ms, total_ms)

    def _collect_garbage(self) -> None:
        keep = self.config.max_to_keep
        if keep <= 0:
            return
        for step in mf.committed_steps(self._path)[:-keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def save(self, step: int, state: TrainState, *,
             dataset_state: dict | None = None) -> bool:
        """Save ``state`` as step ``step``; False when that step is already
        committed. ``dataset_state`` must be the iterator snapshot paired
        with ``step`` (data/infeed.py), not the live dataset's state,
        which the prefetcher has moved past it. Async mode returns once
        the host copy is queued; a commit failure is re-raised at the next
        save or barrier. Every rank calls it at the same steps; only the
        chief writes (the others return False)."""
        t0 = time.perf_counter()
        generators = self._gather_generators(state)
        residual = self._gather_residual(state)
        live = state.state_dict()
        if state.layout is not None:
            live = state.layout.global_state(live, state.optimizer.names)
        # The inverse of the cuts' order (tensor, expert, FSDP).
        if state.ep is not None:
            live = state.ep.global_state(live, state.optimizer.names)
        if state.tp is not None:
            live = state.tp.global_state(live, state.optimizer.names)
        if state.pipe is not None:
            live = state.pipe.global_state(live, state.optimizer.names)
        if not self.is_chief:
            return False
        self._drain()  # a new save waits for the previous commit
        if step in mf.committed_steps(self._path):
            return False
        if os.path.isdir(self._step_dir(step)):
            mf.quarantine(self._path, step, "uncommitted save",
                          ["no committed manifest (save did not complete)"])
        watermark = 0
        if self._watermark_source is not None and dataset_state is not None:
            try:
                watermark = int(self._watermark_source())
            except Exception:
                log.warning("infeed watermark probe failed", exc_info=True)
        # A real copy taken at the step boundary: the loop updates the
        # live tensors in place from the next step on.
        live.pop("collective_residual", None)  # every rank's rows below
        host_state = host_copy(live)
        if isinstance(state.layout, ZeroUpdate):
            host_state["zero_rows"] = state.layout.n
            host_state["zero_fused"] = isinstance(state.optimizer,
                                                  BucketOptimizers)
        if generators is not None:
            host_state["dropout_generators"] = generators
        if residual is not None:
            host_state["collective_residual"] = residual
        ds_state = (None if dataset_state is None
                    else json.loads(json.dumps(dataset_state)))
        topology = reshard.state_topology(state, self._runtime)
        if self._saver is None:
            self._write_and_commit(step, host_state, ds_state, t_begin=t0,
                                   blocked_s=None, watermark=watermark,
                                   topology=topology)
            return True
        blocked_s = time.perf_counter() - t0
        self._saver.submit(
            lambda: self._write_and_commit(
                step, host_state, ds_state, t_begin=t0,
                blocked_s=blocked_s, watermark=watermark,
                topology=topology),
            step=step)
        return True

    def _gather_generators(self, state: TrainState) -> list | None:
        """Every rank's dropout generator state, on the chief (None on the
        others and in a single process): rank r broadcasts its own. The
        states have one size on every rank (one device type)."""
        rt = self._runtime
        if self.process_count == 1:
            return None
        mine = state.dropout_generator.get_state()
        out = []
        for rank in range(self.process_count):
            buf = (mine if rank == rt.process_index
                   else torch.empty_like(mine)).to(rt.collective_device)
            out.append(rt.broadcast_(buf, src=rank).cpu())
        return out if self.is_chief else None

    def _gather_residual(self, state: TrainState
                         ) -> dict[str, torch.Tensor] | None:
        """Every rank's residual row as ``(n, *shape)`` host tensors, on
        the chief (None on the others, and when the run keeps none): rank
        r broadcasts its rows laid end to end."""
        own = state.collective_residual
        if not own:
            return None
        rt = self._runtime
        flat = torch.cat([t.reshape(-1) for t in own.values()])
        rows = []
        for rank in range(self.process_count):
            buf = flat if rank == self._rank else torch.empty_like(flat)
            if self.process_count > 1:
                buf = rt.broadcast_(buf.to(rt.collective_device), src=rank)
            rows.append(buf.to("cpu", copy=True))
        if not self.is_chief:
            return None
        stacked = torch.stack(rows)
        out, off = {}, 0
        for key, t in own.items():
            out[key] = stacked[:, off:off + t.numel()].reshape(
                (self.process_count,) + tuple(t.shape)).clone()
            off += t.numel()
        return out

    @property
    def _rank(self) -> int:
        return 0 if self._runtime is None else self._runtime.process_index

    # -------------------------------------------------------- listings --
    def all_steps(self) -> list[int]:
        """Committed steps, ascending. In a store with step directories
        and no manifest anywhere, every step directory, with a warning."""
        self._drain()
        committed = mf.committed_steps(self._path)
        if not committed:
            legacy = sorted(mf.step_dirs(self._path))
            if legacy:
                log.warning("checkpoint directory %s has no integrity "
                            "manifests — steps %s are trusted unverified",
                            self._path, legacy)
            return legacy
        return committed

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---------------------------------------------------------- restore --
    def _verify(self, step: int) -> list[str]:
        """Integrity errors for one step ([] = safe to restore)."""
        step_dir = self._step_dir(step)
        manifest = mf.read_manifest(step_dir)
        if manifest is None:
            if not mf.committed_steps(self._path):
                log.warning("restoring step %d without integrity "
                            "verification (no manifests in %s)", step,
                            self._path)
                return []
            return ["no committed manifest (save did not complete)"]
        if not self.config.verify_restore:
            return []  # the commit record is still required
        return mf.verify_step_dir(step_dir, manifest)

    def _verified_latest(self) -> int | None:
        """Newest step that verifies, quarantining every newer one that
        does not; None when no restorable step remains."""
        self._drain()
        candidates = sorted(mf.step_dirs(self._path), reverse=True)
        if not candidates:
            return None
        if not mf.committed_steps(self._path):
            return candidates[0]  # a store from before manifests
        chosen = None
        for step in candidates:
            errors = self._verify(step)
            if not errors:
                chosen = step
                break
            log.error("checkpoint step %d in %s is corrupt/torn: %s", step,
                      self._path, "; ".join(errors[:3]))
            reason = ("uncommitted save" if "no committed manifest"
                      in errors[0] else "integrity verification failed")
            mf.quarantine(self._path, step, reason, errors)
            self._emit(telemetry.KIND_CKPT_QUARANTINED, step=step,
                       health={"reason": reason,
                               "errors": "; ".join(errors[:3]),
                               "directory": self._path})
        if chosen is not None and chosen != candidates[0]:
            log.warning("restore falling back from corrupt step %d to "
                        "verified step %d", candidates[0], chosen)
            self._emit(telemetry.KIND_RESTORE_FALLBACK, step=chosen,
                       health={"from_step": candidates[0], "to_step": chosen,
                               "directory": self._path})
        return chosen

    def _check_attention_layout(self, step: int, meta: dict,
                                names) -> None:
        """Fail fast, naming the fix, when the stored parameters use the
        other ``model.fused_qkv`` layout than the model being restored."""
        stored = _attention_layout(meta.get("params", ()))
        want = _attention_layout(names)
        if stored is None or want is None or stored == want:
            return
        raise ValueError(
            f"Checkpoint at step {step} in {self._path} stores {stored} "
            f"attention projections but the model is configured for {want} "
            f"(model.fused_qkv={'true' if want == 'fused' else 'false'}). "
            f"Set model.fused_qkv to match the checkpoint, or transplant the "
            f"params — the fused qkv weight is torch.cat([query, key, "
            f"value]) of the unfused weights (models/convert.py maps both "
            f"layouts).")

    def _load(self, step: int | None, model) -> tuple[int, dict, dict] | None:
        """(step, meta, tensors) of ``step`` — which must verify — or of
        the newest step that verifies; None when there is none. The
        tensors are read to the host: ``load_state_dict`` copies the
        model's (and the EMA's) to the device, and torch Adam/AdamW keep
        their per-parameter step on the host, as a fresh one does."""
        if step is not None:
            errors = self._verify(step)
            if errors:
                raise ValueError(
                    f"checkpoint step {step} in {self._path} failed "
                    f"integrity verification: {'; '.join(errors)}")
        else:
            step = self._verified_latest()
        if step is None:
            return None
        step_dir = self._step_dir(step)
        with open(os.path.join(step_dir, META_FILE)) as fh:
            meta = json.load(fh)
        self._check_attention_layout(step, meta, model.state_dict())
        tensors = torch.load(os.path.join(step_dir, STATE_FILE),
                             map_location="cpu", weights_only=True)
        return step, meta, tensors

    def restore(self, state: TrainState, *, dataset=None,
                step: int | None = None) -> int | None:
        """Load a checkpoint into ``state`` (and the iterator state into
        ``dataset``) in place; returns the restored step, or None when
        there is none. With ``step`` given, that step or an error. Every
        rank calls it; the chief chooses the step."""
        if self.process_count > 1:
            chosen = None
            if self.is_chief:
                chosen = step if step is not None else self._verified_latest()
            step = self._runtime.broadcast_int(chosen)
            if step is None:
                return None
        loaded = self._load(step, state.model)
        if loaded is None:
            return None
        step, meta, tensors = loaded
        reshard_plan = self._topology_gate(step, state)
        data_state = None
        data_path = os.path.join(self._step_dir(step), DATA_FILE)
        if dataset is not None and os.path.isfile(data_path):
            with open(data_path) as fh:
                data_state = json.load(fh)
            # The gate runs before anything is loaded: a failed gate
            # leaves the state and the dataset untouched.
            manifest = mf.read_manifest(self._step_dir(step)) or {}
            plan = data_shard.check_restore_data(
                manifest.get(data_shard.DATA_RECORD_KEY), data_state,
                process_count=self.data_count,
                resume_strict=self._data_resume_strict)
            if plan is not None:
                self._emit(telemetry.KIND_DATA_STATE, step=step, plan=plan)
        tensors = self._own_residual(state, step, tensors)
        tensors = self._own_parts(state, step, meta, tensors)
        if reshard_plan is not None:
            self._record_reshard(reshard_plan, state, tensors, step)
        state.load_state_dict({
            **tensors, "step": meta["step"],
            "generator_device": meta["generator_device"],
            "dropout_generator": self._own_generator(state, meta, tensors)})
        if data_state is not None:
            dataset.restore(data_state)
        return step

    def _topology_gate(self, step: int, state: TrainState) -> dict | None:
        """The mesh gate of ``step`` (ckpt/reshard.py
        ``check_restore_topology``): None to restore as before, a reshard
        plan, or MeshTopologyError. The chief decides and broadcasts its
        verdict (0 same mesh, 1 reshard, 2 refused), so every rank takes
        the same branch; nothing has been loaded yet."""
        saved = (mf.read_manifest(self._step_dir(step)) or {}).get(
            reshard.MESH_RECORD_KEY)
        plan, refused = None, None
        if self.is_chief:
            try:
                plan = reshard.check_restore_topology(
                    saved, state, self._runtime,
                    allow_reshard=self.config.allow_reshard,
                    directory=self._path, step=step)
            except reshard.MeshTopologyError as e:
                refused = e
        if self.process_count > 1:
            verdict = self._runtime.broadcast_int(
                2 if refused else 1 if plan is not None else 0)
            if not self.is_chief and verdict == 1:
                plan = reshard.plan_reshard(saved, state, self._runtime,
                                            step=step)
            elif not self.is_chief and verdict == 2:
                refused = reshard.MeshTopologyError(
                    saved["axes"],
                    reshard.state_topology(state, self._runtime)["axes"],
                    directory=self._path, step=step)
        if refused is not None:
            raise refused
        return plan

    def _record_reshard(self, plan: dict, state: TrainState, tensors: dict,
                        step: int) -> None:
        """After a cross-mesh cut: validate the model tensors about to be
        loaded against the run's, then record the reshard
        (``ckpt_resharded``, JAX's fields)."""
        leaf_count = reshard.validate_restored(
            {"model": state.model.state_dict()},
            {"model": tensors["model"]}, step=step)
        self._emit(telemetry.KIND_CKPT_RESHARDED, step=step,
                   from_axes=plan["from_axes"], to_axes=plan["to_axes"],
                   leaf_count=leaf_count,
                   from_spec_digest=plan["from_spec_digest"],
                   to_spec_digest=plan["to_spec_digest"],
                   respec_agreement=plan["respec_agreement"])
        log.warning("restored checkpoint step %d RESHARDED %s -> %s (%d "
                    "leaves validated)", step,
                    reshard.describe_axes(plan["from_axes"]),
                    reshard.describe_axes(plan["to_axes"]), leaf_count)

    def _own_residual(self, state: TrainState, step: int,
                      tensors: dict) -> dict:
        """``tensors`` with the stored residual rows replaced by this
        rank's row: its own at the same rank count, else from the rows
        folded onto this count (sum-preserving); dropped, with a warning,
        when this run keeps no residual. Without stored rows the run's
        residual starts at zero (``TrainState.load_state_dict``), with a
        warning."""
        tensors = dict(tensors)
        rows = tensors.pop("collective_residual", None)
        want = bool(state.collective_residual)
        if rows is None:
            if want:
                log.warning("Checkpoint at step %d has no collective "
                            "residual (quantized collectives enabled after "
                            "it was saved) — starting from a zero residual",
                            step)
            return tensors
        if not want:
            log.warning("Checkpoint at step %d carries a collective "
                        "error-feedback residual but quantized collectives "
                        "are now off — dropping it", step)
            return tensors
        n_saved = next(iter(rows.values())).shape[0]
        if n_saved != self.process_count:
            rows = fold_residual(rows, self.process_count)
            log.warning("collective_residual folded %d -> %d replica rows "
                        "(sum-preserving) across the restore", n_saved,
                        self.process_count)
        tensors["collective_residual"] = {k: v[self._rank]
                                          for k, v in rows.items()}
        return tensors

    def _own_parts(self, state: TrainState, step: int, meta: dict,
                   tensors: dict) -> dict:
        """``tensors`` (the whole layout) cut to this rank's parts of a
        sharded state: its tensor-parallel parts, its experts or its
        pipeline stage first, then its FSDP or
        ZeRO-1 parts of those; ZeRO's stacked slots refolded first when
        another rank count saved them. A ZeRO toggle across the resume is
        refused."""
        stored = meta.get("zero_rows")
        zero = isinstance(state.layout, ZeroUpdate)
        stored_fused = bool(meta.get("zero_fused", False))
        fused = isinstance(state.optimizer, BucketOptimizers)
        if (stored is not None) != zero or stored_fused != fused:
            saved = ("whole" if stored is None
                     else f"ZeRO-stacked over {stored} rows"
                     + (", grouped per bucket" if stored_fused else ""))
            raise ValueError(
                f"checkpoint step {step} in {self._path} stores an "
                f"optimizer state whose slot layout does not match this "
                f"run's: toggling optimizer.zero_sharding between "
                f"'shard_map' and another mode (or precision.fused_update, "
                f"which regroups the slots per ZeRO bucket) across a "
                f"resume is unsupported (replicated, ZeRO-stacked and "
                f"per-bucket slot layouts are incompatible) — restore with "
                f"the settings the checkpoint was saved under (its slots "
                f"are {saved})")
        names = state.optimizer.names
        if state.tp is not None:
            tensors = state.tp.local_state(tensors, names)
        if state.ep is not None:
            tensors = state.ep.local_state(tensors, names)
        if state.pipe is not None:
            tensors = state.pipe.local_state(tensors, names)
        if state.layout is None:
            return tensors
        if zero and stored != state.layout.n:
            tensors = {**tensors, "optimizer": refold_zero_opt_state(
                tensors["optimizer"], names, state.layout.sizes,
                state.layout.n)}
            log.warning("ZeRO optimizer slots refolded %d -> %d rows "
                        "across the restore", stored, state.layout.n)
        return state.layout.local_state(tensors, names)

    def _own_generator(self, state: TrainState, meta: dict,
                       tensors: dict) -> torch.Tensor:
        """This rank's saved dropout generator state when the checkpoint
        was saved by a gang of this size, else the live (freshly seeded)
        one: a gang of another size has other streams."""
        saved = int(meta.get("process_count", 1))
        if saved == self.process_count:
            if saved == 1:
                return tensors["dropout_generator"]
            return tensors["dropout_generators"][
                self._runtime.process_index]
        log.warning("checkpoint saved by %d rank(s), restored on %d: each "
                    "rank keeps its freshly seeded dropout stream", saved,
                    self.process_count)
        return state.dropout_generator.get_state()

    def restore_model(self, model, *, axes: dict | None = None,
                      step: int | None = None,
                      use_ema: bool = False) -> tuple[int, bool] | None:
        """Load only a checkpoint's model tensors into ``model`` (the
        export path: no optimizer and no generator, so any device), its
        parameters from the EMA with ``use_ema`` when the checkpoint holds
        one; returns (the step, whether the EMA was loaded), or None when
        there is no step. ``axes`` is the mesh the model is restored onto
        (the export's serving mesh; None, one device): a checkpoint saved
        under another passes the gate only with
        ``checkpoint.allow_reshard`` (the export sets it from
        ``serve.allow_reshard``)."""
        loaded = self._load(step, model)
        if loaded is None:
            return None
        step, _, tensors = loaded
        saved = (mf.read_manifest(self._step_dir(step)) or {}).get(
            reshard.MESH_RECORD_KEY)
        target = reshard.normalize_axes(axes or {})
        if reshard.must_reshard(saved, target,
                                allow_reshard=self.config.allow_reshard,
                                directory=self._path, step=step):
            count = reshard.validate_restored(
                {"model": model.state_dict()}, {"model": tensors["model"]},
                step=step)
            log.warning("restored the model of checkpoint step %d "
                        "RESHARDED %s -> %s (%d leaves validated)", step,
                        reshard.describe_axes(saved["axes"]),
                        reshard.describe_axes(target), count)
        model.load_state_dict(tensors["model"])
        ema = tensors.get("ema") or {}
        if use_ema and ema:
            model.load_state_dict(ema, strict=False)
        return step, bool(use_ema and ema)

    # ---------------------------------------------------------- barrier --
    def wait_until_finished(self) -> None:
        """The exit barrier: returns once every accepted save has
        committed (manifest written and fsync'd)."""
        self._drain()

    def close(self) -> None:
        try:
            self._drain()
        finally:
            if self._saver is not None:
                try:
                    self._saver.close()
                except Exception:
                    log.warning("async saver close failed", exc_info=True)
