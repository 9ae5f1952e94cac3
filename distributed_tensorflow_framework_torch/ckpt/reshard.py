"""Moving state across a change of mesh: the port's copy of
``ckpt/reshard.py``.

A checkpoint holds the whole, global layout (ckpt/checkpoint.py), so a
restore onto another mesh is the existing cut of each rank's parts (plus
the refolds below); what this module owns is the contract around it, as
in the JAX package:

  * ``state_topology`` — the mesh record the chief writes into each
    manifest commit record (``MESH_RECORD_KEY``): the ordered axis sizes
    of the run's :class:`core.mesh.MeshRuntime` (a single process without
    one: every axis 1), its device and process counts (a port device is a
    rank) and ``spec_digest``, a sha256 over
    every leaf's layout in this run (whole, a tensor-parallel, FSDP or
    expert part, ZeRO rows, a pipeline stage). The digest is over the
    port's layout, so it does not compare with a JAX digest;
  * ``check_restore_topology`` — the gate: the same axes restore as
    before; other axes raise :class:`MeshTopologyError` (naming both
    meshes and ``checkpoint.allow_reshard``) unless the knob is set, and
    with it give a reshard plan (``plan_reshard``) that the manager
    carries out, validates (``validate_restored``) and emits as
    ``ckpt_resharded``; a manifest with no record (written before the
    gate) restores with a warning;
  * ``fold_residual`` and ``refold_zero_opt_state`` — the rank-count
    dependent parts of the state: the int8 error-feedback residual's rows
    and ZeRO's stacked slot rows.
"""

from __future__ import annotations

import hashlib
import logging

import torch

from distributed_tensorflow_framework_torch.core.mesh import MESH_AXES
from distributed_tensorflow_framework_torch.parallel.sharding import (
    DimSharding,
    infer_param_specs,
    map_slots,
)
from distributed_tensorflow_framework_torch.parallel.zero import (
    ZeroUpdate,
    refold_rows,
)

log = logging.getLogger(__name__)

# The manifest commit record's field carrying the saver's mesh (manifest.py
# ``extra``); absent from manifests written before the gate.
MESH_RECORD_KEY = "mesh"


class MeshTopologyError(ValueError):
    """Restore refused: the checkpoint was saved under another mesh.
    Carries both axis dicts and names the knob that turns the refusal
    into a reshard; ``hint`` is a caller's own line (the export names
    ``serve.allow_reshard``)."""

    def __init__(self, saved_axes: dict, requested_axes: dict, *,
                 directory: str, step: int, hint: str | None = None):
        self.saved_axes = dict(saved_axes)
        self.requested_axes = dict(requested_axes)
        self.directory = directory
        self.step = step
        self.hint = hint
        super().__init__(
            f"Checkpoint at step {step} in {directory} was saved under "
            f"mesh {describe_axes(saved_axes)} but the run is configured "
            f"for mesh {describe_axes(requested_axes)}. Set "
            f"checkpoint.allow_reshard=true to reshard the state onto the "
            f"new mesh (partition specs are re-derived against it), or "
            f"restore on matching hardware. docs/RESILIENCE.md 'losing a "
            f"slice' covers the elastic-supervisor path that does this "
            f"automatically." + (f" {hint}" if hint else ""))


def describe_axes(axes: dict) -> str:
    """Compact form: {'data': 8, 'fsdp': 1, ...} -> ``{data:8}``."""
    parts = [f"{a}:{int(axes[a])}" for a in MESH_AXES
             if a in axes and int(axes[a]) != 1]
    parts += [f"{a}:{int(v)}" for a, v in axes.items()
              if a not in MESH_AXES and int(v) != 1]
    return "{" + ", ".join(parts) + "}" if parts else "{1 device}"


def normalize_axes(axes: dict) -> dict[str, int]:
    """The axes in MESH_AXES order, missing ones as 1, so a record without
    an axis compares equal to a mesh where it has size 1."""
    out = {a: int(axes.get(a, 1)) for a in MESH_AXES}
    for a, v in axes.items():
        if a not in MESH_AXES:
            out[a] = int(v)
    return out


def axes_equal(a: dict | None, b: dict | None) -> bool:
    if a is None or b is None:
        return False
    return normalize_axes(a) == normalize_axes(b)


def _leaf_layouts(state) -> dict[str, list[str]]:
    """Each model tensor's key → how this run holds it: the axes whose
    parts it is (``model``/``expert``/``fsdp`` with the dim and the part
    count), ``zero:<rows>`` for ZeRO's stacked slots, ``pipe:<stages>``
    for a pipelined stage's tensors; [] for a whole, replicated leaf."""
    out: dict[str, list[str]] = {}
    fsdp = state.layout if isinstance(state.layout, DimSharding) else None
    for key in state.model.state_dict():
        parts = []
        for name, layout in (("model", state.tp), ("expert", state.ep),
                             ("fsdp", fsdp)):
            leaf = None if layout is None else layout.leaves.get(key)
            if leaf is not None:
                parts.append(f"{name}:{leaf.dim}/{leaf.fsdp}")
        if isinstance(state.layout, ZeroUpdate) and key in state.layout.sizes:
            parts.append(f"zero:{state.layout.n}")
        if state.pipe is not None:
            parts.append(f"pipe:{state.model.num_stages}")
        out[key] = parts
    return out


def _whole_shapes(state) -> dict[str, tuple[int, ...]]:
    """Each parameter's key → the whole leaf's port shape: the shape
    before the first of the cuts (tensor, expert, FSDP) that split it."""
    fsdp = state.layout if isinstance(state.layout, DimSharding) else None
    out = {}
    for key, p in state.model.named_parameters():
        shape = tuple(p.shape)
        for layout in (fsdp, state.ep, state.tp):  # the last cut first
            leaf = None if layout is None else layout.leaves.get(key)
            if leaf is not None:
                shape = tuple(leaf.shape)
        out[key] = shape
    return out


def spec_digest(state) -> str:
    """sha256 over every model tensor's (key, layout) in this run: a
    fingerprint of how the state is sharded, recorded for forensics and
    never gated on (the same axes with another digest restore: the
    whole-layout checkpoint is cut anew)."""
    h = hashlib.sha256()
    for key, parts in _leaf_layouts(state).items():
        h.update(f"{key}={','.join(parts) or 'whole'}\n".encode())
    return h.hexdigest()


def state_runtime(state, runtime):
    """The runtime whose mesh ``state`` is sharded on: its layouts' (a
    step builder re-forms the subgroups of a runtime formed for another
    mesh, core/mesh.py ``remesh``), else ``runtime``; None for a single
    process."""
    for layout in (state.tp, state.ep, state.layout, state.pipe):
        found = getattr(layout, "runtime", None)
        if found is not None:
            return found
    return runtime


def state_topology(state, runtime) -> dict:
    """The manifest's mesh record for a state trained on ``runtime`` (a
    core/mesh.py MeshRuntime; None, a single process, is the mesh of one
    device: the JAX trainer's one-device mesh)."""
    runtime = state_runtime(state, runtime)
    if runtime is None:
        axes, count = {a: 1 for a in MESH_AXES}, 1
    else:
        axes = {a: int(runtime.sizes[a]) for a in MESH_AXES}
        count = int(runtime.process_count)
    return {
        "axes": axes,
        "device_count": count,
        "process_count": count,
        "spec_digest": spec_digest(state),
    }


def plan_reshard(saved: dict, state, runtime, *, step: int) -> dict:
    """The reshard's record: saved and target axes and digests, the leaf
    count, and on how many parameters the run's layout agrees with the
    port's sharding rules (parallel/sharding.py ``infer_param_specs``,
    the JAX package's) at the new mesh — informational: a ``shard_map``
    run, which keeps every parameter whole, scores low."""
    target = state_topology(state, runtime)
    specs = infer_param_specs(state.model, target["axes"],
                              _whole_shapes(state))
    layouts = _leaf_layouts(state)
    match = total = 0
    for key, _ in state.model.named_parameters():
        total += 1
        want = {a for a in specs.get(key, ()) if a is not None}
        held = {part.split(":")[0] for part in layouts.get(key, ())
                if part.split(":")[0] in ("model", "expert", "fsdp")}
        match += want == held
    return {
        "step": int(step),
        "from_axes": dict(saved.get("axes") or {}),
        "to_axes": dict(target["axes"]),
        "from_spec_digest": saved.get("spec_digest"),
        "to_spec_digest": target.get("spec_digest"),
        "leaf_count": len(state.model.state_dict()),
        "respec_agreement": f"{match}/{total}",
    }


def must_reshard(saved: dict | None, axes: dict, *, allow_reshard: bool,
                 directory: str, step: int) -> bool:
    """The gate on the saved record against the mesh ``axes`` of the
    restore: False to restore as it is (the same mesh, or a manifest with
    no record, with a warning), True for a reshard (another mesh with
    ``allow_reshard``), :class:`MeshTopologyError` for another mesh
    without it."""
    if not saved or not saved.get("axes"):
        log.warning(
            "checkpoint step %d in %s has no mesh topology record (saved "
            "before the elastic layer) — restoring without a topology "
            "check", step, directory)
        return False
    if axes_equal(saved["axes"], axes):
        return False
    if not allow_reshard:
        raise MeshTopologyError(saved["axes"], axes, directory=directory,
                                step=step)
    return True


def check_restore_topology(saved: dict | None, state, runtime, *,
                           allow_reshard: bool, directory: str,
                           step: int) -> dict | None:
    """The restore-time gate (:func:`must_reshard`) for ``state`` on
    ``runtime``: None to restore as it is, else the reshard plan."""
    target = state_topology(state, runtime)
    if not must_reshard(saved, target["axes"], allow_reshard=allow_reshard,
                        directory=directory, step=step):
        if saved and saved.get("spec_digest") not in (
                None, target["spec_digest"]):
            log.info("checkpoint step %d: same mesh, different layout "
                     "digest (sharding knobs changed) — the whole layout "
                     "is cut anew", step)
        return None
    plan = plan_reshard(saved, state, runtime, step=step)
    log.warning("resharding checkpoint step %d: %s -> %s (%d leaves, "
                "respec agreement %s)", step,
                describe_axes(plan["from_axes"]),
                describe_axes(plan["to_axes"]), plan["leaf_count"],
                plan["respec_agreement"])
    return plan


def _tensor_leaves(tree, path: str = "") -> list[tuple[str, object]]:
    """(path, leaf) of every leaf of a nest of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [leaf for k in tree
                for leaf in _tensor_leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in _tensor_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def validate_restored(template, restored, *, step: int) -> int:
    """Leaf by leaf after a cross-mesh restore: the tensors about to be
    loaded (``restored``) against the ones the run holds (``template``),
    nests of dicts of tensors with the same paths, the same shapes and
    the same dtypes. A reshard moves bytes between ranks and never
    reshapes a leaf; drift means the checkpoint does not hold this model's
    state, and the paths are named. Returns the validated leaf count."""
    t_leaves = _tensor_leaves(template)
    r_leaves = _tensor_leaves(restored)
    t_paths = [p for p, _ in t_leaves]
    r_paths = [p for p, _ in r_leaves]
    if t_paths != r_paths:
        missing = sorted(set(t_paths) - set(r_paths))[:5]
        extra = sorted(set(r_paths) - set(t_paths))[:5]
        raise ValueError(
            f"resharded restore at step {step} returned a different tree "
            f"structure than the template: missing {missing}, extra "
            f"{extra}")
    errors = []
    for (path, t), (_, r) in zip(t_leaves, r_leaves):
        t_shape = tuple(t.shape) if hasattr(t, "shape") else None
        r_shape = tuple(r.shape) if hasattr(r, "shape") else None
        if t_shape != r_shape:
            errors.append(f"{path}: template {t_shape} vs restored "
                          f"{r_shape}")
        elif getattr(t, "dtype", None) != getattr(r, "dtype", None):
            errors.append(f"{path}: template dtype "
                          f"{getattr(t, 'dtype', None)} vs restored "
                          f"{getattr(r, 'dtype', None)}")
    if errors:
        raise ValueError(
            f"resharded restore at step {step} changed global leaf "
            f"shapes ({len(errors)} of {len(t_leaves)}): "
            + "; ".join(errors[:5]))
    return len(t_leaves)


def fold_residual(rows: dict[str, torch.Tensor],
                  n_new: int) -> dict[str, torch.Tensor]:
    """Fold stored ``(n_old, *shape)`` error-feedback residual rows
    (train/state.py ``collective_residual``, one row per replica) onto
    ``n_new`` rows, keeping each leaf's sum over the rows — what error
    feedback owes the optimizer: the mean gradient's path depends on the
    total residual, not on how it is spread over the replicas.

    An even shrink (``n_old % n_new == 0``) sums ``n_old / n_new``
    consecutive rows into each new row; any other change puts the total
    in row 0 and starts the other replicas from zero."""

    def fold(leaf: torch.Tensor) -> torch.Tensor:
        n_old = leaf.shape[0]
        if n_old == n_new:
            return leaf
        if n_old % n_new == 0:
            return leaf.reshape((n_new, n_old // n_new)
                                + tuple(leaf.shape[1:])).sum(dim=1)
        out = torch.zeros((n_new,) + tuple(leaf.shape[1:]),
                          dtype=leaf.dtype, device=leaf.device)
        out[0] = leaf.sum(dim=0)
        return out

    return {k: fold(v) for k, v in rows.items()}


def refold_zero_opt_state(stored: dict, names: list[str],
                          sizes: dict[str, int], n_new: int) -> dict:
    """Re-chunk ZeRO-stacked optimizer slots (an ``Optimizer.state_dict()``
    whose slots are ``(n_old, ceil(size/n_old))`` rows, as a checkpoint
    stores them) for ``n_new`` replicas: each slot flattened, truncated to
    its parameter's true ``size`` (``sizes`` by key; ``names`` maps the
    optimizer's indices to keys) and re-padded to ``(n_new,
    ceil(size/n_new))``. The padding is inert (zero gradient and zero
    parameter give a zero update under every rule ZeRO allows), so the
    refold changes no real cell; the step counters pass through."""
    return map_slots(lambda t, key: refold_rows(t, sizes[key], n_new),
                     stored, names)
