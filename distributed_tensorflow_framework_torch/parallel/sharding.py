"""The parameter layouts of FSDP and tensor parallelism: the port's copy
of ``parallel/sharding.py``'s rules.

The JAX package gives every parameter leaf a ``PartitionSpec``
(``infer_param_specs``): with the mesh's ``model`` axis above 1 the
leaves that ``TP_RULES`` match are split Megatron-style over it (the
fused QKV kernel (H, 3, H) on its last dim, ``query``/``key``/``value``
and ``mlp_in`` on their output dim, ``attn_out`` and ``mlp_out`` on their
input dim, the embedding table (V, H) on H), a dim the axis does not
divide staying whole and a rule of another rank than the leaf's being
skipped (:func:`_match_rules`); then, with the ``fsdp`` axis above 1, the
leaf's largest dim still free that ``fsdp`` divides (the trailing one
among equals, :func:`pick_fsdp_dim`) is sharded over ``fsdp``, and a leaf
with no such dim stays replicated over it. The same rule serves the
optimizer slots (which mirror the parameters) and the EMA. The port
applies the rules to the Flax shape of each of its parameters
(models/convert.py ``flax_layout``), so it shards the dims JAX shards
(:func:`infer_param_specs`), and maps each dim onto the port's tensor: a
Dense kernel (in, *out) is the port's (prod(out), in) weight, viewed as
(*out, in) so that the fused QKV's (H, 3, H) kernel keeps its last dim
whole; a Conv kernel (kh, kw, cin, cout) is the port's (cout, cin, kh, kw)
weight; every other leaf has the Flax shape. :class:`FsdpLeaf` holds that
view and its sharded dim, and cuts and joins along it; :class:`TpLeaf`
adds the shape of the part a tensor-parallel layer computes with.

Tensor parallelism cuts first (parallel/tensor_parallel.py: the model's
parameters become its parts, :func:`tp_layout`), expert parallelism next
(parallel/expert.py: E/n of the experts of those parts), and FSDP then
cuts those parts along a dim the ``model`` and ``expert`` axes left free
(``taken``), which gives each rank the block of the JAX leaf at its
(expert, fsdp, model) coordinates.

:class:`DimSharding` keeps a run's tensors in that layout over the fsdp
axis of the mesh (the ranks of one ``fsdp`` subgroup, core/mesh.py):

  * FSDP (``mesh.fsdp > 1`` without ZeRO-1): between steps each rank
    holds its part of every sharded parameter (the model's parameter is
    the part itself), of its optimizer slots and of its EMA. A step
    gathers the whole parameters first — under ``shard_map`` by the
    tallied all-gather of parallel/collectives.py on the configured wire
    (the JAX package's hand-placed, optionally quantized gather), under
    ``jit`` exactly and untallied, as XLA gathers there — and the update
    runs on the parts, after which the whole parameters are dropped;
  * ZeRO-1 (``optimizer.zero_sharding: jit``, the deprecated
    ``optimizer.shard_opt_state``): the parameters and the EMA stay whole
    and replicated; the optimizer runs on each rank's part of them (views
    into the whole parameters), so its slots are parts, and after the
    update every rank's part is gathered into the whole parameters
    (exact f32).

Under pipeline parallelism (parallel/pipeline.py) a stage's encoder layers
stay whole (``whole``), under FSDP and ZeRO-1 alike: the JAX package
shards the stacked leaves over ``pipe`` only, never over ``fsdp``; the
embedding and the MLM head keep their FSDP dims.

The BatchNorm running statistics (buffers) stay whole. A checkpoint holds
the whole tensors (:meth:`DimSharding.global_state`, every rank takes
part); a restore cuts each rank's part back out
(:meth:`DimSharding.local_state`).

The MoE rules (``MOE_RULES``) come before the TP rules, as in the JAX
package: a MoE layer's ``wi`` (E, H, F) and ``wo`` (E, F, H) put their
leading E over the ``expert`` axis and F over ``model``; parallel/expert.py
holds each rank's contiguous block of E/n experts, its slots and EMA
alike, cut from the tensor-parallel part.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Iterator, Mapping

import torch
from torch import nn

from distributed_tensorflow_framework_torch.models.convert import (
    flax_layout,
    torch_shape,
)
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from distributed_tensorflow_framework_torch.parallel.quantization import (
    DEFAULT_BLOCK_SIZE,
)


# Megatron-style TP rules for the transformer models: column-parallel QKV
# and MLP-in (shard output features), row-parallel attn-out and MLP-out
# (shard input features). Patterns are matched against "/".join(the Flax
# path); the JAX package's TP_RULES.
TP_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    # The fused projection's kernel is (H, 3, H), q/k/v on the middle
    # axis, so TP shards the LAST axis and each rank holds its heads of
    # each of q, k and v; a flat (H, 3H) qkv takes the rank-2 rule below.
    (r".*qkv/kernel$", (None, None, "model")),
    (r".*(query|key|value|qkv)/kernel$", (None, "model")),
    (r".*attn_out/kernel$", ("model", None)),
    (r".*mlp_in/kernel$", (None, "model")),
    (r".*mlp_out/kernel$", ("model", None)),
    (r".*embed/embedding$", (None, "model")),
]

# MoE expert weights (models/moe.py): the leading num_experts dim over
# ``expert``, the hidden dims split over ``model`` (column-parallel wi,
# row-parallel wo); the gate stays replicated. The JAX package's MOE_RULES,
# applied whenever the pattern matches (a trivial axis is dropped).
MOE_RULES: list[tuple[str, tuple[str | None, ...]]] = [
    (r".*moe/wi$", ("expert", None, "model")),
    (r".*moe/wo$", ("expert", "model", None)),
]


def _match_rules(path: str, shape: tuple[int, ...], sizes: Mapping[str, int],
                 rules: list[tuple[str, tuple[str | None, ...]]]
                 ) -> tuple[str | None, ...] | None:
    """The spec (one axis name or None per dim) of the first rule whose
    pattern matches ``path`` and whose rank is the leaf's, with every axis
    that is trivial in the mesh (``sizes``) or does not divide its dim
    dropped (replicated on that dim); None when no rule applies."""
    for pattern, spec in rules:
        if re.match(pattern, path):
            if len(spec) != len(shape):
                # A rule of another rank must not half-apply (zip would
                # truncate it): keep looking.
                continue
            return tuple(
                axis if (axis is not None and sizes.get(axis, 1) > 1
                         and dim % sizes[axis] == 0) else None
                for dim, axis in zip(shape, spec))
    return None


def pick_fsdp_dim(shape: tuple[int, ...], fsdp: int,
                  taken: tuple = ()) -> int:
    """Dim index to shard over fsdp, or -1 if none qualifies.

    The LARGEST still-unsharded dim divisible by ``fsdp`` wins; among
    equal-size candidates the TRAILING dim wins (deterministic: a square
    kernel shards its last dim). ``taken`` marks already-sharded dims
    (per-dim axis entries; None = free)."""
    axes = tuple(taken) + (None,) * (len(shape) - len(tuple(taken)))
    best, best_size = -1, 0
    for i, (dim, axis) in enumerate(zip(shape, axes)):
        if axis is None and dim and dim % fsdp == 0 and dim >= best_size:
            best, best_size = i, dim
    return best


def infer_param_specs(model: nn.Module, sizes: Mapping[str, int],
                      shapes: Mapping[str, tuple[int, ...]] | None = None
                      ) -> dict[str, tuple[str | None, ...]]:
    """Each parameter's state_dict key → the JAX package's
    ``PartitionSpec`` of its Flax leaf on a mesh of ``sizes`` (one axis
    name or None per Flax dim): ``MOE_RULES`` first, then ``TP_RULES``
    when ``model`` exceeds 1, then the fsdp dim among those still free
    when ``fsdp`` exceeds 1. ``model`` holds its whole parameters, or
    ``shapes`` gives them (key → the whole port tensor's shape)."""
    out = {}
    fsdp = sizes.get("fsdp", 1)
    for key, (path, shape) in flax_layout(model, shapes).items():
        spec = _match_rules("/".join(path), shape, sizes, MOE_RULES)
        if spec is None and sizes.get("model", 1) > 1:
            spec = _match_rules("/".join(path), shape, sizes, TP_RULES)
        spec = spec or (None,) * len(shape)
        if fsdp > 1:
            best = pick_fsdp_dim(shape, fsdp, spec)
            if best >= 0:
                spec = spec[:best] + ("fsdp",) + spec[best + 1:]
        out[key] = spec
    return out


def infer_fsdp_dims(model: nn.Module, fsdp: int,
                    taken: Mapping[str, int | tuple[int, ...]] | None = None
                    ) -> dict[str, int]:
    """Each parameter's state_dict key → the dim of its FLAX leaf that the
    JAX package's ``infer_param_specs`` shards over ``fsdp`` (-1:
    replicated; every leaf is replicated when ``fsdp`` is 1). ``taken``
    maps a key to the Flax dim (or dims) that tensor and expert
    parallelism already split, which fsdp leaves alone (``model`` then
    holds the parts)."""
    if fsdp <= 1:
        return {key: -1 for key, _ in model.named_parameters()}
    taken = taken or {}
    out = {}
    for key, (_, shape) in flax_layout(model).items():
        spec = [None] * len(shape)
        dims = taken.get(key, -1)
        for dim in (dims,) if isinstance(dims, int) else dims:
            if dim >= 0:
                spec[dim] = "taken"
        out[key] = pick_fsdp_dim(shape, fsdp, tuple(spec))
    return out


@dataclasses.dataclass(frozen=True)
class FsdpLeaf:
    """How one parameter is sharded: the port tensor ``.view(view)`` is
    cut into ``fsdp`` equal parts along ``dim``; ``shape`` is the tensor's
    own (unsharded) shape."""

    shape: tuple[int, ...]
    view: tuple[int, ...]
    dim: int
    fsdp: int

    @property
    def shard_view(self) -> tuple[int, ...]:
        """The shape of one part (the view with ``dim`` cut)."""
        out = list(self.view)
        out[self.dim] //= self.fsdp
        return tuple(out)

    def shard(self, full: torch.Tensor, index: int) -> torch.Tensor:
        """Part ``index`` of ``full`` (a view into it, not a copy)."""
        size = self.view[self.dim] // self.fsdp
        return full.reshape(self.view).narrow(self.dim, index * size, size)

    def unshard(self, parts: torch.Tensor) -> torch.Tensor:
        """``fsdp`` parts stacked on a new dim 0 → the full tensor."""
        moved = parts.movedim(0, self.dim)
        shape = list(self.shard_view)
        shape[self.dim] = self.view[self.dim]
        return moved.reshape(shape).reshape(self.shape)

    def cut(self, full: torch.Tensor, index: int) -> torch.Tensor:
        """Part ``index`` of ``full`` as a new tensor that shares no
        memory with it."""
        return self.shard(full, index).clone(
            memory_format=torch.contiguous_format)


@dataclasses.dataclass(frozen=True)
class TpLeaf(FsdpLeaf):
    """A tensor-parallel leaf: an :class:`FsdpLeaf` over the ``model``
    axis (``fsdp`` is its size) whose part is held in ``part_shape``, the
    port layout of the Flax part (models/convert.py ``torch_shape``), so
    that the layer computes with it."""

    part_shape: tuple[int, ...] = ()

    def cut(self, full: torch.Tensor, index: int) -> torch.Tensor:
        return super().cut(full, index).reshape(self.part_shape)


def _torch_dim(path: tuple[str, ...], flax_shape: tuple[int, ...],
               dim: int) -> tuple[tuple[int, ...], int]:
    """(the view of the port tensor whose dims are the Flax leaf's dims in
    another order, the view's dim that is Flax dim ``dim``)."""
    if path[-1] == "kernel" and len(flax_shape) == 4:  # Conv, OIHW
        kh, kw, cin, cout = flax_shape
        return (cout, cin, kh, kw), (2, 3, 1, 0)[dim]
    if path[-1] == "kernel":  # Dense: (in, *out) → (*out, in)
        view = (*flax_shape[1:], flax_shape[0])
        return view, (len(view) - 1 if dim == 0 else dim - 1)
    return tuple(flax_shape), dim


def tp_layout(model: nn.Module, count: int) -> dict[str, TpLeaf | None]:
    """Each parameter's state_dict key → its :class:`TpLeaf` over a
    ``model`` axis of ``count``, or None for a leaf ``TP_RULES`` leave
    whole (``model`` holds its whole parameters)."""
    out: dict[str, TpLeaf | None] = {}
    params = dict(model.named_parameters())
    specs = infer_param_specs(model, {"model": count})
    for key, (path, flax_shape) in flax_layout(model).items():
        if "model" not in specs[key]:
            out[key] = None
            continue
        dim = specs[key].index("model")
        view, vdim = _torch_dim(path, flax_shape, dim)
        part = list(flax_shape)
        part[dim] //= count
        out[key] = TpLeaf(tuple(params[key].shape), view, vdim, count,
                          part_shape=torch_shape(path, tuple(part)))
    return out


def fsdp_layout(model: nn.Module, fsdp: int,
                taken: Mapping[str, int | tuple[int, ...]] | None = None,
                whole=()) -> dict[str, FsdpLeaf | None]:
    """Each parameter's state_dict key → its :class:`FsdpLeaf`, or None
    for a replicated leaf; ``taken`` as in :func:`infer_fsdp_dims`; the
    keys in ``whole`` (a pipelined stage's layers) stay whole."""
    out: dict[str, FsdpLeaf | None] = {}
    params = dict(model.named_parameters())
    dims = infer_fsdp_dims(model, fsdp, taken)
    whole = set(whole)
    for key, (path, flax_shape) in flax_layout(model).items():
        if dims[key] < 0 or key in whole:
            out[key] = None
            continue
        view, dim = _torch_dim(path, flax_shape, dims[key])
        out[key] = FsdpLeaf(tuple(params[key].shape), view, dim, fsdp)
    return out


def map_slots(fn, opt_state: dict, names: list[str]) -> dict:
    """``opt_state`` (``Optimizer.state_dict()``) with ``fn(slot, name)``
    applied to every slot tensor that mirrors a parameter (ndim >= 1; the
    per-parameter step counters pass through), where ``name`` is that
    parameter's key (``Optimizer.names``). A new nest; what is not mapped
    is shared. A per-bucket state (train/optimizers.py
    ``BucketOptimizers``: ``{"buckets": [...]}`` with one name list per
    bucket) is mapped bucket by bucket."""
    if "buckets" in opt_state:
        return {**opt_state, "buckets": [
            map_slots(fn, part, part_names)
            for part, part_names in zip(opt_state["buckets"], names)]}
    inner = opt_state["inner"]
    state = {i: {k: (fn(v, names[i]) if isinstance(v, torch.Tensor)
                     and v.dim() >= 1 else v) for k, v in slots.items()}
             for i, slots in inner["state"].items()}
    return {**opt_state, "inner": {**inner, "state": state}}


class PartLayout:
    """What the layouts that hold parts of leaves along one group of mesh
    axes share: the exact gather of a part and the checkpoint's whole
    layout. A subclass sets ``runtime``, ``axes`` (the group's mesh axes),
    ``index`` (this rank's place in the group), ``leaves`` (key →
    :class:`FsdpLeaf`, or None for a whole leaf) and ``at_rest`` (whether
    the parameters and the EMA are parts, or only the optimizer slots)."""

    def _gather_exact(self, key: str, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every member's ``part`` (an untallied exact
        gather; a whole leaf or another key as it is)."""
        leaf = self.leaves.get(key)
        if leaf is None:
            return part
        rows = coll._all_gather(part.contiguous(), self.runtime, self.axes)
        return leaf.unshard(rows.view((leaf.fsdp,) + leaf.shard_view))

    def _cut(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        leaf = self.leaves.get(key)
        return whole if leaf is None else leaf.cut(whole, self.index)

    def whole(self, tensors: dict[str, torch.Tensor]
              ) -> dict[str, torch.Tensor]:
        """Parts (key → tensor) gathered whole, exactly; every rank of the
        group calls it."""
        return {k: self._gather_exact(k, t) for k, t in tensors.items()}

    def global_state(self, state: dict, names: list[str]) -> dict:
        """``TrainState.state_dict()`` with every part gathered whole: the
        parameters and the EMA when they are held as parts, the slots
        always. Every rank of the group calls it."""
        out = dict(state)
        if self.at_rest:
            out["model"] = self.whole(state["model"])
            if "ema" in state:
                out["ema"] = self.whole(state["ema"])
        out["optimizer"] = map_slots(lambda t, k: self._gather_exact(k, t),
                                     state["optimizer"], names)
        return out

    def local_state(self, state: dict, names: list[str]) -> dict:
        """The inverse of :meth:`global_state`: this rank's parts (copies)
        of whole tensors."""
        out = dict(state)
        if self.at_rest:
            out["model"] = {k: self._cut(k, v)
                            for k, v in state["model"].items()}
            if "ema" in state:
                out["ema"] = {k: self._cut(k, v)
                              for k, v in state["ema"].items()}
        out["optimizer"] = map_slots(lambda t, k: self._cut(k, t),
                                     state["optimizer"], names)
        return out


class DimSharding(PartLayout):
    """FSDP (``at_rest``) or ZeRO-1 over the fsdp axis of ``runtime`` (see
    the module docstring). ``params`` maps each parameter's key to the
    tensor the optimizer updates: this rank's part of a sharded leaf, the
    parameter itself for a replicated one. ``wire`` and ``block_size``
    are the gather's under ``shard_map`` (``tally``: it is the explicit,
    tallied collective); None gathers exactly. ``taken``: the Flax dims
    of each leaf that tensor and expert parallelism split (``model``
    holds the parts; :func:`fsdp_layout`); ``whole``: the keys that stay whole (a pipelined
    stage's layers)."""

    def __init__(self, model: nn.Module, runtime, *, at_rest: bool,
                 tally: bool = False, wire=None,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 taken: Mapping[str, int | tuple[int, ...]] | None = None,
                 whole=()):
        self.runtime, self.axes = runtime, "fsdp"
        self.group = runtime.axis_group("fsdp")
        self.index = self.group.index
        self.leaves = fsdp_layout(model, self.group.size, taken, whole)
        self.at_rest = at_rest
        self.tally, self.wire, self.block_size = tally, wire, block_size
        self.params: dict[str, torch.Tensor] = {}
        for key, p in model.named_parameters():
            leaf, t = self.leaves[key], p.detach()
            if leaf is not None:
                t = leaf.shard(t, self.group.index)
                if at_rest:
                    t = t.contiguous().clone()
                    p.data = t
            self.params[key] = t

    def _part(self, key: str, full: torch.Tensor) -> torch.Tensor:
        leaf = self.leaves[key]
        return full if leaf is None else leaf.shard(full, self.group.index)

    def _gather(self, key: str, part: torch.Tensor, *,
                explicit: bool = False) -> torch.Tensor:
        """The whole leaf from every member's ``part``; ``explicit``: the
        step's tallied gather on the wire, else an exact untallied one."""
        leaf = self.leaves[key]
        if leaf is None or not explicit:
            return self._gather_exact(key, part)
        return coll.all_gather(
            part, self.runtime, axis=leaf.dim, tiled=True,
            wire_dtype=self.wire, block_size=self.block_size,
            axes="fsdp").reshape(leaf.shape)

    # --------------------------------------------------------- the step --
    def begin_step_(self, model: nn.Module) -> None:
        """FSDP: every sharded parameter becomes the whole leaf."""
        if not self.at_rest:
            return
        for key, p in model.named_parameters():
            if self.leaves[key] is not None:
                p.data = self._gather(key, self.params[key],
                                      explicit=self.tally)

    def shard_grads_(self, model: nn.Module) -> None:
        """Each part's gradient: its cells of the whole reduced
        gradient."""
        for key, p in model.named_parameters():
            self.params[key].grad = self._part(key, p.grad)

    @torch.no_grad()
    def finish_step_(self, model: nn.Module) -> None:
        """After the update. FSDP: drop the whole parameters (the model's
        parameters are the updated parts again); ZeRO-1: gather the
        updated parts into the whole parameters."""
        for key, p in model.named_parameters():
            if self.leaves[key] is None:
                continue
            p.grad = None
            if self.at_rest:
                p.data = self.params[key]
            else:
                p.copy_(self._gather(key, self.params[key]))

    def ema_sources(self, model: nn.Module) -> list[torch.Tensor]:
        """What the EMA averages, in parameter order: the parts under
        FSDP, the whole parameters under ZeRO-1."""
        if self.at_rest:
            return list(self.params.values())
        return [p for _, p in model.named_parameters()]

    def ema_init(self, model: nn.Module) -> dict[str, torch.Tensor]:
        return {k: t.float().clone() for k, t in zip(
            self.params, self.ema_sources(model))}

    @contextlib.contextmanager
    def whole_params(self, model: nn.Module) -> Iterator[None]:
        """The model with its whole parameters (exactly gathered) inside,
        its parts again after; for the eval step."""
        if not self.at_rest:
            yield
            return
        for key, p in model.named_parameters():
            if self.leaves[key] is not None:
                p.data = self._gather(key, self.params[key])
        try:
            yield
        finally:
            for key, p in model.named_parameters():
                if self.leaves[key] is not None:
                    p.data = self.params[key]

    def whole_norms(self):
        """LARS's ``whole_norms``: a part's norm → the whole leaf's, the
        square root of the sum over the members of the parts' squared
        norms (one all_reduce; a replicated leaf's norm is already
        whole)."""
        sharded = {id(self.params[k]) for k, leaf in self.leaves.items()
                   if leaf is not None}

        def fn(params, norms):
            mask = torch.tensor([id(p) in sharded for p in params],
                                device=norms.device)
            sq = torch.where(mask, norms.square(), torch.zeros_like(norms))
            total = coll._all_reduce(sq.clone(), self.runtime, "fsdp")
            return torch.where(mask, total.sqrt(), norms)
        return fn
