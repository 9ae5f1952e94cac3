"""ZeRO weight-update sharding with bucketed collectives: the port's copy
of ``parallel/zero.py``.

Data parallelism holds the whole optimizer state on every replica and
runs the whole weight update on every replica, though the reduced
gradient is the same everywhere. ZeRO (``optimizer.zero_sharding:
shard_map``) reduce-SCATTERS the gradients so that replica i owns shard i
of each flattened leaf, updates only that shard (1/n of the optimizer
state and of the update's work) and all-gathers the result:

  * every parameter leaf is flattened, zero-padded to ``n·c`` elements
    (``c = ceil(size/n)``) and viewed as n rows of c; row i is replica
    i's shard. The optimizer slots are born at the shard's ``(c,)`` shape
    on each rank, which is row i of the JAX package's stacked ``(n, c)``
    slot; a checkpoint stores the stacked rows. Padding is inert: its
    gradient and parameter are zero, so its update is zero under every
    rule ZeRO allows (train/optimizers.py).
  * the leaves are laid out by their FLAX paths (models/convert.py), not
    by the port's parameter names: the buckets hold consecutive leaves in
    REVERSE natural order of those paths (the deepest layer's gradients,
    ready first in the backward, in the first bucket), filled to
    ``optimizer.zero_bucket_mb`` of f32 gradient, and within a bucket the
    leaves' rows sit side by side in that order. Under the int8 wire a
    bucket's quantization blocks span that concatenation, so the layout
    decides the numbers. Each leaf is flattened in the port's own tensor
    layout (a Dense weight is the transpose of the Flax kernel), so a
    transposed leaf's elements fall into other blocks than JAX's.
  * one collective per bucket and phase, as the JAX package issues them:
    the buckets are the coalescing (the replicated all-reduce of
    parallel/collectives.py coalesces every leaf instead).
  * what the gather ships. The JAX package gathers the UPDATES and adds
    them to every replica's full f32 master parameters, so that a lossy
    wire cannot make the replicas drift. torch.optim updates a tensor in
    place and never forms that update, so the port gathers:
      - on the f32 wire, the updated SHARDS, copied into the full
        parameters: exact, and each cell is the cell the replicated step
        computes (the rules are elementwise), so the step equals the
        replicated one bit for bit wherever the reduced gradients do;
      - on the bf16 and int8 wires, the update ``new − old`` of the shard
        (old: the same cells of the full parameter, which every replica
        holds unchanged), which every replica dequantizes identically and
        adds to the same parameters, so the replicas stay identical; the
        master parameters never cross the lossy wire.
    The shards are re-cut from the full parameters at every step, as JAX
    re-slices them, so a lossy step's rounding lives only in the full
    parameters.
  * the int8 reduce-scatter threads error feedback through the residual
    of ``TrainState.collective_residual`` (compensate, quantize, carry
    ``c − D(Q(c))``), at full parameter shape, one row per rank; it has
    no second error term, since the scatter requantizes nothing. The
    gather has no error feedback.

The tally records ``zero_reduce_scatter`` and ``zero_all_gather`` under
the JAX package's byte conventions; :func:`plan_summary` is the static
estimate of the ``zero_update`` event.

``precision.fused_update`` (:meth:`ZeroUpdate.fused_walk_`, JAX's
``fused_update_walk``) runs the same collectives bucket by bucket, in the
same reverse layer order: the bucket's reduce-scatter (with error
feedback on the int8 wire), the update of its shards by its own optimizer
(train/optimizers.py ``BucketOptimizers``), its all-gather (the updated
shards on the f32 wire, ``new − old`` on a lossy one, as above) and the
apply to its whole parameters, so each leaf is read and written once
while its gradient is at hand. The collectives per bucket and the tally
are the unfused path's, and so are the parameters and the slots, bit for
bit on the f32 wire; ``grad_norm`` is the square root of the all-reduced
sum of the shards' squares.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_framework_torch.core import profiling
from distributed_tensorflow_framework_torch.models.convert import flax_layout
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from distributed_tensorflow_framework_torch.parallel.quantization import (
    DEFAULT_BLOCK_SIZE,
    SCALE_BYTES,
    quantize_blockwise,
)
from distributed_tensorflow_framework_torch.parallel.sharding import map_slots

# Tally kinds of the ZeRO collectives, apart from the generic
# reduce_scatter/all_gather so that the bytes of this path can be told
# apart (the zero_update event, the wire A/B).
RS_KIND = "zero_reduce_scatter"
AG_KIND = "zero_all_gather"

# Nominal one-direction NVLink rate of an H100 SXM (18 links × 25 GB/s,
# the data sheet's 900 GB/s both ways), used ONLY for the zero_update
# event's "hidden ms" estimate: an aid to reading the overlap fraction,
# not a measurement.
NOMINAL_LINK_BYTES_PER_S = 450e9


def natural_key(path: str) -> tuple:
    """Digit-aware sort key: ``layer_10`` sorts after ``layer_2``."""
    return tuple(
        (0, int(tok)) if tok.isdigit() else (1, tok)
        for tok in re.split(r"(\d+)", path)
        if tok
    )


@dataclasses.dataclass(frozen=True)
class LeafChunk:
    """Shard geometry for one parameter leaf. ``index``, ``path``,
    ``shape``, ``size`` and ``chunk`` are the JAX package's (``shape`` the
    Flax leaf's); ``name`` is the port's state_dict key."""

    index: int               # position in the Flax tree's flatten order
    path: str                # "/"-joined Flax path (bucket ordering key)
    shape: tuple[int, ...]
    size: int                # true element count
    chunk: int               # per-replica elements: ceil(size / n)
    name: str = ""


@dataclasses.dataclass(frozen=True)
class ZeroPlan:
    """Static shard/bucket plan for one parameter tree over n replicas.

    ``leaf_chunks`` is in the Flax tree's flatten order; ``buckets``
    groups the same leaves in REVERSE layer order — the issue order of the
    bucketed reduce-scatter."""

    n: int
    bucket_bytes: int
    leaf_chunks: tuple[LeafChunk, ...]
    buckets: tuple[tuple[LeafChunk, ...], ...]

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def shard_elements(self) -> int:
        """Per-replica elements across all leaves (incl. padding)."""
        return sum(lc.chunk for lc in self.leaf_chunks)


def build_plan(leaves: Mapping[str, tuple[tuple[str, ...],
                                          tuple[int, ...]]],
               n: int, bucket_mb: float) -> ZeroPlan:
    """Partition parameter leaves into per-replica shards and
    reduce-scatter buckets. ``leaves`` maps each leaf's name to (its Flax
    path, the Flax leaf's shape), as models/convert.py ``flax_layout``
    gives them; the flatten order is the Flax tree's (sorted paths)."""
    if n < 1:
        raise ValueError(f"zero sharding needs n >= 1, got {n}")
    ordered = sorted(leaves.items(), key=lambda kv: kv[1][0])
    chunks = []
    for index, (name, (path, shape)) in enumerate(ordered):
        shape = tuple(int(d) for d in shape)
        size = int(math.prod(shape)) if shape else 1
        chunks.append(LeafChunk(index=index, path="/".join(path),
                                shape=shape, size=size, chunk=-(-size // n),
                                name=name))
    # Reverse layer order: the backward produces the deepest layers'
    # gradients first, so their bucket is issued first.
    rev = sorted(chunks, key=lambda lc: natural_key(lc.path), reverse=True)
    bucket_bytes = max(1, int(bucket_mb * 2**20))
    buckets: list[tuple[LeafChunk, ...]] = []
    cur: list[LeafChunk] = []
    cur_bytes = 0
    for lc in rev:
        cur.append(lc)
        cur_bytes += lc.size * 4  # f32 gradient bytes
        if cur_bytes >= bucket_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(tuple(cur))
    return ZeroPlan(n=n, bucket_bytes=bucket_bytes,
                    leaf_chunks=tuple(chunks), buckets=tuple(buckets))


# ------------------------------------------------------- shard reshaping --
def stack_rows(x: torch.Tensor, chunk: int, n: int) -> torch.Tensor:
    """Full leaf → ``(n, chunk)`` rows (flattened, zero-padded)."""
    flat = x.reshape(-1)
    pad = n * chunk - flat.numel()
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.view(n, chunk)


def local_shard(x: torch.Tensor, chunk: int, n: int,
                row: int) -> torch.Tensor:
    """Row ``row`` of :func:`stack_rows` (a view where no padding is
    needed)."""
    return stack_rows(x, chunk, n)[row]


def refold_rows(rows: torch.Tensor, size: int, n_new: int) -> torch.Tensor:
    """Stacked ``(n_old, ceil(size/n_old))`` rows → ``(n_new,
    ceil(size/n_new))``: flatten, truncate to the true ``size`` (the old
    grid's padding), re-pad for the new grid — the JAX package's
    ``refold_zero_opt_state`` on one slot."""
    chunk = -(-size // n_new)
    if tuple(rows.shape) == (n_new, chunk):
        return rows
    return stack_rows(rows.reshape(-1)[:size], chunk, n_new)


# ------------------------------------------------- bucketed collectives --
def _reduce_scatter_bucket(mat: torch.Tensor, runtime, *, wire,
                           block_size: int, paths: tuple[str, ...]):
    """Reduce-scatter ONE bucket: ``(n, C)`` rows → own summed ``(C,)``.

    Module-level so that a test can spy the per-bucket issue sequence;
    ``paths`` names the bucket's leaves. Returns ``(own_row_sum, e1)``
    where ``e1`` (int8 wire only, else None) is this replica's
    quantization error ``c − D(Q(c))`` in the ``(n, C)`` layout — the
    error-feedback carry."""
    del paths
    n, c = mat.shape
    if wire == torch.int8:
        rows = F.pad(mat, (0, (-c) % block_size))
        q, scales = quantize_blockwise(rows.reshape(-1), block_size)
        coll._record(RS_KIND, mat.numel(), torch.float32,
                     wire_dtype=torch.int8,
                     overhead_bytes=scales.numel() * SCALE_BYTES)
        # Row p of every replica routes to replica p — the scatter phase.
        qx, sx = coll._all_to_all(q, runtime), coll._all_to_all(scales,
                                                                runtime)
        own = coll._sum_dequantized(qx, sx, n, block_size)[:c]
        e1 = coll._add_dequantized(rows.reshape(-1), q, scales, block_size,
                                   -1.0).view(n, -1)[:, :c]
        return own, e1
    flat = mat.reshape(-1)
    if wire is not None and wire != flat.dtype:
        # A narrow float wire and narrow adds (collectives.reduce_scatter's
        # bf16 contract).
        coll._record(RS_KIND, flat.numel(), flat.dtype, wire_dtype=wire)
        own = coll._reduce_scatter(flat.to(wire), runtime)
        return own.float(), None
    coll._record(RS_KIND, flat.numel(), flat.dtype)
    return coll._reduce_scatter(flat, runtime), None


def _all_gather_bucket(vec: torch.Tensor, runtime, *, wire,
                       block_size: int,
                       paths: tuple[str, ...]) -> torch.Tensor:
    """All-gather ONE bucket's ``(C,)`` shard → ``(n, C)`` rows. A lossy
    wire is replica-identical: every replica dequantizes the same
    payload."""
    del paths
    full = coll.all_gather(vec, runtime, axis=0, tiled=True,
                           wire_dtype=wire, block_size=block_size,
                           kind=AG_KIND)
    return full.view(-1, vec.shape[0])


def _scatter_leaves(bucket: tuple[LeafChunk, ...],
                    grads: Mapping[str, torch.Tensor], runtime, n: int, *,
                    wire, block_size: int,
                    residual: Mapping[str, torch.Tensor] | None
                    ) -> tuple[dict, dict]:
    """One bucket of :func:`bucketed_reduce_scatter`: its leaves' slices of
    the mean gradient and, with ``residual`` on the int8 wire, their new
    errors."""
    mats = []
    for lc in bucket:
        g = grads[lc.name].float()
        if residual is not None:
            g = g + residual[lc.name].float()
        mats.append(stack_rows(g, lc.chunk, n))
    mat = torch.cat(mats, dim=1) if len(mats) > 1 else mats[0]
    own, e1 = _reduce_scatter_bucket(
        mat, runtime, wire=wire, block_size=block_size,
        paths=tuple(lc.path for lc in bucket))
    mean_own = own / n
    shards, new_res = {}, {}
    off = 0
    for lc in bucket:
        shards[lc.name] = mean_own[off:off + lc.chunk]
        if e1 is not None and residual is not None:
            new_res[lc.name] = (e1[:, off:off + lc.chunk].reshape(-1)
                                [:lc.size].view_as(grads[lc.name]))
        off += lc.chunk
    return shards, new_res


def bucketed_reduce_scatter(plan: ZeroPlan, grads: Mapping[str, torch.Tensor],
                            runtime, *, wire_dtype=None,
                            block_size: int = DEFAULT_BLOCK_SIZE,
                            residual: Mapping[str, torch.Tensor] | None = None
                            ) -> tuple[dict, dict | None]:
    """Bucketed mean reduce-scatter of the gradients (leaf name →
    tensor), one :func:`_reduce_scatter_bucket` per bucket in plan order.
    Returns ``(shards, new_residual)``: ``shards`` maps each name to this
    replica's ``(chunk,)`` f32 slice of the MEAN gradient; the residual
    (int8 wire with ``residual`` given, else None) maps each name to the
    new error at the gradient's shape.

    Error feedback: ``residual`` is this replica's last-step error at
    parameter shape, added to the gradients before quantizing; summed
    over the replicas, the new error is what the scattered mean missed."""
    wire = coll._canon_wire(wire_dtype)
    use_ef = wire == torch.int8 and residual is not None
    shards: dict[str, torch.Tensor] = {}
    new_res: dict[str, torch.Tensor] = {}
    for bucket in plan.buckets:
        got, res = _scatter_leaves(bucket, grads, runtime, plan.n,
                                   wire=wire, block_size=block_size,
                                   residual=residual if use_ef else None)
        shards.update(got)
        new_res.update(res)
    return shards, (new_res if use_ef else None)


def _gather_leaves(bucket: tuple[LeafChunk, ...],
                   shards: Mapping[str, torch.Tensor], runtime, n: int, *,
                   wire, block_size: int) -> dict[str, torch.Tensor]:
    """One bucket of :func:`bucketed_all_gather`: its leaves whole,
    flattened to ``(size,)``."""
    vec = torch.cat([shards[lc.name].float().reshape(-1) for lc in bucket])
    rows = _all_gather_bucket(vec, runtime, wire=wire, block_size=block_size,
                              paths=tuple(lc.path for lc in bucket))
    if rows.shape[0] != n:
        raise AssertionError(f"gathered {rows.shape[0]} rows, plan has {n}")
    out = {}
    off = 0
    for lc in bucket:
        out[lc.name] = rows[:, off:off + lc.chunk].reshape(-1)[:lc.size]
        off += lc.chunk
    return out


def bucketed_all_gather(plan: ZeroPlan, shards: Mapping[str, torch.Tensor],
                        runtime, *, wire_dtype=None,
                        block_size: int = DEFAULT_BLOCK_SIZE
                        ) -> dict[str, torch.Tensor]:
    """Gather per-replica ``(chunk,)`` shards (name → tensor) back to
    whole leaves, flattened to ``(size,)``: one collective per bucket, in
    plan order."""
    wire = coll._canon_wire(wire_dtype)
    out: dict[str, torch.Tensor] = {}
    for bucket in plan.buckets:
        out.update(_gather_leaves(bucket, shards, runtime, plan.n,
                                  wire=wire, block_size=block_size))
    return out


def shard_global_norm(shards, runtime) -> torch.Tensor:
    """Global L2 norm of leaves that are disjoint per-replica shards: the
    square root of the psum of the local squared sums (padding adds
    exactly zero) — the full mean gradient's norm, which ZeRO never
    forms."""
    local = torch.stack(torch._foreach_norm(
        [x.float() for x in shards])).square().sum()
    return torch.sqrt(coll.psum(local, runtime))


# ------------------------------------------------------------ telemetry --
def plan_summary(plan: ZeroPlan, *, wire_dtype=None,
                 block_size: int = DEFAULT_BLOCK_SIZE) -> dict:
    """Static per-step wire estimate for the ``zero_update`` event, under
    the tally's byte convention (reduce-scatter: 1× input payload;
    all-gather: 1× output payload). ``overlap_frac_est`` is the
    structural bound — every bucket but the last issued has backward
    compute left to hide behind — and ``hidden_ms_est`` the hideable bytes
    at the nominal NVLink rate (an interpretation aid, not a measurement;
    the port does not overlap the collectives with the backward yet)."""
    wire = coll._canon_wire(wire_dtype)
    itemsize = 4 if wire is None else wire.itemsize
    rs_bytes = ag_bytes = 0
    for bucket in plan.buckets:
        c = sum(lc.chunk for lc in bucket)
        payload = plan.n * c
        if wire == torch.int8:
            padded = -(-c // block_size) * block_size
            scales = plan.n * (padded // block_size) * SCALE_BYTES
            rs_bytes += plan.n * padded + scales
            ag_bytes += plan.n * padded + scales
        else:
            rs_bytes += payload * itemsize
            ag_bytes += payload * itemsize
    b = plan.num_buckets
    overlap = (b - 1) / b if b else 0.0
    return {
        "buckets": b,
        "shards": plan.n,
        "shard_elements": plan.shard_elements(),
        "bucket_mb": round(plan.bucket_bytes / 2**20, 3),
        "wire": "float32" if wire is None else str(wire).split(".")[-1],
        "rs_wire_bytes": int(rs_bytes),
        "ag_wire_bytes": int(ag_bytes),
        "overlap_frac_est": round(overlap, 4),
        "hidden_ms_est": round(
            rs_bytes * overlap / NOMINAL_LINK_BYTES_PER_S * 1e3, 3),
    }


class ZeroUpdate:
    """The ZeRO step's state and collectives for one model over the
    data × fsdp ranks of ``runtime`` (every rank unless ``mesh.model``
    exceeds 1; see the module docstring). ``params`` maps each
    parameter's key to this rank's ``(chunk,)`` shard, the tensor the
    optimizer updates (so its slots are born at the shard's shape); the
    model's parameters stay whole and replicated. The shards hold memory
    only inside a step: they are cut anew at each one, and emptied after
    the gather."""

    def __init__(self, model: nn.Module, runtime, *, bucket_mb: float,
                 wire=None, block_size: int = DEFAULT_BLOCK_SIZE):
        self.runtime = runtime
        group = runtime.data_group
        self.n, self.row = group.size, group.index
        self.plan = build_plan(flax_layout(model), self.n, bucket_mb)
        self.wire = coll._canon_wire(wire)
        self.block_size = block_size
        self.chunks = {lc.name: lc.chunk for lc in self.plan.leaf_chunks}
        self.sizes = {lc.name: lc.size for lc in self.plan.leaf_chunks}
        self.params = {k: p.new_empty(0)
                       for k, p in model.named_parameters()}

    def _own(self, key: str, full: torch.Tensor) -> torch.Tensor:
        return local_shard(full, self.chunks[key], self.n, self.row)

    @torch.no_grad()
    def scatter_(self, model: nn.Module, residual=None
                 ) -> tuple[torch.Tensor, dict | None]:
        """The bucketed mean reduce-scatter of the model's gradients: each
        shard is re-cut from its whole parameter and given its slice of the
        mean gradient, and the whole gradients are dropped. Returns (the
        mean gradient's global norm, the new residual or None)."""
        grads = {k: p.grad for k, p in model.named_parameters()}
        shards, new_res = bucketed_reduce_scatter(
            self.plan, grads, self.runtime, wire_dtype=self.wire,
            block_size=self.block_size, residual=residual)
        for key, p in model.named_parameters():
            shard = self.params[key]
            shard.data = self._own(key, p.detach()).clone()
            shard.grad = shards[key]
            p.grad = None
        return (shard_global_norm(list(shards.values()), self.runtime),
                new_res)

    @torch.no_grad()
    def _gather_bucket_(self, bucket, named: dict) -> None:
        """Gather one bucket's update into every rank's whole parameters
        (the updated shards on the f32 wire, ``new − old`` on a lossy
        one) and empty its shards."""
        if self.wire is None:
            vals = {lc.name: self.params[lc.name] for lc in bucket}
        else:
            vals = {lc.name: self.params[lc.name]
                    - self._own(lc.name, named[lc.name].detach())
                    for lc in bucket}
        full = _gather_leaves(bucket, vals, self.runtime, self.n,
                              wire=self.wire, block_size=self.block_size)
        for lc in bucket:
            p = named[lc.name]
            if self.wire is None:
                p.copy_(full[lc.name].view_as(p))
            else:
                p.add_(full[lc.name].view_as(p))
            shard = self.params[lc.name]
            shard.grad = None
            shard.data = shard.new_empty(0)

    def finish_step_(self, model: nn.Module) -> None:
        """Gather the update into every rank's whole parameters, bucket by
        bucket."""
        named = dict(model.named_parameters())
        for bucket in self.plan.buckets:
            self._gather_bucket_(bucket, named)

    def bucket_params(self) -> list[dict[str, torch.Tensor]]:
        """The shards of each bucket, in the plan's order (the fused
        update's optimizers, one a bucket)."""
        return [{lc.name: self.params[lc.name] for lc in bucket}
                for bucket in self.plan.buckets]

    @torch.no_grad()
    def fused_walk_(self, model: nn.Module, optimizers, residual=None
                    ) -> tuple[torch.Tensor, dict | None]:
        """The fused update (module docstring): for each bucket in plan
        order its reduce-scatter, its shards' update by ``optimizers``'s
        optimizer of that bucket, its all-gather and the apply. Returns
        (the mean gradient's global norm, the new residual or None)."""
        named = dict(model.named_parameters())
        use_ef = self.wire == torch.int8 and residual is not None
        new_res: dict[str, torch.Tensor] = {}
        sq_sum = None
        for bucket, opt in zip(self.plan.buckets, optimizers.opts):
            shards, res = _scatter_leaves(
                bucket, {lc.name: named[lc.name].grad for lc in bucket},
                self.runtime, self.n, wire=self.wire,
                block_size=self.block_size,
                residual=residual if use_ef else None)
            new_res.update(res)
            for lc in bucket:
                shard = self.params[lc.name]
                shard.data = self._own(lc.name, named[lc.name].detach()
                                       ).clone()
                shard.grad = shards[lc.name]
                named[lc.name].grad = None
                sq = shard.grad.square().sum()
                sq_sum = sq if sq_sum is None else sq_sum + sq
            with profiling.annotate("optimizer_update"):
                opt.step(None)
            self._gather_bucket_(bucket, named)
        return (torch.sqrt(coll.psum(sq_sum, self.runtime)),
                new_res if use_ef else None)

    def global_state(self, state: dict, names: list[str]) -> dict:
        """``TrainState.state_dict()`` with the slots stacked over the
        ranks: ``(n, chunk)``, row i rank i's. Every rank calls it."""
        return {**state, "optimizer": map_slots(
            lambda t, k: coll._all_gather(t, self.runtime),
            state["optimizer"], names)}

    def local_state(self, state: dict, names: list[str]) -> dict:
        """This rank's row of the stacked slots (which must have this run's
        n rows: ckpt/reshard.py refolds others first)."""
        def row(t, key):
            if tuple(t.shape) != (self.n, self.chunks[key]):
                raise ValueError(
                    f"stacked slot of {key} has shape {tuple(t.shape)}, "
                    f"this run's ZeRO layout ({self.n}, {self.chunks[key]})")
            return t[self.row].clone()
        return {**state, "optimizer": map_slots(row, state["optimizer"],
                                                names)}
