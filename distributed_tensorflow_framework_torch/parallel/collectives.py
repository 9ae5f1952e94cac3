"""Named collectives over the ranks of a process group: the port's
counterpart of ``parallel/collectives.py``.

The JAX package places these inside ``shard_map`` over the mesh's data
axes; the port runs one process per GPU, so each function takes the
:class:`~distributed_tensorflow_framework_torch.core.mesh.MeshRuntime`
(``None``: a single process, where every collective is the identity) and
the mesh axes it spans, ``axes``: None for data × fsdp × expert (the JAX
package's ``batch_spec`` axes; every rank unless ``mesh.model`` exceeds 1, whose
ranks repeat the data-parallel step), or names such as ``"fsdp"`` for the
ranks along those axes that share this rank's other coordinates
(``MeshRuntime.axis_group``). The replica index over them is
:func:`linear_axis_index` (the data-parallel index for None). Each takes a
tensor or a nest of dicts, lists and tuples of tensors and returns the
same nest.

Wire formats (``parallel.collective_dtype``): ``bfloat16`` casts the
payload; ``int8`` runs the EQuARX block-scaled protocol of
parallel/quantization.py (per-block max-abs scales beside the int8
payload, f32 accumulation of the dequantized partials, the reduced chunk
requantized for the gather); :func:`allreduce_gradients_ef` adds the
error-feedback residual that carries the compression error into the next
step.

:func:`ppermute_shift` is ring attention's move (parallel/ring.py): a
differentiable ring shift along a line (``seq`` for the ring) on that
line's own process group. :func:`take_member` and :func:`from_member` are
the pipeline's ends (parallel/pipeline.py): the last stage's output
reaching every stage, its cotangent going back to that stage alone (JAX's
``shard_map(...)[-1]``), and the embedding's output entering stage 0,
whose cotangent every stage then receives (JAX's ``psum`` over ``pipe``
of a cotangent that only stage 0 holds).

The tally (:func:`tally`) records one entry per leaf under the JAX
package's kind names and byte conventions, each leaf padded as JAX pads
it, so one step's ``summary()`` is the dict JAX's gives for the same model
and replica count. The transport coalesces: the gradient reductions run
one collective per phase over a buffer that holds every leaf's padded
chunks side by side (row p of the buffer is what rank p owns). A chunk is
a whole number of quantization blocks, so no block straddles two leaves
and the numbers equal the per-leaf protocol's.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Iterator

import torch
import torch.nn.functional as F

from distributed_tensorflow_framework_torch.parallel.quantization import (
    DEFAULT_BLOCK_SIZE,
    SCALE_BYTES,
    dequantize_blockwise,
    quantize_blockwise,
)

log = logging.getLogger(__name__)

# The tally's grand-total fields.
TALLY_TOTAL_FIELDS = ("total_bytes", "total_logical_bytes")


class CollectiveTally:
    """Per-collective call and byte counters, recorded as each wrapper
    runs inside :func:`tally`.

    Byte convention (the JAX package's): per-rank bytes crossing the
    links, the topology's ``(n-1)/n`` ring factor dropped:

      * all-reduce (psum/pmean): 2 × payload (reduce-scatter phase +
        all-gather phase of the ring algorithm);
      * reduce-scatter / all_to_all: 1 × input payload;
      * all-gather: 1 × OUTPUT payload (each rank receives n × its shard).

    ``wire`` bytes are at the collective's wire dtype plus any block-scale
    overhead; ``logical`` bytes are the same traffic at the operand's
    logical dtype — their ratio is the wire compression.
    """

    def __init__(self) -> None:
        self.calls: dict[str, int] = {}
        self.bytes: dict[str, int] = {}          # wire bytes
        self.logical_bytes: dict[str, int] = {}

    def record(self, kind: str, nbytes: int,
               logical_bytes: int | None = None) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.logical_bytes[kind] = self.logical_bytes.get(kind, 0) + int(
            nbytes if logical_bytes is None else logical_bytes)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    @property
    def total_logical_bytes(self) -> int:
        return sum(self.logical_bytes.values())

    def summary(self) -> dict[str, int]:
        """Flat dict for the telemetry event's ``collectives`` field.
        ``{kind}_logical_bytes`` appears only where a narrow wire made it
        differ from ``{kind}_bytes``."""
        out: dict[str, int] = {}
        for kind in sorted(self.calls):
            out[f"{kind}_calls"] = self.calls[kind]
            out[f"{kind}_bytes"] = self.bytes[kind]
            if self.logical_bytes[kind] != self.bytes[kind]:
                out[f"{kind}_logical_bytes"] = self.logical_bytes[kind]
        for field in TALLY_TOTAL_FIELDS:
            out[field] = getattr(self, field)
        return out


_TALLY_STACK: list[CollectiveTally] = []


@contextlib.contextmanager
def tally() -> Iterator[CollectiveTally]:
    """Collect the byte counters of every collective run inside."""
    t = CollectiveTally()
    _TALLY_STACK.append(t)
    try:
        yield t
    finally:
        _TALLY_STACK.remove(t)


def _record(kind: str, numel: int, dtype: torch.dtype, *,
            wire_dtype: torch.dtype | None = None,
            logical_dtype: torch.dtype | None = None, multiplier: int = 1,
            overhead_bytes: int = 0) -> None:
    """Tally one collective over a leaf of ``numel`` elements of
    ``dtype`` (the operand JAX's wrapper records). ``multiplier`` carries
    the convention factor (2 for all-reduce, n for all-gather's output);
    ``overhead_bytes`` the f32 scales of a block-scaled wire. The wire
    dtype is ``wire_dtype``, else ``dtype``; the logical one
    ``logical_dtype``, else ``dtype``."""
    if not _TALLY_STACK:
        return
    ldt = dtype if logical_dtype is None else logical_dtype
    wdt = dtype if wire_dtype is None else wire_dtype
    logical = int(numel) * ldt.itemsize * multiplier
    wire = int(numel) * wdt.itemsize * multiplier + overhead_bytes
    for t in _TALLY_STACK:
        t.record(kind, wire, logical)


# The wires of ``parallel.collective_dtype``.
_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


def _canon_wire(wire_dtype: Any) -> torch.dtype | None:
    """None/"" → None, else the torch dtype of a wire's name or dtype."""
    if wire_dtype is None or wire_dtype == "":
        return None
    if wire_dtype in _WIRE_DTYPES.values():
        return wire_dtype
    if wire_dtype in _WIRE_DTYPES:
        return _WIRE_DTYPES[wire_dtype]
    raise ValueError(f"unknown collective wire dtype {wire_dtype!r} (one "
                     f"of {sorted(_WIRE_DTYPES)})")


# ------------------------------------------------------------ the nests --

def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"a collective takes tensors and dicts, lists and "
                    f"tuples of them, not {type(tree).__name__}")


def _rebuild(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return type(tree)((k, _rebuild(v, leaves)) for k, v in tree.items())
    return type(tree)(_rebuild(v, leaves) for v in tree)


def _like(tree: Any, leaves: list[torch.Tensor]) -> Any:
    """``leaves`` in the nest of ``tree``."""
    return _rebuild(tree, iter(leaves))


# -------------------------------------------------------------- the group --

def _group(runtime, axes=None):
    """The ``AxisGroup`` of ``axes`` (data × fsdp × expert for None); None without
    a runtime."""
    if runtime is None:
        return None
    return runtime.data_group if axes is None else runtime.axis_group(axes)


def _size(runtime, axes=None) -> int:
    g = _group(runtime, axes)
    return 1 if g is None else g.size


def linear_axis_index(runtime, axes=None) -> int:
    """This replica's linear index over ``axes`` (first axis major; the
    data-parallel index for None); 0 without a group."""
    g = _group(runtime, axes)
    return 0 if g is None else g.index


def _all_reduce(flat: torch.Tensor, runtime, axes=None) -> torch.Tensor:
    return flat if runtime is None else runtime.all_reduce_(
        flat, _group(runtime, axes))


def _all_to_all(x: torch.Tensor, runtime, axes=None) -> torch.Tensor:
    return x if runtime is None else runtime.all_to_all_(
        torch.empty_like(x), x, _group(runtime, axes))


def _all_gather(x: torch.Tensor, runtime, axes=None) -> torch.Tensor:
    """Every member's flat ``x``, stacked: (n, x.numel())."""
    x = x.reshape(-1)
    if runtime is None:
        return x[None]
    g = _group(runtime, axes)
    out = x.new_empty((g.size * x.numel(),))
    return runtime.all_gather_(out, x, g).view(g.size, -1)


def _reduce_scatter(x: torch.Tensor, runtime, axes=None) -> torch.Tensor:
    """Sum of ``x`` over the members, this member's chunk of dim 0."""
    if runtime is None:
        return x
    g = _group(runtime, axes)
    out = x.new_empty((x.shape[0] // g.size,) + x.shape[1:])
    return runtime.reduce_scatter_(out, x.contiguous(), g)


def _reduce_leaves(leaves: list[torch.Tensor], runtime, *, mean: bool,
                   axes=None) -> list[torch.Tensor]:
    """psum (or pmean) of every leaf: one ``all_reduce`` per dtype over
    the leaves laid end to end."""
    n = _size(runtime, axes)
    out: list[torch.Tensor | None] = [None] * len(leaves)
    groups: dict[tuple, list[int]] = {}
    for i, t in enumerate(leaves):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = _all_reduce(flat, runtime, axes)
        if mean:
            flat = flat / n
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return out


class _Chunks:
    """The coalesced layout of a list of leaves: each flattened, padded
    with zeros to a multiple of ``unit`` (a multiple of n), cut into n
    equal chunks of ``c_i`` elements and set side by side, so that row p
    of the (n, Σc_i) buffer holds every leaf's chunk p — JAX's per-leaf
    ``reshape(n, chunk)`` rows, concatenated."""

    def __init__(self, leaves: list[torch.Tensor], n: int, unit: int):
        self.n = n
        self.shapes = [t.shape for t in leaves]
        self.sizes = [t.numel() for t in leaves]
        self.chunks = [-(-s // unit) * unit // n for s in self.sizes]

    def pack(self, flats: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat([
            (F.pad(f, (0, self.n * c - s)) if self.n * c != s else f
             ).view(self.n, c)
            for f, s, c in zip(flats, self.sizes, self.chunks)], dim=1)

    def unpack(self, rows: torch.Tensor) -> list[torch.Tensor]:
        out, off = [], 0
        for shape, s, c in zip(self.shapes, self.sizes, self.chunks):
            out.append(rows[:, off:off + c].reshape(-1)[:s].view(shape))
            off += c
        return out


def _add_dequantized(acc: torch.Tensor, q: torch.Tensor,
                     scales: torch.Tensor, block_size: int,
                     sign: float = 1.0) -> torch.Tensor:
    """``acc + sign·D(q, s)`` rounded once to f32: a fused multiply-add,
    as XLA fuses the JAX package's dequantize multiply into the add that
    follows it. Computed in f64, where the product of an int8 and an f32
    is exact, so the result is the same on every device and is the fused
    one wherever the f64 sum is exact too: always for the local error
    (``|c − D(Q(c))|`` is at most half a quantum) and for partials within
    2^21 of each other."""
    out = torch.addcmul(acc.double().view(-1, block_size),
                        q.view(-1, block_size).double(),
                        scales.view(-1, 1).double(), value=sign)
    return out.float().view(acc.shape)


def _sum_dequantized(q: torch.Tensor, scales: torch.Tensor, n: int,
                     block_size: int) -> torch.Tensor:
    """Σ over the n rows of ``D(q_i, s_i)`` in row order, each row's
    dequantize fused into the running sum (:func:`_add_dequantized`): the
    arithmetic XLA compiles JAX's ``partials.sum(axis=0)`` into."""
    rows = q.view(n, -1)
    s = scales.view(n, -1)
    acc = dequantize_blockwise(rows[0], s[0], block_size)
    for i in range(1, n):
        acc = _add_dequantized(acc, rows[i], s[i], block_size)
    return acc


# ------------------------------------------------------------ all-reduce --

def allreduce_gradients(grads: Any, runtime, *, compute_dtype: Any = None,
                        accumulate_f32: bool = True,
                        block_size: int = DEFAULT_BLOCK_SIZE,
                        axes=None) -> Any:
    """Mean-reduce gradients across the data-parallel ranks.

    No ``compute_dtype``: the f32 mean (``pmean``). A narrow
    ``compute_dtype`` (bfloat16) with ``accumulate_f32=True``:
    reduce-scatter in f32 (exact adds), divide by n, cast the reduced
    chunk to the wire dtype and all-gather it — 6/8 of an f32 all-reduce's
    bytes, one rounding of the mean. With ``accumulate_f32=False``: a
    ``pmean`` in the narrow dtype itself — 4/8 of the bytes, the adds
    narrow too. ``int8`` runs :func:`allreduce_gradients_ef` without a
    residual (~2/8 of the bytes)."""
    wire = _canon_wire(compute_dtype)
    if wire == torch.int8:
        means, _ = allreduce_gradients_ef(grads, None, runtime,
                                          block_size=block_size, axes=axes)
        return means
    leaves = _leaves(grads)
    if wire is None:
        for g in leaves:
            _record("allreduce_grads_pmean", g.numel(), g.dtype,
                    multiplier=2)
        return _like(grads, _reduce_leaves(leaves, runtime, mean=True,
                                           axes=axes))
    if not accumulate_f32:
        for g in leaves:
            _record("allreduce_grads_pmean_narrow", g.numel(), g.dtype,
                    wire_dtype=wire, multiplier=2)
        means = _reduce_leaves([g.to(wire) for g in leaves], runtime,
                               mean=True, axes=axes)
        return _like(grads, [m.to(g.dtype) for m, g in zip(means, leaves)])
    n = _size(runtime, axes)
    layout = _Chunks(leaves, n, n)
    for s, c in zip(layout.sizes, layout.chunks):
        # Exact f32 adds on the scatter; the only lossy step is the
        # narrow representation of the already-reduced mean.
        _record("allreduce_grads_scatter_f32", n * c, torch.float32)
        _record("allreduce_grads_gather_narrow", c, wire,
                logical_dtype=torch.float32, multiplier=n)
    rows = layout.pack([g.float().reshape(-1) for g in leaves])
    shard = _reduce_scatter(rows.view(-1), runtime, axes) / n
    full = _all_gather(shard.to(wire), runtime, axes)
    return _like(grads, [m.to(g.dtype) for m, g in
                         zip(layout.unpack(full), leaves)])


def allreduce_gradients_ef(grads: Any, residuals: Any | None, runtime, *,
                           block_size: int = DEFAULT_BLOCK_SIZE, axes=None
                           ) -> tuple[Any, Any | None]:
    """Block-scaled int8 all-reduce-mean with error feedback.

    The EQuARX protocol, per leaf (coalesced over the leaves here):

      1. compensate: ``c = g + r`` (``r`` is this rank's residual);
      2. quantize ``c`` blockwise, int8 payload + f32 scales;
      3. scatter: one ``all_to_all`` routes chunk p of every rank to rank
         p (int8 on the wire);
      4. accumulate the dequantized partials in f32, divide by n;
      5. requantize the reduced chunk and ``all_gather`` it (int8 wire);
      6. dequantize every chunk — every rank holds the same ``D(Q(m))``.

    The new residual carries both lossy steps: ``r' = e1 + n·e2`` on the
    rank's own chunk, where ``e1 = c − D(Q(c))`` and ``e2 = m − D(Q(m))``;
    summed over the ranks, ``mean(r') = true mean − D(Q(m))``, what this
    step's update missed. ``residuals=None`` gives the single-shot mean and
    None. Returns (means, new residuals in f32), in the nests given."""
    leaves = _leaves(grads)
    n, idx = _size(runtime, axes), linear_axis_index(runtime, axes)
    layout = _Chunks(leaves, n, n * block_size)
    flats = [g.float().reshape(-1) for g in leaves]
    if residuals is not None:
        flats = [f + r.float().reshape(-1)
                 for f, r in zip(flats, _leaves(residuals))]
    for c in layout.chunks:
        _record("allreduce_grads_q8_scatter", n * c, torch.int8,
                logical_dtype=torch.float32,
                overhead_bytes=n * (c // block_size) * SCALE_BYTES)
        _record("allreduce_grads_q8_gather", c, torch.int8,
                logical_dtype=torch.float32, multiplier=n,
                overhead_bytes=n * (c // block_size) * SCALE_BYTES)
    rows = layout.pack(flats).view(-1)
    q, scales = quantize_blockwise(rows, block_size)
    # Rank p receives row p of every rank: all the partials of chunk p.
    qx = _all_to_all(q, runtime, axes)
    sx = _all_to_all(scales, runtime, axes)
    mean_chunk = _sum_dequantized(qx, sx, n, block_size) / n
    q2, s2 = quantize_blockwise(mean_chunk, block_size)
    qg, sg = _all_gather(q2, runtime, axes), _all_gather(s2, runtime, axes)
    mean_full = dequantize_blockwise(qg.reshape(-1), sg.reshape(-1),
                                     block_size).view(n, -1)
    means = [m.to(g.dtype) for m, g in zip(layout.unpack(mean_full),
                                           leaves)]
    if residuals is None:
        return _like(grads, means), None
    # e1 everywhere, plus n·e2 on the chunk this rank reduced (the n
    # undoes next step's mean, so e2 is re-injected at full weight).
    e1 = _add_dequantized(rows, q, scales, block_size, -1.0).view(n, -1)
    # XLA leaves this one unfused: a product, then a difference.
    e2 = mean_chunk - dequantize_blockwise(q2, s2, block_size)
    e1[idx] = e1[idx] + n * e2
    return _like(grads, means), _like(residuals, layout.unpack(e1))


# -------------------------------------------------------- other wrappers --

def psum(x: Any, runtime, axes=None) -> Any:
    leaves = _leaves(x)
    for v in leaves:
        _record("psum", v.numel(), v.dtype, multiplier=2)
    return _like(x, _reduce_leaves(leaves, runtime, mean=False, axes=axes))


def pmean(x: Any, runtime, axes=None) -> Any:
    leaves = _leaves(x)
    for v in leaves:
        _record("pmean", v.numel(), v.dtype, multiplier=2)
    return _like(x, _reduce_leaves(leaves, runtime, mean=True, axes=axes))


class _Ppermute(torch.autograd.Function):
    """``lax.ppermute`` of a list of tensors by ``shift`` along the line
    along ``axis``, in one batch of sends and receives; its transpose sends
    the cotangents back by ``-shift``, also in one batch. Outputs of
    inputs that need no gradient are not differentiable."""

    @staticmethod
    def forward(ctx, runtime, shift, axis, *xs):
        ctx.runtime, ctx.shift, ctx.axis = runtime, shift, axis
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        outs = runtime.ppermute_([torch.empty_like(x) for x in xs],
                                 list(xs), shift, axis)
        need = ctx.needs_input_grad[3:]
        ctx.mark_non_differentiable(
            *(o for o, n in zip(outs, need) if not n))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        send = [torch.zeros(shape, dtype=dtype, device=device) if g is None
                else g for g, n, (shape, dtype, device)
                in zip(grads, need, ctx.like) if n]
        back = iter(ctx.runtime.ppermute_(
            [torch.empty_like(g) for g in send], send, -ctx.shift, ctx.axis)
            if send else [])
        return (None, None, None,
                *(next(back) if n else None for n in need))


def ppermute_shift(x: Any, runtime, shift: int = 1, axis: str = "seq") -> Any:
    """Ring shift along ``axis`` (``seq`` for ring attention): every leaf
    of ``x`` goes to the member ``(i + shift) mod n`` of this rank's line,
    in one batch of point-to-point operations on the line's own process
    group (``MeshRuntime.ppermute_``); differentiable, the cotangents
    travelling back by ``-shift``. The identity without a runtime.
    Tallies ``"ppermute"`` per leaf, as the JAX wrapper does, at each
    forward call (a remat recompute calls it again)."""
    leaves = _leaves(x)
    for v in leaves:
        _record("ppermute", v.numel(), v.dtype)
    if runtime is None:
        return x
    return _like(x, list(_Ppermute.apply(runtime, shift, axis, *leaves)))


class _TakeMember(torch.autograd.Function):
    """Member ``member``'s ``x`` on every member of the line along
    ``axis`` (a broadcast on the line's own group); the cotangent goes to
    that member alone, each member's being the same one (the ranks along
    the line compute what follows identically)."""

    @staticmethod
    def forward(ctx, runtime, axis, member, x):
        ctx.mine = runtime.line_group(axis).index == member
        return runtime.line_broadcast_(x.detach().clone(), axis, member)

    @staticmethod
    def backward(ctx, grad):
        return None, None, None, grad if ctx.mine else torch.zeros_like(grad)


class _FromMember(torch.autograd.Function):
    """The identity on a value every member of the line along ``axis``
    holds alike, whose cotangent only member ``member`` holds: the
    backward broadcasts that member's cotangent to the others."""

    @staticmethod
    def forward(ctx, runtime, axis, member, x):
        ctx.runtime, ctx.axis, ctx.member = runtime, axis, member
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, None, None, ctx.runtime.line_broadcast_(
            grad.contiguous().clone(), ctx.axis, ctx.member)


def take_member(x: torch.Tensor, runtime, axis: str,
                member: int) -> torch.Tensor:
    """Member ``member``'s ``x`` along ``axis``, on every member:
    differentiable, the cotangent reaching member ``member`` alone (the
    JAX package's ``mapped(...)[-1]`` over a stacked ``pipe`` output). The
    identity without a runtime."""
    if runtime is None:
        return x
    return _TakeMember.apply(runtime, axis, member, x)


def from_member(x: torch.Tensor, runtime, axis: str,
                member: int) -> torch.Tensor:
    """``x`` itself (the same on every member along ``axis``), whose
    cotangent is member ``member``'s on every member: the mirror of
    :func:`take_member` (the JAX package's ``psum`` over ``pipe`` of a
    cotangent only stage 0 holds). The identity without a runtime."""
    if runtime is None:
        return x
    return _FromMember.apply(runtime, axis, member, x)


def all_gather(x: torch.Tensor, runtime, *, axis: int = 0,
               tiled: bool = True, wire_dtype: Any = None,
               block_size: int = DEFAULT_BLOCK_SIZE,
               kind: str = "all_gather", axes=None) -> torch.Tensor:
    """All-gather along ``axis`` with an optional narrow wire: ``bfloat16``
    casts the payload (lossy for f32 operands), ``int8`` ships
    block-scaled int8 and dequantizes on arrival. ``tiled`` concatenates
    the ranks' tensors along ``axis``; otherwise they are stacked on a new
    ``axis``."""
    wire = _canon_wire(wire_dtype)
    n = _size(runtime, axes)
    if wire is None or wire == x.dtype:
        _record(kind, x.numel(), x.dtype, multiplier=n)
        stacked = _all_gather(x, runtime, axes)
    elif wire != torch.int8:
        _record(kind, x.numel(), x.dtype, wire_dtype=wire, multiplier=n)
        stacked = _all_gather(x.to(wire), runtime, axes).to(x.dtype)
    else:
        flat = x.float().reshape(-1)
        flat = F.pad(flat, (0, (-flat.numel()) % block_size))
        q, scales = quantize_blockwise(flat, block_size)
        _record(kind, x.numel(), x.dtype, wire_dtype=torch.int8,
                multiplier=n,
                overhead_bytes=n * scales.numel() * SCALE_BYTES)
        qg = _all_gather(q, runtime, axes)
        sg = _all_gather(scales, runtime, axes)
        deq = dequantize_blockwise(qg.reshape(-1), sg.reshape(-1),
                                   block_size).view(n, -1)
        stacked = deq[:, :x.numel()].to(x.dtype)
    stacked = stacked.reshape((n,) + tuple(x.shape))
    moved = stacked.movedim(0, axis)
    if not tiled:
        return moved
    shape = list(x.shape)
    shape[axis] = n * x.shape[axis]
    return moved.reshape(shape)


def reduce_scatter(x: torch.Tensor, runtime, *, scatter_axis: int = 0,
                   wire_dtype: Any = None,
                   block_size: int = DEFAULT_BLOCK_SIZE,
                   kind: str = "reduce_scatter", axes=None) -> torch.Tensor:
    """Reduce-scatter (sum) along ``scatter_axis`` with an optional narrow
    wire. ``bfloat16`` narrows the wire and the adds; ``int8`` quantizes
    each destination's chunk on its own (its scales travel with it), routes
    the chunks with one ``all_to_all`` and adds the dequantized partials
    in f32."""
    wire = _canon_wire(wire_dtype)
    n = _size(runtime, axes)
    if x.shape[scatter_axis] % n:
        raise ValueError(
            f"reduce_scatter axis {scatter_axis} of shape {tuple(x.shape)} "
            f"does not divide the axis size {n}")
    moved = x.movedim(scatter_axis, 0).contiguous()
    if wire is None or wire == x.dtype:
        _record(kind, x.numel(), x.dtype)
        out = _reduce_scatter(moved, runtime, axes)
    elif wire != torch.int8:
        _record(kind, x.numel(), x.dtype, wire_dtype=wire)
        out = _reduce_scatter(moved.to(wire), runtime, axes).to(x.dtype)
    else:
        rows = moved.float().reshape(n, -1)      # row p: rank p's chunk
        rows = F.pad(rows, (0, (-rows.shape[1]) % block_size))
        q, scales = quantize_blockwise(rows.reshape(-1), block_size)
        _record(kind, x.numel(), x.dtype, wire_dtype=torch.int8,
                overhead_bytes=scales.numel() * SCALE_BYTES)
        qx = _all_to_all(q, runtime, axes)
        sx = _all_to_all(scales, runtime, axes)
        summed = _sum_dequantized(qx, sx, n, block_size)[
            :moved.numel() // n]
        out = summed.view((moved.shape[0] // n,) + moved.shape[1:]).to(
            x.dtype)
    return out.movedim(0, scatter_axis)
