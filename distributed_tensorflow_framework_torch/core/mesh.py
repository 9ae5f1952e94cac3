"""The data-parallel runtime across ranks: the port's counterpart of
``core/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` over every device of the
gang and lets XLA insert the collectives. The port runs one process per
GPU (the JAX package: one per host) and a ``torch.distributed`` group
stands in for the mesh:

  * with the gang environment of ``core/cluster.py`` set
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``), :func:`initialize_runtime` pins the rank to GPU
    ``rank % device_count`` and calls ``init_process_group`` at
    ``tcp://<coordinator>`` with that world size and rank: the backend
    :func:`pick_backend` gives (NCCL when every rank has a GPU of its own,
    gloo on the CPU and when ranks share a card, which NCCL refuses), or
    the ``backend`` the caller names;
  * without it no group is formed; the world is 1 and the run is the
    single-device path.

The mesh's sizes resolve as in the JAX package (one axis may be -1, the
product must equal the world size, else :class:`MeshSizeError`, which
``cli/train.py`` maps to rc 84); every axis of ``MESH_AXES`` may exceed 1.
Rank r sits at the coordinates of r in the row-major order of
``MESH_AXES`` (``data`` outermost, ``model`` innermost, so the ranks of
one tensor-parallel group are adjacent, as Megatron places them):
``r = ((((data_idx · fsdp + fsdp_idx) · expert + expert_idx) · pipe +
pipe_idx) · seq + seq_idx) · model + model_idx``. The batch is split
over ``DATA_AXES`` (data × fsdp × expert, the JAX package's
``batch_spec``), and the data-parallel index ``(data_idx · fsdp +
fsdp_idx) · expert + expert_idx`` is what JAX's
``linear_axis_index(("data", "fsdp", "expert"))`` gives. The ranks along
``pipe``, ``seq`` and ``model`` share a data-parallel index: they read
the same batch and draw the same dropout masks
(:attr:`MeshRuntime.data_group`); the ranks along ``seq`` then keep their
own part of each row (parallel/ring.py).

Ring attention moves K/V chunks between the ranks along ``seq``, the
pipeline moves activations and their gradients between the stages along
``pipe``, and the MoE dispatch exchanges expert buffers between the ranks
along ``expert`` (parallel/expert.py), each on a process group of its
line's own (:meth:`MeshRuntime.line_group`; :attr:`MeshRuntime.seq_group`,
:attr:`MeshRuntime.pipe_group`, :attr:`MeshRuntime.expert_group`), formed
for that line alone even where it spans every rank, so that no other
collective (DDP's bucketed all-reduces fire from autograd hooks while the
ring's, the pipeline's or the dispatch's backward sends) ever shares it;
the pipeline's broadcasts from one stage (:meth:`MeshRuntime.line_broadcast_`)
take the same group. The MoE router's balance statistics are summed over
the ranks that hold tokens of the global batch inside the forward and the
backward as well, so the line along ``DATA_AXES`` has a group of its own
too (:attr:`MeshRuntime.router_group`), and so has the line along
``TOKEN_AXES`` (data × fsdp × expert × seq) when ``seq`` exceeds 1, which
the statistics span under sequence parallelism
(:meth:`MeshRuntime.token_group`); the MoE layers' per-row slot counts
travel along ``seq`` on the ring's group, in the same order on every
rank. NCCL, and gloo on CPU tensors, send
and receive natively (``batch_isend_irecv``, both directions in one
batch); gloo's ``send`` and ``recv`` take a tensor's raw pointer without
checking its device, so CUDA tensors there go through the host
(:meth:`p2p_transport`), packed into one pinned buffer each way.

:class:`MeshRuntime` carries the collectives the port uses across ranks:
``all_reduce``, ``broadcast`` and, for the explicit collectives of
parallel/collectives.py, ``all_to_all``, ``all_gather`` and
``reduce_scatter``. All but ``broadcast`` act on every rank, or on an
:class:`AxisGroup`: the ranks along some mesh axes that share this
rank's other coordinates (:meth:`MeshRuntime.axis_group`; explicit FSDP
gathers over ``fsdp`` alone, tensor parallelism reduces over ``model``,
while ZeRO, the gradient reduction, the loss weight and the metrics span
data × fsdp × expert, ``DATA_AXES``). The subgroups are formed by every rank at the
same point: in :func:`initialize_runtime`, or in
:meth:`MeshRuntime.remesh` for another mesh over the same ranks. NCCL,
and gloo on CPU tensors, run
``all_to_all``, ``all_gather`` and ``reduce_scatter`` as the native ops
(``all_to_all_single``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``). Gloo carries only ``all_reduce`` and
``broadcast`` on CUDA tensors, which is how two ranks share one card
(NCCL refuses two ranks on one device), so there the three are built
from ``all_reduce`` over the same group: each rank writes its bytes into
its own slot of a zero-filled buffer viewed as int32, and the integer
sum, every other slot being zero, carries them exactly (a float sum
would turn −0.0 into +0.0); the reduce-scatter is an ``all_reduce`` of
the whole input, of which a rank keeps its chunk. The transport is chosen
by backend and device only (:meth:`MeshRuntime.collective_transport`);
NCCL never takes the second.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import os
from typing import Any, Mapping

import torch
import torch.distributed as dist

from distributed_tensorflow_framework_torch.core import cluster
from distributed_tensorflow_framework_torch.core.config import MeshConfig
from distributed_tensorflow_framework_torch.core.device import resolve_device

log = logging.getLogger(__name__)

MESH_AXES = ("data", "fsdp", "expert", "pipe", "seq", "model")
# The axes a batch is split over and the (non-expert) gradients are
# reduced over: the JAX package's ``batch_spec`` (core/mesh.py).
DATA_AXES = ("data", "fsdp", "expert")
# The ranks that hold tokens of the global batch under sequence
# parallelism: each data-parallel rank's rows are split over ``seq``.
TOKEN_AXES = DATA_AXES + ("seq",)
# The lines that get a process group of their own (see the module
# docstring): one axis each, and the data-parallel line; and the token
# line when ``seq`` exceeds 1 (else it is the data-parallel one).
LINE_AXES = (("expert",), ("pipe",), ("seq",), DATA_AXES)


class MeshSizeError(ValueError):
    """The configured mesh does not fit the gang's ranks. Typed so that
    ``cli/train.py`` can exit with the elastic rc 84."""

    def __init__(self, sizes: dict[str, int], needed: int, available: int):
        self.sizes = dict(sizes)
        self.needed = int(needed)
        self.available = int(available)
        super().__init__(f"Mesh {self.sizes} needs {self.needed} devices but "
                         f"{self.available} are available")


def _resolve_axis_sizes(config: MeshConfig, n: int) -> dict[str, int]:
    """Fill the single -1 axis and validate the product against n."""
    sizes = config.axis_sizes()
    fixed = {k: v for k, v in sizes.items() if v != -1}
    fixed_prod = math.prod(fixed.values())
    free = [k for k, v in sizes.items() if v == -1]
    if len(free) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {free}")
    if free:
        if n % fixed_prod:
            raise MeshSizeError(sizes, fixed_prod, n)
        sizes[free[0]] = n // fixed_prod
    total = math.prod(sizes.values())
    if total != n:
        raise MeshSizeError(sizes, total, n)
    return sizes


def resolve_mesh(config: MeshConfig, world: int) -> dict[str, int]:
    """The mesh's axis sizes at ``world`` ranks; MeshSizeError when they
    do not fit the ranks."""
    return _resolve_axis_sizes(config, world)


def gang_from_env(environ: Mapping[str, str] | None = None
                  ) -> tuple[str, int, int] | None:
    """(coordinator, world size, rank) from the gang environment, or None
    when it is not set (a single process)."""
    env = os.environ if environ is None else environ
    coord = env.get(cluster.ENV_COORDINATOR)
    count = env.get(cluster.ENV_NUM_PROCESSES)
    if not (coord and count):
        return None
    try:
        world, rank = int(count), int(env.get(cluster.ENV_PROCESS_ID) or 0)
    except ValueError as e:
        raise cluster.ClusterSpecError(
            f"malformed gang environment: {cluster.ENV_NUM_PROCESSES}="
            f"{count!r}, {cluster.ENV_PROCESS_ID}="
            f"{env.get(cluster.ENV_PROCESS_ID)!r}") from e
    if world < 1 or not 0 <= rank < world:
        raise cluster.ClusterSpecError(
            f"rank {rank} outside a gang of {world}")
    return coord, world, rank


def pick_backend(device: str | torch.device, world: int) -> str:
    """The process group's backend for ``world`` ranks on ``device``:
    NCCL when each rank has a GPU of its own, gloo on the CPU and when
    the ranks outnumber the visible GPUs (NCCL refuses two ranks on one
    device, gloo carries them through the host)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "gloo" if world > torch.cuda.device_count() else "nccl"


def max_over_ranks(value: int) -> int:
    """The largest ``value`` over the ranks of the default process group,
    which must exist."""
    if not dist.is_initialized():
        raise RuntimeError("max_over_ranks needs the process group that "
                           "initialize_runtime forms from the gang "
                           "environment")
    # NCCL reduces device tensors only; gloo takes host ones.
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    value = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.all_reduce(value, op=dist.ReduceOp.MAX)
    return int(value)


TRANSPORT_NATIVE = "native"
TRANSPORT_ALL_REDUCE = "all_reduce"
TRANSPORT_HOST = "host"


def _byte_rows(rows: int, nbytes: int, device) -> torch.Tensor:
    """A zero (rows, words) int32 buffer with room for ``nbytes`` bytes a
    row."""
    return torch.zeros((rows, -(-nbytes // 4)), dtype=torch.int32,
                       device=device)


def _bytes_of(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.contiguous().view(-1).view(torch.uint8)


def all_gather_by_all_reduce(output: torch.Tensor, input: torch.Tensor,
                             group: "AxisGroup") -> torch.Tensor:
    """``all_gather_`` from one ``all_reduce`` over ``group``: member i's
    bytes in slot i of a zero-filled int32 buffer, summed over the members
    (exact: every other slot is zero)."""
    n, src = group.size, _bytes_of(input)
    buf = _byte_rows(n, src.numel(), input.device)
    buf[group.index].view(torch.uint8)[:src.numel()].copy_(src)
    dist.all_reduce(buf, group=group.group)
    _bytes_of(output).view(n, -1).copy_(
        buf.view(torch.uint8).view(n, -1)[:, :src.numel()])
    return output


def all_to_all_by_all_reduce(output: torch.Tensor, input: torch.Tensor,
                             group: "AxisGroup") -> torch.Tensor:
    """``all_to_all_`` from one ``all_reduce`` over ``group``'s (n
    senders, n receivers) grid of zero-filled int32 slots: member r fills
    row r, and member p reads column p."""
    n, rank = group.size, group.index
    src = _bytes_of(input).view(n, -1)
    chunk = src.shape[1]
    buf = _byte_rows(n * n, chunk, input.device).view(n, n, -1)
    buf[rank].view(torch.uint8).view(n, -1)[:, :chunk].copy_(src)
    dist.all_reduce(buf, group=group.group)
    _bytes_of(output).view(n, -1).copy_(
        buf[:, rank].contiguous().view(torch.uint8).view(n, -1)[:, :chunk])
    return output


def reduce_scatter_by_all_reduce(output: torch.Tensor, input: torch.Tensor,
                                 group: "AxisGroup") -> torch.Tensor:
    """``reduce_scatter_`` from one ``all_reduce`` over ``group`` of the
    whole input, of which member r keeps chunk r."""
    total = input.clone()
    dist.all_reduce(total, group=group.group)
    return output.copy_(total.chunk(group.size)[group.index])


def _pack_bytes(tensors: list[torch.Tensor]
                ) -> tuple[torch.Tensor, list[tuple[int, int]]]:
    """The tensors' bytes side by side in one uint8 tensor on their
    device, each starting at a 16-byte boundary; and each one's (offset,
    bytes)."""
    spans, offset = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        spans.append((offset, n))
        offset += -(-n // 16) * 16
    packed = torch.empty(offset, dtype=torch.uint8, device=tensors[0].device)
    for t, (o, n) in zip(tensors, spans):
        packed[o:o + n].copy_(_bytes_of(t.detach()))
    return packed, spans


def _unpack_bytes(packed: torch.Tensor, spans, like: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
    """The tensors of :func:`_pack_bytes`, each at its ``like``'s dtype
    and shape."""
    return [packed[o:o + n].view(t.dtype).view(t.shape)
            for (o, n), t in zip(spans, like)]


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks along ``axes`` that share this rank's coordinates on
    every other axis: how many (``size``), this rank's place among them
    (``index``, the linear index over ``axes``, first axis major) and the
    torch process group that joins them (None: the default group, which
    is every rank, or no group at all when ``size`` is 1)."""

    axes: tuple[str, ...]
    size: int
    index: int
    group: Any = None


def _coords(sizes: Mapping[str, int], rank: int) -> dict[str, int]:
    """Rank ``rank``'s coordinate on each axis, row-major over MESH_AXES."""
    out = {}
    for axis in reversed(MESH_AXES):
        rank, out[axis] = divmod(rank, sizes[axis])
    return out


def _rank_of(sizes: Mapping[str, int], coords: Mapping[str, int]) -> int:
    rank = 0
    for axis in MESH_AXES:
        rank = rank * sizes[axis] + coords[axis]
    return rank


def _canon_axes(axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for axis in axes:
        if axis not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {axis!r} (one of "
                             f"{MESH_AXES})")
    return tuple(a for a in MESH_AXES if a in axes)


def _subgroup_axes(sizes: Mapping[str, int]) -> list[tuple[str, ...]]:
    """Every proper, non-empty subset of the axes above 1, in a fixed
    order: the subgroups a runtime forms (the whole set is the default
    group)."""
    big = [a for a in MESH_AXES if sizes[a] > 1]
    return [combo for k in range(1, len(big))
            for combo in itertools.combinations(big, k)]


@dataclasses.dataclass
class MeshRuntime:
    """This process's view of the runtime. ``backend`` is the process
    group's (``"nccl"`` or ``"gloo"``), None when no group was formed.
    ``broadcast_`` acts on every rank; the other collectives on every rank
    or on the :class:`AxisGroup` they are given. ``all_reduce_`` and
    ``broadcast_`` do nothing at a world of 1, so the single-rank
    arithmetic stays today's; ``all_to_all_``, ``all_gather_`` and
    ``reduce_scatter_`` copy when no group was formed and run the
    collective in a group of any size, one rank included."""

    sizes: dict[str, int]
    process_index: int
    process_count: int
    device: torch.device
    backend: str | None = None
    # (axes, the other axes' coordinates) → the process group of that
    # subgroup, for the subgroups this rank belongs to
    # (:func:`initialize_runtime` forms them).
    subgroups: dict = dataclasses.field(default_factory=dict)
    # Axes of LINE_AXES → the own process group of this rank's line along
    # them (absent: no group, or the line is one rank).
    line_groups: dict = dataclasses.field(default_factory=dict)

    @property
    def is_chief(self) -> bool:
        """Rank 0: it writes checkpoints and logs (the reference's chief
        worker)."""
        return self.process_index == 0

    @property
    def data_parallel_size(self) -> int:
        return self.sizes["data"] * self.sizes["fsdp"] * self.sizes["expert"]

    @property
    def data_group(self) -> AxisGroup:
        """The ranks along ``DATA_AXES`` that share this rank's ``pipe``,
        ``seq`` and ``model`` coordinates: ``index`` is this rank's
        data-parallel index (which block of the global batch it reads,
        which dropout stream it draws), ``size`` the data-parallel count.
        At ``pipe``, ``seq`` and ``model`` 1 it is every rank, its index
        the rank."""
        return self.axis_group(DATA_AXES)

    def line_group(self, axes) -> AxisGroup:
        """The ranks along ``axes`` (a line of LINE_AXES: one axis name, or
        ``DATA_AXES``) that share this rank's other coordinates, on that
        line's own process group."""
        axes = _canon_axes(axes)
        group = self.axis_group(axes)
        return dataclasses.replace(group, group=self.line_groups.get(axes))

    @property
    def expert_group(self) -> AxisGroup:
        """This rank's ``expert`` line, on the MoE dispatch's own process
        group: ``index`` says which experts of each MoE layer it holds."""
        return self.line_group("expert")

    @property
    def router_group(self) -> AxisGroup:
        """This rank's data-parallel line (the ranks of
        :attr:`data_group`) on a process group of its own, for the MoE
        router's statistics."""
        return self.line_group(DATA_AXES)

    def token_group(self, seq_parallel: bool) -> AxisGroup:
        """The line of the ranks that hold tokens of the global batch, on
        a process group of its own, for the MoE router's statistics:
        :attr:`router_group` when the rows are whole, the line along
        ``TOKEN_AXES`` when ``seq_parallel`` splits them over ``seq``."""
        if seq_parallel and self.sizes["seq"] > 1:
            return self.line_group(TOKEN_AXES)
        return self.router_group

    @property
    def seq_group(self) -> AxisGroup:
        """This rank's ``seq`` line, on the ring's own process group:
        ``index`` is this rank's place in the ring (which part of each row
        it keeps)."""
        return self.line_group("seq")

    @property
    def pipe_group(self) -> AxisGroup:
        """This rank's ``pipe`` line, on the pipeline's own process group:
        ``index`` is this rank's stage."""
        return self.line_group("pipe")

    def member_rank(self, axis: str, index: int) -> int:
        """The global rank of member ``index`` of this rank's line along
        ``axis``."""
        coords = _coords(self.sizes, self.process_index)
        return _rank_of(self.sizes, {**coords, axis: index})

    def describe(self) -> str:
        return (f"rank {self.process_index}/{self.process_count} on "
                f"{self.device}, group {self.backend or 'none'}, mesh "
                f"{self.sizes}")

    @property
    def collective_device(self) -> torch.device:
        """Where a tensor made for a collective lives: NCCL reduces device
        tensors only, gloo takes host ones."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    @property
    def world_group(self) -> AxisGroup:
        """Every rank."""
        return AxisGroup(tuple(a for a in MESH_AXES if self.sizes[a] > 1),
                         self.process_count, self.process_index)

    def axis_group(self, axes) -> AxisGroup:
        """The ranks along ``axes`` (a name or names of MESH_AXES) that
        share this rank's other coordinates."""
        axes = _canon_axes(axes)
        size = math.prod(self.sizes[a] for a in axes)
        coords = _coords(self.sizes, self.process_index)
        index = 0
        for axis in axes:
            index = index * self.sizes[axis] + coords[axis]
        if size == self.process_count:
            return dataclasses.replace(self.world_group, axes=axes)
        if size == 1:
            return AxisGroup(axes, 1, 0)
        big = tuple(a for a in axes if self.sizes[a] > 1)
        key = (big, tuple(coords[a] for a in MESH_AXES if a not in big))
        return AxisGroup(axes, size, index, self.subgroups[key])

    def remesh(self, sizes: Mapping[str, int]) -> "MeshRuntime":
        """This runtime over the same ranks with the mesh ``sizes`` (whose
        product must be the world), its subgroups formed anew: every rank
        must call it at the same point, as ``new_group`` requires."""
        sizes = dict(sizes)
        if math.prod(sizes.values()) != self.process_count:
            raise MeshSizeError(sizes, math.prod(sizes.values()),
                                self.process_count)
        groups, lines = ({}, {}) if self.backend is None else (
            _form_subgroups(sizes, self.process_index),
            _form_line_groups(sizes, self.process_index))
        return dataclasses.replace(self, sizes=sizes, subgroups=groups,
                                   line_groups=lines)

    def _group(self, group: AxisGroup | None) -> AxisGroup:
        return self.world_group if group is None else group

    def all_reduce_(self, tensor: torch.Tensor,
                    group: AxisGroup | None = None) -> torch.Tensor:
        """Sum ``tensor`` over the ranks (of ``group``) in place; returns
        it."""
        g = self._group(group)
        if g.size > 1:
            dist.all_reduce(tensor, group=g.group)
        return tensor

    def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``tensor`` with rank ``src``'s in place; returns it."""
        if self.process_count > 1:
            dist.broadcast(tensor, src=src)
        return tensor

    def line_broadcast_(self, tensor: torch.Tensor, axis: str,
                        member: int) -> torch.Tensor:
        """Overwrite ``tensor`` with member ``member``'s of this rank's line
        along ``axis`` (``pipe`` or ``seq``), on the line's own process group,
        in place; returns it. Gloo and NCCL both broadcast CUDA tensors."""
        group = self.line_group(axis)
        if self.backend is not None and group.size > 1:
            dist.broadcast(tensor, src=self.member_rank(axis, member),
                           group=group.group)
        return tensor

    def collective_transport(self, device: torch.device | str) -> str:
        """How ``all_to_all_``, ``all_gather_`` and ``reduce_scatter_``
        move tensors on ``device``: ``"all_reduce"`` for gloo with CUDA
        tensors, else ``"native"`` (NCCL, gloo on the CPU, or no group)."""
        if self.backend == "gloo" and torch.device(device).type == "cuda":
            return TRANSPORT_ALL_REDUCE
        return TRANSPORT_NATIVE

    def p2p_transport(self, device: torch.device | str) -> str:
        """How ``ppermute_`` moves tensors on ``device``: ``"host"`` (a
        copy to the host and back) for gloo with CUDA tensors, else
        ``"native"``."""
        if self.backend == "gloo" and torch.device(device).type == "cuda":
            return TRANSPORT_HOST
        return TRANSPORT_NATIVE

    def ppermute_(self, outputs: list[torch.Tensor],
                  inputs: list[torch.Tensor], shift: int = 1,
                  axis: str = "seq") -> list[torch.Tensor]:
        """Send each of ``inputs`` to the member ``shift`` places on along
        this rank's line along ``axis`` (``pipe`` or ``seq``) and receive the
        member ``shift`` places back's into ``outputs`` (each at its
        input's shape): ``lax.ppermute`` with ``(j, j + shift mod n)``,
        every tensor in one ``batch_isend_irecv`` on the line's own process
        group. Returns ``outputs``."""
        group = self.line_group(axis)
        n, i = group.size, group.index
        if self.backend is None or n == 1 or shift % n == 0:
            for out, x in zip(outputs, inputs):
                out.copy_(x)
            return outputs
        dst = self.member_rank(axis, (i + shift) % n)
        src = self.member_rank(axis, (i - shift) % n)
        host = self.p2p_transport(inputs[0].device) == TRANSPORT_HOST
        if host:
            # One pinned host buffer each way: one copy off the card, one
            # send and one receive, one copy back.
            packed, spans = _pack_bytes(inputs)
            pinned = {"dtype": torch.uint8,
                      "pin_memory": torch.cuda.is_available()}
            sends = [torch.empty(packed.numel(), **pinned).copy_(packed)]
            recvs = [torch.empty(packed.numel(), **pinned)]
        else:
            sends = [x.detach().contiguous() for x in inputs]
            recvs = [torch.empty_like(x) for x in sends]
        ops = []
        for tag, (x, y) in enumerate(zip(sends, recvs)):
            ops.append(dist.P2POp(dist.isend, x, dst, group.group, tag))
            ops.append(dist.P2POp(dist.irecv, y, src, group.group, tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if host:
            recvs = _unpack_bytes(recvs[0].to(outputs[0].device), spans,
                                  inputs)
        for out, y in zip(outputs, recvs):
            out.copy_(y)
        return outputs

    def all_to_all_(self, output: torch.Tensor, input: torch.Tensor,
                    group: AxisGroup | None = None) -> torch.Tensor:
        """Split ``input`` into as many equal chunks along dim 0 as the
        group has members and send chunk p to member p; ``output``
        (input's shape) receives member r's chunk as its chunk r. Returns
        ``output``."""
        g = self._group(group)
        if self.backend is None or g.size == 1:
            return output.copy_(input)
        if self.collective_transport(input.device) == TRANSPORT_ALL_REDUCE:
            return all_to_all_by_all_reduce(output, input, g)
        dist.all_to_all_single(output, input.contiguous(), group=g.group)
        return output

    def all_gather_(self, output: torch.Tensor, input: torch.Tensor,
                    group: AxisGroup | None = None) -> torch.Tensor:
        """``output`` (the group's size × input's dim 0) becomes every
        member's ``input`` concatenated in member order. Returns it."""
        g = self._group(group)
        if self.backend is None or g.size == 1:
            return output.copy_(input)
        if self.collective_transport(input.device) == TRANSPORT_ALL_REDUCE:
            return all_gather_by_all_reduce(output, input, g)
        dist.all_gather_into_tensor(output, input.contiguous(),
                                    group=g.group)
        return output

    def reduce_scatter_(self, output: torch.Tensor, input: torch.Tensor,
                        group: AxisGroup | None = None) -> torch.Tensor:
        """Sum ``input`` over the group's members and give member r chunk
        r of the sum (along dim 0, one equal chunk per member) in
        ``output``. Returns it."""
        g = self._group(group)
        if self.backend is None or g.size == 1:
            return output.copy_(input)
        if self.collective_transport(input.device) == TRANSPORT_ALL_REDUCE:
            return reduce_scatter_by_all_reduce(output, input, g)
        dist.reduce_scatter_tensor(output, input.contiguous(), group=g.group)
        return output

    def broadcast_int(self, value: int | None, src: int = 0) -> int | None:
        """Rank ``src``'s value on every rank (None travels as -1)."""
        if self.process_count == 1:
            return value
        out = torch.tensor([-1 if value is None else int(value)],
                           dtype=torch.int64, device=self.collective_device)
        out = int(self.broadcast_(out, src))
        return None if out < 0 else out

    def shutdown(self) -> None:
        """Destroy the process group this runtime formed."""
        if self.backend is not None and dist.is_initialized():
            dist.destroy_process_group()
            self.backend = None


def _form_subgroups(sizes: Mapping[str, int], rank: int) -> dict:
    """Form every subgroup of :func:`_subgroup_axes` (each rank must call
    ``new_group`` for every group, in the same order) and keep those this
    rank belongs to, keyed as :meth:`MeshRuntime.axis_group` reads them."""
    mine = _coords(sizes, rank)
    out = {}
    for axes in _subgroup_axes(sizes):
        others = [a for a in MESH_AXES if a not in axes]
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            ranks = [_rank_of(sizes, {**dict(zip(others, fixed)),
                                      **dict(zip(axes, inner))})
                     for inner in itertools.product(
                         *(range(sizes[a]) for a in axes))]
            group = dist.new_group(ranks)
            if rank in ranks:
                out[(axes, fixed)] = group
    return out


def _form_line_groups(sizes: Mapping[str, int], rank: int) -> dict:
    """A process group for each line of LINE_AXES (and of TOKEN_AXES when
    ``seq`` exceeds 1) of more than one rank (every rank calls
    ``new_group`` for each, in the same order), used by that line's own
    collectives alone (the MoE dispatch's along ``expert``, the
    pipeline's along ``pipe``, the ring's and the MoE slot counts' along
    ``seq``, the MoE router's along ``DATA_AXES`` or ``TOKEN_AXES``);
    returns this rank's, by axes."""
    mine = {}
    for axes in LINE_AXES + ((TOKEN_AXES,) if sizes["seq"] > 1 else ()):
        if math.prod(sizes[a] for a in axes) == 1:
            continue
        others = [a for a in MESH_AXES if a not in axes]
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            ranks = [_rank_of(sizes, {**dict(zip(others, fixed)),
                                      **dict(zip(axes, inner))})
                     for inner in itertools.product(
                         *(range(sizes[a]) for a in axes))]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine[axes] = group
    return mine


def initialize_runtime(config: MeshConfig | None = None,
                       device: str | torch.device = "cuda",
                       backend: str | None = None, *,
                       environ: Mapping[str, str] | None = None
                       ) -> MeshRuntime:
    """Resolve the mesh against the gang and form the process group.
    ``backend`` overrides :func:`pick_backend` (gloo with CUDA tensors
    runs two ranks on one card). Raises MeshSizeError when the
    mesh does not fit the ranks, DeviceUnavailableError for CUDA without a
    card."""
    config = config or MeshConfig()
    gang = gang_from_env(environ)
    if gang is None:
        runtime = MeshRuntime(resolve_mesh(config, 1), 0, 1,
                              resolve_device(device))
    else:
        coord, world, rank = gang
        sizes = resolve_mesh(config, world)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            resolve_device(dev)  # raises without a card
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = resolve_device(dev)
        backend = backend or pick_backend(dev, world)
        if not dist.is_initialized():
            dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                    world_size=world, rank=rank)
        runtime = MeshRuntime(sizes, rank, world, dev, dist.get_backend(),
                              _form_subgroups(sizes, rank),
                              _form_line_groups(sizes, rank))
    log.info("Mesh runtime: %s", runtime.describe())
    return runtime
