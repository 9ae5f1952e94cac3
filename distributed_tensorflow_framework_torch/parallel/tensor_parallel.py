"""Megatron tensor parallelism over the mesh's ``model`` axis.

The JAX package writes no module for this: under ``train.spmd_mode: jit``
it gives the parameters the ``TP_RULES`` layout (parallel/sharding.py)
and GSPMD inserts every collective. The port runs one process per rank,
so it places them by hand, as Megatron does, in the layers the rules
split:

  * a column-parallel Dense (the fused ``qkv`` or ``query``/``key``/
    ``value``, ``mlp_in``): its weight is this rank's block of output
    features; its input passes through :func:`copy_to_group` (identity
    forward, all-reduce of the gradient backward), and its bias, which the
    rules leave whole and replicated, is sliced to the same features
    after a :func:`copy_to_group` of its own, so that the bias gradient,
    zero outside this rank's features, is summed whole on every rank;
  * a row-parallel Dense (``attn_out``, ``mlp_out``): its weight is this
    rank's block of input features, its partial product passes through
    :func:`reduce_from_group` (all-reduce forward, identity backward),
    and its bias is added once, after the reduction;
  * the embedding table (V, H), held as this rank's H-part (the JAX
    layout at rest): :func:`gather_from_group` gathers it whole over
    ``model`` once per forward, for the lookup and for the tied MLM
    projection, and the backward keeps this rank's slice of the table's
    gradient. GSPMD instead all-reduces the (B, S, V) partial logits;
    the gather is exact and moves V·H floats, not B·S·V.

The attention between the two projections runs on this rank's heads,
``[r·nh/m, (r+1)·nh/m)``, which are the columns the split of the (H, 3, H)
kernel's last dim gives rank r; it calls the same attention function, so
on the card the flash kernels see ``nh/m`` heads. When ``m`` does not
divide the heads (but divides H, so the rules still split the columns)
a rank's columns cut across a head: Q, K and V are gathered whole over
``model`` (:func:`gather_from_group`), every rank runs the attention on
every head, and keeps its columns of the context for the row-parallel
``attn_out`` (:func:`split_to_group`, whose backward gathers the
context's gradient whole, so that the attention's backward, and with it
the gradient that reaches the gather, is the same on every rank). GSPMD
reshards the same way.

A MoE layer's ``wi`` (E, H, F) is column-parallel and its ``wo`` (E, F,
H) row-parallel over F (the ``MOE_RULES``): the layer's ``tp`` is the
group, its expert buffers pass through :func:`copy_to_group` and its
expert outputs through :func:`reduce_from_group` (models/moe.py). Everything else (the
LayerNorms, ``pos_embedding``, the MLM head, the biases) is replicated
and computed on replicated activations, so its gradient is the same on
every rank of the group and no reduction over ``model`` is needed.

Why the slice backward of the gather is exact: the gathered table is used
only on replicated activations (the lookup of replicated ids, the
projection of the replicated hidden state with the replicated logits'
gradient), so the gradient that reaches the gather is identical on every
rank of the group, and this rank's slice of it is the gradient of its
part, with nothing to sum.

The dtype of the reductions. The lowered JAX step of a bf16 BERT at
``{data: 1, model: 2}`` (on the CPU devices) holds bf16 all-reduces of
the row-parallel dot outputs, of the column-parallel inputs' gradients
and of the partial logits, which the CPU backend's all-reduce promotion
runs in f32: each partial is rounded to bf16, the sum is taken in f32
and rounded to bf16 again. :meth:`Group.all_reduce` does the same: a bf16 (or
f16) tensor is summed in f32 and cast back; an f32 one is summed in f32.

The group is ``runtime.axis_group("model")``: NCCL, or gloo, whose
all-reduce carries CUDA tensors too (two ranks sharing one card), and
whose gather is then built from ``all_reduce``
(core/mesh.py ``all_gather_by_all_reduce``). There is no fallback: a
model whose group cannot be reached raises, and a model split over
``model`` never runs with whole weights.
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_tensorflow_framework_torch.models.convert import flax_layout
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from distributed_tensorflow_framework_torch.parallel.sharding import (
    PartLayout,
    infer_param_specs,
    tp_layout,
)
from distributed_tensorflow_framework_torch.train.optimizers import (
    global_norm,
)


class Group:
    """The ``model`` group of a runtime: the collectives the layers call."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.axis = runtime.axis_group("model")
        if self.axis.size <= 1 or runtime.backend is None:
            raise RuntimeError(
                f"tensor parallelism needs a process group over mesh.model "
                f"> 1 ranks; this runtime has model={self.axis.size} and "
                f"backend {runtime.backend!r}")

    @property
    def size(self) -> int:
        return self.axis.size

    @property
    def index(self) -> int:
        return self.axis.index

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, a new tensor of x's dtype: a narrow
        float is summed in f32 (see the module docstring)."""
        acc = x.to(torch.float32, memory_format=torch.contiguous_format,
                   copy=True)
        self.runtime.all_reduce_(acc, self.axis)
        return acc.to(x.dtype)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every member's ``x`` joined along ``dim`` in member order."""
        rows = coll._all_gather(x.contiguous(), self.runtime, "model")
        rows = rows.view((self.size,) + tuple(x.shape)).movedim(0, dim)
        shape = list(x.shape)
        shape[dim] *= self.size
        return rows.reshape(shape)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return group.gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.narrow(ctx.dim, ctx.group.index * ctx.size, ctx.size)
        return part.contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        size = x.shape[dim] // group.size
        return x.narrow(dim, group.index * size, size).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.gather(grad, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Identity forward; the gradient is summed over the group."""
    return _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group forward; identity backward."""
    return _Reduce.apply(x, group)


def gather_from_group(x: torch.Tensor, group: Group,
                      dim: int) -> torch.Tensor:
    """The members' ``x`` joined along ``dim``; the gradient keeps this
    rank's slice (exact when the upstream gradient is the same on every
    member: the module docstring)."""
    return _Gather.apply(x, group, dim)


def split_to_group(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` (the same on every member) along
    ``dim``; the gradient is every member's block joined whole."""
    return _Split.apply(x, group, dim)


class ColumnParallel:
    """A Dense whose weight holds this rank's output features: the
    layer's ``tp`` (models/layers.py). ``bias_view``/``bias_dim``: the
    whole bias viewed as the Flax bias (*out) and the dim its features
    are split on."""

    def __init__(self, group: Group, bias_view: tuple[int, ...],
                 bias_dim: int):
        self.group, self.bias_view, self.bias_dim = group, bias_view, bias_dim

    def __call__(self, x, weight, bias, dtype):
        g = self.group
        size = self.bias_view[self.bias_dim] // g.size
        b = copy_to_group(bias, g).view(self.bias_view).narrow(
            self.bias_dim, g.index * size, size).reshape(-1)
        x = copy_to_group(x.to(dtype), g)
        return torch.nn.functional.linear(x, weight.to(dtype)) + b.to(dtype)


class RowParallel:
    """A Dense whose weight holds this rank's input features; the bias is
    added once, after the reduction."""

    def __init__(self, group: Group):
        self.group = group

    def __call__(self, x, weight, bias, dtype):
        y = torch.nn.functional.linear(x.to(dtype), weight.to(dtype))
        return reduce_from_group(y, self.group) + bias.to(dtype)


class GatheredTable:
    """An embedding table held as this rank's parts along ``dim``; called
    with the part, returns the whole table (the Embed's ``tp``)."""

    def __init__(self, group: Group, dim: int):
        self.group, self.dim = group, dim

    def __call__(self, part):
        return gather_from_group(part, self.group, self.dim)


class TensorParallel(PartLayout):
    """The tensor-parallel layout of ``model`` over the ``model`` axis of
    ``runtime``: built on the WHOLE model (every rank draws the same
    initial parameters), it cuts each leaf ``TP_RULES`` split into this
    rank's part (the model's parameter becomes the part), and gives the
    split layers their collectives (the module docstring). ``leaves``:
    key → :class:`~.sharding.TpLeaf` or None; ``flax_dims``: key → the
    Flax dim split (-1 for a whole leaf). The parameters, the slots and
    the EMA are parts at rest; a checkpoint holds them whole
    (``global_state``, ``local_state``)."""

    def __init__(self, model: nn.Module, runtime):
        from distributed_tensorflow_framework_torch.models.bert import (
            MultiHeadAttention,
        )
        from distributed_tensorflow_framework_torch.models.layers import Dense
        from distributed_tensorflow_framework_torch.models.moe import MoEMlp

        self.runtime, self.axes, self.at_rest = runtime, "model", True
        self.group = Group(runtime)
        self.index = self.group.index
        m = self.group.size
        self.leaves = tp_layout(model, m)
        specs = infer_param_specs(model, {"model": m})
        self.flax_dims = {k: (s.index("model") if "model" in s else -1)
                          for k, s in specs.items()}
        layout = flax_layout(model)
        modules = dict(model.named_modules())
        for name, module in modules.items():
            if isinstance(module, MultiHeadAttention):
                proj = f"{name}.{'qkv' if module.fused_qkv else 'query'}"
                if self.leaves[f"{proj}.weight"] is None:
                    continue
                if module.num_heads % m:
                    # The columns cut across a head: gather Q/K/V whole.
                    module.head_group = self.group
                else:
                    module.tp_size = m
        for key, leaf in self.leaves.items():
            if leaf is None:
                continue
            owner = modules[key.rsplit(".", 1)[0]]
            dim = self.flax_dims[key]
            if isinstance(owner, MoEMlp):
                owner.tp = self.group
            elif isinstance(owner, Dense) and dim == 0:
                owner.tp = RowParallel(self.group)
            elif isinstance(owner, Dense):
                _, bias_shape = layout[key.rsplit(".", 1)[0] + ".bias"]
                owner.tp = ColumnParallel(self.group, bias_shape, dim - 1)
            else:  # the embedding table
                owner.tp = GatheredTable(self.group, leaf.dim)
        with torch.no_grad():
            for key, p in model.named_parameters():
                if self.leaves[key] is not None:
                    p.data = self.leaves[key].cut(p.detach(), self.index)

    @property
    def sharded(self) -> int:
        """How many leaves are split."""
        return sum(leaf is not None for leaf in self.leaves.values())

    def global_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of the whole gradient from the parts'
        (key → gradient): the squared norms of the split leaves summed over
        the group (one all-reduce), a replicated leaf counted once. With no
        leaf split it is the unsplit step's norm, bit for bit."""
        if not self.sharded:
            return global_norm(list(grads.values()))
        keys = list(grads)
        sq = torch.stack(torch._foreach_norm(
            [grads[k].float() for k in keys])).square()
        mask = torch.tensor([self.leaves[k] is not None for k in keys],
                            device=sq.device)
        split = torch.where(mask, sq, torch.zeros_like(sq)).sum()
        whole = torch.where(mask, torch.zeros_like(sq), sq).sum()
        return torch.sqrt(self.group.all_reduce(split) + whole)

    def whole_norms(self, params: dict[str, torch.Tensor], inner=None):
        """LARS's ``whole_norms`` (train/optimizers.py) for the tensors the
        optimizer updates (``params``, key → tensor): ``inner``'s (FSDP's)
        first, then the squared norms of the split leaves summed over the
        group."""
        split = {id(params[k]) for k, leaf in self.leaves.items()
                 if leaf is not None}

        def fn(tensors, norms):
            if inner is not None:
                norms = inner(tensors, norms)
            mask = torch.tensor([id(t) in split for t in tensors],
                                device=norms.device)
            sq = torch.where(mask, norms.square(), torch.zeros_like(norms))
            return torch.where(mask, self.group.all_reduce(sq).sqrt(), norms)
        return fn
