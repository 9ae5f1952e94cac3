"""Expert parallelism over the mesh's ``expert`` axis, and the MoE
router's statistics across ranks.

The JAX package writes no module for this: under ``train.spmd_mode: jit``
it gives ``wi``/``wo`` the ``MOE_RULES`` layout (parallel/sharding.py,
dim 0 over ``expert``) and GSPMD turns the dispatch into all-to-alls. The
port runs one process per rank, so it places them by hand:

  * :class:`ExpertParallel` cuts every MoE layer's ``wi`` (E, H, F) and
    ``wo`` (E, F, H) into this rank's contiguous block of ``E/n`` experts
    (rank i of the ``expert`` line holds experts ``[i·E/n, (i+1)·E/n)``),
    on a model built whole from the seed on every rank; the optimizer
    slots and the EMA follow the parameters, and a checkpoint holds the
    whole (E, ...) tensors (``global_state``/``local_state``, every rank
    of the line taking part);
  * :class:`ExpertExchange` moves a layer's (B, E, C, H) expert buffers:
    each rank sends the buffers of rank p's experts to rank p, which runs
    its experts on every rank's rows and sends the outputs back for the
    combine. Both moves are one ``all_to_all`` over the expert line's own
    process group (core/mesh.py ``expert_group``; gloo with CUDA tensors
    builds it from ``all_reduce``), whose backward is the same exchange
    (:class:`_AllToAll`: the adjoint of a permutation of blocks between
    ranks is its inverse, which for this layout is itself). Under
    ``model.remat`` the recompute replays the exchange: every rank
    recomputes the same layers in the same order;
  * :class:`RouterStats` sums a layer's balance statistics over the
    data-parallel ranks (core/mesh.py ``router_group``), so that the
    balance loss, the z-loss and the dropped fraction are the global
    batch's, as under the JAX ``jit`` step; its backward all-reduces the
    gradient, which makes DDP's average of the ranks' gradients the
    gradient of the global loss whatever loss scale each rank applies.

The gradients. Every leaf that is not an expert part is reduced by DDP
over data × fsdp × expert, as a replicated leaf. An expert part's
gradient already holds every rank of its expert line's tokens (the
exchange's backward brought them), each scaled as its rank scaled its
loss; so DDP leaves the parts out, and :meth:`ExpertParallel.reduce_grads_`
sums them over data × fsdp in one all-reduce and divides by the
data-parallel count, as DDP's average does.
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_tensorflow_framework_torch.parallel.sharding import (
    FsdpLeaf,
    PartLayout,
    infer_param_specs,
)
from distributed_tensorflow_framework_torch.train.optimizers import (
    global_norm,
)

def _exchange(x: torch.Tensor, runtime, group) -> torch.Tensor:
    # Contiguous first: ``empty_like`` keeps a permuted tensor's strides,
    # and the collective fills its output in memory order.
    x = x.contiguous()
    return runtime.all_to_all_(torch.empty_like(x), x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, runtime, group):
        ctx.runtime, ctx.group = runtime, group
        return _exchange(x, runtime, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.runtime, ctx.group), None, None


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, runtime, group):
        ctx.runtime, ctx.group = runtime, group
        return runtime.all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.runtime.all_reduce_(grad.clone(), ctx.group), None, None


class RouterStats:
    """A MoE layer's ``stats`` (models/moe.py): the sum over the
    data-parallel ranks, differentiable."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.group = runtime.router_group

    def __call__(self, sums: torch.Tensor) -> torch.Tensor:
        return _SumOverRanks.apply(sums, self.runtime, self.group)


class ExpertExchange:
    """A MoE layer's ``ep`` (models/moe.py): the move of its expert
    buffers to the ranks that hold their experts and back."""

    def __init__(self, runtime):
        self.runtime = runtime
        self.group = runtime.expert_group
        self.size = self.group.size

    def to_experts(self, xe: torch.Tensor) -> torch.Tensor:
        """(B, E, C, H), every expert of this rank's rows → (n·B, E/n, C,
        H), this rank's experts of every rank's rows (rank r's at
        [r·B, (r+1)·B))."""
        b, e, c, h = xe.shape
        n = self.size
        send = xe.reshape(b, n, e // n, c, h).transpose(0, 1)
        return _AllToAll.apply(send, self.runtime, self.group).reshape(
            n * b, e // n, c, h)

    def from_experts(self, oe: torch.Tensor, b: int) -> torch.Tensor:
        """The inverse of :meth:`to_experts` on the experts' outputs."""
        nb, el, c, h = oe.shape
        n = self.size
        back = _AllToAll.apply(oe.reshape(n, b, el, c, h), self.runtime,
                               self.group)
        return back.transpose(0, 1).reshape(b, n * el, c, h)


def moe_layers(model: nn.Module) -> list[tuple[str, nn.Module]]:
    """Every MoE layer of ``model`` with its module name."""
    from distributed_tensorflow_framework_torch.models.moe import MoEMlp

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, MoEMlp)]


def attach_router_stats(model: nn.Module, runtime) -> None:
    """Give every MoE layer of ``model`` the sum of its statistics over
    ``runtime``'s data-parallel ranks (none at one rank)."""
    if runtime is None or runtime.backend is None \
            or runtime.router_group.size <= 1:
        return
    for _, m in moe_layers(model):
        m.stats = RouterStats(runtime)


class ExpertParallel(PartLayout):
    """The expert-parallel layout of ``model`` over the ``expert`` axis of
    ``runtime`` (the module docstring): built on the WHOLE model, it cuts
    each ``wi``/``wo`` whose E the axis divides into this rank's experts
    (the model's parameter becomes the part) and gives those layers their
    :class:`ExpertExchange`. ``leaves``: key → :class:`FsdpLeaf` over
    dim 0, or None for a leaf held whole."""

    def __init__(self, model: nn.Module, runtime):
        self.runtime, self.axes, self.at_rest = runtime, "expert", True
        group = runtime.axis_group("expert")
        self.index, n = group.index, group.size
        specs = infer_param_specs(model, {"expert": n})
        params = dict(model.named_parameters())
        self.leaves: dict[str, FsdpLeaf | None] = {}
        for key, spec in specs.items():
            shape = tuple(params[key].shape)
            self.leaves[key] = (FsdpLeaf(shape, shape, 0, n)
                                if spec[:1] == ("expert",) else None)
        for name, layer in moe_layers(model):
            if self.leaves[f"{name}.wi"] is not None:
                layer.ep = ExpertExchange(runtime)
        with torch.no_grad():
            for key, p in model.named_parameters():
                if self.leaves[key] is not None:
                    p.data = self.leaves[key].cut(p.detach(), self.index)

    @property
    def sharded(self) -> int:
        """How many leaves are split."""
        return sum(leaf is not None for leaf in self.leaves.values())

    def part_keys(self) -> list[str]:
        return [k for k, leaf in self.leaves.items() if leaf is not None]

    @torch.no_grad()
    def reduce_grads_(self, model: nn.Module, count: int) -> None:
        """The expert parts' gradients summed over data × fsdp (one
        all-reduce of them laid end to end) and divided by ``count``, the
        data-parallel ranks DDP averages over."""
        params = dict(model.named_parameters())
        grads = [params[k].grad for k in self.part_keys()]
        if not grads:
            return
        # The data-parallel axes but ``expert``: the exchange's backward
        # already summed over those.
        group = self.runtime.axis_group(("data", "fsdp"))
        if group.size > 1:
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.runtime.all_reduce_(flat, group)
            torch._foreach_copy_(grads, [
                t.view_as(g) for t, g in zip(
                    flat.split([g.numel() for g in grads]), grads)])
        torch._foreach_mul_(grads, 1.0 / count)

    def _sum_split(self, sq: torch.Tensor, mask: torch.Tensor
                   ) -> torch.Tensor:
        split = torch.where(mask, sq, torch.zeros_like(sq))
        return self.runtime.all_reduce_(split, self.runtime.axis_group(
            "expert"))

    def global_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The global L2 norm of the whole gradient from the parts': the
        parts' squared norms summed over the expert line (one
        all-reduce), a replicated leaf counted once."""
        if not self.sharded:
            return global_norm(list(grads.values()))
        keys = list(grads)
        sq = torch.stack(torch._foreach_norm(
            [grads[k].float() for k in keys])).square()
        mask = torch.tensor([self.leaves[k] is not None for k in keys],
                            device=sq.device)
        whole = torch.where(mask, torch.zeros_like(sq), sq).sum()
        return torch.sqrt(self._sum_split(sq, mask).sum() + whole)

    def whole_norms(self, params: dict[str, torch.Tensor]):
        """LARS's ``whole_norms`` (train/optimizers.py): a part's norm →
        the whole leaf's (one all-reduce of the squares over the expert
        line)."""
        split = {id(params[k]) for k in self.part_keys()}

        def fn(tensors, norms):
            mask = torch.tensor([id(t) in split for t in tensors],
                                device=norms.device)
            total = self._sum_split(norms.square(), mask).sqrt()
            return torch.where(mask, total, norms)
        return fn
