"""Mixture-of-Experts FFN: the port of ``models/moe.py``.

A learned top-k gate routes each token to ``topk`` of ``num_experts``
expert MLPs (GShard/Switch). The semantics are the JAX package's, pinned
against it in tests/test_torch_moe.py:

  * **Routing.** The gate is an f32 Dense without bias on ``x`` in f32;
    its softmax gives the probabilities, and the k choices of a token are
    iterated argmax with masking (:func:`_topk_choices`; ties go to the
    first index, as ``torch.argmax`` and ``jnp.argmax`` both give them).
    The routing is discontinuous in the gate's product, so on the card
    the product must run in full f32: the port never turns TF32 on.
  * **Capacity.** The dispatch group is one batch row: each expert takes
    at most ``C = max(topk, ceil(topk · S / E · capacity_factor))``
    assignments of a row, claimed in (round, position) order; the rest
    are dropped, with combine weight 0.
  * **Two dispatchers, one result.** ``sorted`` (the default,
    :func:`topk_dispatch_sorted`) ranks the B·k·S assignments inside their
    expert with one argsort of the key ``expert · A + index`` (A = k·S)
    and scatters them into a (B, E, C+1) token table whose dump column C
    takes the assignments over capacity (the only place indices repeat)
    before it is cut off; ``dense`` (:func:`topk_dispatch`) builds the
    (B, S, E, C) one-hot dispatch and combine tensors. Top-1 keeps the raw
    probability (Switch); top-k ≥ 2 normalises over the placed choices,
    dividing by ``max(denom, 1e-9)``.
  * **Experts.** ``wi`` (E, H, F) and ``wo`` (E, F, H) are f32 parameters
    in the Flax layout (not Dense kernels: models/convert.py keeps them as
    they are), initialised with the JAX package's ``variance_scaling(1.0,
    "fan_in", "truncated_normal", in_axis=-2, out_axis=-1)``, which counts
    the leading E as receptive field: fan_in = E·H for ``wi``, E·F for
    ``wo``. The expert products are plain ``torch.einsum`` in ``dtype``
    with the tanh GELU between them (the JAX package computes them outside
    any Pallas kernel).
  * **Aux outputs.** The layer returns ``(out, {"aux_loss", "zloss",
    "drop_frac"})``: the Switch balance loss ``E · Σ_e me_e · ce_e`` (me
    the mean gate probability, ce the fraction of first choices, 1.0 when
    balanced) plus ``zloss_weight`` times the router z-loss (the mean of
    ``logsumexp(logits)²``, computed only when armed), the z-loss, and
    the fraction of the B·S·k assignments dropped.

Across ranks (parallel/expert.py). Under the JAX package's ``jit`` step
the layer sees the global batch, so ``me``, ``ce``, the z-loss and the
dropped fraction are means over every data-parallel rank's rows. The
port's layer computes its rows' sums and, when ``stats`` is set (a
:class:`~distributed_tensorflow_framework_torch.parallel.expert.RouterStats`),
sums them over those ranks with one all-reduce, whose backward is the
all-reduce of the gradient (its adjoint), so that DDP's average of the
ranks' gradients is the gradient of the global loss. When ``ep`` is set
(an :class:`~distributed_tensorflow_framework_torch.parallel.expert.ExpertExchange`),
``wi`` and ``wo`` hold this rank's ``E/n`` experts and the (B, E, C, H)
expert buffers travel to the ranks that hold their experts and back.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_framework_torch.models.layers import (
    Dense,
    variance_scaling_fan_in_,
)

DISPATCH_IMPLS = ("sorted", "dense")


def _check_topk(topk: int, e: int) -> None:
    if not 1 <= topk <= e:
        raise ValueError(
            f"topk={topk} must be in [1, num_experts={e}] — above e, argmax "
            f"over the exhausted gate would silently re-dispatch to expert 0"
        )


def _topk_choices(probs: torch.Tensor, topk: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared routing decision: iterated argmax with masking (not
    ``torch.topk``, whose ties need not match). Returns (choices (B, K, S)
    int64, first_mask (B, S, E) f32, the one-hot of the first round)."""
    e = probs.shape[-1]
    choices = []
    remaining = probs
    first_mask = None
    for _ in range(topk):
        choice = remaining.argmax(dim=-1)                # (B, S)
        hot = F.one_hot(choice, e).to(probs.dtype)
        if first_mask is None:
            first_mask = hot
        choices.append(choice)
        remaining = remaining * (1.0 - hot)
    return torch.stack(choices, dim=1), first_mask


def route(gate_logits: torch.Tensor, topk: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs (B, S, E) f32, choices (B, K, S), first_mask (B, S, E)) of
    the gate's logits; ValueError for ``topk`` outside [1, E]."""
    _check_topk(topk, gate_logits.shape[-1])
    probs = torch.softmax(gate_logits.float(), dim=-1)
    choices, first_mask = _topk_choices(probs, topk)
    return probs, choices, first_mask


def balance_loss(probs: torch.Tensor, first_mask: torch.Tensor
                 ) -> torch.Tensor:
    """The Switch balance loss of one group of rows: E · Σ me·ce."""
    me = probs.mean(dim=(0, 1))
    ce = first_mask.mean(dim=(0, 1))
    return probs.shape[-1] * (me * ce).sum()


def dense_tables(probs: torch.Tensor, choices: torch.Tensor, topk: int,
                 capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-hot (B, S, E, C) ``dispatch`` and the weighted ``combine``
    of the JAX ``topk_dispatch``: round k claims the slots after the
    earlier rounds' claims, in token order."""
    b, s, e = probs.shape
    dispatch = probs.new_zeros((b, s, e, capacity))
    gate_weights = probs.new_zeros((b, s, e))
    claimed = probs.new_zeros((b, e))
    for k in range(topk):
        mask = F.one_hot(choices[:, k], e).to(probs.dtype)  # (B, S, E)
        # Position of each token within its chosen expert's buffer.
        pos = torch.cumsum(mask, dim=1) - 1.0 + claimed[:, None, :]
        mask = mask * (pos < capacity)
        claimed = claimed + mask.sum(dim=1)
        gate_weights = gate_weights + probs * mask
        pos_in = (pos * mask).sum(dim=-1)                # (B, S)
        cap_oh = F.one_hot(pos_in.long(), capacity).to(probs.dtype)
        cap_oh = cap_oh * mask.sum(dim=-1, keepdim=True)
        dispatch = dispatch + mask[..., None] * cap_oh[..., None, :]
    if topk > 1:
        denom = gate_weights.sum(dim=-1, keepdim=True)
        gate_weights = gate_weights / denom.clamp(min=1e-9)
    return dispatch, dispatch * gate_weights[..., None]


def sorted_tables(probs: torch.Tensor, expert_a: torch.Tensor, topk: int,
                  capacity: int) -> tuple[torch.Tensor, ...]:
    """The index tables of the JAX ``topk_dispatch_sorted``: (token_table
    (B, E, C) int64, table_valid (B, E, C) f32, pos_a (B, K, S) clamped to
    [0, C), combine_w (B, K, S), 0 for a dropped assignment)."""
    b, s, e = probs.shape
    dev = probs.device
    w_a = torch.gather(probs[:, None].expand(b, topk, s, e), -1,
                       expert_a[..., None])[..., 0]      # (B, K, S)
    a = topk * s  # assignments per row, k-major, s-minor
    expert_f = expert_a.reshape(b, a)
    index = torch.arange(a, device=dev)
    token_f = torch.arange(s, device=dev).repeat(topk).expand(b, a)
    # Rank the assignments within their expert in (round, position)
    # order, the dense path's claim order, by one sort of a composite key.
    order = torch.argsort(expert_f * a + index[None, :], dim=-1)
    se_ = torch.gather(expert_f, -1, order)
    st_ = torch.gather(token_f, -1, order)
    counts = F.one_hot(expert_f, e).sum(dim=1)           # (B, E)
    starts = torch.cumsum(counts, dim=-1) - counts       # exclusive
    pos_sorted = index[None, :] - torch.gather(starts, -1, se_)
    valid_sorted = pos_sorted < capacity
    dest = torch.where(valid_sorted, pos_sorted, capacity)  # dump column C
    bidx = torch.arange(b, device=dev)[:, None].expand(b, a)
    token_table = torch.zeros((b, e, capacity + 1), dtype=torch.int64,
                              device=dev)
    token_table[bidx, se_, dest] = st_
    table_valid = probs.new_zeros((b, e, capacity + 1))
    table_valid[bidx, se_, dest] = valid_sorted.to(probs.dtype)
    # Back to assignment (k-major) order for the combine's gather: the
    # sort's permutation scattered, its inverse.
    pos_a = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
    valid_a = torch.empty_like(valid_sorted).scatter_(-1, order, valid_sorted)
    pos_a = pos_a.reshape(b, topk, s).clamp(0, capacity - 1)
    w_placed = w_a * valid_a.reshape(b, topk, s).to(probs.dtype)
    if topk == 1:
        combine_w = w_placed  # Switch: the raw probability
    else:
        denom = w_placed.sum(dim=1, keepdim=True)
        combine_w = w_placed / denom.clamp(min=1e-9)
    return (token_table[..., :capacity], table_valid[..., :capacity], pos_a,
            combine_w)


def topk_dispatch(gate_logits: torch.Tensor, topk: int, capacity: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX ``topk_dispatch``: (dispatch, combine, aux_loss) of one
    group of rows, the (B, S, E, C) one-hot tables."""
    probs, choices, first_mask = route(gate_logits, topk)
    dispatch, combine = dense_tables(probs, choices, topk, capacity)
    return dispatch, combine, balance_loss(probs, first_mask)


def topk_dispatch_sorted(gate_logits: torch.Tensor, topk: int,
                         capacity: int) -> tuple[torch.Tensor, ...]:
    """The JAX ``topk_dispatch_sorted``: (token_table, table_valid,
    expert_a, pos_a, combine_w, aux_loss) of one group of rows, the same
    routing as :func:`topk_dispatch` through O(B·E·C) tables."""
    probs, expert_a, first_mask = route(gate_logits, topk)
    token_table, table_valid, pos_a, combine_w = sorted_tables(
        probs, expert_a, topk, capacity)
    return (token_table, table_valid, expert_a, pos_a, combine_w,
            balance_loss(probs, first_mask))


def capacity_for(seq_len: int, num_experts: int, topk: int,
                 capacity_factor: float) -> int:
    """Slots per expert and batch row."""
    return max(topk, int(math.ceil(topk * seq_len / num_experts
                                   * capacity_factor)))


class MoEMlp(nn.Module):
    """The MoE FFN that replaces an encoder layer's dense MLP: Flax
    ``moe/{gate/kernel, wi, wo}``. ``stats`` and ``ep`` (the module
    docstring) are set by parallel/expert.py; None runs the layer on this
    rank's rows alone, with every expert here."""

    def __init__(self, hidden: int, num_experts: int, mlp_dim: int, *,
                 topk: int = 2, capacity_factor: float = 1.25,
                 dispatch_impl: str = "sorted", zloss_weight: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if dispatch_impl not in DISPATCH_IMPLS:
            raise ValueError(
                f"moe dispatch_impl must be 'sorted' or 'dense', got "
                f"{dispatch_impl!r}")
        _check_topk(topk, num_experts)
        self.num_experts = num_experts
        self.topk = topk
        self.capacity_factor = capacity_factor
        self.dispatch_impl = dispatch_impl
        self.zloss_weight = zloss_weight
        self.dtype = dtype
        self.stats = None
        self.ep = None
        self.gate = Dense(hidden, num_experts, dtype=torch.float32,
                          use_bias=False, device=device)
        self.wi = nn.Parameter(torch.empty(
            num_experts, hidden, mlp_dim, dtype=torch.float32, device=device))
        self.wo = nn.Parameter(torch.empty(
            num_experts, mlp_dim, hidden, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        """``wi`` and ``wo`` (the gate is a Dense of its own): fan_in =
        E·H and E·F, as the JAX initialiser counts it."""
        e, h, f = self.wi.shape
        variance_scaling_fan_in_(self.wi, e * h, generator)
        variance_scaling_fan_in_(self.wo, e * f, generator)

    def _experts(self, xe: torch.Tensor) -> torch.Tensor:
        """The expert MLPs on their (B, E, C, H) buffers, in ``dtype``;
        under expert parallelism on this rank's experts of every rank's
        buffers."""
        dtype = self.dtype
        b = xe.shape[0]
        if self.ep is not None:
            xe = self.ep.to_experts(xe)
        he = F.gelu(torch.einsum("bech,ehf->becf", xe, self.wi.to(dtype)),
                    approximate="tanh")
        oe = torch.einsum("becf,efh->bech", he, self.wo.to(dtype))
        return oe if self.ep is None else self.ep.from_experts(oe, b)

    def forward(self, x: torch.Tensor
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        b, s, _ = x.shape
        e, k, dtype = self.num_experts, self.topk, self.dtype
        capacity = capacity_for(s, e, k, self.capacity_factor)
        gate_logits = self.gate(x.float())
        probs, choices, first_mask = route(gate_logits, k)
        rows = torch.arange(b, device=x.device)[:, None, None]
        if self.dispatch_impl == "sorted":
            token_table, table_valid, pos_a, combine_w = sorted_tables(
                probs, choices, k, capacity)
            placed = table_valid.sum()
            # Each expert's claimed tokens, (B, E, C, H), with no (B, S,
            # E, C) intermediary.
            xe = (x.to(dtype)[rows, token_table]
                  * table_valid[..., None].to(dtype))
        else:
            dispatch, combine = dense_tables(probs, choices, k, capacity)
            placed = dispatch.sum()
            xe = torch.einsum("bsec,bsh->bech", dispatch.to(dtype),
                              x.to(dtype))
        oe = self._experts(xe)
        if self.dispatch_impl == "sorted":
            og = oe[rows, choices, pos_a]                # (B, K, S, H)
            out = (og * combine_w[..., None].to(dtype)).sum(dim=1)
        else:
            out = torch.einsum("bsec,bech->bsh", combine.to(dtype), oe)
        # The statistics as sums over this rank's rows: [Σ probs (E), Σ
        # z² (1), Σ first choices (E), placed (1), tokens (1)]; summed
        # over the data-parallel ranks when ``stats`` is set.
        z2 = (torch.logsumexp(gate_logits, dim=-1).square().sum()
              if self.zloss_weight else gate_logits.new_zeros(()))
        sums = torch.cat([probs.sum(dim=(0, 1)), z2[None],
                          first_mask.sum(dim=(0, 1)), placed[None],
                          placed.new_full((1,), float(b * s))])
        if self.stats is not None and self.training:
            sums = self.stats(sums)
        tokens = sums[-1]
        me, ce = sums[:e] / tokens, sums[e + 1:2 * e + 1] / tokens
        zloss = sums[e] / tokens
        aux = e * (me * ce).sum()
        return out, {"aux_loss": aux + self.zloss_weight * zloss,
                     "zloss": zloss,
                     "drop_frac": 1.0 - sums[2 * e + 1] / (tokens * k)}
