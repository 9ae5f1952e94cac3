"""BERT-base for masked-LM: the training and the serving forward.

Port of ``distributed_tensorflow_framework_tpu/models/bert.py`` (the dense
encoder): post-LayerNorm encoder, token + position embeddings,
tied-embedding MLM head. Module and parameter names follow the Flax tree
(``embed_block``, ``layer{i}/attn/qkv``, ``head/mlm_bias``, ...) so
models/convert.py maps one onto the other by name.

The dtype flow mirrors the Flax module's: parameters are f32, matmuls run in
``dtype`` (bf16 in production), LayerNorms compute in and return f32, the
embedding output is cast to ``dtype``, and the vocabulary projection is a
``dtype`` matmul followed by an f32 bias add.

Dropout at ``dropout_rate`` follows the attention block, the MLP and the
embedding LayerNorm, as in the Flax model. It is active in ``train()`` mode
and the identity in ``eval()``. Its masks come from the
``dropout_generator`` the caller passes to ``forward`` (the trainer owns
it), never from the global RNG; kept values are scaled by 1/keep_prob in
the activation dtype, as Flax's ``nn.Dropout`` does.

``attention_impl``: "pallas" runs ops/flash_attention.py (the CUDA kernel on
the card), "xla" the plain :func:`dot_product_attention`, "ring"
parallel/ring.py's ring attention over the mesh's ``seq`` ranks.

Under sequence parallelism (:meth:`BertForMLM.shard_sequence`, ring
attention at ``mesh.seq > 1``) the model takes whole rows and each rank
of ``seq`` keeps its part of every row, ``[r·S/n, (r+1)·S/n)``, through
the embedding, every encoder layer and the MLM head, whose logits are
this part's: activations are O(S/n · D) a rank. Positions are the part's
(packed rows: ``segment_positions`` of the whole row, then this part),
and dropout draws each mask at the whole row's shape from the same
generator and keeps this part, so the masks, and the generator's state
after each draw, are those of one process at ``seq = 1``.

Under tensor parallelism (parallel/tensor_parallel.py) the projections
are split over the mesh's ``model`` axis: ``tp_size`` of the attention is
the axis's size, and its ``nh / tp_size`` heads are this rank's; the
embedding table is held as this rank's H-part and gathered whole once per
forward (``Embed.table``).

``remat`` checkpoints each encoder layer (``torch.utils.checkpoint``, the
counterpart of ``nn.remat(EncoderLayer)``): the backward recomputes a
layer's activations from its input instead of keeping them, so activation
memory holds one layer's worth at a time. The recompute replays the
layer's dropout masks from the same ``dropout_generator`` state and then
puts the generator back, so the gradients and the generator's state are
those of the model without remat (:func:`remat_layer`).
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from distributed_tensorflow_framework_torch.models.layers import (
    Dense,
    LayerNorm,
    dropout,
    normal_,
)
from distributed_tensorflow_framework_torch.ops.flash_attention import (
    flash_attention,
)
from distributed_tensorflow_framework_torch.parallel import ring

_F32_MIN = torch.finfo(torch.float32).min


def dot_product_attention(q, k, v, *, mask=None, segment_ids=None,
                          dtype=torch.float32):
    """Reference attention. q, k, v: (B, S, H, D); mask: (B, 1, 1, S) bool
    or None; segment_ids: (B, S) packed-sequence ids or None. Scores are
    formed in q's dtype and masked in f32 (the finite f32 min keeps a
    fully-masked row finite), probabilities cast to ``dtype``."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
        math.sqrt(d), dtype=q.dtype, device=q.device)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, _F32_MIN)
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        scores = torch.where(same, scores, _F32_MIN)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


ATTENTION_IMPLS = ("pallas", "xla", "ring")


class MultiHeadAttention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, *, dtype: torch.dtype,
                 attention_impl: str, fused_qkv: bool, device=None):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {attention_impl!r} not in "
                             f"{ATTENTION_IMPLS}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.fused_qkv = fused_qkv
        # The tensor-parallel split of the heads (1: every head here).
        self.tp_size = 1
        # The ring's runtime (core/mesh.py) under sequence parallelism;
        # None: a ring of one rank.
        self.seq_runtime = None
        # A plain attribute, so a caller can hold the model against the
        # kernel's plain version by swapping it (chip_smoke.py does).
        if attention_impl == "pallas":
            self.attention_fn = flash_attention
        elif attention_impl == "ring":
            self.attention_fn = self._ring_attention
        else:
            self.attention_fn = functools.partial(dot_product_attention,
                                                  dtype=dtype)
        if fused_qkv:
            # One (H -> 3H) projection; the Flax kernel is (H, 3, H) and
            # the split below is its qkv[..., i, :].
            self.qkv = Dense(hidden, 3 * hidden, dtype=dtype, device=device)
        else:
            self.query = Dense(hidden, hidden, dtype=dtype, device=device)
            self.key = Dense(hidden, hidden, dtype=dtype, device=device)
            self.value = Dense(hidden, hidden, dtype=dtype, device=device)
        self.attn_out = Dense(hidden, hidden, dtype=dtype, device=device)

    def _ring_attention(self, q, k, v, *, mask=None, segment_ids=None):
        return ring.ring_attention_masked(q, k, v, mask=mask,
                                          segment_ids=segment_ids,
                                          runtime=self.seq_runtime)

    def forward(self, x, mask=None, segment_ids=None):
        b, s, h = x.shape
        nh = self.num_heads // self.tp_size
        width = nh * (h // self.num_heads)
        heads = (b, s, nh, h // self.num_heads)
        if self.fused_qkv:
            qkv = self.qkv(x).view(b, s, 3, width)
            q, k, v = (qkv[:, :, i, :].reshape(heads) for i in range(3))
        else:
            q = self.query(x).reshape(heads)
            k = self.key(x).reshape(heads)
            v = self.value(x).reshape(heads)
        out = self.attention_fn(q, k, v, mask=mask, segment_ids=segment_ids)
        return self.attn_out(out.reshape(b, s, width))


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, *,
                 dtype: torch.dtype, attention_impl: str, fused_qkv: bool,
                 dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        # (this rank's index, the seq ranks) under sequence parallelism.
        self.seq_part = None
        self.attn = MultiHeadAttention(
            hidden, num_heads, dtype=dtype, attention_impl=attention_impl,
            fused_qkv=fused_qkv, device=device)
        self.ln1 = LayerNorm(hidden, device=device)
        self.mlp_in = Dense(hidden, mlp_dim, dtype=dtype, device=device)
        self.mlp_out = Dense(mlp_dim, hidden, dtype=dtype, device=device)
        self.ln2 = LayerNorm(hidden, device=device)

    def forward(self, x, mask=None, segment_ids=None, generator=None):
        attn = dropout(self.attn(x, mask, segment_ids), self.dropout_rate,
                       generator, self.training, self.seq_part)
        x = self.ln1(x + attn)
        y = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        y = dropout(y, self.dropout_rate, generator, self.training,
                    self.seq_part)
        return self.ln2(x + y)


@contextlib.contextmanager
def _replaying(generator: torch.Generator, state: torch.Tensor):
    """Run the body with ``generator`` set to ``state``, then return it to
    where it stood before the body."""
    after = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(after)


def remat_layer(layer: nn.Module, x, mask, segment_ids, generator):
    """``layer(x, mask, segment_ids, generator)`` under a per-layer
    activation checkpoint. ``preserve_rng_state`` covers only the default
    generators, and dropout draws from ``generator``, so the recompute
    would draw other masks and give wrong gradients without an error. So
    the forward's generator state is captured as it starts, the recompute
    runs from that state, and the generator is then put back where the
    forward left it."""
    def contexts():
        if generator is None:
            return contextlib.nullcontext(), contextlib.nullcontext()
        return (contextlib.nullcontext(),
                _replaying(generator, generator.get_state()))

    return torch.utils.checkpoint.checkpoint(
        layer, x, mask, segment_ids, generator, use_reentrant=False,
        preserve_rng_state=False, context_fn=contexts)


class Embed(nn.Module):
    """Flax ``nn.Embed`` parameter holder (``embedding`` → ``weight``).
    Under tensor parallelism ``weight`` is this rank's part and ``tp``
    gathers the whole table."""

    def __init__(self, num: int, features: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num, features, dtype=torch.float32, device=device))
        self.tp = None

    def table(self) -> torch.Tensor:
        """The whole table."""
        return self.weight if self.tp is None else self.tp(self.weight)


class BertEmbed(nn.Module):
    """Token + position embedding front; returns the activations and the
    raw embedding table (the MLM projection is tied to it)."""

    def __init__(self, vocab_size: int, hidden: int, max_seq_len: int, *,
                 dtype: torch.dtype, dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.seq_part = None
        self.embed = Embed(vocab_size, hidden, device=device)
        self.pos_embedding = nn.Parameter(torch.empty(
            max_seq_len, hidden, dtype=torch.float32, device=device))
        self.embed_ln = LayerNorm(hidden, device=device)

    def forward(self, input_ids, position_ids=None, generator=None,
                offset: int = 0):
        """``offset``: the first position of ``input_ids`` in its row
        (this rank's part under sequence parallelism), when
        ``position_ids`` is None."""
        table = self.embed.table()
        x = F.embedding(input_ids, table).to(self.dtype)
        if position_ids is None:
            pos = self.pos_embedding[None, offset:offset + input_ids.shape[1]]
        else:
            # Packed rows: per-document positions, reset at each segment.
            pos = self.pos_embedding[position_ids]
        x = self.embed_ln(x + pos.to(self.dtype))
        x = dropout(x, self.dropout_rate, generator, self.training,
                    self.seq_part)
        return x.to(self.dtype), table


class MLMHead(nn.Module):
    """transform → gelu → LN → tied-embedding projection + f32 bias."""

    def __init__(self, vocab_size: int, hidden: int, *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.mlm_transform = Dense(hidden, hidden, dtype=dtype, device=device)
        self.mlm_ln = LayerNorm(hidden, device=device)
        self.mlm_bias = nn.Parameter(torch.empty(
            vocab_size, dtype=torch.float32, device=device))

    def forward(self, x, embedding):
        x = F.gelu(self.mlm_transform(x), approximate="tanh")
        x = self.mlm_ln(x)
        logits = F.linear(x.to(self.dtype), embedding.to(self.dtype))
        return logits.float() + self.mlm_bias


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Positions that restart at every segment boundary: index i minus the
    running start-of-segment index (the JAX model's cummax trick)."""
    s = segment_ids.shape[1]
    idx = torch.arange(s, device=segment_ids.device)
    change = torch.ones_like(segment_ids, dtype=torch.bool)
    change[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    starts = torch.cummax(torch.where(change, idx[None, :], 0), dim=1).values
    return idx[None, :] - starts


class BertForMLM(nn.Module):
    def __init__(self, *, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, max_seq_len: int = 512,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_impl: str = "xla", fused_qkv: bool = False,
                 remat: bool = False, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        # The ring's runtime under sequence parallelism (shard_sequence).
        self.seq_runtime = None
        self.embed_block = BertEmbed(vocab_size, hidden_size, max_seq_len,
                                     dtype=dtype, dropout_rate=dropout_rate,
                                     device=device)
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(
                hidden_size, num_heads, mlp_dim, dtype=dtype,
                attention_impl=attention_impl, fused_qkv=fused_qkv,
                dropout_rate=dropout_rate, device=device))
        self.head = MLMHead(vocab_size, hidden_size, dtype=dtype,
                            device=device)

    def init_weights(self, generator: torch.Generator | None) -> None:
        """Draw every parameter as the Flax initialisers would: dense
        kernels variance-scaled, embedding tables normal(0.02), biases
        zero, LayerNorm scales one."""
        for module in self.modules():
            if isinstance(module, Dense):
                module.reset_parameters(generator)
            elif isinstance(module, LayerNorm):
                module.reset_parameters()
        normal_(self.embed_block.embed.weight, 0.02, generator)
        normal_(self.embed_block.pos_embedding, 0.02, generator)
        with torch.no_grad():
            self.head.mlm_bias.zero_()

    def shard_sequence(self, runtime) -> None:
        """Sequence parallelism over ``runtime``'s ``seq`` ranks (ring
        attention): from here on ``forward`` takes whole rows and returns
        the logits of this rank's part of each."""
        group = runtime.axis_group("seq")
        part = (group.index, group.size)
        self.seq_runtime = runtime
        self.embed_block.seq_part = part
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            layer.seq_part = part
            layer.attn.seq_runtime = runtime

    def forward(self, input_ids, attention_mask=None, segment_ids=None, *,
                dropout_generator: torch.Generator | None = None):
        """Logits (B, S, vocab) f32 — under sequence parallelism those of
        this rank's part of each row, (B, S/n, vocab). ``dropout_generator``
        feeds the dropout masks in ``train()`` mode; ``eval()`` mode
        ignores it."""
        position_ids = (None if segment_ids is None
                        else segment_positions(segment_ids))
        offset = 0
        if self.seq_runtime is not None:
            part = ring.seq_part(self.seq_runtime, input_ids.shape[1])
            offset = part.start
            input_ids = input_ids[:, part]
            if attention_mask is not None:
                attention_mask = attention_mask[:, part]
            if segment_ids is not None:
                segment_ids = segment_ids[:, part]
                position_ids = position_ids[:, part]
        x, table = self.embed_block(input_ids, position_ids,
                                    dropout_generator, offset)
        mask = (None if attention_mask is None
                else attention_mask[:, None, None, :].bool())
        remat = self.remat and torch.is_grad_enabled()
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            if remat:
                x = remat_layer(layer, x, mask, segment_ids,
                                dropout_generator)
            else:
                x = layer(x, mask, segment_ids, dropout_generator)
        return self.head(x, table)
