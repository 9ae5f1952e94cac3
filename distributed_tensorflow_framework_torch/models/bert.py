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

Mixture-of-Experts (``num_experts > 0``; models/moe.py): every
``moe_every``-th layer (layers ``moe_every − 1``, ``2·moe_every − 1``, ...)
takes a ``moe`` FFN (Flax ``layer{i}/moe/{gate/kernel, wi, wo}``) in
place of ``mlp_in``/``mlp_out``. Every layer returns ``(x, aux)``, the
MoE layer's aux dict or zeros, and the model returns ``{"logits",
"moe_aux_loss", "moe_drop_frac"[, "moe_zloss"]}``, each the mean over
its MoE layers (``moe_zloss`` only when ``moe_zloss_weight`` is set), as
the Flax model does.

``remat`` checkpoints each encoder layer (models/remat.py, the
counterpart of ``nn.remat(EncoderLayer, policy=...)``): the backward
recomputes a layer's activations from its input instead of keeping them,
so activation memory holds one layer's worth at a time, or with
``ckpt_policy="dots_saveable"`` (``precision.remat_policy``) the layer's
matrix-product outputs besides. The recompute replays the layer's dropout
masks from the same ``dropout_generator`` state and then puts the
generator back, so the gradients and the generator's state are those of
the model without remat (:func:`remat_layer`).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_framework_torch.models import remat
from distributed_tensorflow_framework_torch.models.layers import (
    Dense,
    LayerNorm,
    dropout,
    normal_,
)
from distributed_tensorflow_framework_torch.models.moe import MoEMlp
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


# The keys of an encoder layer's aux dict (models/moe.py).
AUX_KEYS = ("aux_loss", "zloss", "drop_frac")


class EncoderLayer(nn.Module):
    """Attention and the FFN: the dense MLP, or with ``num_experts > 0``
    the MoE FFN (``moe``; ``moe_kwargs`` are MoEMlp's options). Returns
    ``(x, aux)``: the MoE FFN's aux dict, or f32 zeros under the same
    keys."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, *,
                 dtype: torch.dtype, attention_impl: str, fused_qkv: bool,
                 dropout_rate: float = 0.0, num_experts: int = 0,
                 moe_kwargs: dict | None = None, device=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        # (this rank's index, the seq ranks) under sequence parallelism.
        self.seq_part = None
        self.attn = MultiHeadAttention(
            hidden, num_heads, dtype=dtype, attention_impl=attention_impl,
            fused_qkv=fused_qkv, device=device)
        self.ln1 = LayerNorm(hidden, device=device)
        self.moe = None
        if num_experts > 0:
            self.moe = MoEMlp(hidden, num_experts, mlp_dim, dtype=dtype,
                              device=device, **(moe_kwargs or {}))
        else:
            self.mlp_in = Dense(hidden, mlp_dim, dtype=dtype, device=device)
            self.mlp_out = Dense(mlp_dim, hidden, dtype=dtype, device=device)
        self.ln2 = LayerNorm(hidden, device=device)

    def forward(self, x, mask=None, segment_ids=None, generator=None):
        attn = dropout(self.attn(x, mask, segment_ids), self.dropout_rate,
                       generator, self.training, self.seq_part)
        x = self.ln1(x + attn)
        if self.moe is not None:
            y, aux = self.moe(x)
        else:
            y = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
            zero = x.new_zeros((), dtype=torch.float32)
            aux = dict.fromkeys(AUX_KEYS, zero)
        y = dropout(y, self.dropout_rate, generator, self.training,
                    self.seq_part)
        return self.ln2(x + y), aux


def remat_layer(layer: nn.Module, x, mask, segment_ids, generator,
                policy: str | None = None):
    """``layer(x, mask, segment_ids, generator)`` (its ``(x, aux)``, the
    aux dict carried through as ``nn.remat`` carries return values) under
    a per-layer activation checkpoint that keeps what ``policy`` names
    (models/remat.py: None or "save_nothing" keeps nothing,
    "dots_saveable" the matrix products' outputs).
    ``preserve_rng_state`` covers only the default generators, and
    dropout draws from ``generator``, so the recompute would draw other
    masks and give wrong gradients without an error. So the forward's
    generator state is captured as it starts, the recompute runs from
    that state, and the generator is then put back where the forward
    left it."""
    return remat.checkpoint(layer, x, mask, segment_ids, generator,
                            policy=policy, generator=generator)


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
                 remat: bool = False, ckpt_policy: str | None = None,
                 num_experts: int = 0,
                 moe_every: int = 2, expert_topk: int = 2,
                 capacity_factor: float = 1.25, moe_dispatch: str = "sorted",
                 moe_zloss_weight: float = 0.0, device=None):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        self.ckpt_policy = ckpt_policy
        self.num_experts = num_experts
        self.moe_zloss_weight = moe_zloss_weight
        every = max(moe_every, 1)
        # The layers that take the MoE FFN (the Flax model's choice).
        self.moe_layers = [i for i in range(num_layers) if num_experts > 0
                           and i % every == every - 1]
        moe_kwargs = dict(topk=expert_topk, capacity_factor=capacity_factor,
                          dispatch_impl=moe_dispatch,
                          zloss_weight=moe_zloss_weight)
        # The ring's runtime under sequence parallelism (shard_sequence).
        self.seq_runtime = None
        self.embed_block = BertEmbed(vocab_size, hidden_size, max_seq_len,
                                     dtype=dtype, dropout_rate=dropout_rate,
                                     device=device)
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(
                hidden_size, num_heads, mlp_dim, dtype=dtype,
                attention_impl=attention_impl, fused_qkv=fused_qkv,
                dropout_rate=dropout_rate,
                num_experts=num_experts if i in self.moe_layers else 0,
                moe_kwargs=moe_kwargs, device=device))
        self.head = MLMHead(vocab_size, hidden_size, dtype=dtype,
                            device=device)

    def init_weights(self, generator: torch.Generator | None) -> None:
        """Draw every parameter as the Flax initialisers would: dense
        kernels and the experts variance-scaled, embedding tables
        normal(0.02), biases zero, LayerNorm scales one."""
        for module in self.modules():
            if isinstance(module, (Dense, MoEMlp)):
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
        this rank's part of each row, (B, S/n, vocab) — or, with MoE
        layers, the dict of the module docstring. ``dropout_generator``
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
        totals = None
        for i in range(self.num_layers):
            layer = getattr(self, f"layer{i}")
            if remat:
                x, aux = remat_layer(layer, x, mask, segment_ids,
                                     dropout_generator, self.ckpt_policy)
            else:
                x, aux = layer(x, mask, segment_ids, dropout_generator)
            if i in self.moe_layers:
                totals = aux if totals is None else {
                    k: totals[k] + aux[k] for k in AUX_KEYS}
        logits = self.head(x, table)
        if not self.num_experts:
            return logits
        if totals is None:
            totals = dict.fromkeys(AUX_KEYS, logits.new_zeros(()))
        n = max(len(self.moe_layers), 1)
        out = {"logits": logits,
               "moe_aux_loss": totals["aux_loss"] / n,
               "moe_drop_frac": totals["drop_frac"] / n}
        if self.moe_zloss_weight:
            out["moe_zloss"] = totals["zloss"] / n
        return out


# ---------------------------------------------------------------------------
# Autoregressive decode path (serve/decode.py).
#
# The port of the JAX package's decode walk (models/bert.py
# ``bert_decode_layers`` and its helpers): a CAUSAL prefill over the prompt
# that also exports every layer's K/V, and a per-token step whose keys and
# values come from a paged cache instead of the layer input. Both are
# plain functions over :func:`decode_params`, the trained BertForMLM's
# tensors in f32 with every kernel matrix laid out (K, N) once, with the KV
# residency behind an ``attend`` callback so the engine owns paging while
# the model owns the math.
#
# A stream's logits must be bit-equal whether it decodes alone or among
# neighbours (the JAX package pins this). XLA gets that by construction;
# PyTorch on the CPU does not, so two formulations here are deliberate:
#   * a one-row product runs as two rows (:func:`_decode_dense`): torch
#     takes a matrix-vector path for a single row, whose sums differ in
#     the last bits from the matrix product of every other row count;
#   * :func:`paged_decode_attention` forms its scores and context by
#     elementwise products reduced over the head and key dims, not by a
#     batched matrix product: the batched product's sums change with the
#     row count, and its and the softmax's inner-dim reductions change
#     with the padded key count, while a reduction over an outer dim adds
#     the keys one by one in order, so masked padding (exact zeros after
#     the softmax) leaves the sums alone.
# ---------------------------------------------------------------------------

_DECODE_EPS = 1e-6


def decode_support_reason(model_config) -> str | None:
    """Why this model config cannot take the autoregressive decode path
    (None = supported). The decode walk reads the dense BERT tensors by
    name; what it does not know is refused by name rather than failing as
    a KeyError mid-stream."""
    if model_config.name.lower() not in ("bert", "bert_base", "bert-base"):
        return (f"model {model_config.name!r} has no causal decode head "
                f"(decode supports the dense bert family)")
    if getattr(model_config, "num_experts", 0):
        return "MoE encoder layers are not supported by the decode path"
    if getattr(model_config, "pipeline_stages", 1) > 1:
        return "pipelined checkpoints are not servable (see serve/export.py)"
    return None


def decode_params(state_dict: dict, device=None) -> dict:
    """The serving layout of a BertForMLM state_dict for the decode walk,
    on ``device``: f32 tensors, every dense kernel transposed once to a
    contiguous (K, N) (the separate query/key/value kernels concatenated
    into one (H, 3H), the fused one as it is), and the tied embedding
    table pre-transposed to the (H, V) ``projection`` — the counterpart of
    the JAX ``bert_decode_head_params``. Built at load and at every
    reload, so the two can never differ in layout."""

    def t(key):
        return state_dict[key].to(device, torch.float32)

    def dense(prefix):
        return (t(f"{prefix}.weight").t().contiguous(), t(f"{prefix}.bias"))

    def norm(prefix):
        return (t(f"{prefix}.weight"), t(f"{prefix}.bias"))

    layers = []
    i = 0
    while f"layer{i}.ln1.weight" in state_dict:
        p = f"layer{i}"
        if f"{p}.attn.qkv.weight" in state_dict:
            qkv = dense(f"{p}.attn.qkv")
        else:
            parts = [dense(f"{p}.attn.{n}") for n in ("query", "key",
                                                      "value")]
            qkv = (torch.cat([w for w, _ in parts], dim=1).contiguous(),
                   torch.cat([b for _, b in parts]))
        layers.append({"qkv": qkv, "attn_out": dense(f"{p}.attn.attn_out"),
                       "ln1": norm(f"{p}.ln1"),
                       "mlp_in": dense(f"{p}.mlp_in"),
                       "mlp_out": dense(f"{p}.mlp_out"),
                       "ln2": norm(f"{p}.ln2")})
        i += 1
    table = t("embed_block.embed.weight")
    return {"embed": table, "pos": t("embed_block.pos_embedding"),
            "embed_ln": norm("embed_block.embed_ln"), "layers": layers,
            "head": {"transform": dense("head.mlm_transform"),
                     "ln": norm("head.mlm_ln"),
                     "projection": table.t().contiguous(),
                     "bias": t("head.mlm_bias")}}


def _decode_ln(p, x):
    """f32 LayerNorm, ε = 1e-6, the JAX decode walk's two-pass form."""
    scale, bias = p
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + _DECODE_EPS) * scale + bias


def _decode_matmul(x, w):
    """``x @ w`` over x's rows flattened, a single row run as two (see
    the section's comment)."""
    rows = x.reshape(-1, x.shape[-1])
    if rows.shape[0] == 1:
        y = (rows.expand(2, -1) @ w)[:1]
    else:
        y = rows @ w
    return y.reshape(*x.shape[:-1], w.shape[1])


def _decode_dense(p, x):
    w, b = p
    return _decode_matmul(x, w) + b


def bert_decode_layers(params: dict, ids, positions, attend):
    """The shared causal walk: embed -> N x (attn -> add&norm -> MLP ->
    add&norm), f32. ``ids``/``positions``: (B, T) int64. ``attend(layer,
    q, k, v) -> context`` with q/k/v/context all (B, T, H) f32 — prefill
    passes an in-register causal attention, the per-token decode step a
    paged-pool write and gather. Returns the final hidden states (B, T,
    H)."""
    x = params["embed"][ids] + params["pos"][positions]
    x = _decode_ln(params["embed_ln"], x)
    h = x.shape[-1]
    for i, lp in enumerate(params["layers"]):
        q, k, v = _decode_dense(lp["qkv"], x).split(h, dim=-1)
        ctx = attend(i, q, k, v)
        x = _decode_ln(lp["ln1"], x + _decode_dense(lp["attn_out"], ctx))
        y = F.gelu(_decode_dense(lp["mlp_in"], x), approximate="tanh")
        x = _decode_ln(lp["ln2"], x + _decode_dense(lp["mlp_out"], y))
    return x


def bert_decode_logits(params: dict, hidden):
    """MLM head over decode hidden states: transform -> gelu -> LN ->
    tied-embedding projection + bias, all f32. hidden: (..., H)."""
    head = params["head"]
    t = F.gelu(_decode_dense(head["transform"], hidden), approximate="tanh")
    t = _decode_ln(head["ln"], t)
    return _decode_matmul(t, head["projection"]) + head["bias"]


def _sqrt_f32(d: int) -> float:
    """√d rounded to f32, as the JAX walk divides by ``jnp.sqrt(f32(d))``."""
    return float(torch.tensor(float(d)).sqrt())


def causal_prefill_attention(q, k, v, length, num_heads: int):
    """In-register causal attention for the prefill pass. q/k/v:
    (B, S, H) f32; ``length`` (B,) masks keys past each row's prompt.
    Query row i attends keys j <= i (and j < length)."""
    b, s, h = q.shape
    d = h // num_heads
    qh = q.reshape(b, s, num_heads, d)
    kh = k.reshape(b, s, num_heads, d)
    vh = v.reshape(b, s, num_heads, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / _sqrt_f32(d)
    idx = torch.arange(s, device=q.device)
    causal = idx[None, :] <= idx[:, None]                      # (Sq, Sk)
    valid = idx[None, None, None, :] < length[:, None, None, None]
    scores = torch.where(causal[None, None] & valid, scores, _F32_MIN)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, s, h)


def paged_decode_attention(q, k_keys, v_keys, positions, num_heads: int):
    """One-token attention over gathered paged KV. q: (B, H) for the
    current token; k_keys/v_keys: (B, S_kv, H) gathered from the page
    pool (padding included); keys at j <= positions[b] are live, the
    rest — page-table padding and not-yet-written slots — are masked.
    Reduced over outer dims so that a row's result depends on neither
    its neighbours nor the padded S_kv (see the section's comment)."""
    b, h = q.shape
    s_kv = k_keys.shape[1]
    d = h // num_heads
    kh = k_keys.reshape(b, s_kv, num_heads, d)
    vh = v_keys.reshape(b, s_kv, num_heads, d)
    scores = (q.reshape(b, 1, num_heads, d) * kh).sum(-1) / _sqrt_f32(d)
    live = (torch.arange(s_kv, device=q.device)[None, :]
            <= positions[:, None])                             # (B, S_kv)
    scores = torch.where(live[:, :, None], scores, _F32_MIN)
    probs = torch.softmax(scores, dim=1)                       # over keys
    return (probs[..., None] * vh).sum(1).reshape(b, h)
