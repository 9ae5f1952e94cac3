"""BERT-base masked-LM pretraining in plain PyTorch, f32: the reference
of the ``bert-base-mlm`` configuration.

The encoder of Devlin et al. 2018 (arXiv:1810.04805) as the configuration
runs it: token + position embeddings, post-LayerNorm encoder layers
(self-attention with one fused Q/K/V projection laid out [q | k | v],
tanh-GELU MLP), dropout after the embedding LayerNorm, after the
attention's output projection and after the MLP; the MLM head (dense,
GELU, LayerNorm, the projection tied to the token table, an output bias),
softmax cross-entropy over the masked positions, divided by their count.
Departures from the paper, all as the configuration states them: LayerNorm
ε 1e-6; no token-type embedding, no pooler, no next-sentence loss; masked
positions hold the [MASK] id always (no 80/10/10).

The update: clipping by the global norm (``grad_clip_norm``), then AdamW
(ε outside the root, bias correction from step 1, decoupled weight decay
on rank ≥ 2 leaves) with the learning rate of the schedule at the step
before the update.

The dropout masks are drawn from a ``torch.Generator`` seeded with the
seed the benchmark gives both sides, in the program's order and at its
shapes: per step the embedding's, then per layer the attention's and the
MLP's, each ``torch.empty((B, S, H)).bernoulli_(keep)``.

Imports nothing of the program. Every tensor is f32 and TF32 is off;
``quant="fp8"`` is the control, fp8 where the configuration computes in
bf16 (reference/common.py ``Ops``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import (decays, exact_f32, leaf_norms,
                              learning_rate, Ops)


def _model(exp: dict) -> dict:
    return exp["model"]


def param_specs(exp: dict) -> dict:
    """name -> (shape, init), in the program's parameter names; every
    matrix and table normal(0, 0.02) (BERT's initializer range), biases
    zero, LayerNorm scales one."""
    m = _model(exp)
    h, f, v, s = (m["hidden_size"], m["mlp_dim"], m["vocab_size"],
                  m["max_seq_len"])
    w = ("normal", 0.02)
    specs = {
        "embed_block.pos_embedding": ((s, h), w),
        "embed_block.embed.weight": ((v, h), w),
        "embed_block.embed_ln.weight": ((h,), ("ones",)),
        "embed_block.embed_ln.bias": ((h,), ("zeros",)),
    }
    for i in range(m["num_layers"]):
        p = f"layer{i}."
        specs.update({
            p + "attn.qkv.weight": ((3 * h, h), w),
            p + "attn.qkv.bias": ((3 * h,), ("zeros",)),
            p + "attn.attn_out.weight": ((h, h), w),
            p + "attn.attn_out.bias": ((h,), ("zeros",)),
            p + "ln1.weight": ((h,), ("ones",)),
            p + "ln1.bias": ((h,), ("zeros",)),
            p + "mlp_in.weight": ((f, h), w),
            p + "mlp_in.bias": ((f,), ("zeros",)),
            p + "mlp_out.weight": ((h, f), w),
            p + "mlp_out.bias": ((h,), ("zeros",)),
            p + "ln2.weight": ((h,), ("ones",)),
            p + "ln2.bias": ((h,), ("zeros",)),
        })
    specs.update({
        "head.mlm_bias": ((v,), ("zeros",)),
        "head.mlm_transform.weight": ((h, h), w),
        "head.mlm_transform.bias": ((h,), ("zeros",)),
        "head.mlm_ln.weight": ((h,), ("ones",)),
        "head.mlm_ln.bias": ((h,), ("zeros",)),
    })
    return specs


def buffer_specs(exp: dict) -> dict:
    return {}


def step_flops(exp: dict, batch: dict) -> float:
    """Model FLOPs of one training step on ``batch``: three times the
    forward's products, counting the attention over the row's real keys,
    and the MLM head at the masked positions only (what the loss needs);
    a recomputed forward is not counted. Forward, per row of S real
    tokens: 2·S·L·(4H² + 2HF) in the projections and the MLP, 4·S²·H·L in
    the attention's two products, and 2·M·(H² + H·V) in the head for the
    row's M masked positions."""
    m = _model(exp)
    h, f, v, layers = (m["hidden_size"], m["mlp_dim"], m["vocab_size"],
                       m["num_layers"])
    lengths = batch["attention_mask"].sum(dim=1).double()
    masked = float((batch["targets"] >= 0).sum())
    tokens = float(lengths.sum())
    fwd = (2.0 * tokens * layers * (4 * h * h + 2 * h * f)
           + 4.0 * float((lengths ** 2).sum()) * h * layers
           + 2.0 * masked * (h * h + h * v))
    return 3.0 * fwd


def _layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _masked_ce_sum(P: dict, exp: dict, ids, attention_mask, targets, masks,
                   ops: Ops) -> torch.Tensor:
    """Σ of the masked positions' CE over these rows (``masks``: this
    step's dropout keep-masks, cut to these rows; None: no dropout)."""
    m = _model(exp)
    h, nh, eps = m["hidden_size"], m["num_heads"], 1e-6
    keep = 1.0 - m["dropout_rate"]
    b, s = ids.shape
    d = h // nh

    mm, act = ops.mm, ops.act

    def drop(x, k):
        return x if masks is None else torch.where(masks[k], x / keep, 0.0)

    def linear(x, name):
        return act(mm(x, P[name + ".weight"].t()) + P[name + ".bias"])

    x = act(P["embed_block.embed.weight"][ids.long()]
            + P["embed_block.pos_embedding"][:s])
    x = _layer_norm(x, P["embed_block.embed_ln.weight"],
                    P["embed_block.embed_ln.bias"], eps)
    x = drop(x, 0)
    valid = attention_mask.bool()[:, None, None, :]
    for i in range(m["num_layers"]):
        p = f"layer{i}."
        qkv = linear(x, p + "attn.qkv").view(b, s, 3, h)
        qh, kh, vh = (qkv[:, :, j].reshape(b, s, nh, d).transpose(1, 2)
                      for j in range(3))
        scores = mm(qh, kh.transpose(-1, -2)) / math.sqrt(d)
        scores = scores.masked_fill(~valid, float("-inf"))
        ctx = mm(torch.softmax(scores, dim=-1), vh)
        ctx = ctx.transpose(1, 2).reshape(b, s, h)
        a = drop(linear(ctx, p + "attn.attn_out"), 1 + 2 * i)
        x = _layer_norm(act(x + a), P[p + "ln1.weight"], P[p + "ln1.bias"],
                        eps)
        y = linear(act(_gelu(linear(x, p + "mlp_in"))), p + "mlp_out")
        y = drop(y, 2 + 2 * i)
        x = _layer_norm(act(x + y), P[p + "ln2.weight"], P[p + "ln2.bias"],
                        eps)
    sel = targets >= 0
    z = _gelu(linear(x[sel], "head.mlm_transform"))
    z = _layer_norm(z, P["head.mlm_ln.weight"], P["head.mlm_ln.bias"], eps)
    logits = mm(z, P["embed_block.embed.weight"].t()) + P["head.mlm_bias"]
    return F.cross_entropy(logits, targets[sel].long(), reduction="sum")


def draw_masks(gen: torch.Generator, exp: dict, rows: int, seq: int,
               device) -> list[torch.Tensor] | None:
    """One step's keep-masks in the program's draw order."""
    m = _model(exp)
    rate = m["dropout_rate"]
    if rate == 0.0:
        return None
    shape = (rows, seq, m["hidden_size"])
    return [torch.empty(shape, device=device).bernoulli_(
        1.0 - rate, generator=gen).bool()
        for _ in range(1 + 2 * m["num_layers"])]


def train_steps(exp: dict, params: dict, buffers: dict, batches: list,
                *, dropout_seed: int, quant: str | None = None,
                rows_block: int = 16) -> dict:
    """Run ``len(batches)`` steps from ``params``. Returns the loss of each
    step, each leaf's norm of the first step's gradient as the update
    takes it (after clipping), and each leaf's norm of its change over the
    steps. The rows of a step go through in blocks of ``rows_block``: the
    loss is a sum over masked positions divided by their count, so the
    blocks' gradients add up to the batch's."""
    ops = Ops(quant)
    opt = exp["optimizer"]
    if opt["name"] != "adamw":
        raise ValueError("the BERT reference updates with AdamW only")
    beta1, beta2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    wd, clip = opt["weight_decay"], opt["grad_clip_norm"]
    total_steps = exp["train"]["total_steps"]
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    mom = {k: torch.zeros_like(v) for k, v in start.items()}
    vel = {k: torch.zeros_like(v) for k, v in start.items()}
    losses, first_grads = [], None
    with exact_f32():
        for t, batch in enumerate(batches):
            ids, am, tg = (batch["input_ids"], batch["attention_mask"],
                           batch["targets"])
            rows, seq = ids.shape
            masks = draw_masks(gen, exp, rows, seq, device)
            count = (tg >= 0).sum().clamp(min=1).double()
            total = torch.zeros((), dtype=torch.float64, device=device)
            for r0 in range(0, rows, rows_block):
                r = slice(r0, r0 + rows_block)
                part = _masked_ce_sum(
                    P, exp, ids[r], am[r], tg[r],
                    None if masks is None else [mk[r] for mk in masks], ops)
                (part / count.float()).backward()
                total += part.detach().double()
            losses.append(float(total / count))
            with torch.no_grad():
                grads = {k: p.grad for k, p in P.items()}
                if clip > 0:
                    norm = torch.linalg.vector_norm(torch.stack(
                        [torch.linalg.vector_norm(g) for g in grads.values()]))
                    scale = (clip / norm).clamp(max=1.0)
                    for g in grads.values():
                        g.mul_(scale)
                if t == 0:
                    first_grads = leaf_norms(grads)
                lr = learning_rate(opt, total_steps, t)
                n = t + 1
                for k, p in P.items():
                    g = grads[k]
                    if decays(p.shape):
                        p.mul_(1.0 - lr * wd)
                    mom[k].mul_(beta1).add_(g, alpha=1.0 - beta1)
                    vel[k].mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
                    denom = (vel[k] / (1.0 - beta2 ** n)).sqrt_().add_(eps)
                    p.addcdiv_(mom[k], denom, value=-lr / (1.0 - beta1 ** n))
                    p.grad = None
    with torch.no_grad():
        change = leaf_norms({k: P[k].detach() - start[k] for k in P})
    return {"losses": losses, "grad_norms": first_grads,
            "change_norms": change}
