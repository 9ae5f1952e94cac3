"""Pipeline parallelism: BERT's encoder stack split into stages over the
ranks along ``pipe``, under the gpipe, 1f1b and interleaved schedules.

The port's counterpart of the JAX package's ``parallel/pipeline.py``. The
JAX package stacks the layers (leading dim L), shards that dim over
``pipe`` and runs a static schedule inside a nested ``shard_map`` that
every device executes in lockstep, garbage in the fill and drain slots.
The port runs one process per GPU, so one rank is one stage: it holds
only its own layers (:class:`PipelinedBert`; the stored layer order is
the natural one, ``layer{g}`` for global layer g, whatever the schedule),
and the schedules of parallel/schedule.py are walked by hand, the
activations moving stage to stage by point-to-point sends on the pipe
line's own process group (``MeshRuntime.ppermute_`` along ``pipe``):

``gpipe`` — the circular fill-drain forward: ``M + S - 1`` slots; in
every slot every rank joins the +1 shift of its carry, stage 0 takes
microbatch ``t`` in, and a rank computes only its active slots
(``0 <= t - idx < M``), where JAX computes garbage and drops it (the
result is the same). Each active slot's graph is kept (residency M
stage-activation sets a rank); the backward walks the slots in reverse,
each slot's gradient shifting -1.

``interleaved`` — ``v`` round-robin chunks a rank (global chunk
``q = c·S + s`` on rank ``s``, :func:`stage_chunks`): ``v·M + S - 1``
slots, stage 0 taking a microbatch in at chunk 0 and the last stage
emitting it at chunk ``v - 1``; the same +1 shift carries chunk ``q``'s
output to chunk ``q + 1`` one slot later, and the backward mirrors it.

``1f1b`` — one ``torch.autograd.Function``: its forward is the circular
schedule with no graph kept; its backward walks ``slot_table("1f1b")``:
per slot a forward (re)compute hop at +1 into a rolling store of depth
``2S - 1`` (the stage input and the recompute's graph) and a backward hop
at -1, where each rank runs ``torch.autograd.grad`` of one microbatch
against its own layers from its stored entry. A microbatch's state lives
from its forward slot to its backward slot, at most ``min(M, 2S - 1)``
of them on stage 0 (``schedule.peak_inflight``): the JAX package keeps
only the boundary input there and linearises the stage again inside the
backward slot; the port keeps the recompute's graph instead, so a stage
runs its forward twice a step (the forward and the recompute), not three
times.

Each (microbatch, global layer) pair draws its dropout masks from its own
generator, seeded from the rank's dropout stream at the stack's entry
(:func:`stream_base`) and the pair, so every schedule draws the same
masks, and the 1f1b recompute replays the forward's.

The stack's two ends are collectives (parallel/collectives.py): the
embedding's output enters through :func:`~.collectives.from_member` (the
identity; stage 0's input cotangent is broadcast to every stage, the
JAX ``psum`` over ``pipe`` of a cotangent only stage 0 holds), and the
last stage's output reaches every stage through
:func:`~.collectives.take_member` (the JAX ``mapped(...)[-1]``), so the
embedding and the MLM head, replicated over ``pipe``, run on every stage
with the same values and take the same gradients: not summed over
``pipe``, and not left on one stage. The stage parameters are inputs of
the executors' Functions, so their gradients accumulate into ``.grad``
and DDP's hooks fire.

:class:`StageLayout` turns a rank's state into the whole layout and
back: a checkpoint holds the whole stack in the natural layer order
(every stage's layers gathered over ``pipe``), which one process (a
``BertForMLM``) or a run under another schedule reads.

With ``ckpt_policy`` (``precision.remat_policy``, the JAX
``_stage_apply``'s per-layer ``jax.checkpoint``) every layer a stage runs
with grad enabled is checkpointed under that policy (models/bert.py
``remat_layer``, its dropout stream replayed): the gpipe and interleaved
forwards keep each slot's graph with the layers' activations
recomputed in the backward, and 1f1b's recompute, which runs inside the
slot's backward, checkpoints the layers again, so their activations are
rebuilt inside ``torch.autograd.grad`` of that slot.

Packed rows (segment ids) are refused with a TypeError, as the JAX
``PipelinedBert.apply`` takes no segment ids.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch
from torch import nn

from distributed_tensorflow_framework_torch.core.mesh import (
    _pack_bytes,
    _unpack_bytes,
)
from distributed_tensorflow_framework_torch.models.bert import remat_layer
from distributed_tensorflow_framework_torch.parallel import collectives as coll
from distributed_tensorflow_framework_torch.parallel import schedule as sched

# The Flax tree's key of the stacked layer stack (models/convert.py).
STACK_KEY = "pipeline_layers"
AXIS = "pipe"


def stage_chunks(num_layers: int, stages: int, virtual: int,
                 index: int) -> list[list[int]]:
    """The global layers of each of stage ``index``'s chunks, chunk 0
    first: chunk c is global chunk ``c·S + index`` of ``L / (S·v)``
    layers (one chunk, the stage's contiguous ``L/S`` layers, at v = 1)."""
    per = num_layers // (stages * virtual)
    return [list(range((c * stages + index) * per,
                       (c * stages + index + 1) * per))
            for c in range(virtual)]


def interleave_perm(num_layers: int, stages: int, virtual: int) -> list[int]:
    """The stack's rows in stage order, each stage's chunks in c order:
    the JAX package's ``_interleave_perm``, whose block s of ``L/S`` rows
    is what device s holds."""
    return [g for s in range(stages)
            for chunk in stage_chunks(num_layers, stages, virtual, s)
            for g in chunk]


@dataclasses.dataclass(frozen=True)
class SlotWork:
    """What a rank computes in one forward slot: chunk ``chunk`` of
    microbatch ``mb``, its input taken in from the embedding
    (``inject``) or from the carry, its output the stack's (``emit``) or
    the next stage's carry."""

    mb: int
    chunk: int
    inject: bool
    emit: bool


def forward_plan(schedule: str, stages: int, microbatches: int,
                 virtual: int, index: int) -> list[SlotWork | None]:
    """Stage ``index``'s work in each forward slot of ``schedule`` (None:
    idle), from ``schedule.slot_table``."""
    s, v = stages, virtual
    table = sched.slot_table("gpipe" if schedule == "1f1b" else schedule,
                             s, microbatches, v)
    out: list[SlotWork | None] = []
    for slot in table:
        if index not in slot.fwd:
            out.append(None)
            continue
        c = ((slot.t - index) % (s * v)) // s if schedule == "interleaved" \
            else 0
        out.append(SlotWork(slot.fwd[index], c, index == 0 and c == 0,
                            index == s - 1 and c == v - 1))
    return out


def stream_base(generator: torch.Generator) -> int:
    """A seed from the state of a rank's dropout stream (its bytes hashed:
    no draw, no device sync), from which each (microbatch, layer) pair's
    stream derives. The ranks along ``pipe`` share a data-parallel index,
    hence the stream, hence the base."""
    state = generator.get_state().numpy().tobytes()
    return int.from_bytes(hashlib.blake2b(state, digest_size=8).digest(),
                          "little") & 0x7FFF_FFFF_FFFF_FFFF


def layer_seed(base: int, mb: int, layer: int) -> int:
    """The seed of microbatch ``mb``'s dropout stream in global layer
    ``layer``."""
    state = np.random.SeedSequence((base, mb, layer)).generate_state(
        1, np.uint64)[0]
    return int(state) & 0x7FFF_FFFF_FFFF_FFFF


class _Stack:
    """One call of the stack on this rank: the microbatches of its input,
    their masks, the dropout base and the parameters to differentiate,
    and the schedules' walks."""

    def __init__(self, model: "PipelinedBert", x: torch.Tensor,
                 mask: torch.Tensor | None, base: int | None):
        m = model.num_microbatches
        if x.shape[0] % m:
            raise ValueError(f"per-shard batch {x.shape[0]} not divisible "
                             f"by num_microbatches={m}")
        self.model, self.runtime = model, model.runtime
        self.s, self.m, self.index = model.num_stages, m, model.stage
        self.plan = forward_plan(model.schedule, self.s, m,
                                 model.virtual_stages, self.index)
        self.x = x
        self.xm = x.detach().chunk(m)
        self.masks = [None] * m if mask is None else list(mask.chunk(m))
        self.base = base
        self.params = [p for p in model.stage_parameters()
                       if p.requires_grad]
        # The carry between stages is a layer's output: f32, whatever the
        # activation dtype (the LayerNorms return f32).
        self.zeros = torch.zeros(self.xm[0].shape, dtype=torch.float32,
                                 device=x.device)

    def run_chunk(self, c: int, x: torch.Tensor, mb: int) -> torch.Tensor:
        """Chunk ``c`` of this stage on microbatch ``mb``'s ``x``."""
        for g in self.model.chunks[c]:
            gen = None
            if self.base is not None:
                gen = self.model.layer_generator(x.device)
                gen.manual_seed(layer_seed(self.base, mb, g))
            layer = getattr(self.model, f"layer{g}")
            if self.model.ckpt_policy is not None and torch.is_grad_enabled():
                x, _ = remat_layer(layer, x, self.masks[mb], None, gen,
                                   self.model.ckpt_policy)
            else:
                x, _ = layer(x, self.masks[mb], None, gen)
        return x

    def hop(self, buf: torch.Tensor, shift: int) -> torch.Tensor:
        return self.runtime.ppermute_([torch.empty_like(buf)], [buf], shift,
                                      AXIS)[0]

    def _leaf(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach().requires_grad_(x.is_floating_point())

    def forward(self, keep: bool) -> tuple[torch.Tensor, dict]:
        """The circular (or interleaved) forward; with ``keep``, each active
        slot's (input leaf, output) graph by slot. Returns the stack's
        output (the last stage's; zeros elsewhere) and the graphs."""
        outs: list[Any] = [None] * self.m
        graphs = {}
        buf = self.zeros
        for t, work in enumerate(self.plan):
            if t:
                buf = self.hop(buf, 1)
            if work is None:
                continue
            inp = self.xm[work.mb] if work.inject else buf
            if keep:
                leaf = self._leaf(inp)
                with torch.enable_grad():
                    y = self.run_chunk(work.chunk, leaf, work.mb)
                graphs[t] = (leaf, y)
                y = y.detach()
            else:
                y = self.run_chunk(work.chunk, inp, work.mb)
            buf = y
            if work.emit:
                outs[work.mb] = y
        if self.index == self.s - 1:
            return torch.cat(outs), graphs
        return self.x.new_zeros(self.x.shape, dtype=torch.float32), graphs

    def _vjp(self, leaf, y, g_out, acc):
        got = torch.autograd.grad(y, [leaf, *self.params], g_out,
                                  allow_unused=True)
        for i, g in enumerate(got[1:]):
            if g is not None:
                acc[i] = g if acc[i] is None else acc[i] + g
        return got[0]

    def _results(self, dxm, acc):
        dx = (torch.cat(dxm) if self.index == 0
              else torch.zeros_like(self.x))
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, acc)]
        return dx, grads

    def backward_graphs(self, graphs: dict, dy: torch.Tensor):
        """The mirror of :meth:`forward`: the slots in reverse, each active
        slot's gradient from its kept graph, the input's gradient shifting
        -1 (zeros from an idle or injected slot). Returns (dx, the
        parameters' gradients)."""
        dym = dy.chunk(self.m)
        acc: list[Any] = [None] * len(self.params)
        dxm: list[Any] = [None] * self.m
        gbuf = self.zeros
        for t in reversed(range(len(self.plan))):
            work, send = self.plan[t], self.zeros
            if work is not None:
                leaf, y = graphs.pop(t)
                g_out = dym[work.mb] if work.emit else gbuf
                dxin = self._vjp(leaf, y, g_out, acc)
                if work.inject:
                    dxm[work.mb] = dxin
                else:
                    send = dxin
            if t:
                gbuf = self.hop(send, -1)
        return self._results(dxm, acc)

    def backward_1f1b(self, dy: torch.Tensor):
        """The 1F1B backward: ``slot_table("1f1b")`` with a forward
        (re)compute hop at +1 into the rolling store and a backward hop at
        -1 per slot (see the module docstring)."""
        s, idx = self.s, self.index
        dym = dy.chunk(self.m)
        acc: list[Any] = [None] * len(self.params)
        dxm: list[Any] = [None] * self.m
        depth = 2 * s - 1
        store: list[Any] = [None] * depth
        fbuf, gbuf, send = self.zeros, self.zeros, self.zeros
        for slot in sched.slot_table("1f1b", s, self.m):
            t = slot.t
            if slot.fwd:
                if t:
                    fbuf = self.hop(fbuf, 1)
                if idx in slot.fwd:
                    mb = slot.fwd[idx]
                    leaf = self._leaf(self.xm[mb] if idx == 0 else fbuf)
                    with torch.enable_grad():
                        y = self.run_chunk(0, leaf, mb)
                    store[t % depth] = (leaf, y)
                    fbuf = y.detach()
            if slot.bwd:
                if t > s - 1:
                    gbuf = self.hop(send, -1)
                send = self.zeros
                if idx in slot.bwd:
                    mb = slot.bwd[idx]
                    # This stage forwarded mb at slot mb + idx.
                    leaf, y = store[(mb + idx) % depth]
                    store[(mb + idx) % depth] = None
                    g_out = dym[mb] if idx == s - 1 else gbuf
                    dxin = self._vjp(leaf, y, g_out, acc)
                    if idx == 0:
                        dxm[mb] = dxin
                    else:
                        send = dxin
        return self._results(dxm, acc)


class _GraphSchedule(torch.autograd.Function):
    """gpipe and interleaved: the forward keeps each slot's graph, the
    backward mirrors the slots."""

    @staticmethod
    def forward(ctx, stack, x, *params):
        out, ctx.graphs = stack.forward(keep=True)
        ctx.stack = stack
        return out

    @staticmethod
    def backward(ctx, dy):
        dx, grads = ctx.stack.backward_graphs(ctx.graphs, dy.contiguous())
        ctx.graphs = None
        return (None, dx, *grads)


class _OneFOneB(torch.autograd.Function):
    """1f1b: the forward keeps nothing but its input, the backward
    recomputes each stage's forward inside the 1F1B slot walk."""

    @staticmethod
    def forward(ctx, stack, x, *params):
        ctx.stack = stack
        return stack.forward(keep=False)[0]

    @staticmethod
    def backward(ctx, dy):
        dx, grads = ctx.stack.backward_1f1b(dy.contiguous())
        return (None, dx, *grads)


class PipelinedBert(nn.Module):
    """BERT for MLM with the encoder stack pipelined over ``pipe``: this
    rank's stage of a ``BertForMLM`` (``whole``, whose other layers it
    drops), with the embedding and the MLM head replicated on every
    stage. ``schedule`` and ``virtual_stages`` select the stage schedule
    (parallel/schedule.py; ``virtual_stages`` 0 resolves as there);
    ``num_microbatches`` 0 means ``num_stages``; ``ckpt_policy`` checkpoints
    each layer under that save policy (models/remat.py). The parameters keep the
    whole model's names, so a state_dict is a part of the whole one."""

    def __init__(self, whole: nn.Module, runtime, *, num_stages: int,
                 num_microbatches: int = 0, schedule: str = "gpipe",
                 virtual_stages: int = 0, model_kwargs: dict | None = None,
                 ckpt_policy: str | None = None):
        super().__init__()
        if runtime is None:
            raise ValueError("PipelinedBert needs the mesh runtime (the "
                             "ranks along pipe)")
        if whole.num_layers % num_stages:
            raise ValueError(
                f"num_layers={whole.num_layers} must divide into "
                f"pipeline_stages={num_stages}")
        group = runtime.axis_group(AXIS)
        if group.size != num_stages:
            raise ValueError(
                f"model.pipeline_stages={num_stages} must equal the mesh's "
                f"pipe axis size {group.size}")
        self.runtime = runtime
        self.num_layers = whole.num_layers
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches or num_stages
        self.schedule = schedule
        self.virtual_stages = sched.resolve_virtual(
            schedule, num_stages, self.num_microbatches, virtual_stages,
            whole.num_layers)
        self.stage = group.index
        self.chunks = stage_chunks(self.num_layers, num_stages,
                                   self.virtual_stages, self.stage)
        self.layer_ids = [g for chunk in self.chunks for g in chunk]
        self.model_kwargs = dict(model_kwargs or {})
        self.ckpt_policy = ckpt_policy
        self.dropout_rate = whole.embed_block.dropout_rate
        self.embed_block = whole.embed_block
        for g in sorted(self.layer_ids):
            self.add_module(f"layer{g}", getattr(whole, f"layer{g}"))
        self.head = whole.head
        self._generator = None

    def stage_parameters(self) -> list[torch.Tensor]:
        """This stage's layers' parameters, in chunk order."""
        return [p for g in self.layer_ids
                for p in getattr(self, f"layer{g}").parameters()]

    def is_stage_key(self, key: str) -> bool:
        """Whether a state_dict key belongs to the pipelined stack."""
        return key.startswith("layer")

    def layer_generator(self, device: torch.device) -> torch.Generator:
        """The generator each (microbatch, layer) stream is seeded into."""
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
        return self._generator

    @property
    def bubble_frac(self) -> float:
        return sched.bubble_frac(self.schedule, self.num_stages,
                                 self.num_microbatches, self.virtual_stages)

    def forward(self, input_ids, attention_mask=None, segment_ids=None, *,
                dropout_generator: torch.Generator | None = None):
        """Logits (B, S, vocab) f32 on every stage."""
        if segment_ids is not None:
            raise TypeError(
                "PipelinedBert takes no segment_ids (packed rows), as the "
                "JAX package's PipelinedBert.apply takes none")
        x, table = self.embed_block(input_ids, None, dropout_generator)
        mask = (None if attention_mask is None
                else attention_mask[:, None, None, :].bool())
        base = None
        if self.training and self.dropout_rate > 0:
            if dropout_generator is None:
                raise ValueError("dropout in train() mode needs a "
                                 "dropout_generator")
            base = stream_base(dropout_generator)
        rt = self.runtime
        x = coll.from_member(x, rt, AXIS, 0)
        stack = _Stack(self, x, mask, base)
        if torch.is_grad_enabled() and (x.requires_grad or stack.params):
            fn = _OneFOneB if self.schedule == "1f1b" else _GraphSchedule
            y = fn.apply(stack, x, *stack.params)
        else:
            with torch.no_grad():
                y = stack.forward(keep=False)[0]
        y = coll.take_member(y, rt, AXIS, self.num_stages - 1)
        return self.head(y, table)

    @torch.no_grad()
    def apply_reference(self, whole_state: dict, input_ids,
                        attention_mask=None) -> torch.Tensor:
        """The same parameters (the whole layout, ``StageLayout``) run
        straight through one ``BertForMLM`` in this process, in eval
        mode: the tests' reference."""
        from distributed_tensorflow_framework_torch.models.bert import (
            BertForMLM,
        )

        device = self.head.mlm_bias.device
        ref = BertForMLM(**self.model_kwargs, device=device)
        ref.load_state_dict(whole_state)
        return ref.eval()(input_ids, attention_mask)


def _flat_keys(keys, prefix: str) -> list[str]:
    return [k[len(prefix):] for k in keys if k.startswith(prefix)]


class StageLayout:
    """A pipelined model's state in the whole layout and back, and the
    global gradient norm over the stages. The whole layout is a whole
    ``BertForMLM``'s: its parameter keys in its order, its optimizer's
    indices in its order (decayed keys first, ``decay_mask``)."""

    def __init__(self, model: PipelinedBert):
        from distributed_tensorflow_framework_torch.train.optimizers import (
            decay_mask,
        )

        self.model = model
        self.runtime = model.runtime
        self.line = self.runtime.pipe_group
        s, v = model.num_stages, model.virtual_stages
        self.members = [
            [g for chunk in stage_chunks(model.num_layers, s, v, j)
             for g in chunk] for j in range(s)]
        keys = [k for k, _ in model.named_parameters()]
        first = model.layer_ids[0]
        self.suffixes = _flat_keys(keys, f"layer{first}.")
        local_mask = decay_mask(model)
        mask = {k: local_mask[k] for k in keys
                if not model.is_stage_key(k)}
        for g in range(model.num_layers):
            for suf in self.suffixes:
                mask[f"layer{g}.{suf}"] = local_mask[f"layer{first}.{suf}"]
        stack = self._stack_keys(range(model.num_layers))
        self.whole_keys = ([k for k in keys if k.startswith("embed_block.")]
                           + stack
                           + [k for k in keys if k.startswith("head.")])
        self.whole_opt_names = ([k for k in self.whole_keys if mask[k]]
                                + [k for k in self.whole_keys
                                   if not mask[k]])
        self.n_decay = sum(mask[k] for k in self.whole_keys)

    def _stack_keys(self, layers) -> list[str]:
        return [f"layer{g}.{suf}" for g in layers for suf in self.suffixes]

    def _gather(self, tensors: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        """Every stage's ``layer{g}.*`` tensors (each stage holding the same
        suffixes and shapes for its own layers) by whole key, on the host:
        one byte-exact all-gather over the pipe line."""
        mine = self._stack_keys(self.model.layer_ids)
        like = [tensors[k] for k in mine]
        rt = self.runtime
        packed, spans = _pack_bytes([t.detach() for t in like])
        packed = packed.to(rt.collective_device)
        out = torch.empty(self.line.size * packed.numel(),
                          dtype=torch.uint8, device=packed.device)
        rt.all_gather_(out, packed, self.line)
        out = out.cpu().view(self.line.size, -1)
        host_like = [t.detach().cpu() for t in like]
        whole = {}
        for j, layers in enumerate(self.members):
            parts = _unpack_bytes(out[j], spans, host_like)
            for key, t in zip(self._stack_keys(layers), parts):
                whole[key] = t.clone()
        return whole

    def whole(self, tensors: dict[str, torch.Tensor]
              ) -> dict[str, torch.Tensor]:
        """A stage's tensors by key (its parameters, EMA or gradients) →
        the whole model's, in its key order, the stack gathered from
        every stage. Every rank of the pipe line calls it."""
        gathered = self._gather(tensors)
        return {k: tensors[k] if k in tensors else gathered[k]
                for k in self.whole_keys}

    def _whole_optimizer(self, opt: dict, names: list[str]) -> dict:
        inner = opt["inner"]
        by_key = {names[i]: slots for i, slots in inner["state"].items()}
        state = {}
        if by_key:
            slot_names = list(by_key[names[0]])
            gathered = {
                s: self._gather({k: by_key[k][s] for k in by_key
                                 if self.model.is_stage_key(k)})
                for s in slot_names}
            for i, k in enumerate(self.whole_opt_names):
                state[i] = (by_key[k] if k in by_key
                            else {s: gathered[s][k] for s in slot_names})
        groups = inner["param_groups"]
        n = len(self.whole_opt_names)
        spans = [range(0, self.n_decay), range(self.n_decay, n)]
        groups = [dict(g, params=list(r)) for g, r in zip(groups, spans)]
        return {**opt, "inner": {**inner, "state": state,
                                 "param_groups": groups}}

    def global_state(self, state: dict, names: list[str]) -> dict:
        """``TrainState.state_dict()`` in the whole layout: the stack
        gathered from every stage (its parameters, EMA and optimizer
        slots), the embedding and head as this stage holds them. Every
        rank calls it."""
        out = dict(state)
        out["model"] = self.whole(state["model"])
        if "ema" in state:
            out["ema"] = self.whole(state["ema"])
        out["optimizer"] = self._whole_optimizer(state["optimizer"], names)
        return out

    def local_state(self, state: dict, names: list[str]) -> dict:
        """The inverse of :meth:`global_state`: this stage's part of a
        whole-layout state, its optimizer indices this rank's."""
        keys = [k for k, _ in self.model.named_parameters()]
        out = dict(state)
        out["model"] = {k: state["model"][k] for k in keys}
        if "ema" in state:
            out["ema"] = {k: state["ema"][k] for k in keys}
        inner = state["optimizer"]["inner"]
        index = {k: i for i, k in enumerate(self.whole_opt_names)}
        local = {}
        if inner["state"]:
            local = {i: inner["state"][index[k]] for i, k in enumerate(names)}
        n_decay = sum(1 for k in names
                      if index[k] < self.n_decay)
        spans = [range(0, n_decay), range(n_decay, len(names))]
        groups = [dict(g, params=list(r))
                  for g, r in zip(inner["param_groups"], spans)]
        out["optimizer"] = {**state["optimizer"], "inner": {
            **inner, "state": local, "param_groups": groups}}
        return out

    def global_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The whole gradient's norm: the stack's squares summed over the
        stages, the replicated leaves counted once."""
        stack = [g for k, g in grads.items() if self.model.is_stage_key(k)]
        rest = [g for k, g in grads.items()
                if not self.model.is_stage_key(k)]
        sq = torch.stack([torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([t.float() for t in ts]))
        ).square() for ts in (stack, rest)])
        stack_sq = sq[:1].clone()
        self.runtime.all_reduce_(stack_sq, self.runtime.axis_group(AXIS))
        return (stack_sq[0] + sq[1]).sqrt()
