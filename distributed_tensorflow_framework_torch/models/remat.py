"""Activation rematerialisation: a block's forward under
``torch.utils.checkpoint`` with the JAX package's save policies.

The counterpart of ``nn.remat(block, policy=...)`` in the JAX models. The
backward recomputes the block's activations from its input instead of
keeping them; a policy names what the checkpoint keeps all the same:

  * ``None`` / ``"save_nothing"`` (``nothing_saveable``): nothing but the
    block's inputs, the whole forward replayed;
  * ``"dots_saveable"``: the outputs of the matrix products (``aten.mm``,
    ``addmm``, ``bmm``, ``baddbmm``), as JAX keeps every ``dot_general``
    output. Convolutions are not dots. A product inside an
    ``autograd.Function``'s forward (the flash-attention kernels' wrapper,
    whose plain version on the CPU runs ``bmm``) runs with grad disabled
    and is recomputed, as a ``pallas_call`` is under ``dots_saveable``;
  * ``"conv_saved"`` (ResNet's ``model.remat_policy``): the output of
    every ``aten.convolution``, which is each ConvBN's conv output (JAX's
    ``conv_out`` name), so the recompute replays only the BatchNorm, ReLU
    and residual tail. The int8 branch (models/layers.py ``QuantConv``)
    runs no convolution op: its quantized product is replayed, as the
    recompute would replay it before reaching a kept output anyway.

The selective policies run through
``torch.utils.checkpoint.create_selective_checkpoint_contexts``; its two
contexts are composed with the port's own. In the recompute
:func:`replaying` is true, and BatchNorm (models/layers.py) then leaves
its running statistics alone: JAX's ``nn.remat`` drops the replay's
update, so the statistics after a step are those without remat. With a
``generator`` (BERT's dropout stream), the recompute runs from the
generator's state at the forward's start and then puts it back where it
stood (:func:`replay_generator`), since ``preserve_rng_state`` covers only
the default generators and other masks would give wrong gradients without
an error.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.utils.checkpoint as ckpt

aten = torch.ops.aten

POLICIES = ("save_nothing", "dots_saveable", "conv_saved")
DOT_OPS = frozenset({aten.mm.default, aten.addmm.default, aten.bmm.default,
                     aten.baddbmm.default})
_CONV_OPS = frozenset({aten.convolution.default})

_STATE = threading.local()


def replaying() -> bool:
    """Whether this thread is recomputing a checkpointed block."""
    return getattr(_STATE, "replay", False)


@contextlib.contextmanager
def _replay():
    before = replaying()
    _STATE.replay = True
    try:
        yield
    finally:
        _STATE.replay = before


@contextlib.contextmanager
def replay_generator(generator: torch.Generator, state: torch.Tensor):
    """Run the body with ``generator`` set to ``state``, then return it to
    where it stood before the body."""
    after = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(after)


def _policy_fn(policy: str):
    keep = DOT_OPS if policy == "dots_saveable" else _CONV_OPS

    def fn(ctx, op, *args, **kwargs):
        save = op in keep and torch.is_grad_enabled()
        return (ckpt.CheckpointPolicy.MUST_SAVE if save
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return fn


@contextlib.contextmanager
def _all(managers):
    with contextlib.ExitStack() as stack:
        for manager in managers:
            stack.enter_context(manager)
        yield


def checkpoint(fn, *args, policy: str | None = None,
               generator: torch.Generator | None = None):
    """``fn(*args)`` under an activation checkpoint with ``policy`` (None
    or one of :data:`POLICIES`), replaying ``generator`` in the
    recompute."""
    if policy is not None and policy not in POLICIES:
        raise ValueError(f"remat policy must be one of {POLICIES}, got "
                         f"{policy!r}")

    def contexts():
        forward, recompute = [], [_replay()]
        if generator is not None:
            recompute.append(replay_generator(generator,
                                              generator.get_state()))
        if policy in ("dots_saveable", "conv_saved"):
            caching, cached = ckpt.create_selective_checkpoint_contexts(
                _policy_fn(policy))
            forward.append(caching)
            recompute.append(cached)
        return _all(forward), _all(recompute)

    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, context_fn=contexts)
