"""Plain PyTorch pieces the references share: f32 with TF32 off, the
learning-rate schedule, per-leaf norms, and the fp8 rounding of the
control.

Imports nothing of the program: the configuration comes in as the plain
dict of the experiment as run.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# Largest finite values of the two fp8 formats.
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact_f32():
    """f32 products as f32: TF32 off for cuBLAS and cuDNN inside the
    block, the previous settings back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under one per-tensor scale (amax ↦ the
    format's largest value), back in f32."""
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


class _FP8(torch.autograd.Function):
    """Forward: the tensor rounded to fp8 e4m3; backward: its gradient
    rounded to fp8 e5m2 (the two formats of fp8 training)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Ops:
    """The products and the activations of a reference: plain f32, or
    (``quant="fp8"``, the control) fp8 where the configuration computes in
    bf16: every product's operands and every activation the program keeps
    in its compute dtype rounded to e4m3 going forward, their gradients
    to e5m2 going back, each tensor under one scale (amax ↦ the format's
    largest value); products accumulate in f32, normalisations and the
    loss stay f32."""

    def __init__(self, quant: str | None = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.act = _FP8.apply if quant else (lambda t: t)

    def mm(self, a, b):
        return self.act(a) @ self.act(b)

    def conv(self, x, w, stride):
        return F.conv2d(self.act(x), self.act(w), stride=stride)


def learning_rate(opt: dict, total_steps: int, step: int) -> float:
    """The schedule at ``step`` (the count before the update): a linear
    warmup from 0 over ``warmup_steps``, then ``constant``, ``linear`` to
    0 over the rest, or ``staircase`` (``decay_factor`` at each of the
    absolute ``boundaries``)."""
    base, warm = float(opt["learning_rate"]), int(opt["warmup_steps"])
    if step < warm:
        return base * step / warm
    after = step - warm
    kind = opt["schedule"]
    if kind == "constant":
        return base
    if kind == "linear":
        span = max(1, total_steps - warm)
        return base * (1.0 - min(after, span) / span)
    if kind == "staircase":
        value = base
        for b in sorted({int(b) - warm for b in opt["boundaries"]}):
            if after >= b:
                value *= float(opt["decay_factor"])
        return value
    raise ValueError(f"schedule {kind!r} has no reference")


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                         for n in names]).tolist()
    return dict(zip(names, norms))


def decays(shape) -> bool:
    """Weight decay applies to kernels and embedding tables (rank ≥ 2),
    not to biases or normalisation scales."""
    return len(shape) >= 2
