"""Layer building blocks and initialisers for the port's models.

Initialisers draw from an explicit ``torch.Generator`` and match the
distributions of the JAX package's (``models/layers.py``, Flax): the bits
differ, the statistics do not.

  * dense kernels: variance_scaling(1.0, "fan_in", "truncated_normal") —
    normal truncated at ±2σ, rescaled so the truncated std is sqrt(1/fan_in);
  * conv kernels: variance_scaling(2.0, "fan_out", "normal"), a plain
    normal (Flax ``nn.Conv``'s own default, the truncated fan-in one, for
    LeNet's);
  * embedding tables: normal(0, 0.02);
  * biases zero, LayerNorm and BatchNorm scale one (zero for a residual
    block's last BN).

:func:`dense`, :class:`LayerNorm`, :class:`Conv` and :class:`BatchNorm`
reproduce Flax's dtype flow (``param_dtype=float32``, compute in
``dtype``; normalisation statistics in f32) so the bf16 rounding points
line up with the JAX model's. The image half (conv, BatchNorm, ConvBN,
space-to-depth, SAME max-pool) is below its own heading.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# Std of a unit normal truncated to [-2, 2]; Flax divides by it so the
# truncated draw has the requested variance.
_TRUNC_STD = 0.87962566103423978


def variance_scaling_fan_in_(weight: torch.Tensor, fan_in: int,
                             generator: torch.Generator | None) -> torch.Tensor:
    """Flax ``variance_scaling(1.0, "fan_in", "truncated_normal")``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def normal_(weight: torch.Tensor, std: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax ``nn.initializers.normal(std)``."""
    with torch.no_grad():
        return nn.init.normal_(weight, 0.0, std, generator=generator)


class Dense(nn.Module):
    """``y = x @ W.T + b`` with f32 parameters, computed in ``dtype``:
    Flax's Dense casts the input, kernel and bias to the compute dtype, so
    the product rounds once and the bias add rounds again. Under tensor
    parallelism ``tp`` (parallel/tensor_parallel.py ``ColumnParallel`` or
    ``RowParallel``) computes the layer from this rank's part of the
    weight and its collectives; None computes it whole."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.tp = None
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(
            out_features, dtype=torch.float32, device=device))

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        variance_scaling_fan_in_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp(x, self.weight, self.bias, self.dtype)
        return dense(x, self.weight, self.bias, self.dtype)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y + bias.to(dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            training: bool, part: tuple[int, int] | None = None
            ) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep each element with probability 1 − rate
    and scale it by 1/(1 − rate), computed in x's dtype; the identity when
    not training or at rate 0. ``part`` = (r, n): ``x`` is part r of n
    equal parts of a whole along dim 1 (sequence parallelism), so the
    mask is drawn at the whole's shape and part r of it kept — the mask
    one process draws for the whole, and the same draw from
    ``generator``."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train() mode needs a dropout_generator "
                         "(the port never draws from the global RNG)")
    keep_prob = 1.0 - rate
    shape = list(x.shape)
    if part is not None:
        shape[1] *= part[1]
    keep = torch.empty(shape, device=x.device).bernoulli_(
        keep_prob, generator=generator).bool()
    if part is not None:
        c = x.shape[1]
        keep = keep[:, part[0] * c:(part[0] + 1) * c]
    # Flax divides by keep_prob rounded to x's dtype (0.8984375 in bf16);
    # rounding it here on the host keeps the division free of a copy to
    # the device.
    rounded = torch.tensor(keep_prob, dtype=x.dtype).item()
    return torch.where(keep, x / rounded, 0.0)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: ε = 1e-6 (torch's default is
    1e-5), statistics in f32 with the fast variance E[x²] − E[x]² clamped
    at 0, and an f32 result whatever the input dtype."""

    def __init__(self, features: int, *, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(
            features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(
            features, dtype=torch.float32, device=device))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


# --------------------------------------------------------------- images --
#
# The image half of the JAX package's models/layers.py. The image models
# take NHWC batches, as the pipelines yield them and as the JAX models
# read them, permute them once at entry and run NCHW logically. The
# permuted view of an NHWC tensor has channels_last strides, which is the
# layout in which cuDNN runs bf16 convolutions on the tensor cores, and
# the trainer puts the weights in it too (``nn.Module.to(memory_format=
# torch.channels_last)``). Every op below keeps that layout.

def variance_scaling_fan_out_normal_(
        weight: torch.Tensor, generator: torch.Generator | None,
        scale: float = 2.0) -> torch.Tensor:
    """Flax ``variance_scaling(scale, "fan_out", "normal")`` for a conv
    weight (cout, cin, kh, kw): a plain normal (not truncated) with
    std √(scale / fan_out), fan_out = kh·kw·cout — the JAX package's
    ``conv_kernel_init``."""
    cout, _, kh, kw = weight.shape
    return normal_(weight, math.sqrt(scale / (kh * kw * cout)), generator)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding along one axis: the output is ⌈size/stride⌉ and
    the total padding max((out−1)·stride + kernel − size, 0), the smaller
    half before. At stride 2 it is asymmetric (a 3×3/s2 conv on 32 pads
    (0, 1), the 7×7/s2 stem on 224 pads (2, 3)), which a symmetric
    ``padding=k//2`` does not reproduce."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_pairs(x: torch.Tensor, kernel: tuple[int, int],
               stride: tuple[int, int], padding) -> tuple[tuple[int, int],
                                                          tuple[int, int]]:
    if padding == "SAME":
        return (same_pads(x.shape[2], kernel[0], stride[0]),
                same_pads(x.shape[3], kernel[1], stride[1]))
    if padding == "VALID":
        return (0, 0), (0, 0)
    return tuple(tuple(p) for p in padding)


def pad_nchw(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """``F.pad`` of H and W by ((top, bottom), (left, right)), kept in
    channels_last when x is."""
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    out = F.pad(x, (l, r, t, b), value=value)
    if x.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


class Conv(nn.Module):
    """Flax ``nn.Conv(param_dtype=float32)`` on NCHW activations: the
    weight is f32 (cout, cin, kh, kw) — the Flax kernel (kh, kw, cin, cout)
    transposed — and the input, weight and bias are cast to ``dtype``, so
    the conv rounds once and the bias add again. ``padding`` is "SAME"
    (XLA's, see :func:`same_pads`), "VALID" or explicit
    ((top, bottom), (left, right)) pairs, which pass through as given.
    Symmetric pads go to ``F.conv2d``; asymmetric ones are applied first
    with ``F.pad``. On the card an f32 conv takes cuDNN's default, TF32
    (``torch.backends.cudnn.allow_tf32``)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, int], *,
                 strides: tuple[int, int] = (1, 1), padding="SAME",
                 use_bias: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, *self.kernel_size, dtype=torch.float32,
            device=device))
        self.bias = (nn.Parameter(torch.empty(
            features, dtype=torch.float32, device=device))
            if use_bias else None)

    def reset_parameters(self, generator: torch.Generator | None, *,
                         init: str = "he") -> None:
        """``init="he"``: the JAX ``conv_kernel_init``; ``"lecun"``: Flax
        ``nn.Conv``'s default, variance_scaling(1, fan_in, truncated)."""
        if init == "he":
            variance_scaling_fan_out_normal_(self.weight, generator)
        else:
            cout, cin, kh, kw = self.weight.shape
            variance_scaling_fan_in_(self.weight, cin * kh * kw, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor, padding=None) -> torch.Tensor:
        """``padding`` overrides the layer's for this call (Inception's aux
        head picks it from the map's size)."""
        (t, b), (l, r) = _pad_pairs(x, self.kernel_size, self.strides,
                                    self.padding if padding is None
                                    else padding)
        x = x.to(self.dtype)
        if t == b and l == r:
            symmetric = (t, l)
        else:
            x, symmetric = pad_nchw(x, ((t, b), (l, r))), (0, 0)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias,
                        stride=self.strides, padding=symmetric)


def _all_reduce(t: torch.Tensor, group=None) -> None:
    """Sum ``t`` over the ranks of ``group`` (None: the default process
    group) in place; a no-op without a process group (one device)."""
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(t, group=group)


class _CrossRankBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over the batch of every rank of a process
    group (the data-parallel ranks, :func:`use_cross_rank_bn`), in f32:
    ``(x, weight, bias, eps, group) -> (y, mean, var)``.

    Forward: one ``all_reduce`` of the per-channel ``[Σx, Σx², n]``, then
    Flax's statistics, ``mean = E[x]`` and the biased
    ``var = max(E[x²] − E[x]², 0)``. Backward: one ``all_reduce`` of
    ``[Σdy, Σdy·x̂]`` gives the global means that ``dx`` needs; ``dweight``/``dbias`` stay the rank's
    own sums, which DDP averages with the other gradients. Only
    ``all_reduce``: gloo carries no other collective on CUDA tensors, and
    ``nn.SyncBatchNorm`` needs ``all_gather`` (and keeps the unbiased
    running variance). Without a process group the reductions are the
    rank's own: Flax's statistics on one device."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        ctx.group = group
        xf = x.float()
        dims, c = (0, 2, 3), x.shape[1]
        count = torch.full((1,), xf.numel() // c, dtype=torch.float32,
                           device=x.device)
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
        _all_reduce(stats, group)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp(min=0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean[:, None, None]) * invstd[:, None, None]
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return (xhat * weight[:, None, None] + bias[:, None, None], mean,
                var)

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dims, c = (0, 2, 3), x.shape[1]
        dy = dy.float()
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        dbias, dweight = local[:c].clone(), local[c:].clone()
        _all_reduce(local, ctx.group)
        mean_dy = (local[:c] / n)[:, None, None]
        mean_dy_xhat = (local[c:] / n)[:, None, None]
        dx = ((dy - mean_dy - xhat * mean_dy_xhat)
              * (invstd * weight)[:, None, None])
        return dx.to(x.dtype), dweight, dbias, None, None


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` (the JAX package's ``BatchNorm``,
    momentum 0.9, ε 1e-5) over the channels of an NCHW tensor.

    The statistics and the normalisation are f32 whatever the input
    dtype; the output is cast to ``dtype``. ``weight``/``bias`` are the
    Flax ``scale``/``bias``; ``running_mean``/``running_var`` are its
    ``batch_stats`` ``mean``/``var`` (no ``num_batches_tracked``, so the
    state_dict maps one to one). In train mode the running statistics move
    as Flax moves them, ``ra ← 0.9·ra + 0.1·batch`` (torch's momentum
    0.1), with the BIASED batch variance: ``F.batch_norm`` would fold in
    the unbiased one (×n/(n−1)), so its statistics are read into scratch
    buffers (momentum 1) and the update is made here, the variance scaled
    back by (n−1)/n. ``zero_init_gamma`` starts the scale at zero (the
    last BN of a residual block).

    ``cross_rank`` (:func:`use_cross_rank_bn`, which the trainer calls
    when the data-parallel ranks are more than one) takes the training
    statistics over the batch of every rank of ``group``, the data × fsdp
    ranks (:class:`_CrossRankBatchNorm`): under the JAX package's ``jit``
    the batch is one global array, so its BN statistics are global
    whatever ``model.bn_cross_replica`` says, and the ranks along
    ``model`` hold the same batch. At one data-parallel rank the
    single-device path above runs unchanged."""

    def __init__(self, features: int, *, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9, eps: float = 1e-5,
                 zero_init_gamma: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.zero_init_gamma = zero_init_gamma
        self.cross_rank = False
        self.group = None
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(features, **f32))
        self.bias = nn.Parameter(torch.empty(features, **f32))
        self.register_buffer("running_mean", torch.zeros(features, **f32))
        self.register_buffer("running_var", torch.ones(features, **f32))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_init_gamma else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=self.eps)
            return y.to(self.dtype)
        keep = self.momentum
        if self.cross_rank:
            y, mean, var = _CrossRankBatchNorm.apply(
                x, self.weight, self.bias, self.eps, self.group)
            with torch.no_grad():
                self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
                self.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
            return y.to(self.dtype)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias,
                         training=True, momentum=1.0, eps=self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(keep).add_(mean, alpha=1.0 - keep)
            self.running_var.mul_(keep).add_(var, alpha=(1.0 - keep)
                                             * (n - 1) / n)
        return y.to(self.dtype)


def use_cross_rank_bn(model: nn.Module, group=None) -> int:
    """Switch every BatchNorm of ``model`` to statistics over the ranks of
    ``group`` (a torch process group; None: the default one); returns how
    many there are."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.cross_rank = True
        bn.group = group
    return len(bns)


class ConvBN(nn.Module):
    """Conv (no bias, He init) → BatchNorm → optional ReLU: the JAX
    ``ConvBN``, whose Flax tree is ``conv/kernel`` and
    ``BatchNorm_0/bn/{scale,bias}`` (models/convert.py maps ``bn`` onto
    ``BatchNorm_0/bn``)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, int], *,
                 strides: tuple[int, int] = (1, 1), padding="SAME",
                 use_relu: bool = True, zero_init_gamma: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.use_relu = use_relu
        self.conv = Conv(in_features, features, kernel_size, strides=strides,
                         padding=padding, dtype=dtype, device=device)
        self.bn = BatchNorm(features, dtype=dtype,
                            zero_init_gamma=zero_init_gamma, device=device)

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        self.conv.reset_parameters(generator)
        self.bn.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.use_relu else x


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC space-to-depth: (N,H,W,C) → (N,H/b,W/b,b²·C), the channel
    order (di, dj, c) flattened — pixel (b·i+di, b·j+dj, c) lands at
    channel (di·b + dj)·C + c, the order the s2d stem's kernel mapping
    depends on."""
    n, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth: {h}x{w} not divisible by {block}")
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def max_pool_same(x: torch.Tensor, window: int,
                  stride: int) -> torch.Tensor:
    """Flax ``nn.max_pool(padding="SAME")``: XLA's SAME pads, filled with
    −inf, so a pad never wins the max."""
    pads = _pad_pairs(x, (window, window), (stride, stride), "SAME")
    return F.max_pool2d(pad_nchw(x, pads, value=float("-inf")), window,
                        stride)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """The NHWC batch as an NCHW view: no copy, channels_last strides."""
    return x.permute(0, 3, 1, 2)
