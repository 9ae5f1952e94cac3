"""Fused attention: the whole-K flash-attention kernels for Hopper.

Port of ``distributed_tensorflow_framework_tpu/ops/flash_attention.py``'s
whole-K regime: the forward (``_attn_fwd_kernel``, launched by
``_flash_fwd``) and the two-pass backward (``_attn_bwd_dq_kernel`` and
``_attn_bwd_dkv_kernel``, launched by ``_flash_bwd``). The kernels are
hand-written CUDA (``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``),
built for ``sm_90a`` at first use and called through ctypes.

Public functions keep the JAX package's layout and guards:

  * :func:`flash_attention` — ``(B, S, H, D)`` q/k/v, optional
    ``(B, 1, 1, S)`` bool mask and ``(B, S)`` segment ids, returns
    ``(B, S, H, D)`` in q's dtype.
  * :func:`flash_attention_with_lse` — the ``flash_attention_chunk``
    counterpart: additive ``(B, Sk)`` key bias, separate q/kv segment ids,
    returns ``(o, lse)`` with lse ``(B, S, H, 1)`` f32.

Both are differentiable through :class:`FlashAttention`, the counterpart of
``_make_fused``'s custom VJPs: the forward saves q, k, v, bias, the segment
ids, o and lse (nothing of size S×S), and the backward forms
``delta = Σ_d dO·O`` (minus the lse cotangent) in plain torch, as
``_flash_bwd`` does, then runs the dQ and dK/dV kernels. The key-bias
gradient (heads summed) is returned only when the bias requires grad.
Differentiating at S > MAX_SEQ_VMEM raises: the JAX package takes its
streaming kernels there (ROADMAP B5/B6), which are not ported.

Dispatch is by the tensors' device, never by a fallback: CUDA tensors
launch the kernels (or raise), CPU tensors run the plain PyTorch versions
:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`.
``flash_attention.launches``, ``flash_attention_dq_kernel.launches`` and
``flash_attention_dkv_kernel.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from distributed_tensorflow_framework_torch.ops._build import (
    KernelLaunchError,
    KernelLibrary,
)

NEG_INF = float(torch.finfo(torch.float32).min)
BLOCK_Q = 128  # the JAX kernel's q-block: sets the sequence-length guard
# Longest sequence the whole-K kernels take under autograd; the JAX package
# switches to its streaming backward above it.
MAX_SEQ_VMEM = 4096
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = KernelLibrary("flash_attn_fwd.cu", {
    "dtf_flash_attn_fwd": (_I, [
        _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, ctypes.c_float, _P]),
    "dtf_cuda_error_string": (ctypes.c_char_p, [_I]),
})
_BWD_OPERANDS = [_P] * 4 + [_LL] * 8 + [_P] * 5
_BWD_SHAPE = [_I, _I, _I, _I, _I, ctypes.c_float, _P]
_BWD_LIB = KernelLibrary("flash_attn_bwd.cu", {
    "dtf_flash_attn_bwd_dq": (_I, _BWD_OPERANDS + [_P] + _BWD_SHAPE),
    "dtf_flash_attn_bwd_dkv": (_I, _BWD_OPERANDS + [_P] * 3 + _BWD_SHAPE),
    "dtf_flash_attn_bwd_error_string": (ctypes.c_char_p, [_I]),
})


def attention_bias(mask: torch.Tensor | None, b: int, s: int,
                   device: torch.device) -> torch.Tensor:
    """(B, 1, 1, S) bool mask (or None) → additive (B, S) f32 key bias:
    0 where attended, the finite NEG_INF where masked."""
    if mask is None:
        return torch.zeros((b, s), dtype=torch.float32, device=device)
    keep = mask.reshape(b, s).to(device=device, dtype=torch.bool)
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)


def _scores(q, k, bias, q_seg, kv_seg):
    """(B, H, Sq, Sk) f32 scores with the TPU kernels' rounding points:
    dots of the inputs upcast to f32 (bf16 products are exact in f32),
    then scale, then bias; segment mismatches score the finite NEG_INF."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias.float()[:, None, None, :]
    if q_seg is not None:
        same = (q_seg.float()[:, None, :, None]
                == kv_seg.float()[:, None, None, :])
        s = torch.where(same, s, NEG_INF)
    return s


def flash_attention_reference(q, k, v, bias, q_seg=None, kv_seg=None):
    """Plain PyTorch version of the forward kernel, on any device: the TPU
    kernel's math with its rounding points (``p`` rounds to the input
    dtype before the PV product). Same arguments and results as
    :func:`flash_attention_with_lse`."""
    s = _scores(q, k, bias, q_seg, kv_seg)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                       # (B, H, Sq, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).permute(0, 2, 1, 3)          # (B, Sq, H, 1)
    return o.to(q.dtype), lse.contiguous()


def attention_delta(o, do, dlse=None):
    """``delta = Σ_d dO·O`` in f32, (B, S, H, 1), minus the lse cotangent
    when there is one (``_flash_bwd``: ∂lse/∂s = p folds into ds)."""
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    return delta if dlse is None else delta - dlse.float()


def _probs_and_ds(q, k, v, bias, q_seg, kv_seg, lse, do, delta):
    """Recomputed ``p = exp(s − lse)`` (no renormalisation: a fully-masked
    row, whose lse is NEG_INF, gets p = 1 for every key, as on the TPU) and
    ``ds = p·(dp − delta)``, both (B, H, Sq, Sk) f32."""
    p = torch.exp(_scores(q, k, bias, q_seg, kv_seg)
                  - lse.float().permute(0, 2, 1, 3))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.float().permute(0, 2, 1, 3))


def flash_attention_dq_reference(q, k, v, bias, q_seg, kv_seg, lse, do,
                                 delta):
    """Plain PyTorch version of the dQ kernel (same arguments as
    :func:`flash_attention_dq_kernel`): ``ds`` rounds to the input dtype
    for the ``ds·k`` product, scale multiplies after it."""
    _, ds = _probs_and_ds(q, k, v, bias, q_seg, kv_seg, lse, do, delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), k.float())
    return (dq * (1.0 / (q.shape[-1] ** 0.5))).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, bias, q_seg, kv_seg, lse, do,
                                  delta):
    """Plain PyTorch version of the dK/dV kernel (same arguments as
    :func:`flash_attention_dkv_kernel`): ``ds`` rounds to the input dtype
    for ``dsᵀ·q``, ``p`` for ``pᵀ·dO``, and the per-head key-bias gradient
    (B, H, Sk) f32 sums the unrounded ds."""
    p, ds = _probs_and_ds(q, k, v, bias, q_seg, kv_seg, lse, do, delta)
    dtype = q.dtype
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), do.float())
    dk = dk * (1.0 / (q.shape[-1] ** 0.5))
    return dk.to(dtype), dv.to(dtype), ds.sum(dim=2)


def flash_attention_bwd_reference(q, k, v, bias, q_seg, kv_seg, o, lse, do,
                                  delta=None):
    """Plain PyTorch version of the dQ and dK/dV kernels together, on any
    device: ``(dq, dk, dv, dbias_h)``, the first three (B, S, H, D) in the
    input dtype and dbias_h (B, H, Sk) f32. ``delta`` defaults to
    :func:`attention_delta` of (o, do)."""
    if delta is None:
        delta = attention_delta(o, do)
    args = (q, k, v, bias, q_seg, kv_seg, lse, do, delta)
    return (flash_attention_dq_reference(*args),
            *flash_attention_dkv_reference(*args))


def _head_view(t: torch.Tensor) -> torch.Tensor:
    """The kernels read (B, S, H, D) with free batch/sequence strides but
    dense (H, D) rows; anything else is copied once."""
    d = t.shape[-1]
    if t.stride(-1) != 1 or t.stride(-2) != d:
        t = t.contiguous()
    return t


def _kernel_operands(name, q, k, v, bias, q_seg, kv_seg, *more):
    """Check and lay out what a kernel reads: q, k, v and ``more`` (further
    (B, S, H, D) operands of q's dtype) as head views, the bias and segment
    ids as contiguous (B, S) f32. Raises on anything the kernels do not
    take."""
    b, s, h, d = q.shape
    heads = (q, k, v, *more)
    if not (q.is_cuda and all(t.device == q.device for t in heads)):
        raise ValueError(f"{name} needs its (B, S, H, D) operands on one "
                         f"CUDA device")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in heads):
        raise ValueError(
            f"{name} takes float32 or bfloat16 operands of one dtype, got "
            f"{[t.dtype for t in heads]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if any(t.shape != q.shape for t in heads):
        raise ValueError(f"{name} needs equal-shape operands, got "
                         f"{[tuple(t.shape) for t in heads]}")
    bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
    if bias.shape != (b, s):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(b, s)}")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both q_seg and kv_seg, or neither")
    if q_seg is not None:
        q_seg, kv_seg = (t.to(device=q.device, dtype=torch.float32)
                         .contiguous() for t in (q_seg, kv_seg))
        if q_seg.shape != (b, s) or kv_seg.shape != (b, s):
            raise ValueError("segment ids must be (B, S)")
    return [_head_view(t) for t in heads], bias, q_seg, kv_seg


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on_error(err, lib_error_string, name, q):
    if err:
        b, s, h, d = q.shape
        raise KernelLaunchError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib_error_string(err).decode()}) at "
            f"(B,S,H,D)=({b},{s},{h},{d}) {q.dtype}")


def flash_attention_kernel(q, k, v, bias, q_seg=None, kv_seg=None):
    """Launch the forward CUDA kernel on CUDA tensors; raises on anything
    it does not take. Returns ``(o, lse)`` like
    :func:`flash_attention_reference`. Adds one to
    ``flash_attention.launches`` per launch."""
    (q, k, v), bias, q_seg, kv_seg = _kernel_operands(
        "flash_attention_kernel", q, k, v, bias, q_seg, kv_seg)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, s, h, 1), dtype=torch.float32, device=q.device)
    lib = _LIB.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dtf_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), bias.data_ptr(), _ptr(q_seg),
            _ptr(kv_seg), o.data_ptr(), lse.data_ptr(), b, s, h, d,
            _DTYPE_CODES[q.dtype], 1.0 / (d ** 0.5), stream)
    flash_attention.launches += 1
    _raise_on_error(err, lib.dtf_cuda_error_string, "flash_attn_fwd", q)
    return o, lse


def _bwd_launch(entry, name, out_shapes, q, k, v, bias, q_seg, kv_seg, lse,
                do, delta):
    """Check the operands of a backward entry point, allocate its outputs
    (``out_shapes``: (shape, dtype) pairs, ``None`` dtype = q's) and launch
    it. Returns (CUDA error code, the library's error-string function,
    outputs)."""
    (q, k, v, do), bias, q_seg, kv_seg = _kernel_operands(
        name, q, k, v, bias, q_seg, kv_seg, do)
    b, s, h, d = q.shape
    lse, delta = (t.to(device=q.device, dtype=torch.float32).contiguous()
                  for t in (lse, delta))
    if lse.shape != (b, s, h, 1) or delta.shape != (b, s, h, 1):
        raise ValueError(f"lse and delta must be (B, S, H, 1) = "
                         f"{(b, s, h, 1)}")
    outs = [torch.empty(shape, dtype=dtype or q.dtype, device=q.device)
            for shape, dtype in out_shapes]
    lib = _BWD_LIB.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1),
            bias.data_ptr(), _ptr(q_seg), _ptr(kv_seg), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), b, s, h, d,
            _DTYPE_CODES[q.dtype], 1.0 / (d ** 0.5), stream)
    return err, lib.dtf_flash_attn_bwd_error_string, outs


def flash_attention_dq_kernel(q, k, v, bias, q_seg, kv_seg, lse, do, delta):
    """Launch the dQ CUDA kernel on CUDA tensors; raises on anything it
    does not take. Returns dq (B, S, H, D) in q's dtype, the first result
    of :func:`flash_attention_bwd_reference`. Adds one to
    ``flash_attention_dq_kernel.launches`` per launch."""
    err, error_string, (dq,) = _bwd_launch(
        "dtf_flash_attn_bwd_dq", "flash_attention_dq_kernel",
        [(q.shape, None)], q, k, v, bias, q_seg, kv_seg, lse, do, delta)
    flash_attention_dq_kernel.launches += 1
    _raise_on_error(err, error_string, "flash_attn_bwd_dq", q)
    return dq


def flash_attention_dkv_kernel(q, k, v, bias, q_seg, kv_seg, lse, do, delta):
    """Launch the dK/dV CUDA kernel on CUDA tensors; raises on anything it
    does not take. Returns ``(dk, dv, dbias_h)``, the last three results
    of :func:`flash_attention_bwd_reference`. Adds one to
    ``flash_attention_dkv_kernel.launches`` per launch."""
    b, s, h, _ = q.shape
    err, error_string, outs = _bwd_launch(
        "dtf_flash_attn_bwd_dkv", "flash_attention_dkv_kernel",
        [(q.shape, None), (q.shape, None), ((b, h, s), torch.float32)],
        q, k, v, bias, q_seg, kv_seg, lse, do, delta)
    flash_attention_dkv_kernel.launches += 1
    _raise_on_error(err, error_string, "flash_attn_bwd_dkv", q)
    return tuple(outs)


flash_attention_dq_kernel.launches = 0
flash_attention_dkv_kernel.launches = 0


def _check_device(q) -> None:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")


def _forward(q, k, v, bias, q_seg, kv_seg):
    if tuple(bias.shape) != tuple(q.shape[:2]):
        raise ValueError(f"bias shape {tuple(bias.shape)} != (B, S) = "
                         f"{tuple(q.shape[:2])}")
    _check_device(q)
    if q.is_cuda:
        return flash_attention_kernel(q, k, v, bias, q_seg, kv_seg)
    return flash_attention_reference(q, k, v, bias, q_seg, kv_seg)


def _backward(q, k, v, bias, q_seg, kv_seg, o, lse, do, delta):
    _check_device(q)
    if q.is_cuda:
        args = (q, k, v, bias, q_seg, kv_seg, lse, do, delta)
        return (flash_attention_dq_kernel(*args),
                *flash_attention_dkv_kernel(*args))
    return flash_attention_bwd_reference(q, k, v, bias, q_seg, kv_seg, o,
                                         lse, do, delta)


class FlashAttention(torch.autograd.Function):
    """``(q, k, v, bias, q_seg, kv_seg) → (o, lse)`` with the whole-K
    kernels' backward. Segment ids (or None) get no gradient; the bias gets
    the heads-summed dbias when it requires grad."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_seg, kv_seg):
        o, lse = _forward(q, k, v, bias, q_seg, kv_seg)
        ctx.save_for_backward(q, k, v, bias, q_seg, kv_seg, o, lse)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, q_seg, kv_seg, o, lse = ctx.saved_tensors
        if do is None:  # only lse was used
            do = torch.zeros_like(o)
        delta = attention_delta(o, do, dlse)
        dq, dk, dv, dbias_h = _backward(q, k, v, bias, q_seg, kv_seg, o,
                                        lse, do, delta)
        dbias = dbias_h.sum(dim=1) if ctx.needs_input_grad[3] else None
        return dq, dk, dv, dbias, None, None


def _attention(q, k, v, bias, q_seg, kv_seg):
    """Forward only when nothing needs a gradient (serving under
    ``inference_mode`` included), else through :class:`FlashAttention`."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v, bias))):
        return _forward(q, k, v, bias, q_seg, kv_seg)
    if q.shape[1] > MAX_SEQ_VMEM:
        raise NotImplementedError(
            f"flash attention gradients at S={q.shape[1]} > {MAX_SEQ_VMEM} "
            f"need the streaming backward kernels, not ported yet — "
            f"ROADMAP.md queue B items B5/B6")
    return FlashAttention.apply(q, k, v, bias, q_seg, kv_seg)


def _check_lengths(q, k, v) -> None:
    s_q, s_k = q.shape[1], k.shape[1]
    if s_q != s_k or v.shape[1] != s_k or k.shape != q.shape or (
            v.shape != q.shape):
        raise ValueError(
            f"flash attention needs equal-shape q/k/v, got "
            f"q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    if s_q % min(BLOCK_Q, s_q):
        raise ValueError(f"seq len {s_q} must be a multiple of {BLOCK_Q}")


def flash_attention(q, k, v, *, mask=None, segment_ids=None):
    """Fused attention. q, k, v: (B, S, H, D); mask: (B, 1, 1, S) bool or
    None; segment_ids: (B, S) int packed-sequence ids or None — tokens
    attend only within equal ids (the block-diagonal mask is computed
    inside the kernel from O(S) ids). Returns (B, S, H, D) in q's dtype."""
    _check_lengths(q, k, v)
    b, s = q.shape[:2]
    bias = attention_bias(mask, b, s, q.device)
    seg = None if segment_ids is None else segment_ids.to(torch.float32)
    o, _ = _attention(q, k, v, bias, seg, seg)
    return o


flash_attention.launches = 0


def flash_attention_with_lse(q, k, v, bias, q_seg=None, kv_seg=None):
    """Per-chunk fused attention with its logsumexp (the counterpart of the
    JAX package's ``flash_attention_chunk``): (B, S, H, D) q/k/v, additive
    (B, Sk) f32 key bias, optional (B, S) q/kv segment ids →
    (o (B, S, H, D), lse (B, S, H, 1) f32). ``o`` is normalised within the
    chunk; fully-masked rows give a uniform average and lse ≈ NEG_INF.
    Differentiable in q, k, v, the bias and through lse."""
    _check_lengths(q, k, v)
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both q_seg and kv_seg, or neither")
    if q_seg is not None:
        q_seg, kv_seg = q_seg.to(torch.float32), kv_seg.to(torch.float32)
    return _attention(q, k, v, bias, q_seg, kv_seg)
