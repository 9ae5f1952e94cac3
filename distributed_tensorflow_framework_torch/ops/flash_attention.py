"""Fused attention: the flash-attention kernels for Hopper.

Port of ``distributed_tensorflow_framework_tpu/ops/flash_attention.py``,
both of its regimes. The JAX package dispatches on the sequence length:
whole-K kernels up to ``MAX_SEQ_VMEM`` (4096) and streaming kernels above
it, and for the backward a third route, the fused one-pass kernel
(``FUSED_BWD``). The port's kernels are hand-written CUDA for ``sm_90a``,
built at first use and called through ctypes:

  * ``csrc/flash_attn_fwd.cu`` — the forward at every length (it streams
    64-key tiles with an online softmax; bf16 on the tensor cores; replaces
    ``_attn_fwd_kernel`` and ``_attn_fwd_kernel_kb``);
  * ``csrc/flash_attn_bwd.cu`` — the two-pass dQ and dK/dV kernels at every
    length, bf16 on the tensor cores (replace the whole-K and the streaming
    dQ and dK/dV kernels);
  * ``csrc/flash_attn_bwd_fused.cu`` — the one-pass backward, bf16 on the
    tensor cores (replaces ``_attn_bwd_fused_kernel_kb``).

The bf16 kernels share their ``mma.sync`` building blocks
(``csrc/flash_attn_mma.cuh``), and the fused kernel runs the two-pass dK/dV
kernel's body (``csrc/flash_attn_bwd_common.cuh``), so the two routes' dk,
dv and dbias_h are the same bits; f32 inputs take CUDA-core kernels, since
TF32 would miss the f32 tolerance.

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
``_flash_bwd`` does, then takes the route :func:`backward_route` names,
chosen exactly as the JAX package chooses it. The key-bias gradient (heads
summed) is returned only when the bias requires grad.

Dispatch is by the tensors' device, never by a fallback: CUDA tensors
launch the kernels (or raise), CPU tensors run the plain PyTorch versions —
:func:`flash_attention_reference` (whole-K forward),
:func:`flash_attention_kb_reference` (streaming forward, taken on the CPU
where the JAX package streams) and :func:`flash_attention_bwd_reference`
(every backward route). ``flash_attention.launches``,
``flash_attention_dq_kernel.launches``,
``flash_attention_dkv_kernel.launches`` and
``flash_attention_bwd_fused_kernel.launches`` count kernel launches; the
``segmented_launches`` beside each count those with segment ids (packed
rows), which reach the kernels' ``kSegmented`` variants.

The dispatch knobs are module globals read at call time, so tests and
scripts can assign them as the JAX package's do. They start from the
environment at import, with the JAX package's names, defaults and parsing:
``FLASH_BLOCK_Q_KB`` (512), ``FLASH_BLOCK_K_KB`` (1024),
``FLASH_MAX_SEQ_VMEM`` (4096), ``FLASH_FUSED_BWD_MAX`` (8192),
``FLASH_FUSED_WHOLE_K_MIN`` (unset: the dtype-aware default of
:func:`fused_whole_k_min`) and ``FLASH_FUSED_BWD=1/0``, which forces the
fused backward on or off.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os

import torch

from distributed_tensorflow_framework_torch.ops._build import (
    KernelLaunchError,
    KernelLibrary,
)

log = logging.getLogger(__name__)

NEG_INF = float(torch.finfo(torch.float32).min)
BLOCK_Q = 128  # the JAX kernel's q-block: sets the sequence-length guard
# Longest sequence the JAX package gives its whole-K kernels; above it, it
# streams. The port's CUDA kernels stream at every length, so here it only
# picks the backward route and, on the CPU, the forward's plain version.
MAX_SEQ_VMEM = int(os.environ.get("FLASH_MAX_SEQ_VMEM", "4096"))
# The JAX streaming kernels' tiles. Here they set the key blocks over which
# the streaming forward's plain version keeps its running max (where p is
# rounded), and the row blocks the plain versions work through, so that
# nothing of size S×S is formed at once.
BLOCK_Q_KB = int(os.environ.get("FLASH_BLOCK_Q_KB", "512"))
BLOCK_K_KB = int(os.environ.get("FLASH_BLOCK_K_KB", "1024"))
# The fused one-pass backward, as in the JAX package: FUSED_BWD None = auto
# (fused_bwd_enabled), True/False forces it. It runs only where s_k <=
# FUSED_BWD_MAX, and takes over the whole-K two-pass pair from
# fused_whole_k_min(dtype) up. FLASH_FUSED_BWD=1/0, FLASH_FUSED_BWD_MAX and
# FLASH_FUSED_WHOLE_K_MIN set them from the environment.
_FUSED_BWD_ENV = os.environ.get("FLASH_FUSED_BWD")
FUSED_BWD: bool | None = (
    None if _FUSED_BWD_ENV is None else _FUSED_BWD_ENV not in ("", "0"))
FUSED_BWD_MAX = int(os.environ.get("FLASH_FUSED_BWD_MAX", "8192"))
_FUSED_WHOLE_K_MIN_ENV = os.environ.get("FLASH_FUSED_WHOLE_K_MIN")
FUSED_WHOLE_K_MIN: int | None = (
    None if _FUSED_WHOLE_K_MIN_ENV is None else int(_FUSED_WHOLE_K_MIN_ENV))
FUSED_WHOLE_K_MIN_BF16 = 2048
# Lower-case substrings of torch.cuda.get_device_name() on which the fused
# kernel's parity with the two-pass kernels and its S = 8192 step time (no
# slower than two-pass) are recorded in PERF.md; auto turns it on only
# there, as the JAX package does per TPU generation. The H100 80GB HBM3 at
# 700 W, with both routes on the tensor cores (chip_smoke.py, PERF.md §6):
# fused dk, dv and dbias_h equal to the pair's bit for bit; the fused kernel
# 0.909x the pair's time at (1,12,8192,64) bf16 (2.7454 against 3.0187 ms),
# 0.929x at (4,12,2048,64) and 0.915x at (2,12,4096,64), the bf16 takeover
# band; the S = 8192 training step 28-32 ms less kernel time than on the
# pair (858-860 against 888-890 ms), a gain that its host-clock time shows
# only within the spread between turns.
FUSED_BWD_VERIFIED_DEVICES: tuple[str, ...] = ("h100 80gb hbm3",)
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _pick_block(s: int, target: int) -> int:
    """Largest BLOCK_Q-multiple ≤ ``target`` that divides ``s`` (at least
    BLOCK_Q); ``s`` itself when ``s`` ≤ BLOCK_Q. The JAX package's tile
    picker: the guards make ``s`` a BLOCK_Q-multiple (or < BLOCK_Q)."""
    if s <= BLOCK_Q:
        return s
    b = max(BLOCK_Q, min(target - target % BLOCK_Q, s))
    while s % b:
        b -= BLOCK_Q
    return b


def _row_blocks(s: int) -> list[slice]:
    """The row blocks of a length-``s`` sequence that the plain versions
    work through: ``_pick_block(s, BLOCK_Q_KB)`` rows each, or all ``s``
    rows where ``s`` is no BLOCK_Q-multiple."""
    n = _pick_block(s, BLOCK_Q_KB) if s <= BLOCK_Q or not s % BLOCK_Q else s
    return [slice(i, i + n) for i in range(0, s, n)]


def fused_whole_k_min(dtype: torch.dtype) -> int:
    """Shortest sequence at which the fused backward takes over from the
    whole-K two-pass pair: FUSED_WHOLE_K_MIN when set, else
    FUSED_WHOLE_K_MIN_BF16 for bf16 and above MAX_SEQ_VMEM otherwise."""
    if FUSED_WHOLE_K_MIN is not None:
        return FUSED_WHOLE_K_MIN
    if dtype == torch.bfloat16:
        return FUSED_WHOLE_K_MIN_BF16
    return MAX_SEQ_VMEM + 1


@functools.lru_cache(maxsize=None)
def _warn_unverified(name: str) -> None:
    log.warning("fused flash-attention backward off: %r is not in "
                "FUSED_BWD_VERIFIED_DEVICES (no record that the fused kernel "
                "is no slower than the two-pass kernels there); set "
                "FLASH_FUSED_BWD=1 to force it", name)


def fused_bwd_enabled(device: torch.device | str | None = None) -> bool:
    """Resolve the FUSED_BWD tri-state for tensors on ``device``. A bool in
    FUSED_BWD wins. Auto (None) is off on the CPU, as the JAX package is
    off the TPU, and on a CUDA device only when its name matches a
    FUSED_BWD_VERIFIED_DEVICES entry (warning once per unlisted card)."""
    if FUSED_BWD is not None:
        return FUSED_BWD
    if device is None or torch.device(device).type != "cuda":
        return False
    name = torch.cuda.get_device_name(device)
    if any(p in name.lower() for p in FUSED_BWD_VERIFIED_DEVICES):
        return True
    _warn_unverified(name)
    return False


def backward_route(q: torch.Tensor, k: torch.Tensor) -> str:
    """``"whole_k"``, ``"stream"`` or ``"fused"``: the backward the JAX
    package runs for (B, S, H, D) q and k (``_make_fused``'s ``bwd`` and
    ``_flash_bwd``). On the card "whole_k" and "stream" both launch the
    two-pass dQ and dK/dV kernels, "fused" the one-pass kernel."""
    s, s_k = q.shape[1], k.shape[1]
    use_fused = fused_bwd_enabled(q.device) and s_k <= FUSED_BWD_MAX
    takeover = use_fused and min(s, s_k) >= fused_whole_k_min(q.dtype)
    if max(s, s_k) > MAX_SEQ_VMEM or takeover:
        return "fused" if use_fused else "stream"
    return "whole_k"


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
_FUSED_LIB = KernelLibrary("flash_attn_bwd_fused.cu", {
    "dtf_flash_attn_bwd_fused": (_I, _BWD_OPERANDS + [_P] * 4 + _BWD_SHAPE),
    "dtf_flash_attn_bwd_fused_error_string": (ctypes.c_char_p, [_I]),
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
    """Plain PyTorch version of the forward kernel in the whole-K regime,
    on any device: ``_attn_fwd_kernel``'s math with its rounding points
    (``p`` rounds to the input dtype, against the row's max, before the PV
    product). Same arguments and results as
    :func:`flash_attention_with_lse`."""
    s = _scores(q, k, bias, q_seg, kv_seg)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                       # (B, H, Sq, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).permute(0, 2, 1, 3)          # (B, Sq, H, 1)
    return o.to(q.dtype), lse.contiguous()


def _rows(t, rows):
    return None if t is None else t[:, rows]


def flash_attention_kb_reference(q, k, v, bias, q_seg=None, kv_seg=None):
    """Plain PyTorch version of the forward kernel in the streaming regime
    (``_attn_fwd_kernel_kb``), on any device: a running (m, l, acc) over key
    blocks of ``_pick_block(s_k, BLOCK_K_KB)``, starting from m = NEG_INF,
    with ``p`` rounded to the input dtype against the running max. Rows go
    through in blocks of ``BLOCK_Q_KB``, so nothing of size S×S is formed.
    Same arguments and results as :func:`flash_attention_reference`."""
    b, _, h, d = q.shape
    s_k = k.shape[1]
    block_k = _pick_block(s_k, BLOCK_K_KB)
    vf = v.float()
    f32 = {"dtype": torch.float32, "device": q.device}
    outs, lses = [], []
    for rows in _row_blocks(q.shape[1]):
        qb = q[:, rows]
        n = qb.shape[1]
        m = torch.full((b, h, n, 1), NEG_INF, **f32)
        l = torch.zeros((b, h, n, 1), **f32)
        acc = torch.zeros((b, h, n, d), **f32)
        for k0 in range(0, s_k, block_k):
            keys = slice(k0, k0 + block_k)
            sc = _scores(qb, k[:, keys], bias[:, keys], _rows(q_seg, rows),
                         _rows(kv_seg, keys))
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf[:, keys])
            m = m_new
        outs.append((acc / l).permute(0, 2, 1, 3).to(q.dtype))
        lses.append((m + torch.log(l)).permute(0, 2, 1, 3))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1).contiguous()


def attention_delta(o, do, dlse=None):
    """``delta = Σ_d dO·O`` in f32, (B, S, H, 1), minus the lse cotangent
    when there is one (``_flash_bwd``: ∂lse/∂s = p folds into ds)."""
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    return delta if dlse is None else delta - dlse.float()


def _probs_and_ds(q, k, v, bias, q_seg, kv_seg, lse, do, delta, rows):
    """For the query rows ``rows``: recomputed ``p = exp(s − lse)`` (no
    renormalisation: a fully-masked row, whose lse is NEG_INF, gets p = 1
    for every key, as on the TPU) and ``ds = p·(dp − delta)``, both
    (B, H, rows, Sk) f32."""
    p = torch.exp(_scores(q[:, rows], k, bias, _rows(q_seg, rows), kv_seg)
                  - lse[:, rows].float().permute(0, 2, 1, 3))
    dp = torch.einsum("bqhd,bkhd->bhqk", do[:, rows].float(), v.float())
    return p, p * (dp - delta[:, rows].float().permute(0, 2, 1, 3))


def flash_attention_dq_reference(q, k, v, bias, q_seg, kv_seg, lse, do,
                                 delta):
    """Plain PyTorch version of the dQ kernel (same arguments as
    :func:`flash_attention_dq_kernel`): ``ds`` rounds to the input dtype
    for the ``ds·k`` product, scale multiplies after it. Rows go through in
    blocks of ``BLOCK_Q_KB``."""
    kf, scale = k.float(), 1.0 / (q.shape[-1] ** 0.5)
    out = []
    for rows in _row_blocks(q.shape[1]):
        _, ds = _probs_and_ds(q, k, v, bias, q_seg, kv_seg, lse, do, delta,
                              rows)
        dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), kf)
        out.append((dq * scale).to(q.dtype))
    return torch.cat(out, dim=1)


def flash_attention_dkv_reference(q, k, v, bias, q_seg, kv_seg, lse, do,
                                  delta):
    """Plain PyTorch version of the dK/dV kernel (same arguments as
    :func:`flash_attention_dkv_kernel`): ``ds`` rounds to the input dtype
    for ``dsᵀ·q``, ``p`` for ``pᵀ·dO``, and the per-head key-bias gradient
    (B, H, Sk) f32 sums the unrounded ds. The sums over query rows are
    taken in f32 per block of ``BLOCK_Q_KB`` rows, then over the blocks."""
    dtype = q.dtype
    dk = dv = dbias_h = 0.0
    for rows in _row_blocks(q.shape[1]):
        p, ds = _probs_and_ds(q, k, v, bias, q_seg, kv_seg, lse, do, delta,
                              rows)
        dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds.to(dtype).float(),
                               q[:, rows].float())
        dv = dv + torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(),
                               do[:, rows].float())
        dbias_h = dbias_h + ds.sum(dim=2)
    dk = dk * (1.0 / (q.shape[-1] ** 0.5))
    return dk.to(dtype), dv.to(dtype), dbias_h


def flash_attention_bwd_reference(q, k, v, bias, q_seg, kv_seg, o, lse, do,
                                  delta=None):
    """Plain PyTorch version of every backward kernel, on any device:
    ``(dq, dk, dv, dbias_h)``, the first three (B, S, H, D) in the input
    dtype and dbias_h (B, H, Sk) f32. ``delta`` defaults to
    :func:`attention_delta` of (o, do). The whole-K pair, the streaming pair
    and the fused one-pass kernel compute the same function: each
    recomputes ``p = exp(s − lse)``, rounds ``ds`` only as the left operand
    of ``ds·k`` and ``dsᵀ·q`` and ``p`` only for ``pᵀ·dO``, and sums the
    unrounded ds into dbias; they differ only in the order of their f32
    sums."""
    if delta is None:
        delta = attention_delta(o, do)
    args = (q, k, v, bias, q_seg, kv_seg, lse, do, delta)
    return (flash_attention_dq_reference(*args),
            *flash_attention_dkv_reference(*args))


def _aligned_16(t: torch.Tensor) -> bool:
    """Whether ``t`` starts on 16 bytes and its batch and sequence strides
    are multiples of 16 bytes (a dimension of size 1 has no stride to
    keep), as the kernels' 16-byte async copies need."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * size % 16 == 0 for i in (0, 1) if t.shape[i] > 1)


def _head_view(t: torch.Tensor) -> torch.Tensor:
    """The kernels read (B, S, H, D) with free batch/sequence strides but
    dense (H, D) rows, starting on 16 bytes with 16-byte strides; anything
    else is copied once into a fresh contiguous tensor (``contiguous()``
    alone would keep a misaligned tensor that is already dense)."""
    d = t.shape[-1]
    if t.stride(-1) != 1 or t.stride(-2) != d or not _aligned_16(t):
        t = t.clone(memory_format=torch.contiguous_format)
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
    """Launch the forward CUDA kernel on CUDA tensors (bf16 on the tensor
    cores, f32 on the CUDA cores; operands that break the 16-byte rule are
    copied once by :func:`_head_view`); raises on anything it does not
    take. Returns ``(o, lse)`` like :func:`flash_attention_reference`, the
    same bits on every launch. Adds one to ``flash_attention.launches`` per
    launch."""
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
    flash_attention.segmented_launches += q_seg is not None
    _raise_on_error(err, lib.dtf_cuda_error_string, "flash_attn_fwd", q)
    return o, lse


def _bwd_launch(library, entry, name, out_shapes, q, k, v, bias, q_seg,
                kv_seg, lse, do, delta):
    """Check the operands of a backward entry point of ``library``,
    allocate its outputs (``out_shapes``: (shape, dtype, allocator) with
    ``None`` dtype = q's; the allocator is ``torch.empty``, or
    ``torch.zeros`` for a buffer the kernel adds into) and launch it.
    Returns (CUDA error code, the loaded library, outputs)."""
    (q, k, v, do), bias, q_seg, kv_seg = _kernel_operands(
        name, q, k, v, bias, q_seg, kv_seg, do)
    b, s, h, d = q.shape
    lse, delta = (t.to(device=q.device, dtype=torch.float32).contiguous()
                  for t in (lse, delta))
    if lse.shape != (b, s, h, 1) or delta.shape != (b, s, h, 1):
        raise ValueError(f"lse and delta must be (B, S, H, 1) = "
                         f"{(b, s, h, 1)}")
    outs = [alloc(shape, dtype=dtype or q.dtype, device=q.device)
            for shape, dtype, alloc in out_shapes]
    lib = library.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), do.stride(0), do.stride(1),
            bias.data_ptr(), _ptr(q_seg), _ptr(kv_seg), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), b, s, h, d,
            _DTYPE_CODES[q.dtype], 1.0 / (d ** 0.5), stream)
    return err, lib, outs


def flash_attention_dq_kernel(q, k, v, bias, q_seg, kv_seg, lse, do, delta):
    """Launch the dQ CUDA kernel on CUDA tensors; raises on anything it
    does not take. Returns dq (B, S, H, D) in q's dtype, the first result
    of :func:`flash_attention_bwd_reference`. Adds one to
    ``flash_attention_dq_kernel.launches`` per launch."""
    err, lib, (dq,) = _bwd_launch(
        _BWD_LIB, "dtf_flash_attn_bwd_dq", "flash_attention_dq_kernel",
        [(q.shape, None, torch.empty)], q, k, v, bias, q_seg, kv_seg, lse,
        do, delta)
    flash_attention_dq_kernel.launches += 1
    flash_attention_dq_kernel.segmented_launches += q_seg is not None
    _raise_on_error(err, lib.dtf_flash_attn_bwd_error_string,
                    "flash_attn_bwd_dq", q)
    return dq


def flash_attention_dkv_kernel(q, k, v, bias, q_seg, kv_seg, lse, do, delta):
    """Launch the dK/dV CUDA kernel on CUDA tensors; raises on anything it
    does not take. Returns ``(dk, dv, dbias_h)``, the last three results
    of :func:`flash_attention_bwd_reference`. Adds one to
    ``flash_attention_dkv_kernel.launches`` per launch."""
    b, s, h, _ = q.shape
    err, lib, outs = _bwd_launch(
        _BWD_LIB, "dtf_flash_attn_bwd_dkv", "flash_attention_dkv_kernel",
        [(q.shape, None, torch.empty), (q.shape, None, torch.empty),
         ((b, h, s), torch.float32, torch.empty)],
        q, k, v, bias, q_seg, kv_seg, lse, do, delta)
    flash_attention_dkv_kernel.launches += 1
    flash_attention_dkv_kernel.segmented_launches += q_seg is not None
    _raise_on_error(err, lib.dtf_flash_attn_bwd_error_string,
                    "flash_attn_bwd_dkv", q)
    return tuple(outs)


def flash_attention_bwd_fused_kernel(q, k, v, bias, q_seg, kv_seg, lse, do,
                                     delta):
    """Launch the fused one-pass backward CUDA kernel on CUDA tensors
    (bf16 on the tensor cores, f32 on the CUDA cores; operands that break
    the 16-byte rule are copied once by :func:`_head_view`); raises on
    anything it does not take. Returns ``(dq, dk, dv, dbias_h)`` like
    :func:`flash_attention_bwd_reference`; dk, dv and dbias_h are the bits
    of :func:`flash_attention_dkv_kernel`. dq is summed by f32 atomic adds
    into a zeroed f32 buffer, cast to q's dtype here; the order of those
    adds varies from run to run. Adds one to
    ``flash_attention_bwd_fused_kernel.launches`` per launch."""
    b, s, h, _ = q.shape
    err, lib, (dq, dk, dv, dbias_h) = _bwd_launch(
        _FUSED_LIB, "dtf_flash_attn_bwd_fused",
        "flash_attention_bwd_fused_kernel",
        [(q.shape, torch.float32, torch.zeros), (q.shape, None, torch.empty),
         (q.shape, None, torch.empty),
         ((b, h, s), torch.float32, torch.empty)],
        q, k, v, bias, q_seg, kv_seg, lse, do, delta)
    flash_attention_bwd_fused_kernel.launches += 1
    flash_attention_bwd_fused_kernel.segmented_launches += q_seg is not None
    _raise_on_error(err, lib.dtf_flash_attn_bwd_fused_error_string,
                    "flash_attn_bwd_fused", q)
    return dq.to(q.dtype), dk, dv, dbias_h


flash_attention_dq_kernel.launches = 0
flash_attention_dkv_kernel.launches = 0
flash_attention_bwd_fused_kernel.launches = 0
flash_attention_dq_kernel.segmented_launches = 0
flash_attention_dkv_kernel.segmented_launches = 0
flash_attention_bwd_fused_kernel.segmented_launches = 0


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
    if k.shape[1] > MAX_SEQ_VMEM:  # where the JAX package streams
        return flash_attention_kb_reference(q, k, v, bias, q_seg, kv_seg)
    return flash_attention_reference(q, k, v, bias, q_seg, kv_seg)


def _backward(q, k, v, bias, q_seg, kv_seg, o, lse, do, delta):
    _check_device(q)
    route = backward_route(q, k)
    if not q.is_cuda:  # every route's plain version
        return flash_attention_bwd_reference(q, k, v, bias, q_seg, kv_seg, o,
                                             lse, do, delta)
    args = (q, k, v, bias, q_seg, kv_seg, lse, do, delta)
    if route == "fused":
        return flash_attention_bwd_fused_kernel(*args)
    return (flash_attention_dq_kernel(*args),
            *flash_attention_dkv_kernel(*args))


class FlashAttention(torch.autograd.Function):
    """``(q, k, v, bias, q_seg, kv_seg) → (o, lse)`` with the kernels'
    backward on the route :func:`backward_route` names. Segment ids (or
    None) get no gradient; the bias gets the heads-summed dbias when it
    requires grad."""

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
flash_attention.segmented_launches = 0


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
