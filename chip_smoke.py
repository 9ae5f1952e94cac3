#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases (any failure raises and the script exits non-zero):

  1. device — requires ``torch.cuda.is_available()``; prints the card's
     name and power limit (nvidia-smi). TF32 is switched off for matmuls
     and cuDNN, so f32 references are full f32.
  2. build — compiles every kernel under
     ``distributed_tensorflow_framework_torch/ops/csrc/`` (one nvcc per
     source, in parallel) and prints the build seconds, then per kernel
     function its registers and spill bytes (ptxas) and its count of
     tensor-core instructions (HMMA/HGMMA in ``cuobjdump -sass``). The
     bf16 tensor-core kernels (``*_tc_kernel``: the forward, the two-pass
     pair and the fused one-pass kernel) must have some, and none may
     spill at D = 64. A line per (D, segmented) sets the fused kernel's
     count beside the dK/dV kernel's (five products against four).
  3. kernel parity — the forward kernel against its plain PyTorch version
     on the card, bf16 and f32, at (B,H,S,D) = (8,12,512,64), (2,4,128,32),
     (2,4,64,32), (2,2,256,128) and the ragged (2,3,96,32): no mask,
     trailing padding, packed segment ids, one fully-masked row (whose o
     must be V's mean); a second launch must give the same bits (no
     atomics). Then q and k as views that break the 16-byte rule (a 2-byte
     storage offset, an odd sequence stride): the wrapper copies them, and
     the outputs equal the aligned operands'. At the serving shape, times
     the kernel (with its TFLOP/s) and
     ``torch.nn.functional.scaled_dot_product_attention`` (the yardstick;
     the port never calls it) by their device kernel time, since the host
     work of each call outlasts its kernel, and the plain version by CUDA
     events, beside the bound.
  3b. backward kernel parity — the dQ and dK/dV kernels against their
     plain versions (dq, dk, dv, dbias_h) at the same five shapes, bf16 and
     f32, the same four cases; on the fully-masked row each key's dv must
     be the row's summed dO (p = 1, the TPU semantics), and a second launch
     of each kernel must give the same bits (no atomics). The fused
     one-pass kernel in the same cases: its dk, dv and dbias_h equal the
     pair's bit for bit (one key-block body in each dtype) and a relaunch's,
     its dq lies within GRAD_RTOL of the pair's and of the plain version's
     (dq is summed by f32 atomics, so its last bits may vary). Then the
     misaligned q and k views of phase 3, through the pair and through the
     fused kernel. Times
     each kernel, its plain version and the backward of
     ``scaled_dot_product_attention`` (the yardstick for the pair) at
     (8,12,512,64) bf16 with padding, beside the bounds.
  3c. long-context kernel parity — at the streaming lengths (1,2,8192,64)
     and (1,2,16384,64), bf16 and f32, with padding and with segment ids:
     the forward kernel against the streaming forward's plain version, and
     the two-pass dQ/dK/dV kernels and the fused one-pass kernel each
     against the plain backward and the fused kernel against the two-pass
     kernels, whose dk, dv and dbias_h it must equal bit for bit. Then the
     fused kernel on the ragged (2,3,96,32), bf16 and f32, and at
     (2,2,2048,64) bf16 (where it takes over the whole-K pair), all four
     cases. The forward's o is held relative to the case's largest |o|.
     Times the forward, dQ and dK/dV at (1,12,16384,64) and the fused
     kernel at (1,12,8192,64), bf16, with their TFLOP/s, beside their plain
     versions, their bounds and SDPA's forward or backward device time;
     then the fused kernel against the two-pass pair in turns at
     (1,12,8192,64) and in the whole-K takeover band, (4,12,2048,64) and
     (2,12,4096,64) bf16, where auto must pick the fused kernel on a card
     listed in FUSED_BWD_VERIFIED_DEVICES and the pair elsewhere.
  4. serve — full-width BERT-base (12 x 768, 12 heads, MLP 3072, vocab
     30522, max_seq_len 512, bf16, fused QKV, attention_impl pallas) with
     weights from a seed, written as a port artifact; the server is started
     through ``cli/serve.py``'s ``main`` (port 0, seq buckets 128/256/512)
     and answers concurrent ``POST /predict`` requests of different
     lengths; a 512-token request goes through ``engine.predict``. Each
     run checks HTTP 200, shapes, finiteness, that the kernel launched 12
     times per batch, and one request's logits against the same model run
     with the kernel's plain version. SIGTERM drains the server.
  5. train — ``cli/train.py``'s ``main`` on ``configs/bert_base_mlm.yaml``
     at full width and depth (dropout 0.1, AdamW, clip 1.0) for 30 steps.
     The batch goes from 256 to 32 x 512 so that activations and the f32
     logits fit one card (18.2 GB peak, NVIDIA H100 80GB HBM3 at 700 W).
     Checks rc 0, finite metrics and the launch counts: forward 12 x (30
     steps + 2 eval batches), dQ and dK/dV 12 x 30, fused 0. Prints the
     steady step
     time, tokens/s and peak memory, then one profiled step by kernel
     class and the device idle share.
  5b. training parity and learning — one step's gradients at 8 x 512
     through the kernels against the same model and dropout stream with
     the kernels' plain versions; every leaf within MODEL_GRAD_RTOL and a
     non-zero QKV weight gradient. Then 30 steps on one repeated batch at
     a constant lr of 1e-4: the loss at step 30 must be below 0.9 x the
     loss at step 1 (the first runs went 10.490 → 7.219 on an NVIDIA H100
     80GB HBM3 at 700 W).
  6. long-context training — ``cli/train.py``'s ``main`` on
     ``configs/bert_long_ring.yaml`` at its width and depth (12 x 768,
     remat, dropout 0.1, bf16) on one card: ``mesh.seq=1`` and
     ``attention_impl pallas`` (ring attention is not ported), no
     checkpoints, 3 steps of the config's 8 rows in 8 micro-batches of
     one row. FUSED_BWD stays on auto and must pick the two-pass kernels
     at S = 16384 (above FUSED_BWD_MAX), and at S = 8192 the fused kernel
     on a card listed in FUSED_BWD_VERIFIED_DEVICES (the H100 80GB HBM3
     is), else the two-pass kernels. Checks rc 0, finite metrics and the
     launch counts per micro-batch: forward 24 (forward and recompute), dQ
     and dK/dV 12 or fused 12. Prints the steady step time, tokens/s, peak
     memory and one profiled step by kernel class.
  6b. fused vs two-pass at S = 8192 — one micro-step's gradients (dropout
     and remat on) with the fused backward forced on against the two-pass
     kernels, every leaf within MODEL_GRAD_RTOL; then the phase-6 step
     timed on each route in turns (host clock) and profiled once on each
     (kernel time, which the host's speed does not move). This drives each
     route through a full-width model step whichever one auto picks.

Every count is set to 0 just before a main-path run (the serve runs, the
training runs) and read just after; launches made to compare or time a
kernel do not count. Where auto picks the fused kernel nowhere on this
card, its ``launches`` in the record are those of phase 6b's forced
micro-step, marked ``launches_forced``. The line before the last is the
card's ``nvidia-smi`` name and power limit; the line before that the
per-kernel JSON record; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

SEED = 0
H100_BF16_FLOPS = 989e12   # dense tensor-core peak (H100 SXM data sheet)
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
_CSRC = "distributed_tensorflow_framework_torch/ops/csrc/"
SOURCES = {"fwd": _CSRC + "flash_attn_fwd.cu", "dq": _CSRC + "flash_attn_bwd.cu",
           "dkv": _CSRC + "flash_attn_bwd.cu",
           "fused": _CSRC + "flash_attn_bwd_fused.cu"}
# The TPU kernels each one replaces (def lines): whole-K and streaming.
_TPU = "distributed_tensorflow_framework_tpu/ops/flash_attention.py:"
REPLACES = {"fwd": [_TPU + "140", _TPU + "254"],
            "dq": [_TPU + "179", _TPU + "304"],
            "dkv": [_TPU + "213", _TPU + "347"], "fused": [_TPU + "403"]}
# Phases 3 and 3b: the serving and training shape, two small ones, D = 128
# and a length that is not a multiple of the kernels' 64-row tiles (rows and
# keys past S must contribute nothing).
PARITY_SHAPES = ((8, 12, 512, 64), (2, 4, 128, 32), (2, 4, 64, 32),
                 (2, 2, 256, 128), (2, 3, 96, 32))
# Phase 3c: the streaming lengths of the long-context runs, two heads.
LONG_SHAPES = ((1, 2, 8192, 64), (1, 2, 16384, 64))
KERNEL_NAMES = {"fwd": "flash_attn_fwd", "dq": "flash_attn_bwd_dq",
                "dkv": "flash_attn_bwd_dkv", "fused": "flash_attn_bwd_fused"}
# S x S x D products per kernel (attention_bound, attention_bwd_bounds).
PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4, "fused": 5}
# Kernel vs plain version, same inputs on the card. o: bf16 allows two ulps
# near 1 (the kernel rounds p against a running max, the plain version
# against the row max, so one rounding can differ); f32 sums the same
# products in another order. lse: relative, its terms are unrounded f32.
O_ATOL = {"bfloat16": 1.6e-2, "float32": 2e-5}
LSE_RTOL = 1e-5
# Phase 3c: o as max|err| over the case's max|o|. Over 8k-16k keys each o
# averages thousands of values (max|o| ~0.1), so an absolute limit near 1
# would pass an o that is 20% off. bf16: four ulps at the largest value
# (the output's rounding and p's rounding against another running max);
# f32: the same products summed in another order.
O_RTOL = {"bfloat16": 1.6e-2, "float32": 2e-5}
# Backward kernels vs their plain versions, as max|err| / max|ref| per
# output. dq, dk, dv in bf16: four bf16 ulps at the largest value, one for
# the output's own rounding and three for ds and p roundings that an f32
# summation-order difference in s or dp flips by one ulp. f32: 2e-5, the
# same products summed in another order. dbias_h sums unrounded f32 ds in
# both dtypes: 1e-5.
GRAD_RTOL = {"bfloat16": 1.6e-2, "float32": 2e-5}
DBIAS_RTOL = 1e-5
# Served logits vs the same model with the kernel's plain version: bf16
# activations through 12 layers, where a flipped bf16 rounding in one
# attention output propagates; logits have std ~0.55 at this init.
LOGIT_MAX_ATOL = 0.15
LOGIT_MEAN_ATOL = 1e-2
HTTP_LENGTHS = (4, 8, 12, 16, 24, 32)
# Phase 5: BERT-base training at full width and depth. The batch goes from
# the config's 256 to 32 rows of 512 tokens so that activations and the
# f32 logits (32 x 512 x 30522) fit one card.
TRAIN_OVERRIDES = (
    "data.global_batch_size=32", "train.total_steps=30",
    "train.log_interval=10", "train.eval_steps=2", "train.eval_interval=0",
    "checkpoint.directory=", "resilience.rollback=false")
# Phase 5b: one step at 8 x 512, kernels against their plain versions.
# Gradients differ where the forward kernel's online softmax rounds a bf16
# p one ulp away from the plain version's (phase 3), and 12 bf16
# layers carry such flips into every gradient: tolerance per leaf, as
# max|err| over the leaf's max|grad|.
PARITY_OVERRIDES = ("data.global_batch_size=8", "checkpoint.directory=",
                    "resilience.rollback=false")
MODEL_GRAD_RTOL = 5e-2
# Then 30 steps on that one batch at a constant lr of 1e-4, no warmup: the
# loss at step 30 must be below LEARN_RATIO x the loss at step 1.
LEARN_OVERRIDES = ("optimizer.schedule=constant", "optimizer.warmup_steps=0",
                   "optimizer.learning_rate=1e-4", "train.total_steps=30")
LEARN_RATIO = 0.9
# Phase 6: configs/bert_long_ring.yaml on one card. Ring attention (A11),
# checkpoints (A4) and the rollback ladder (A14) are not ported, so the
# same model runs attention_impl pallas on a mesh of one. The config's
# global batch of 8 rows goes through in 8 micro-batches of one row, so
# that a 16k-token row's f32 logits (2 GB) are the largest activation; the
# run is cut to 3 steps.
LONG_CONFIG = "configs/bert_long_ring.yaml"
LONG_OVERRIDES = (
    "mesh.seq=1", "model.attention_impl=pallas", "checkpoint.directory=",
    "resilience.rollback=false", "train.grad_accum_steps=8",
    "train.total_steps=3", "train.log_interval=1", "train.eval_steps=0")
# Phase 6's sequence lengths. Both runs leave FUSED_BWD on auto, the choice
# users get: the two-pass pair at 16384 (above FUSED_BWD_MAX), and at 8192
# the fused kernel on a card listed in FUSED_BWD_VERIFIED_DEVICES, else the
# streaming two-pass pair (long_runs).
LONG_SEQS = (16384, 8192)
# The whole-K takeover band (bf16, 2048 <= S <= 4096), where auto picks the
# fused kernel over the two-pass pair on a listed card: both timed at 8192
# tokens per call.
BAND_SHAPES = ((4, 12, 2048, 64), (2, 12, 4096, 64))


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline_ms(moved_bytes: float, flops: float, elem_bytes: int):
    """Least time for the work: the bytes at the memory rate, the
    operations at the peak rate of the input type, whichever is longer.
    Returns (ms, "bytes" | "operations")."""
    peak = H100_BF16_FLOPS if elem_bytes == 2 else H100_F32_FLOPS
    t_bytes = moved_bytes / H100_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_flops(name: str, b, h, s, d) -> int:
    """Operations of kernel ``name``: PRODUCTS[name] S x S x D products of
    2*B*H*S^2*D each."""
    return PRODUCTS[name] * 2 * b * h * s * s * d


def tflops(name: str, b, h, s, d, ms: float) -> float:
    """Achieved TFLOP/s of kernel ``name`` at (b, h, s, d) in ``ms``."""
    return attention_flops(name, b, h, s, d) / (ms * 1e-3) / 1e12


def attention_bound(b, h, s, d, elem_bytes, segmented):
    """Forward kernel: q, k, v, bias (and segment ids) read once, o and lse
    written once; two products."""
    moved = 4 * b * s * h * d * elem_bytes + b * s * 4 + b * s * h * 4
    moved += 2 * b * s * 4 if segmented else 0
    return roofline_ms(moved, attention_flops("fwd", b, h, s, d), elem_bytes)


def attention_bwd_bounds(b, h, s, d, elem_bytes, segmented) -> dict:
    """dQ reads q, k, v, dO, bias, lse and delta and writes dq: three
    S x S x D products. dK/dV reads the same and writes dk, dv and the f32
    per-head dbias: four products. The fused kernel reads the same and
    writes dq, dk, dv and dbias: five products."""
    head = b * s * h * d * elem_bytes
    common = 4 * head + b * s * 4 + 2 * b * s * h * 4
    common += 2 * b * s * 4 if segmented else 0
    dbias = b * h * s * 4
    moved = {"dq": common + head, "dkv": common + 2 * head + dbias,
             "fused": common + 3 * head + dbias}
    return {name: roofline_ms(bytes_, attention_flops(name, b, h, s, d),
                              elem_bytes)
            for name, bytes_ in moved.items()}


# ---------------------------------------------------------------- phase 2

def ptxas_usage(log_text: str) -> dict:
    """{mangled kernel: (registers, spill store bytes, spill load bytes)}
    from ``nvcc -Xptxas -v`` output, where a "Compiling entry function"
    line names the function of the next "Used N registers" line and a
    "Function properties for" line the function of the next spill line."""
    regs, spills, name, props = {}, {}, None, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props is not None:
            spills[props] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            regs[name] = int(m.group(1))
    return {fn: (n, *spills.get(fn, (0, 0))) for fn, n in regs.items()}


def sass_tensor_ops(tools: str, library) -> dict:
    """{mangled kernel: count of HMMA and HGMMA instructions} from
    ``cuobjdump -sass`` of a built library."""
    sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass",
                           str(library)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\b(HMMA|HGMMA)\.", line):
            counts[name] += 1
    return counts


def build_report(_build, result) -> dict:
    """Phase 2's lines for one built library: per kernel function its
    registers and spill bytes (ptxas) and its tensor-core instructions
    (cuobjdump). The bf16 tensor-core kernels must run on the tensor cores,
    and at D = 64, the main path's width, must not spill. Returns
    {short name: (registers, spill stores, spill loads, HMMA/HGMMA)}."""
    tools = os.path.dirname(_build.find_nvcc())
    usage = ptxas_usage(result.log)
    mma = sass_tensor_ops(tools, result.library)
    names = sorted(set(usage) | set(mma))
    demangled = subprocess.run([os.path.join(tools, "cu++filt")],
                               input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    log(f"  {result.source.name}: {result.seconds:.2f} s, "
        f"{sum(mma.values())} HMMA/HGMMA in {len(mma)} kernels")
    report = {}
    for mangled, full in zip(names, demangled):
        short = re.search(r"flash_attn_\w+(<[^>]*>)?", full).group(0)
        regs, stores, loads = usage.get(mangled, (None, None, None))
        report[short] = (regs, stores, loads, mma.get(mangled, 0))
        log(f"    {short}: {regs} registers, spill stores {stores} B, "
            f"spill loads {loads} B, {mma.get(mangled, 0)} HMMA/HGMMA")
        # cu++filt writes template arguments as "<(int)64, (bool)0>".
        d64 = re.search(r"<(\(int\))?64,", short) is not None
        if "_tc_kernel" in short and (
                not mma.get(mangled) or (d64 and (stores or loads))):
            raise AssertionError(f"{short}: expected tensor-core "
                                 f"instructions and, at D = 64, no spills")
    return report


def fused_beside_pair(report: dict) -> None:
    """One phase-2 line per variant of the fused tensor-core kernel, beside
    the two-pass dK/dV kernel with the same template arguments: registers,
    spill bytes and HMMA counts (the fused kernel's five products against
    the dK/dV kernel's four)."""
    for short, (regs, stores, loads, hmma) in sorted(report.items()):
        if not short.startswith("flash_attn_bwd_fused_tc_kernel"):
            continue
        args = short[short.index("<"):]
        pair = report.get("flash_attn_bwd_dkv_tc_kernel" + args)
        if pair is None:
            raise AssertionError(f"no dK/dV kernel beside {short}")
        log(f"  fused vs dK/dV {args}: registers {regs} / {pair[0]}, spill "
            f"bytes {stores + loads} / {pair[1] + pair[2]}, HMMA {hmma} / "
            f"{pair[3]} (ratio {hmma / pair[3]:.3f}, five products against "
            f"four: 1.25)")


# ---------------------------------------------------------------- phase 3

def attention_cases(torch, fa, gen, b: int, s: int) -> dict:
    """The masking cases every parity check runs: (key bias, segment ids
    or None) for no mask, trailing padding in row 0, three packed segments
    per row over that padding, and (where b > 1) row 1 fully masked."""
    zero = torch.zeros(b, s, device="cuda")
    pad = zero.clone()
    pad[0, s - s // 4:] = fa.NEG_INF
    seg = torch.zeros(b, s, device="cuda")
    for row in range(b):
        cuts = torch.randperm(s - 1, device="cuda",
                              generator=gen)[:2].sort().values + 1
        seg[row, cuts[0]:] = 1
        seg[row, cuts[1]:] = 2
    cases = {"none": (zero, None), "padding": (pad, None),
             "segments": (pad, seg)}
    if b > 1:
        dead = pad.clone()
        dead[1, :] = fa.NEG_INF
        cases["masked_row"] = (dead, None)
    return cases


def kernel_parity(torch, fa) -> dict:
    """The forward kernel against its plain version on the same inputs, at
    every PARITY_SHAPES shape, bf16 and f32, in the four masking cases; a
    second launch must give the same bits (each block owns its rows, no
    atomics). Then the misaligned views (misaligned_view_parity)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, h, s, d in PARITY_SHAPES:
            q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            for case, (bias, sg) in attention_cases(torch, fa, gen,
                                                    b, s).items():
                o, lse = fa.flash_attention_kernel(q, k, v, bias, sg, sg)
                o2, lse2 = fa.flash_attention_kernel(q, k, v, bias, sg, sg)
                torch.cuda.synchronize()
                ro, rlse = fa.flash_attention_reference(q, k, v, bias, sg, sg)
                o_err = (o.float() - ro.float()).abs().max().item()
                lse_err = ((lse - rlse).abs()
                           / rlse.abs().clamp(min=1.0)).max().item()
                finite = bool(torch.isfinite(o).all() and
                              torch.isfinite(lse).all())
                stable = torch.equal(o, o2) and torch.equal(lse, lse2)
                ok = (finite and stable and o_err <= O_ATOL[name]
                      and lse_err <= LSE_RTOL)
                if case == "masked_row":
                    uniform = v[1].float().mean(dim=0, keepdim=True)
                    ok = ok and bool(
                        (o[1].float() - uniform).abs().max()
                        <= O_ATOL[name] + 1e-6)
                    ok = ok and bool((lse[1] <= 0.99 * fa.NEG_INF).all())
                worst = max(worst, o_err)
                log(f"parity {name} (B,H,S,D)=({b},{h},{s},{d}) {case}: "
                    f"o max|err| {o_err:.3e} (tol {O_ATOL[name]}), lse "
                    f"rel err {lse_err:.3e} (tol {LSE_RTOL}), finite "
                    f"{finite}, two launches equal {stable} -> "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"kernel disagrees with its plain version: {name} "
                        f"({b},{h},{s},{d}) {case}")
    misaligned_view_parity(torch, fa, gen, "fwd")
    return {"max_abs_err": worst}


def kernel_timing(torch, fa) -> dict:
    """At the serving shape (B=8, H=12, S=512, D=64, bf16, padding mask):
    the kernel and SDPA on the same inputs by their device kernel time, the
    plain version by CUDA events. The kernel is shorter than its wrapper's
    host work, so CUDA events around back-to-back calls time the host; that
    figure is logged beside it. The 25 MB of inputs stay in the 50 MB L2
    between launches."""
    import torch.nn.functional as F

    b, h, s, d = PARITY_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    keep = torch.ones(b, s, dtype=torch.bool, device="cuda")
    keep[:, s - s // 4:] = False
    bias = torch.where(keep, 0.0, fa.NEG_INF)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask4 = keep[:, None, None, :]
    def kernel():
        return fa.flash_attention_kernel(q, k, v, bias)

    out = {
        "ms": device_ms(torch, kernel, iters=50),
        "events_ms": time_ms(torch, kernel),
        "plain_ms": time_ms(
            torch, lambda: fa.flash_attention_reference(q, k, v, bias)),
        "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4)),
    }
    out["bound_ms"], out["bound_by"] = attention_bound(b, h, s, d, 2, False)
    rate = {key: tflops("fwd", b, h, s, d, out[key])
            for key in ("ms", "library_ms")}
    log(f"timing flash_attn_fwd (B,H,S,D)=({b},{h},{s},{d}) bf16: kernel "
        f"(device) {out['ms']:.4f} ms ({rate['ms']:.1f} TFLOP/s; CUDA events"
        f" over back-to-back calls {out['events_ms']:.4f} ms), plain "
        f"{out['plain_ms']:.4f} ms, sdpa (device) {out['library_ms']:.4f} ms"
        f" ({rate['library_ms']:.1f} TFLOP/s), bound {out['bound_ms']:.4f} "
        f"ms ({out['bound_by']})")
    return out


# --------------------------------------------------------------- phase 3b

def rel_err(got, ref) -> float:
    """max|got - ref| over max|ref| (at least 1e-6), in f32."""
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp(min=1e-6)).item()


def bwd_kernel_parity(torch, fa) -> dict:
    """dQ and dK/dV kernels against their plain versions on the same
    inputs: o and lse from the forward's plain version, a random dO, delta
    from (o, dO); then the fused kernel against both (fused_parity).
    Returns the worst absolute error of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {"dq": 0.0, "dkv": 0.0, "fused": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for b, h, s, d in PARITY_SHAPES:
            q, k, v, do = (torch.randn(b, s, h, d, device="cuda",
                                       generator=gen).to(dtype)
                           for _ in range(4))
            for case, (bias, sg) in attention_cases(torch, fa, gen,
                                                    b, s).items():
                o, lse = fa.flash_attention_reference(q, k, v, bias, sg, sg)
                args = (q, k, v, bias, sg, sg, lse, do,
                        fa.attention_delta(o, do))
                got, again = two_pass_kernels(fa, args), two_pass_kernels(
                    fa, args)
                torch.cuda.synchronize()
                ref = {"dq": fa.flash_attention_dq_reference(*args)}
                ref["dk"], ref["dv"], ref["dbias_h"] = (
                    fa.flash_attention_dkv_reference(*args))
                errs = {key: rel_err(got[key], ref[key]) for key in got}
                tols = {key: GRAD_RTOL[name] for key in ("dq", "dk", "dv")}
                tols["dbias_h"] = DBIAS_RTOL
                finite = all(bool(torch.isfinite(t).all())
                             for t in got.values())
                # No atomics: a second launch gives the same bits.
                stable = all(torch.equal(got[key], again[key]) for key in got)
                ok = finite and stable and all(errs[key] <= tols[key]
                                               for key in errs)
                if case == "masked_row":
                    # TPU semantics: p = exp(s - lse) = 1 for every key of
                    # a fully-masked row, so each key's dv is the sum of dO
                    # over the row's queries, not its mean.
                    want = do[1].float().sum(dim=0, keepdim=True)
                    ok = ok and rel_err(got["dv"][1], want.expand_as(
                        got["dv"][1])) <= GRAD_RTOL[name]
                for key, kernel in (("dq", "dq"), ("dk", "dkv"),
                                    ("dv", "dkv"), ("dbias_h", "dkv")):
                    worst[kernel] = max(worst[kernel], (
                        got[key].float() - ref[key].float()).abs().max()
                        .item())
                log(f"bwd parity {name} (B,H,S,D)=({b},{h},{s},{d}) {case}: "
                    + ", ".join(f"{key} {errs[key]:.2e} (tol {tols[key]})"
                                for key in errs)
                    + f", finite {finite}, two launches equal {stable} -> "
                    + ("ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError(
                        f"backward kernels disagree with their plain "
                        f"versions: {name} ({b},{h},{s},{d}) {case}")
                fused_parity(torch, fa, args, got, ref, do, name, case,
                             f"({b},{h},{s},{d})", worst)
    misaligned_view_parity(torch, fa, gen, "bwd")
    misaligned_view_parity(torch, fa, gen, "fused")
    return worst


def fused_kernel(fa, args) -> dict:
    """dq, dk, dv and dbias_h from one launch of the fused kernel."""
    return dict(zip(("dq", "dk", "dv", "dbias_h"),
                    fa.flash_attention_bwd_fused_kernel(*args)))


def fused_parity(torch, fa, args, pair, ref, do, name, case, shape,
                 worst) -> None:
    """The fused kernel on one phase-3b case: dk, dv and dbias_h equal to
    the pair's bit for bit and to a relaunch's; dq within GRAD_RTOL of the
    pair's and of the plain version's; finite; on the fully-masked row each
    key's dv is the row's summed dO."""
    got, again = fused_kernel(fa, args), fused_kernel(fa, args)
    torch.cuda.synchronize()
    keys = ("dk", "dv", "dbias_h")
    bits = all(torch.equal(got[key], pair[key]) for key in keys)
    stable = all(torch.equal(got[key], again[key]) for key in keys)
    errs = {"dq vs pair": rel_err(got["dq"], pair["dq"]),
            "dq vs plain": rel_err(got["dq"], ref["dq"]),
            "relaunch dq": rel_err(again["dq"], got["dq"])}
    finite = all(bool(torch.isfinite(t).all()) for t in got.values())
    ok = finite and bits and stable and all(
        e <= GRAD_RTOL[name] for e in errs.values())
    if case == "masked_row":
        want = do[1].float().sum(dim=0, keepdim=True)
        ok = ok and rel_err(got["dv"][1], want.expand_as(
            got["dv"][1])) <= GRAD_RTOL[name]
    for key in got:
        worst["fused"] = max(worst["fused"], (
            got[key].float() - ref[key].float()).abs().max().item())
    log(f"fused parity {name} (B,H,S,D)={shape} {case}: dk, dv, dbias_h "
        f"equal to the pair's {bits}, to a relaunch's {stable}; "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f" (tol {GRAD_RTOL[name]}), finite {finite} -> "
        + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"fused kernel disagrees with the pair or the "
                             f"plain backward: {name} {shape} {case}")


def two_pass_kernels(fa, args) -> dict:
    """dq, dk, dv and dbias_h from one launch of each two-pass kernel."""
    out = {"dq": fa.flash_attention_dq_kernel(*args)}
    out["dk"], out["dv"], out["dbias_h"] = fa.flash_attention_dkv_kernel(*args)
    return out


def misaligned_view_parity(torch, fa, gen, which: str) -> None:
    """At (8,12,512,64) bf16 with padding: q as a view that starts 2 bytes
    past a 16-byte boundary and k as a view with a sequence stride of
    H·D + 1 elements. The wrappers must copy both once (the kernels' 16-byte
    copies need aligned rows), so the outputs equal those of the aligned
    tensors bit for bit. ``which``: "fwd" (the forward kernel) or "bwd"
    (the two-pass pair) or "fused" (the fused kernel, whose dq is summed
    by atomics and held within GRAD_RTOL; its other outputs bit for
    bit)."""
    b, h, s, d = PARITY_SHAPES[0]
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    bias = attention_cases(torch, fa, gen, b, s)["padding"][0]
    q_off = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:]
    q_off = q_off.view(q.shape).copy_(q)
    k_wide = torch.empty(b, s, h * d + 1, dtype=k.dtype, device="cuda")
    k_str = k_wide[..., :h * d].view(k.shape).copy_(k)
    if fa._aligned_16(q_off) or fa._aligned_16(k_str):
        raise AssertionError("the misaligned views came out aligned")
    if which == "fwd":
        def run(q_, k_):
            return dict(zip(("o", "lse"),
                            fa.flash_attention_kernel(q_, k_, v, bias)))
    else:
        o, lse = fa.flash_attention_reference(q, k, v, bias)
        rest = (v, bias, None, None, lse, do, fa.attention_delta(o, do))
        kernels = two_pass_kernels if which == "bwd" else fused_kernel

        def run(q_, k_):
            return kernels(fa, (q_, k_) + rest)
    want = run(q, k)
    got = run(q_off, k_str)
    torch.cuda.synchronize()
    atomic = {"dq"} if which == "fused" else set()
    equal = all(torch.equal(got[key], want[key]) for key in want
                if key not in atomic) and all(
        rel_err(got[key], want[key]) <= GRAD_RTOL["bfloat16"]
        for key in atomic)
    log(f"{which} misaligned views bfloat16 (B,H,S,D)=({b},{h},{s},{d}) "
        f"padding: q 2 bytes past 16, k sequence stride {k_str.stride(1)} "
        f"elements; outputs equal to the aligned operands' {equal}"
        + (" (dq within GRAD_RTOL)" if atomic else "") + " -> "
        + ("ok" if equal else "FAIL"))
    if not equal:
        raise AssertionError(f"misaligned operand views changed the {which} "
                             f"kernels' outputs")


def bwd_kernel_timing(torch, fa) -> dict:
    """At the training shape (B=8, H=12, S=512, D=64, bf16, padding mask):
    each backward kernel, its plain version, and the backward of
    ``scaled_dot_product_attention`` on the same inputs (the yardstick for
    the pair; the port never calls it)."""
    import torch.nn.functional as F

    b, h, s, d = PARITY_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    keep = torch.ones(b, s, dtype=torch.bool, device="cuda")
    keep[:, s - s // 4:] = False
    bias = torch.where(keep, 0.0, fa.NEG_INF)
    o, lse = fa.flash_attention_kernel(q, k, v, bias)
    args = (q, k, v, bias, None, None, lse, do, fa.attention_delta(o, do))
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves,
                                         attn_mask=keep[:, None, None, :])
    grad_out = do.transpose(1, 2)
    library_ms = device_ms(torch, lambda: torch.autograd.grad(
        out, leaves, grad_out, retain_graph=True))
    bounds = attention_bwd_bounds(b, h, s, d, 2, False)
    timing = {}
    for name, kernel, plain in (
            ("dq", fa.flash_attention_dq_kernel,
             fa.flash_attention_dq_reference),
            ("dkv", fa.flash_attention_dkv_kernel,
             fa.flash_attention_dkv_reference)):
        rec = {"ms": time_ms(torch, lambda: kernel(*args)),
               "plain_ms": time_ms(torch, lambda: plain(*args)),
               "library_ms": library_ms}
        rec["bound_ms"], rec["bound_by"] = bounds[name]
        log(f"timing flash_attn_bwd_{name} (B,H,S,D)=({b},{h},{s},{d}) bf16: "
            f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"sdpa backward (both, device) {library_ms:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        timing[name] = rec
    return timing


# --------------------------------------------------------------- phase 3c

def bwd_results(torch, fa, args) -> dict:
    """Every backward kernel and the plain backward on the same inputs:
    {"two_pass": ..., "fused": ..., "plain": ...}, each a dict of dq, dk,
    dv and dbias_h."""
    names = ("dq", "dk", "dv", "dbias_h")
    two = (fa.flash_attention_dq_kernel(*args),
           *fa.flash_attention_dkv_kernel(*args))
    fused = fa.flash_attention_bwd_fused_kernel(*args)
    torch.cuda.synchronize()
    plain = (fa.flash_attention_dq_reference(*args),
             *fa.flash_attention_dkv_reference(*args))
    return {route: dict(zip(names, outs)) for route, outs in (
        ("two_pass", two), ("fused", fused), ("plain", plain))}


def check_bwd(torch, res: dict, do, name: str, case: str, what: str,
              worst: dict) -> None:
    """Hold the fused kernel against the plain backward and against the
    two-pass kernels, and the two-pass kernels against the plain backward,
    with phase 3b's tolerances; the fused kernel's dk, dv and dbias_h must
    equal the two-pass ones bit for bit (one key-block body in each dtype);
    on the fully-masked row each key's dv must be the row's summed dO.
    Updates ``worst`` (max |err| per kernel)."""
    tols = {key: GRAD_RTOL[name] for key in ("dq", "dk", "dv")}
    tols["dbias_h"] = DBIAS_RTOL
    checks = (("fused vs plain", "fused", "plain"),
              ("two-pass vs plain", "two_pass", "plain"),
              ("fused vs two-pass", "fused", "two_pass"))
    ok = all(bool(torch.isfinite(t).all())
             for route in ("two_pass", "fused") for t in res[route].values())
    bits = all(torch.equal(res["fused"][key], res["two_pass"][key])
               for key in ("dk", "dv", "dbias_h"))
    ok = ok and bits
    parts = [f"fused dk, dv, dbias_h equal to the two-pass ones {bits}"]
    for label, got, ref in checks:
        errs = {key: rel_err(res[got][key], res[ref][key]) for key in tols}
        ok = ok and all(errs[key] <= tols[key] for key in tols)
        parts.append(label + " " + ", ".join(
            f"{key} {errs[key]:.2e}" for key in tols))
    if case == "masked_row":
        want = do[1].float().sum(dim=0, keepdim=True)
        for route in ("two_pass", "fused"):
            dv = res[route]["dv"][1]
            ok = ok and rel_err(dv, want.expand_as(dv)) <= GRAD_RTOL[name]
    for key, kernel in (("dq", "dq"), ("dk", "dkv"), ("dv", "dkv"),
                        ("dbias_h", "dkv")):
        plain = res["plain"][key].float()
        worst[kernel] = max(worst[kernel], (
            res["two_pass"][key].float() - plain).abs().max().item())
        worst["fused"] = max(worst["fused"], (
            res["fused"][key].float() - plain).abs().max().item())
    log(f"{what} {case}: " + "; ".join(parts)
        + f" (tol {GRAD_RTOL[name]}, dbias_h {DBIAS_RTOL}) -> "
        + ("ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError(f"backward kernels disagree: {what} {case}")


def long_kernel_parity(torch, fa) -> dict:
    """Phase 3c: the kernels at the streaming lengths, with padding and
    with segment ids, bf16 and f32. The forward kernel against the
    streaming forward's plain version; the two-pass and the fused backward
    against the plain backward and against each other, on the plain
    forward's o and lse. Then the fused kernel on the ragged (2,3,96,32)
    and in the whole-K takeover band (2,2,2048,64) bf16, all four cases.
    Returns the worst absolute error of each kernel."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "fused": 0.0}
    runs = [(shape, dtype, ("padding", "segments"))
            for shape in LONG_SHAPES
            for dtype in (torch.bfloat16, torch.float32)]
    runs += [((2, 3, 96, 32), dtype, None)
             for dtype in (torch.bfloat16, torch.float32)]
    runs += [((2, 2, 2048, 64), torch.bfloat16, None)]
    for (b, h, s, d), dtype, wanted in runs:
        name = str(dtype).split(".")[-1]
        what = f"{name} (B,H,S,D)=({b},{h},{s},{d})"
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda",
                                   generator=gen).to(dtype)
                       for _ in range(4))
        for case, (bias, sg) in attention_cases(torch, fa, gen, b,
                                                s).items():
            if wanted is not None and case not in wanted:
                continue
            o, lse = fa.flash_attention_kb_reference(q, k, v, bias, sg, sg)
            if s > fa.MAX_SEQ_VMEM:
                ko, klse = fa.flash_attention_kernel(q, k, v, bias, sg, sg)
                torch.cuda.synchronize()
                o_err = (ko.float() - o.float()).abs().max().item()
                o_rel = rel_err(ko, o)
                lse_err = ((klse - lse).abs()
                           / lse.abs().clamp(min=1.0)).max().item()
                ok = (bool(torch.isfinite(ko).all()) and o_rel <= O_RTOL[name]
                      and lse_err <= LSE_RTOL)
                worst["fwd"] = max(worst["fwd"], o_err)
                log(f"long parity fwd {what} {case}: o max|err| {o_err:.3e} "
                    f"= {o_rel:.3e} of max|o| {o.float().abs().max().item():.3e}"
                    f" (tol {O_RTOL[name]}), lse rel err {lse_err:.3e} (tol "
                    f"{LSE_RTOL}) -> {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"forward kernel disagrees with the "
                                         f"streaming plain version: {what} "
                                         f"{case}")
            args = (q, k, v, bias, sg, sg, lse, do, fa.attention_delta(o, do))
            check_bwd(torch, bwd_results(torch, fa, args), do, name, case,
                      f"long parity bwd {what}", worst)
            del args
        del q, k, v, do
        torch.cuda.empty_cache()
    return worst


def long_kernel_timing(torch, fa) -> dict:
    """At the long-context runs' shapes (B=1, H=12, D=64, bf16, no mask, as
    the synthetic stream's rows): the forward and the two-pass pair at
    S = 16384, the fused kernel at S = 8192, each beside its plain version,
    the bound, and SDPA's forward or backward device time on the same
    inputs (the yardstick; the port never calls it)."""
    import torch.nn.functional as F

    out = {}
    for s, names in ((16384, ("fwd", "dq", "dkv")), (8192, ("fused",))):
        b, h, d = 1, 12, 64
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        bias = torch.zeros(b, s, device="cuda")
        o, lse = fa.flash_attention_kernel(q, k, v, bias)
        args = (q, k, v, bias, None, None, lse, do, fa.attention_delta(o, do))
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        sdpa = {"fwd": device_ms(torch, lambda: F.scaled_dot_product_attention(
                    *(t.detach() for t in leaves)), iters=3, warmup=1),
                "bwd": device_ms(torch, lambda: torch.autograd.grad(
                    sdpa_out, leaves, do.transpose(1, 2), retain_graph=True),
                    iters=3, warmup=1)}
        bounds = attention_bwd_bounds(b, h, s, d, 2, False)
        bounds["fwd"] = attention_bound(b, h, s, d, 2, False)
        calls = {
            "fwd": (lambda: fa.flash_attention_kernel(q, k, v, bias),
                    lambda: fa.flash_attention_kb_reference(q, k, v, bias)),
            "dq": (lambda: fa.flash_attention_dq_kernel(*args),
                   lambda: fa.flash_attention_dq_reference(*args)),
            "dkv": (lambda: fa.flash_attention_dkv_kernel(*args),
                    lambda: fa.flash_attention_dkv_reference(*args)),
            "fused": (lambda: fa.flash_attention_bwd_fused_kernel(*args),
                      lambda: fa.flash_attention_bwd_reference(
                          q, k, v, bias, None, None, o, lse, do, args[-1])),
        }
        for name in names:
            kernel, plain = calls[name]
            rec = {"plain_ms": time_ms(torch, plain, iters=2, warmup=1),
                   "library_ms": sdpa["fwd" if name == "fwd" else "bwd"]}
            if name == "fused":  # in turns with the pair, as in the band
                turns = fused_vs_pair_timing(torch, fa, (b, h, s, d), args)
                rec["ms"], rec["two_pass_ms"] = (turns["fused_ms"],
                                                 turns["two_pass_ms"])
            else:
                rec["ms"] = time_ms(torch, kernel, iters=3, warmup=1)
            rec["tflops"] = tflops(name, b, h, s, d, rec["ms"])
            rec["bound_ms"], rec["bound_by"] = bounds[name]
            log(f"timing {KERNEL_NAMES[name]} (B,H,S,D)=({b},{h},{s},{d}) "
                f"bf16: kernel {rec['ms']:.4f} ms ({rec['tflops']:.1f} "
                f"TFLOP/s), plain {rec['plain_ms']:.4f} ms, sdpa "
                f"{'forward' if name == 'fwd' else 'backward (dq+dk+dv)'} "
                f"(device) {rec['library_ms']:.4f} ms, bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
            out[name] = rec
        del q, k, v, do, o, lse, args, leaves, sdpa_out
        torch.cuda.empty_cache()
    out["fused"]["takeover_band"] = [fused_vs_pair_timing(torch, fa, shape)
                                     for shape in BAND_SHAPES]
    return out


def fused_listed(torch, fa) -> bool:
    """Whether this card is in FUSED_BWD_VERIFIED_DEVICES, where auto takes
    the fused backward wherever the JAX package would."""
    name = torch.cuda.get_device_name(0).lower()
    return any(p in name for p in fa.FUSED_BWD_VERIFIED_DEVICES)


def long_runs(torch, fa) -> list[tuple[int, str]]:
    """(sequence length, the backward route auto must pick) of phase 6."""
    return [(seq, "fused" if seq <= fa.FUSED_BWD_MAX and fused_listed(
        torch, fa) else "stream") for seq in LONG_SEQS]


def fused_vs_pair_timing(torch, fa, shape, args=None) -> dict:
    """The fused kernel against the two-pass pair at one shape (bf16, no
    mask) where auto must pick the fused kernel on a listed card and the
    pair elsewhere: (1,12,8192,64) and the whole-K takeover band. Timed in
    turns (fused, pair, pair, fused), CUDA events; ``args`` are the kernels'
    inputs when the caller has them."""
    b, h, s, d = shape
    want = "fused" if fused_listed(torch, fa) else (
        "whole_k" if s <= fa.MAX_SEQ_VMEM else "stream")
    probe = torch.empty(b, s, h, d, device="cuda", dtype=torch.bfloat16)
    with fused_bwd(fa, None):
        if fa.backward_route(probe, probe) != want:
            raise AssertionError(f"auto does not pick the {want} backward "
                                 f"at {shape} bf16")
    del probe
    if args is None:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        bias = torch.zeros(b, s, device="cuda")
        o, lse = fa.flash_attention_kernel(q, k, v, bias)
        args = (q, k, v, bias, None, None, lse, do, fa.attention_delta(o, do))
    calls = {"fused": lambda: fa.flash_attention_bwd_fused_kernel(*args),
             "two_pass": lambda: (fa.flash_attention_dq_kernel(*args),
                                  fa.flash_attention_dkv_kernel(*args))}
    times = {"fused": [], "two_pass": []}
    for route in ("fused", "two_pass", "two_pass", "fused"):
        times[route].append(time_ms(torch, calls[route], iters=10, warmup=2))
    rec = {"shape": list(shape), "fused_ms": statistics.mean(times["fused"]),
           "two_pass_ms": statistics.mean(times["two_pass"]), "auto": want}
    log(f"timing fused vs two-pass (B,H,S,D)=({b},{h},{s},{d}) bf16, auto "
        f"{want}: fused "
        f"{', '.join(f'{t:.4f}' for t in times['fused'])} ms "
        f"({tflops('fused', b, h, s, d, rec['fused_ms']):.1f} TFLOP/s), "
        f"two-pass (dq + dkv) "
        f"{', '.join(f'{t:.4f}' for t in times['two_pass'])} ms; fused / "
        f"two-pass {rec['fused_ms'] / rec['two_pass_ms']:.3f}")
    return rec


# ---------------------------------------------------------------- phase 4

def kernel_wrappers(fa) -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    return {"fwd": fa.flash_attention, "dq": fa.flash_attention_dq_kernel,
            "dkv": fa.flash_attention_dkv_kernel,
            "fused": fa.flash_attention_bwd_fused_kernel}


def reset_counts(fa) -> None:
    """Set every kernel's launch count to 0, just before a main-path run."""
    for wrapper in kernel_wrappers(fa).values():
        wrapper.launches = 0


def read_counts(fa, serving: bool = False) -> dict:
    """The launch counts just after a main-path run; a serving run must
    have launched no backward kernel."""
    counts = {name: wrapper.launches
              for name, wrapper in kernel_wrappers(fa).items()}
    if serving and (counts["dq"] or counts["dkv"] or counts["fused"]):
        raise AssertionError(f"serving launched backward kernels: {counts}")
    return counts


def reference_model(torch, fa, model_config, state_dict):
    """The served model with every attention call swapped for the
    kernel's plain version, on the card."""
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.models.bert import (
        MultiHeadAttention,
    )

    def plain_attention(q, k, v, *, mask=None, segment_ids=None):
        b, s = q.shape[:2]
        bias = fa.attention_bias(mask, b, s, q.device)
        seg = None if segment_ids is None else segment_ids.float()
        return fa.flash_attention_reference(q, k, v, bias, seg, seg)[0]

    model = get_model(model_config, device="cuda")
    model.load_state_dict(state_dict)
    for module in model.modules():
        if isinstance(module, MultiHeadAttention):
            module.attention_fn = plain_attention
    return model


def check_logits(torch, ref_model, ids, got, bucket: int, what: str) -> dict:
    """``got`` (len, vocab) against the plain-attention model on the same
    padded row the engine ran."""
    n = len(ids)
    pad_ids = torch.zeros(1, bucket, dtype=torch.int64, device="cuda")
    pad_ids[0, :n] = torch.tensor(ids, device="cuda")
    mask = torch.zeros(1, bucket, dtype=torch.int64, device="cuda")
    mask[0, :n] = 1
    with torch.inference_mode():
        ref = ref_model(pad_ids, mask)[0, :n].float().cpu()
    got = torch.as_tensor(got, dtype=torch.float32).reshape(ref.shape)
    diff = (got - ref).abs()
    res = {"max": diff.max().item(), "mean": diff.mean().item(),
           "ref_std": ref.std().item()}
    log(f"{what}: logits vs plain-attention model max|err| "
        f"{res['max']:.4e} (tol {LOGIT_MAX_ATOL}), mean {res['mean']:.4e} "
        f"(tol {LOGIT_MEAN_ATOL}), ref std {res['ref_std']:.4f}")
    if not (res["max"] <= LOGIT_MAX_ATOL and res["mean"] <= LOGIT_MEAN_ATOL):
        raise AssertionError(f"{what}: served logits disagree with the "
                             f"plain-attention model")
    return res


class HttpClient(threading.Thread):
    """Waits for the server's endpoint.json, sends concurrent
    ``POST /predict`` requests, reads ``/healthz``, then SIGTERMs this
    process so ``cli.serve.main`` drains and returns."""

    def __init__(self, log_dir: str, vocab: int):
        super().__init__(name="chip-smoke-client", daemon=True)
        self.log_dir = log_dir
        self.vocab = vocab
        self.results: dict = {}
        self.error: BaseException | None = None

    def _endpoint(self, timeout_s: float = 600.0) -> str:
        path = os.path.join(self.log_dir, "endpoint.json")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.isfile(path):
                with open(path) as fh:
                    return json.load(fh)["url"]
            time.sleep(0.2)
        raise TimeoutError(f"server wrote no {path} in {timeout_s} s")

    def _post(self, url: str, ids: list[int]) -> tuple[int, dict, float]:
        body = json.dumps({"inputs": {"input_ids": ids,
                                      "attention_mask": [1] * len(ids)}})
        req = urllib.request.Request(
            url + "/predict", data=body.encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as resp:
            payload = json.loads(resp.read())
            return resp.status, payload, (time.perf_counter() - t0) * 1e3

    def run(self) -> None:
        try:
            import numpy as np

            url = self._endpoint()
            rng = np.random.default_rng(SEED)
            reqs = [rng.integers(0, self.vocab, n).tolist()
                    for n in HTTP_LENGTHS]
            replies: list = [None] * len(reqs)

            def send(i):
                try:
                    replies[i] = self._post(url, reqs[i])
                except Exception as e:  # noqa: BLE001 — re-raised below
                    replies[i] = e

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            for i, reply in enumerate(replies):
                if not isinstance(reply, tuple):
                    raise RuntimeError(
                        f"/predict of {HTTP_LENGTHS[i]} tokens failed: "
                        f"{reply!r}")
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            self.results = {"requests": reqs, "replies": replies,
                            "health": health}
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            self.error = e
        finally:
            os.kill(os.getpid(), signal.SIGTERM)


def kernel_class(name: str) -> str:
    name = name.lower()
    for kernel in ("flash_attn_bwd_fused", "flash_attn_bwd_dq",
                   "flash_attn_bwd_dkv", "flash_attn_fwd"):
        if kernel in name:
            return kernel
    if any(t in name for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "gemm"
    if "multi_tensor" in name:  # the foreach ops: grad norm, clip, AdamW
        return "optimizer"
    return "elementwise"


def device_kernels(prof) -> list[tuple[float, int, str]]:
    """(ms, launches, name) of each device kernel in a profile: device-side
    records only (the CPU ops that launched them carry the same time
    again), without user annotation ranges (``Optimizer.step#AdamW.step``
    spans kernels that are counted on their own)."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.key_averages():
        if (getattr(ev, "device_type", None) != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if ms > 0:
            out.append((ms, ev.count, ev.key))
    return out


def device_ms(torch, fn, iters: int = 10, warmup: int = 3) -> float:
    """Device kernel time of one call of ``fn``, from the profiler. For a
    call whose host work outlasts its kernels (an autograd backward over a
    small graph), CUDA events around back-to-back calls would time the
    host instead."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ms for ms, _, _ in device_kernels(prof)) / iters


def log_profile(prof, what: str, top: int) -> float:
    """Sum a profile's device kernel time by class, log it with the
    ``top`` longest kernels, and return the total in ms (0 when the
    profiler saw no device time)."""
    classes: dict[str, float] = {}
    kernels = []
    for ms, count, key in device_kernels(prof):
        cls = kernel_class(key)
        classes[cls] = classes.get(cls, 0.0) + ms
        kernels.append((ms, count, cls, key[:70]))
    total = sum(classes.values())
    if not total:
        log(f"profile ({what}): torch.profiler saw no device time")
        return 0.0
    log(f"profile ({what}, kernel time by class): " + ", ".join(
        f"{c} {ms:.3f} ms ({100 * ms / total:.1f}%)"
        for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]))
        + f"; total {total:.3f} ms")
    for ms, count, cls, key in sorted(kernels, reverse=True)[:top]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {cls:<11s} {key}")
    return total


def forward_breakdown(torch, model, plain_model, vocab: int) -> None:
    """Where one full batch's device time goes: the served forward at the
    largest bucket (8 rows x 512 tokens) timed against the same model
    with the kernel's plain version, then one profiled forward summed by
    kernel class. Measurement only; runs after the launch counts are
    read."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    ids = torch.randint(0, vocab, (8, 512), device="cuda", generator=gen)
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        t_kernel = time_ms(torch, lambda: model(ids, mask), iters=5)
        t_plain = time_ms(torch, lambda: plain_model(ids, mask), iters=5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(ids, mask)
            torch.cuda.synchronize()
    log(f"forward 8x512 bf16: {t_kernel:.3f} ms with the kernel, "
        f"{t_plain:.3f} ms with its plain version (CUDA events, 5 runs)")
    log_profile(prof, "one forward", top=8)


def serve_phase(torch, fa, workdir: str) -> tuple[int, dict]:
    import numpy as np

    from distributed_tensorflow_framework_torch.cli import serve as cli_serve
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.models import get_model
    from distributed_tensorflow_framework_torch.models.convert import to_flax
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        input_spec_for,
        load_artifact,
        save_artifact,
    )

    config_path = "configs/bert_base_mlm.yaml"
    overrides = ["serve.port=0", "serve.seq_buckets=[128,256,512]",
                 f"serve.log_dir={workdir}/logs"]
    cfg = load_config(config_path, overrides=overrides)
    m = cfg.model
    if (m.name, m.num_layers, m.hidden_size, m.num_heads, m.mlp_dim,
            m.vocab_size, m.max_seq_len, m.dtype, m.fused_qkv,
            m.attention_impl) != ("bert", 12, 768, 12, 3072, 30522, 512,
                                  "bfloat16", True, "pallas"):
        raise AssertionError(f"{config_path} is no longer BERT-base: {m}")
    t0 = time.perf_counter()
    model = get_model(m, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(SEED))
    artifact_dir = os.path.join(workdir, "artifact")
    save_artifact(artifact_dir, model_config=m, task="mlm",
                  params=to_flax(model), step=0,
                  input_spec=input_spec_for(cfg, "mlm"),
                  source={"seed": SEED, "made_by": "chip_smoke.py"})
    del model
    log(f"serve: BERT-base artifact from seed {SEED} written in "
        f"{time.perf_counter() - t0:.1f} s")

    # 4a: the HTTP server through cli/serve.py's main.
    client = HttpClient(os.path.join(workdir, "logs"), m.vocab_size)
    reset_counts(fa)
    client.start()
    rc = cli_serve.main(["--artifact", artifact_dir, "--config", config_path,
                         "--device", "cuda", *sum(
                             (["--set", o] for o in overrides), [])])
    http_launches = read_counts(fa, serving=True)["fwd"]
    client.join(60)
    if client.error is not None:
        raise client.error
    if rc != 0:
        raise AssertionError(f"cli.serve.main returned {rc}")
    res = client.results
    latencies = []
    for ids, (status, payload, ms) in zip(res["requests"], res["replies"]):
        out = payload["outputs"]
        shape = (len(out), len(out[0]), len(out[0][0]))
        if status != 200 or shape != (1, len(ids), m.vocab_size):
            raise AssertionError(f"/predict of {len(ids)} tokens: HTTP "
                                 f"{status}, outputs {shape}")
        latencies.append(ms)
    http_batches = res["health"]["engine"]["batches"]
    log(f"serve http: {len(latencies)} requests of lengths "
        f"{list(HTTP_LENGTHS)}, p50 {statistics.median(latencies):.1f} ms, "
        f"max {max(latencies):.1f} ms, batches {http_batches}, kernel "
        f"launches {http_launches}")
    if http_launches != 12 * http_batches or http_batches < 1:
        raise AssertionError(f"expected {12 * http_batches} kernel launches "
                             f"(12 layers x {http_batches} batches), saw "
                             f"{http_launches}")

    # 4b: a 512-token and a 300-token request through engine.predict.
    artifact = load_artifact(artifact_dir)
    engine = InferenceEngine(artifact, cfg.serve, device="cuda")
    rng = np.random.default_rng(SEED + 2)
    long_ids = [rng.integers(0, m.vocab_size, n).tolist() for n in (512, 300)]
    reset_counts(fa)
    outs = [engine.predict({"input_ids": ids}, timeout=600)
            for ids in long_ids]
    engine_launches = read_counts(fa, serving=True)["fwd"]
    engine_batches = engine.stats()["batches"]
    engine.drain(60)
    for ids, out in zip(long_ids, outs):
        if out.shape != (1, len(ids), m.vocab_size) or not (
                np.isfinite(out).all()):
            raise AssertionError(f"engine.predict of {len(ids)} tokens gave "
                                 f"{out.shape}")
    log(f"serve engine.predict: lengths {[len(i) for i in long_ids]}, "
        f"batches {engine_batches}, kernel launches {engine_launches}")
    if engine_launches != 12 * engine_batches or engine_batches < 1:
        raise AssertionError(f"expected {12 * engine_batches} launches, "
                             f"saw {engine_launches}")

    ref = reference_model(torch, fa, m, artifact.state_dict)
    i24 = HTTP_LENGTHS.index(24)
    check_logits(torch, ref, res["requests"][i24],
                 res["replies"][i24][1]["outputs"], 128, "http 24 tokens")
    check_logits(torch, ref, long_ids[0], outs[0], 512,
                 "engine 512 tokens")
    forward_breakdown(torch, engine.model, ref, m.vocab_size)
    return http_launches + engine_launches, {
        "requests": len(latencies), "batches": http_batches + engine_batches}


# ---------------------------------------------------------------- phase 5

def train_breakdown(torch, config, warmup: int = 2, steps: int = 5) -> None:
    """One training step at a main-path run's shape, after the launch
    counts are read: step time over ``steps`` synced steps after
    ``warmup`` (host clock), then one profiled step summed by kernel class;
    idle = 1 − kernel time / step time."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    builder = StepBuilder(config, device="cuda")
    state = builder.init_state(SEED)
    batch = to_device(next(get_dataset(config.data)), torch.device("cuda"))
    for _ in range(warmup):
        builder.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        builder.train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        builder.train_step(state, batch)
        torch.cuda.synchronize()
    log(f"train step {config.data.global_batch_size}x{config.data.seq_len} "
        f"bf16: {step_ms:.3f} ms (host clock, {steps} synced steps)")
    total = log_profile(prof, "one train step", top=12)
    if total:
        log(f"train step device idle {100 * max(0.0, 1 - total / step_ms):.1f}%"
            f" of the step")


def train_phase(torch, fa, workdir: str) -> dict:
    """``cli.train.main`` on BERT-base at full width; returns the launch
    counts of the run."""
    from distributed_tensorflow_framework_torch.cli import train as cli_train
    from distributed_tensorflow_framework_torch.core.config import load_config

    config_path = "configs/bert_base_mlm.yaml"
    cfg = load_config(config_path, overrides=list(TRAIN_OVERRIDES))
    m, o = cfg.model, cfg.optimizer
    if (m.name, m.num_layers, m.hidden_size, m.num_heads, m.mlp_dim,
            m.vocab_size, m.max_seq_len, m.dtype, m.fused_qkv,
            m.attention_impl, m.dropout_rate, o.name, o.grad_clip_norm) != (
            "bert", 12, 768, 12, 3072, 30522, 512, "bfloat16", True,
            "pallas", 0.1, "adamw", 1.0):
        raise AssertionError(f"{config_path} is no longer BERT-base MLM "
                             f"training: {m}, {o}")
    log_dir = os.path.join(workdir, "train_logs")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa)
    t0 = time.perf_counter()
    rc = cli_train.main(["--config", config_path, "--device", "cuda",
                         "--log-dir", log_dir,
                         *sum((["--set", s] for s in TRAIN_OVERRIDES), [])])
    counts = read_counts(fa)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"cli.train.main returned {rc}")
    with open(os.path.join(log_dir, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    train = [e for e in events if e["kind"] == "train_step"]
    evals = [e for e in events if e["kind"] == "eval"]
    steps, micro = cfg.train.total_steps, cfg.train.total_steps * max(
        1, cfg.train.grad_accum_steps)
    want = {"fwd": 12 * (micro + cfg.train.eval_steps), "dq": 12 * micro,
            "dkv": 12 * micro, "fused": 0}
    for e in train:
        log(f"train step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items())
            + f", {e['throughput']['examples_per_sec']:.2f} examples/s")
    for e in evals:
        log(f"train eval at step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items()))
    values = [v for e in train + evals for v in e["metrics"].values()]
    if ([e["step"] for e in train] != list(range(
            cfg.train.log_interval, steps + 1, cfg.train.log_interval))
            or len(evals) != 1
            or not all(math.isfinite(v) for v in values)):
        raise AssertionError("training metrics missing or not finite")
    # Steady window: the logging windows after the first (which builds
    # the kernels); the throughput meter restarts at every synced log.
    eps = [e["throughput"]["examples_per_sec"] for e in train[1:]]
    rate = statistics.mean(eps)
    tokens = rate * cfg.data.seq_len
    log(f"train: {steps} steps of {cfg.data.global_batch_size}x"
        f"{cfg.data.seq_len} in {wall:.1f} s; steady (steps "
        f"{train[0]['step'] + 1}-{steps}) {1e3 * cfg.data.global_batch_size / rate:.2f}"
        f" ms/step, {tokens:.0f} tokens/s; peak memory {peak_gb:.2f} GB; "
        f"kernel launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"expected launches {want}, saw {counts}")
    train_breakdown(torch, cfg)
    return counts


# --------------------------------------------------------------- phase 5b

def plain_attention_fn(torch, fa):
    """``flash_attention`` with the kernels' plain versions on the card:
    the forward reference, and the dQ/dK/dV references in the backward."""

    class PlainFlashAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, bias, seg):
            o, lse = fa.flash_attention_reference(q, k, v, bias, seg, seg)
            ctx.save_for_backward(q, k, v, bias, seg, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, bias, seg, o, lse = ctx.saved_tensors
            dq, dk, dv, _ = fa.flash_attention_bwd_reference(
                q, k, v, bias, seg, seg, o, lse, do)
            return dq, dk, dv, None, None

    def plain_attention(q, k, v, *, mask=None, segment_ids=None):
        b, s = q.shape[:2]
        bias = fa.attention_bias(mask, b, s, q.device)
        seg = None if segment_ids is None else segment_ids.float()
        return PlainFlashAttention.apply(q, k, v, bias, seg)

    return plain_attention


def train_parity_phase(torch, fa) -> None:
    """One step's gradients through the kernels against the same model
    with their plain versions, then learning on one repeated batch."""
    from distributed_tensorflow_framework_torch.core.config import load_config
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.models.bert import (
        MultiHeadAttention,
    )
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    cfg = load_config("configs/bert_base_mlm.yaml",
                      overrides=list(PARITY_OVERRIDES))
    builder = StepBuilder(cfg, device="cuda")
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cuda"))
    grads = {}
    for route in ("kernel", "plain"):
        state = builder.init_state(SEED)  # same weights, same dropout seed
        if route == "plain":
            plain = plain_attention_fn(torch, fa)
            for module in state.model.modules():
                if isinstance(module, MultiHeadAttention):
                    module.attention_fn = plain
        state.optimizer.zero_grad()
        reset_counts(fa)
        builder._micro_step(state, batch, 1.0)
        counts = read_counts(fa)
        if route == "kernel" and counts != {"fwd": 12, "dq": 12, "dkv": 12,
                                            "fused": 0}:
            raise AssertionError(f"kernel route launched {counts}")
        if route == "plain" and any(counts.values()):
            raise AssertionError(f"plain route launched kernels: {counts}")
        grads[route] = {k: p.grad.float().clone()
                        for k, p in state.model.named_parameters()}
        del state
    worst_key, worst = "", 0.0
    for key, ref in grads["plain"].items():
        err = rel_err(grads["kernel"][key], ref)
        if err > worst:
            worst_key, worst = key, err
    qkv = [f"layer{i}.attn.qkv.weight" for i in range(12)]
    qkv_norms = [grads["kernel"][k].norm().item() for k in qkv]
    qkv_err = max(rel_err(grads["kernel"][k], grads["plain"][k]) for k in qkv)
    log(f"train parity: gradients through the kernels vs their plain "
        f"versions, worst leaf {worst_key} {worst:.3e} of its max (tol "
        f"{MODEL_GRAD_RTOL}); QKV weight gradient norms {min(qkv_norms):.4e}"
        f"..{max(qkv_norms):.4e}, worst QKV error {qkv_err:.3e}")
    if worst > MODEL_GRAD_RTOL or not all(
            n > 0 and math.isfinite(n) for n in qkv_norms):
        raise AssertionError("kernel-path gradients disagree with the "
                             "plain-attention model, or the QKV projection "
                             "got no gradient")

    # Learning: the same batch over and over at a constant lr.
    cfg = load_config("configs/bert_base_mlm.yaml",
                      overrides=list(PARITY_OVERRIDES) + list(LEARN_OVERRIDES))
    builder = StepBuilder(cfg, device="cuda")
    state = builder.init_state(SEED)
    trajectory = [float(builder.train_step(state, batch)["loss"])
                  for _ in range(cfg.train.total_steps)]
    log("learning on one repeated batch (8x512, lr 1e-4 constant): loss "
        + " ".join(f"{v:.3f}" for v in trajectory))
    if not trajectory[-1] < LEARN_RATIO * trajectory[0]:
        raise AssertionError(
            f"loss at step {len(trajectory)} ({trajectory[-1]:.4f}) is not "
            f"below {LEARN_RATIO} x the loss at step 1 ({trajectory[0]:.4f})")


# ---------------------------------------------------------------- phase 6

def long_config(torch, seq: int, extra=()):
    """``configs/bert_long_ring.yaml`` at ``seq`` tokens on one card, with
    its width and depth checked."""
    from distributed_tensorflow_framework_torch.core.config import load_config

    over = list(LONG_OVERRIDES) + list(extra)
    if seq != 16384:
        over += [f"model.max_seq_len={seq}", f"data.seq_len={seq}"]
    cfg = load_config(LONG_CONFIG, overrides=over)
    m = cfg.model
    if (m.name, m.num_layers, m.hidden_size, m.num_heads, m.mlp_dim,
            m.vocab_size, m.dtype, m.remat, m.dropout_rate) != (
            "bert", 12, 768, 12, 3072, 30522, "bfloat16", True, 0.1):
        raise AssertionError(f"{LONG_CONFIG} is no longer long-context "
                             f"BERT-base with remat: {m}")
    return cfg, over


@contextlib.contextmanager
def fused_bwd(fa, value):
    """``fa.FUSED_BWD`` set to ``value`` (None = auto) for the block, as the
    JAX package's scripts assign it, and restored after."""
    saved = fa.FUSED_BWD
    fa.FUSED_BWD = value
    try:
        yield
    finally:
        fa.FUSED_BWD = saved


def long_train_phase(torch, fa, workdir: str, seq: int, route: str) -> dict:
    """``cli.train.main`` on the long-context config at ``seq`` tokens with
    FUSED_BWD on auto, which must pick ``route`` ("fused" or "stream");
    returns the run's launch counts."""
    from distributed_tensorflow_framework_torch.cli import train as cli_train

    cfg, over = long_config(torch, seq)
    log_dir = os.path.join(workdir, f"long_{seq}")
    steps = cfg.train.total_steps
    micro = steps * max(1, cfg.train.grad_accum_steps)
    layers = cfg.model.num_layers
    fused = route == "fused"
    # With remat the forward kernel runs twice per layer and micro-batch
    # (forward and recompute), and once per layer for an eval batch.
    want = {"fwd": 2 * layers * micro + layers * cfg.train.eval_steps,
            "dq": 0 if fused else layers * micro,
            "dkv": 0 if fused else layers * micro,
            "fused": layers * micro if fused else 0}
    with fused_bwd(fa, None):
        auto = fa.backward_route(*(torch.empty(1, seq, 1, 64, device="cuda",
                                               dtype=torch.bfloat16),) * 2)
        if auto != route:
            raise AssertionError(
                f"S={seq}: auto picks the {auto} backward on "
                f"{torch.cuda.get_device_name(0)}, expected {route}")
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa)
        t0 = time.perf_counter()
        rc = cli_train.main(["--config", LONG_CONFIG, "--device", "cuda",
                             "--log-dir", log_dir,
                             *sum((["--set", o] for o in over), [])])
        counts = read_counts(fa)
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise AssertionError(f"cli.train.main returned {rc} at S={seq}")
    with open(os.path.join(log_dir, "events.jsonl")) as fh:
        train = [e for e in map(json.loads, fh) if e["kind"] == "train_step"]
    for e in train:
        log(f"long S={seq} step {e['step']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in e["metrics"].items()))
    if [e["step"] for e in train] != list(range(1, steps + 1)) or not all(
            math.isfinite(v) for e in train for v in e["metrics"].values()):
        raise AssertionError(f"S={seq}: training metrics missing or not "
                             f"finite")
    # Steady window: the steps after the first; the throughput meter
    # restarts at every synced log step.
    rate = statistics.mean(e["throughput"]["examples_per_sec"]
                           for e in train[1:])
    b = cfg.data.global_batch_size
    log(f"long S={seq}: {steps} steps of {b}x{seq} (grad accum "
        f"{cfg.train.grad_accum_steps}, remat, "
        f"{'fused' if fused else 'two-pass'} backward) in {wall:.1f} s; "
        f"steady (steps 2-{steps}) {1e3 * b / rate:.1f} ms/step, "
        f"{rate * seq:.0f} tokens/s; peak memory {peak_gb:.2f} GB; kernel "
        f"launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"S={seq}: expected launches {want}, saw "
                             f"{counts}")
    with fused_bwd(fa, None):
        train_breakdown(torch, cfg, warmup=1, steps=1)
    return counts


# --------------------------------------------------------------- phase 6b

def long_fused_parity_phase(torch, fa) -> tuple[dict, int]:
    """At S = 8192 with dropout and remat: one micro-step's gradients with
    the fused backward against the same model, weights, batch and dropout
    stream with the two-pass kernels (a plain-attention model would hold
    12 layers of 3 GB score tensors); then the full phase-6 step timed on
    each route, in turns (host clock), and its kernel time in one profiled
    step per route. Returns the step times and the fused kernel's launches
    in the forced micro-step."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    cfg, _ = long_config(torch, 8192, ("data.global_batch_size=1",
                                       "train.grad_accum_steps=1"))
    builder = StepBuilder(cfg, device="cuda")
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cuda"))
    grads = {}
    for fused in (True, False):
        state = builder.init_state(SEED)
        state.optimizer.zero_grad()
        reset_counts(fa)
        with fused_bwd(fa, fused):
            builder._micro_step(state, batch, 1.0)
        counts = read_counts(fa)
        want = {"fwd": 24, "dq": 0 if fused else 12,
                "dkv": 0 if fused else 12, "fused": 12 if fused else 0}
        if counts != want:
            raise AssertionError(f"fused={fused}: launched {counts}, "
                                 f"expected {want}")
        if fused:
            forced_launches = counts["fused"]
        grads[fused] = {k: p.grad.float().clone()
                        for k, p in state.model.named_parameters()}
        del state
    # The key projection's bias has a gradient that is zero in exact
    # arithmetic (softmax ignores the per-row constant q·b_k), so both
    # routes hold only f32 noise there: it is measured against the
    # model's largest gradient, every other leaf against its own.
    top = max(g.abs().max().item() for g in grads[False].values())
    worst_key, worst, noise = "", 0.0, 0.0
    for key, ref in grads[False].items():
        if key.endswith("attn.key.bias"):
            noise = max(noise, (grads[True][key] - ref).abs().max()
                        .item() / top)
            continue
        err = rel_err(grads[True][key], ref)
        if err > worst:
            worst_key, worst = key, err
    log(f"long fused parity S=8192 (dropout 0.1, remat): gradients with "
        f"the fused backward vs the two-pass kernels, worst leaf "
        f"{worst_key} {worst:.3e} of its max (tol {MODEL_GRAD_RTOL}); "
        f"key-projection biases {noise:.3e} of the largest gradient")
    if not (worst <= MODEL_GRAD_RTOL and noise <= MODEL_GRAD_RTOL):
        raise AssertionError("fused-backward gradients disagree with the "
                             "two-pass kernels at S=8192")
    del grads

    cfg, _ = long_config(torch, 8192)
    builder = StepBuilder(cfg, device="cuda")
    batch = to_device(next(get_dataset(cfg.data)), torch.device("cuda"))
    state = builder.init_state(SEED)
    times = {False: [], True: []}
    for i, fused in enumerate((False, True, False, True, True, False,
                               False, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fused_bwd(fa, fused):
            builder.train_step(state, batch)
        torch.cuda.synchronize()
        if i >= 2:  # the first step of each route warms up
            times[fused].append((time.perf_counter() - t0) * 1e3)
    out = {"two_pass_ms": statistics.mean(times[False]),
           "fused_ms": statistics.mean(times[True])}
    log(f"long step S=8192 {cfg.data.global_batch_size}x8192 (grad accum "
        f"{cfg.train.grad_accum_steps}), host clock, synced, in turns: "
        f"two-pass {', '.join(f'{t:.1f}' for t in times[False])} ms, "
        f"fused {', '.join(f'{t:.1f}' for t in times[True])} ms; means "
        f"{out['two_pass_ms']:.1f} / {out['fused_ms']:.1f} ms")
    # The host clock also counts the host's dispatch, which varies from
    # machine to machine; the kernel time of one profiled step per route
    # does not.
    for fused, route in ((False, "two_pass"), (True, "fused")):
        with fused_bwd(fa, fused), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            builder.train_step(state, batch)
            torch.cuda.synchronize()
        out[f"{route}_kernel_ms"] = log_profile(
            prof, f"one 8x8192 step, {route.replace('_', '-')} backward",
            top=0)
    log(f"long step S=8192 kernel time per step: two-pass "
        f"{out['two_pass_kernel_ms']:.1f} ms, fused "
        f"{out['fused_kernel_ms']:.1f} ms")
    return out, forced_launches



def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from distributed_tensorflow_framework_torch.core.device import (
            gpu_name_and_power_limit,
        )
        from distributed_tensorflow_framework_torch.ops import _build
        from distributed_tensorflow_framework_torch.ops import (
            flash_attention as fa,
        )
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable ({e}) — "
              f"run from the repository root", file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power_limit()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"phase 2 build: {len(built)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    report = {}
    for result in built:
        report.update(build_report(_build, result))
    fused_beside_pair(report)

    log("phase 3 kernel parity")
    parity = kernel_parity(torch, fa)
    timing = kernel_timing(torch, fa)
    log("phase 3b backward kernel parity")
    bwd_worst = bwd_kernel_parity(torch, fa)
    bwd_timing = bwd_kernel_timing(torch, fa)
    log("phase 3c long-context kernel parity")
    long_worst = long_kernel_parity(torch, fa)
    long_timing = long_kernel_timing(torch, fa)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        log("phase 4 serve")
        launches, served = serve_phase(torch, fa, workdir)
        log(f"serve summary: {served['requests']} HTTP requests + 2 engine "
            f"requests, {served['batches']} batches, {launches} kernel "
            f"launches")
        log("phase 5 train")
        train_counts = train_phase(torch, fa, workdir)
        log("phase 5b training parity and learning")
        train_parity_phase(torch, fa)
        log("phase 6 long-context training")
        long_counts = [long_train_phase(torch, fa, workdir, seq, route)
                       for seq, route in long_runs(torch, fa)]
    log("phase 6b fused vs two-pass backward at S=8192")
    step_8192, forced_launches = long_fused_parity_phase(torch, fa)

    # Launches on the main path: serving, the S=512 training run and the
    # two long-context runs. Times, bounds and the plain and library times
    # are those at the long-context shapes (phase 3c); "s512" keeps the
    # S=512 ones of phases 3 and 3b. Where auto does not pick the fused
    # kernel on this card, its launches are those of phase 6b's micro-step
    # with FUSED_BWD forced on, and say so.
    launched = {name: train_counts[name] + sum(c[name] for c in long_counts)
                for name in KERNEL_NAMES}
    launched["fwd"] += launches
    forced = launched["fused"] == 0
    if forced:
        launched["fused"] = forced_launches
    short = {"fwd": timing, **bwd_timing}
    worst = {"fwd": parity["max_abs_err"], **bwd_worst}
    extra = {"fused": {"launches_forced": forced, "step_8192": step_8192}}
    record = {"kernels": [
        {"name": KERNEL_NAMES[name], "route": "cuda", "source": SOURCES[name],
         "units": "bf16 on the tensor cores (mma.sync.m16n8k16), f32 on the "
                  "CUDA cores",
         "replaces": REPLACES[name], "launches": launched[name],
         "max_abs_err": max(worst[name], long_worst[name]),
         **long_timing[name],
         **({"s512": short[name]} if name in short else {}),
         **extra.get(name, {})}
        for name in KERNEL_NAMES]}
    for k in record["kernels"]:
        log(f"kernel {k['name']}: max_abs_err {k['max_abs_err']}, kernel_ms "
            f"{k['ms']} ({k['tflops']:.1f} TFLOP/s), plain_ms {k['plain_ms']}, "
            f"library_ms "
            f"{k['library_ms']}, bound_ms {k['bound_ms']} ({k['bound_by']}), "
            f"launches {k['launches']}")
    print(json.dumps(record))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
