"""Peaks, roofline bounds and kernel classes, frozen for the benchmark.

Copied from the repository's ``chip_smoke.py`` (``roofline_ms``,
``attention_flops``, ``attention_bound``, ``attention_bwd_bounds``,
``kernel_class``, ``image_kernel_class``) so that a later change to that
script cannot move the yardstick. The peaks are one NVIDIA H100 SXM's
dense rates from its data sheet, at the full 700 W power limit.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, bf16
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12

# S x S x D products per kernel (attention_bound, attention_bwd_bounds).
PRODUCTS = {"flash_attn_fwd": 2, "flash_attn_bwd_dq": 3,
            "flash_attn_bwd_dkv": 4, "flash_attn_bwd_fused": 5}
ATTENTION_KERNELS = ("flash_attn_bwd_fused", "flash_attn_bwd_dq",
                     "flash_attn_bwd_dkv", "flash_attn_fwd")


def roofline_ms(moved_bytes: float, flops: float, elem_bytes: int):
    """Least time for the work: the bytes at the memory rate, the
    operations at the peak rate of the input type, whichever is longer.
    Returns (ms, "bytes" | "operations")."""
    peak = H100_BF16_FLOPS if elem_bytes == 2 else H100_F32_FLOPS
    t_bytes = moved_bytes / H100_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_flops(kernel: str, b, h, s, d) -> int:
    """Operations of ``kernel``: PRODUCTS[kernel] S x S x D products of
    2*B*H*S^2*D each."""
    return PRODUCTS[kernel] * 2 * b * h * s * s * d


def attention_bound(b, h, s, d, elem_bytes, segmented):
    """Forward kernel: q, k, v, bias (and segment ids) read once, o and lse
    written once; two products."""
    moved = 4 * b * s * h * d * elem_bytes + b * s * 4 + b * s * h * 4
    moved += 2 * b * s * 4 if segmented else 0
    return roofline_ms(moved, attention_flops("flash_attn_fwd", b, h, s, d),
                       elem_bytes)


def attention_bwd_bounds(b, h, s, d, elem_bytes, segmented) -> dict:
    """dQ reads q, k, v, dO, bias, lse and delta and writes dq: three
    S x S x D products. dK/dV reads the same and writes dk, dv and the f32
    per-head dbias: four products. The fused kernel reads the same and
    writes dq, dk, dv and dbias: five products."""
    head = b * s * h * d * elem_bytes
    common = 4 * head + b * s * 4 + 2 * b * s * h * 4
    common += 2 * b * s * 4 if segmented else 0
    dbias = b * h * s * 4
    moved = {"flash_attn_bwd_dq": common + head,
             "flash_attn_bwd_dkv": common + 2 * head + dbias,
             "flash_attn_bwd_fused": common + 3 * head + dbias}
    return {name: roofline_ms(bytes_, attention_flops(name, b, h, s, d),
                              elem_bytes)
            for name, bytes_ in moved.items()}


def attention_bound_ms(kernel: str, b, h, s, d, elem_bytes=2,
                       segmented=False) -> float:
    """The bound of one launch of ``kernel`` at these shapes, in ms."""
    if kernel == "flash_attn_fwd":
        return attention_bound(b, h, s, d, elem_bytes, segmented)[0]
    return attention_bwd_bounds(b, h, s, d, elem_bytes, segmented)[kernel][0]


def kernel_class(name: str) -> str:
    """The BERT step's classes: each flash-attention kernel by name, the
    GEMMs, the foreach kernels, and the rest (elementwise)."""
    name = name.lower()
    for kernel in ATTENTION_KERNELS:
        if kernel in name:
            return kernel
    if any(t in name for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "gemm"
    if "multi_tensor" in name:  # the foreach ops: grad norm, clip, AdamW
        return "optimizer"
    return "elementwise"


def image_kernel_class(name: str) -> str:
    """cuDNN convolutions, BatchNorm, GEMMs, the optimizer's foreach ops,
    and the rest (ReLU, adds, pooling, casts, the loss)."""
    n = name.lower()
    if any(t in n for t in ("bn_fw", "bn_bw", "batch_norm", "batchnorm")):
        return "batchnorm"
    if any(t in n for t in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                            "cudnn")):
        return "conv"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "gemm"
    if "multi_tensor" in n:
        return "optimizer"
    return "elementwise"


def is_collective(name: str) -> bool:
    n = name.lower()
    return "nccl" in n
