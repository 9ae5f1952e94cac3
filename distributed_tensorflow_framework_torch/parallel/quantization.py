"""Block-scaled int8 quantization for collective wire formats: the port's
copy of ``parallel/quantization.py``.

The EQuARX recipe: split a flat f32 tensor into blocks of ``block_size``
elements, carry one f32 scale per block (max-abs / 127) and ship the
payload as int8, so a quantized collective moves ~1.016 bytes per element
against f32's 4 at the default 256. The contract, as in the JAX package:

  * inputs are flat f32 tensors whose size divides ``block_size`` (the
    callers pad with zeros; a zero block quantizes to zeros exactly);
  * a zero block gets scale 1.0, never 0; the others max-abs × f32(1/127),
    which is how XLA compiles the JAX package's ``maxabs / 127.0`` (a
    division by a constant becomes a multiplication by its reciprocal);
  * round half to even (``torch.round``, as ``jnp.rint``) of the f32
    quotient ``blocks / scales``, clamped to ±127, so the worst error per
    element is ``maxabs/254``.

On the CPU the codec gives JAX's bits (tests/test_torch_collectives.py).
"""

from __future__ import annotations

import torch

DEFAULT_BLOCK_SIZE = 256
# Wire-format overhead: one f32 scale per block.
SCALE_BYTES = 4
# 1/127 rounded to f32 (see the module docstring).
_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def quantize_blockwise(x: torch.Tensor, block_size: int = DEFAULT_BLOCK_SIZE
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 → (int8 payload of ``x``'s shape, f32 scales, one per
    block). ``x`` must be 1-D with ``x.numel() % block_size == 0``."""
    if x.dim() != 1 or x.numel() % block_size:
        raise ValueError(
            f"quantize_blockwise wants a flat tensor padded to a multiple of "
            f"block_size={block_size}, got shape {tuple(x.shape)}")
    blocks = x.float().view(-1, block_size)
    maxabs = blocks.abs().amax(dim=-1)
    scales = torch.where(maxabs > 0, maxabs * _INV_127,
                         torch.ones_like(maxabs))
    q = torch.round(blocks / scales[:, None]).clamp_(-127, 127)
    return q.to(torch.int8).view(x.shape), scales


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         block_size: int = DEFAULT_BLOCK_SIZE
                         ) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` (up to the rounding)."""
    blocks = q.float().view(-1, block_size)
    return (blocks * scales[:, None]).view(q.shape)


def quantization_error(x: torch.Tensor,
                       block_size: int = DEFAULT_BLOCK_SIZE) -> torch.Tensor:
    """``x - D(Q(x))``, the quantity error feedback carries forward."""
    q, s = quantize_blockwise(x, block_size)
    return x.float() - dequantize_blockwise(q, s, block_size)
