"""Ring attention: sequence-parallel exact attention over the ``seq`` axis.

Port of ``distributed_tensorflow_framework_tpu/parallel/ring.py``. Each
rank along ``seq`` holds one chunk of every row's tokens, ``[r·S/n,
(r+1)·S/n)``, through the whole model (models/bert.py); the attention
computes the local chunk first, then passes the K/V chunk (with its key
bias and its segment ids) one rank on, n − 1 times, so that each rank's
queries see every chunk: rank r holds its own at step 0 and then r − 1,
r − 2, … mod n. The chunks' partial attentions merge by their
logsumexp, in f32, and the result is cast to q's dtype at the end.

The move is :func:`~.collectives.ppermute_shift`: one autograd node per
rotation that sends and receives K, V, the bias and the segment ids in
one batch on the ring's own process group (core/mesh.py), and whose
backward sends the cotangents back the other way. Every rank issues the
same point-to-point operations in the same order, in the forward, in a
remat recompute and in autograd's backward, so the ranks stay in step.

Each chunk takes one of two routes, as in the JAX package
(:func:`_chunk_attention`): the flash kernels with their lse
(ops/flash_attention.py ``flash_attention_chunk``; on the card the CUDA
kernels, whose backward folds the lse cotangent into ``delta − dlse``)
at a chunk of at least ``FLASH_CHUNK_MIN`` tokens, or above
``MAX_SEQ_VMEM``, when the kernels take its shape; otherwise a plain
PyTorch chain that forms the chunk's scores, as the JAX package's XLA
chain does. A chunk above ``MAX_SEQ_VMEM`` that the kernels cannot take
raises, instead of forming a chunk² score block.

``FLASH_CHUNK_MIN`` is a module global read at call time, so tests and
scripts can assign it as the JAX package's do. Its value, 2048, is the
JAX package's crossover between its kernel and its XLA chain, measured
there on another device; it was not measured on the H100.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_framework_torch.ops import flash_attention as fa
from distributed_tensorflow_framework_torch.parallel import collectives as coll

FLASH_CHUNK_MIN = 2048
_F32_MIN = torch.finfo(torch.float32).min


def _unsupported_chunk(c: int) -> ValueError:
    return ValueError(
        f"ring chunk {c} exceeds MAX_SEQ_VMEM={fa.MAX_SEQ_VMEM} but "
        f"is not a BLOCK_Q multiple, so the flash kernels can't take "
        f"it and the XLA fallback would materialize a {c}x{c} score "
        f"block per shard. Pick mesh.seq so seq/ring_shards is a "
        f"128-multiple.")


def check_ring_shape(seq_len: int, n: int) -> None:
    """Raise, before anything is built, what the ring would raise for rows
    of ``seq_len`` tokens over ``n`` ranks: a length ``n`` does not divide,
    or a chunk above ``MAX_SEQ_VMEM`` that the kernels cannot take."""
    if seq_len % n:
        raise ValueError(
            f"data.seq_len={seq_len} does not split over mesh.seq={n}: "
            f"ring attention gives every rank an equal chunk of each row")
    c = seq_len // n
    if c > fa.MAX_SEQ_VMEM and not fa.chunk_supported(c):
        raise _unsupported_chunk(c)


def _chunk_attention(q, k, v, bias, q_seg=None, kv_seg=None):
    """One K/V chunk → (o (B, Sq, H, D) f32, normalised within the chunk;
    lse (B, Sq, H, 1) f32). ``q_seg``/``kv_seg``: (B, Sq)/(B, Sk) segment
    ids or None; tokens attend only within equal ids."""
    c = q.shape[1]
    if (c >= FLASH_CHUNK_MIN or c > fa.MAX_SEQ_VMEM) and \
            fa.chunk_supported(c):
        o, lse = fa.flash_attention_chunk(q, k, v, bias, q_seg, kv_seg)
        return o.float(), lse
    if c > fa.MAX_SEQ_VMEM:
        raise _unsupported_chunk(c)
    # The JAX chain's rounding: q·kᵀ in q's dtype, then f32, then scaled.
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = s + bias[:, None, None, :]
    if q_seg is not None:
        s = torch.where(q_seg[:, None, :, None] == kv_seg[:, None, None, :],
                        s, _F32_MIN)
    m = s.amax(dim=-1, keepdim=True)                          # (B,H,Sq,1)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)                           # (B,H,Sq,1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).float()
    o = pv / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).permute(0, 2, 1, 3)              # (B,Sq,H,1)
    return o, lse


def _merge_chunks(o, lse, o_c, lse_c):
    """Logsumexp-reweighted merge of two chunk-normalised partial
    attentions: o, o_c (B, Sq, H, D) f32; lse, lse_c (B, Sq, H, 1). A
    chunk whose keys are all masked (lse_c ≈ the f32 min) gets weight 0
    exactly."""
    lse_new = torch.logaddexp(lse, lse_c)
    o_new = o * torch.exp(lse - lse_new) + o_c * torch.exp(lse_c - lse_new)
    return o_new, lse_new


def ring_attention(q, k, v, bias, segment_ids=None, *, runtime=None):
    """Exact attention over the whole row with K/V rotating along ``seq``.
    Per-rank shapes: q, k, v (B, S/n, H, D), ``bias`` the additive (B, S/n)
    f32 key bias of this rank's chunk, which rotates with its K/V;
    ``segment_ids`` (B, S/n) or None, whose K/V-side copy rotates while
    the local one masks the queries, so packed documents cross chunk
    boundaries. ``runtime`` (core/mesh.py) gives the ring (None: a ring
    of one, the local chunk alone). Returns (B, S/n, H, D) in q's
    dtype."""
    n = 1 if runtime is None else runtime.sizes["seq"]
    seg = segment_ids
    o, lse = _chunk_attention(q, k, v, bias, seg, seg)
    chunk = [k, v, bias] + ([] if seg is None else [seg])
    for _ in range(n - 1):
        chunk = coll.ppermute_shift(chunk, runtime)
        o_c, lse_c = _chunk_attention(q, chunk[0], chunk[1], chunk[2], seg,
                                      None if seg is None else chunk[3])
        o, lse = _merge_chunks(o, lse, o_c, lse_c)
    return o.to(q.dtype)


def ring_attention_masked(q, k, v, *, mask=None, segment_ids=None,
                          runtime=None):
    """:func:`ring_attention` behind the model's attention signature:
    ``mask`` is this rank's (B, 1, 1, S/n) bool key mask (or None), turned
    into the additive f32 bias as ``ring_attention_sharded`` turns it."""
    b, s = q.shape[:2]
    bias = fa.attention_bias(mask, b, s, q.device)
    return ring_attention(q, k, v, bias, segment_ids, runtime=runtime)


def seq_part(runtime, length: int) -> slice:
    """This rank's tokens of a ``length``-token row: ``[r·c, (r+1)·c)``
    with ``c = length / n`` over the ``seq`` ranks."""
    group = runtime.axis_group("seq")
    c = length // group.size
    return slice(group.index * c, (group.index + 1) * c)
