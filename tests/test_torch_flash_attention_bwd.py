"""PyTorch port of the flash-attention backward vs the JAX package.

The same numpy inputs and output cotangents (made from a seed) go through
``jax.grad`` of the JAX ``flash_attention`` / ``flash_attention_chunk``
(Pallas in interpret mode on the CPU, as tests/test_attention.py runs
them, so the JAX side runs its dQ and dK/dV kernels) and through torch
autograd of the port's ``flash_attention`` / ``flash_attention_with_lse``
on CPU tensors, where the port's ``FlashAttention`` runs the kernels'
plain PyTorch versions. The CUDA kernels themselves are held against those
plain versions on the card by chip_smoke.py.

Tolerances are on max|port − JAX| / max(1, max|JAX|) per gradient:
  * f32: 1e-5 — the same f32 arithmetic summed in other orders (observed
    ~7e-7);
  * bf16: 1.6e-2, four bf16 ulps at the largest value — both sides round
    o, p and ds to bf16 at the same points, but an f32 summation-order
    difference can flip a rounding by one ulp, and delta is formed from
    the bf16 o of each side's own forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.ops import flash_attention as pt
from distributed_tensorflow_framework_tpu.ops import flash_attention as jx
from tests.test_torch_hygiene import torch_threads  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b=2, s=128, h=4, d=32):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    keep = np.ones((b, s), bool)
    keep[0, s - s // 4:] = False  # trailing padding in row 0
    seg = np.zeros((b, s), np.int32)
    for row in range(b):  # three packed documents of uneven length
        cuts = sorted(rng.choice(np.arange(1, s), 2, replace=False))
        seg[row, cuts[0]:] = 1
        seg[row, cuts[1]:] = 2
    glse = rng.standard_normal((b, s, h, 1)).astype(np.float32)
    return q, k, v, g, keep, seg, glse


def _leaves(arrays, dtype):
    return [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]


def _assert_close(got, ref, tol, what):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"


def _check_flash_attention(s, variant, dtype_name, seed):
    jdt, tdt = DTYPES[dtype_name]
    q, k, v, g, keep, seg, _ = _inputs(seed, s=s)
    mask = keep[:, None, None, :] if variant == "mask" else None
    segs = seg if variant == "segments" else None

    def loss(q, k, v):
        o = jx.flash_attention(
            q, k, v, mask=None if mask is None else jnp.asarray(mask),
            segment_ids=None if segs is None else jnp.asarray(segs))
        return jnp.sum(o.astype(jnp.float32) * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    leaves = _leaves((q, k, v), tdt)
    out = pt.flash_attention(
        *leaves, mask=None if mask is None else torch.from_numpy(mask),
        segment_ids=None if segs is None else torch.from_numpy(segs))
    (out.float() * torch.from_numpy(g)).sum().backward()
    for name, leaf, r in zip("qkv", leaves, ref):
        assert leaf.grad.dtype == tdt
        _assert_close(leaf.grad, r, TOL[dtype_name], f"d{name}")


@pytest.mark.parametrize("s", [64, 128, 256])
@pytest.mark.parametrize("variant", ["plain", "mask", "segments"])
def test_gradients_match_jax_f32(s, variant):
    _check_flash_attention(s, variant, "float32", seed=s)


@pytest.mark.parametrize("variant", ["mask", "segments"])
def test_gradients_match_jax_bf16(variant):
    _check_flash_attention(128, variant, "bfloat16", seed=7)


@pytest.mark.parametrize("s", [64, 128, 256])
@pytest.mark.parametrize("segmented", [False, True])
def test_chunk_gradients_with_lse_cotangent_and_dbias(s, segmented):
    """The chunk path: gradients flow through o AND lse (delta − dlse in
    the backward), and into the key bias (per-head dbias summed over
    heads)."""
    q, k, v, g, keep, seg, glse = _inputs(100 + s, s=s)
    bias = np.where(keep, 0.0, pt.NEG_INF).astype(np.float32)
    segs = (jnp.asarray(seg), jnp.asarray(seg)) if segmented else ()

    def loss(q, k, v, bias):
        o, lse = jx.flash_attention_chunk(q, k, v, bias, *segs)
        return jnp.sum(o * g) + jnp.sum(lse * glse)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    leaves = _leaves((q, k, v, bias), torch.float32)
    tsegs = (torch.from_numpy(seg),) * 2 if segmented else ()
    o, lse = pt.flash_attention_with_lse(*leaves, *tsegs)
    ((o * torch.from_numpy(g)).sum()
     + (lse * torch.from_numpy(glse)).sum()).backward()
    for name, leaf, r in zip(("dq", "dk", "dv", "dbias"), leaves, ref):
        _assert_close(leaf.grad, r, TOL["float32"], name)


def test_fully_masked_row_gradients_match_jax():
    """A fully-masked row keeps the TPU semantics: lse = NEG_INF, so the
    backward's p = exp(s − lse) is 1 for every key (not 1/S), and each
    key's dv gathers the whole dO column of that row."""
    q, k, v, g, keep, _, _ = _inputs(5, s=64)
    keep[1, :] = False
    bias = np.where(keep, 0.0, pt.NEG_INF).astype(np.float32)

    def loss(q, k, v):
        o, _ = jx.flash_attention_chunk(q, k, v, jnp.asarray(bias))
        return jnp.sum(o * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = _leaves((q, k, v), torch.float32)
    o, _ = pt.flash_attention_with_lse(*leaves, torch.from_numpy(bias))
    (o * torch.from_numpy(g)).sum().backward()
    for name, leaf, r in zip("qkv", leaves, ref):
        _assert_close(leaf.grad, r, TOL["float32"], f"d{name}")
    dv_row = leaves[2].grad[1].numpy()
    np.testing.assert_allclose(
        dv_row, np.broadcast_to(g[1].sum(axis=0), dv_row.shape),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("segmented", [False, True])
def test_bwd_reference_matches_autograd_of_the_forward(segmented):
    """The plain backward (p recomputed from lse) equals torch autograd
    through the plain forward on rows that are not fully masked."""
    q, k, v, g, keep, seg, _ = _inputs(11, s=128)
    bias = torch.from_numpy(np.where(keep, 0.0, pt.NEG_INF)
                            .astype(np.float32))
    sg = torch.from_numpy(seg).float() if segmented else None
    leaves = _leaves((q, k, v), torch.float32)
    o, lse = pt.flash_attention_reference(*leaves, bias, sg, sg)
    do = torch.from_numpy(g)
    (o * do).sum().backward()
    dq, dk, dv, dbias_h = pt.flash_attention_bwd_reference(
        *(t.detach() for t in leaves), bias, sg, sg, o.detach(),
        lse.detach(), do)
    for name, got, leaf in zip("qkv", (dq, dk, dv), leaves):
        _assert_close(got, leaf.grad.numpy(), TOL["float32"], f"d{name}")
    assert dbias_h.shape == (2, 4, 128) and dbias_h.dtype == torch.float32


def test_gradient_beyond_max_seq_vmem_takes_the_streaming_route(monkeypatch):
    """Beyond MAX_SEQ_VMEM the gradient takes the streaming two-pass route:
    with the threshold forced to 128 in both packages (FUSED_BWD off),
    s = 256 goes that way, and its gradients match the JAX package's
    streaming backward (``_flash_bwd_kb``) on the same inputs (f32, 1e-5)."""
    for mod in (pt, jx):
        monkeypatch.setattr(mod, "MAX_SEQ_VMEM", 128)
        monkeypatch.setattr(mod, "BLOCK_Q_KB", 128)
        monkeypatch.setattr(mod, "BLOCK_K_KB", 128)
        monkeypatch.setattr(mod, "FUSED_BWD", False)
    calls = []
    stream_bwd = jx._flash_bwd_kb
    monkeypatch.setattr(jx, "_flash_bwd_kb",
                        lambda *a, **kw: calls.append(1) or stream_bwd(*a, **kw))
    jax.clear_caches()  # the jitted backward read MAX_SEQ_VMEM when traced
    q, k, v, g, keep, _, glse = _inputs(3, s=256)
    bias = np.where(keep, 0.0, pt.NEG_INF).astype(np.float32)

    def loss(q, k, v):
        o, lse = jx.flash_attention_chunk(q, k, v, jnp.asarray(bias))
        return jnp.sum(o * g) + jnp.sum(lse * glse)

    ref = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    assert calls, "the JAX package did not take its streaming backward"
    leaves = _leaves((q, k, v), torch.float32)
    assert pt.backward_route(leaves[0], leaves[1]) == "stream"
    o, lse = pt.flash_attention_with_lse(*leaves, torch.from_numpy(bias))
    ((o * torch.from_numpy(g)).sum()
     + (lse * torch.from_numpy(glse)).sum()).backward()
    for name, leaf, r in zip("qkv", leaves, ref):
        _assert_close(leaf.grad, r, TOL["float32"], f"d{name}")


def test_forward_only_paths_take_no_autograd():
    """Without a gradient to compute (no requires_grad, no_grad, or
    serving under inference_mode) the forward runs alone, at any length."""
    q = torch.randn(1, 64, 2, 32, requires_grad=True)
    with torch.inference_mode():
        assert pt.flash_attention(q, q, q).grad_fn is None
    with torch.no_grad():
        assert pt.flash_attention(q, q, q).grad_fn is None
    assert pt.flash_attention(q, q, q).grad_fn is not None
    long = torch.zeros(1, pt.MAX_SEQ_VMEM + pt.BLOCK_Q, 1, 32)
    assert pt.flash_attention(long, long, long).shape == long.shape


def test_cpu_backward_launches_no_kernel():
    q = torch.randn(1, 64, 2, 32, requires_grad=True)
    before = (pt.flash_attention.launches,
              pt.flash_attention_dq_kernel.launches,
              pt.flash_attention_dkv_kernel.launches)
    pt.flash_attention(q, q, q).sum().backward()
    assert q.grad is not None
    assert (pt.flash_attention.launches,
            pt.flash_attention_dq_kernel.launches,
            pt.flash_attention_dkv_kernel.launches) == before


def _misaligned(kind):
    """A (2, 128, 4, 32) bf16 view with dense (H, D) rows that breaks the
    kernels' 16-byte rule one way."""
    b, s, h, d = 2, 128, 4, 32
    if kind == "storage_offset":  # starts 2 bytes past a 16-byte boundary
        flat = torch.arange(b * s * h * d + 1, dtype=torch.float32)
        return flat.to(torch.bfloat16)[1:].view(b, s, h, d)
    if kind == "sequence_stride":  # H·D + 1 elements between positions
        wide = torch.randn(b, s, h * d + 1).to(torch.bfloat16)
        return wide[..., :h * d].view(b, s, h, d)
    wide = torch.randn(b, s * h * d + 1).to(torch.bfloat16)  # batch stride
    return wide[:, :s * h * d].view(b, s, h, d)


@pytest.mark.parametrize("kind", ["storage_offset", "sequence_stride",
                                  "batch_stride"])
def test_head_view_copies_a_misaligned_view_once(kind):
    """The backward kernels copy 16-byte chunks, so an operand whose start
    or batch/sequence stride is not a multiple of 16 bytes is copied into
    a fresh contiguous (aligned) tensor with the same values; the copy
    passes unchanged."""
    t = _misaligned(kind)
    assert not pt._aligned_16(t)
    got = pt._head_view(t)
    assert got is not t and got.is_contiguous() and pt._aligned_16(got)
    assert torch.equal(got, t)
    assert pt._head_view(got) is got


def test_head_view_keeps_the_fused_qkv_views_of_bert():
    """The main path copies nothing: the q, k and v that the port's BERT
    attention slices out of its fused QKV projection (BERT-base widths,
    bf16) start on 16 bytes with 16-byte strides, so ``_head_view`` returns
    each as it is."""
    from distributed_tensorflow_framework_torch.models.bert import (
        MultiHeadAttention,
    )

    attn = MultiHeadAttention(768, 12, dtype=torch.bfloat16,
                              attention_impl="pallas", fused_qkv=True)
    seen = []

    def spy(q, k, v, *, mask=None, segment_ids=None):
        seen.extend((t, pt._head_view(t)) for t in (q, k, v))
        return q

    attn.attention_fn = spy
    with torch.no_grad():
        attn(torch.randn(2, 16, 768).to(torch.bfloat16))
    assert len(seen) == 3
    for view, kept in seen:
        assert not view.is_contiguous() and view.stride(1) == 3 * 768
        assert kept is view


def test_backward_kernel_entries_refuse_cpu_tensors():
    q = torch.zeros(1, 64, 2, 32)
    lse = torch.zeros(1, 64, 2, 1)
    args = (q, q, q, torch.zeros(1, 64), None, None, lse, q, lse)
    with pytest.raises(ValueError, match="CUDA"):
        pt.flash_attention_dq_kernel(*args)
    with pytest.raises(ValueError, match="CUDA"):
        pt.flash_attention_dkv_kernel(*args)
