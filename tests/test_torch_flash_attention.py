"""PyTorch port of the flash-attention forward vs the JAX package.

The same numpy inputs (made from a seed) go through the JAX
``flash_attention`` / ``flash_attention_chunk`` (Pallas in interpret mode
on the CPU, as tests/test_attention.py runs them) and ``_xla_reference``,
and through the port's ``flash_attention`` / ``flash_attention_with_lse``
on CPU tensors, where the port runs its plain PyTorch version of the CUDA
kernel. The kernel itself is held against that plain version on the card
by chip_smoke.py.

Tolerances: f32 rtol = atol = 2e-5 (tests/test_attention.py's bound: the
two sides sum the same f32 products in different orders). bf16 outputs are
compared at rtol = atol = 1.6e-2, two bf16 ulps near 1: both sides round
``p`` and ``o`` to bf16 at the same points, but an f32 difference in the
last place can flip either rounding by one ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.ops import _build
from distributed_tensorflow_framework_torch.ops import flash_attention as pt
from distributed_tensorflow_framework_tpu.ops import flash_attention as jx
from tests.test_torch_hygiene import torch_threads  # noqa: F401

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)


def _inputs(seed, b=2, s=128, h=4, d=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    keep = np.ones((b, s), bool)
    keep[0, s - s // 4:] = False  # trailing padding in row 0
    seg = np.zeros((b, s), np.int32)
    for row in range(b):  # three packed documents of uneven length
        cuts = sorted(rng.choice(np.arange(1, s), 2, replace=False))
        seg[row, cuts[0]:] = 1
        seg[row, cuts[1]:] = 2
    return q, k, v, keep, seg


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("s", [64, 128, 256])
@pytest.mark.parametrize("variant", ["plain", "mask", "segments"])
def test_flash_attention_matches_jax_f32(s, variant):
    q, k, v, keep, seg = _inputs(s, s=s)
    mask = keep[:, None, None, :] if variant == "mask" else None
    segs = seg if variant == "segments" else None
    ref = jx.flash_attention(
        _jax(q), _jax(k), _jax(v),
        mask=None if mask is None else jnp.asarray(mask),
        segment_ids=None if segs is None else jnp.asarray(segs))
    out = pt.flash_attention(
        _torch(q), _torch(k), _torch(v),
        mask=None if mask is None else torch.from_numpy(mask),
        segment_ids=None if segs is None else torch.from_numpy(segs))
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32_TOL)


@pytest.mark.parametrize("variant", ["mask", "segments"])
def test_flash_attention_matches_jax_bf16(variant):
    q, k, v, keep, seg = _inputs(7, s=128, d=64)
    kwargs_j, kwargs_t = {}, {}
    if variant == "mask":
        kwargs_j["mask"] = jnp.asarray(keep[:, None, None, :])
        kwargs_t["mask"] = torch.from_numpy(keep[:, None, None, :])
    else:
        kwargs_j["segment_ids"] = jnp.asarray(seg)
        kwargs_t["segment_ids"] = torch.from_numpy(seg)
    bf = jnp.bfloat16
    ref = jx.flash_attention(_jax(q, bf), _jax(k, bf), _jax(v, bf),
                             **kwargs_j)
    out = pt.flash_attention(
        *(_torch(t, torch.bfloat16) for t in (q, k, v)), **kwargs_t)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _np(ref), **BF16_TOL)


@pytest.mark.parametrize("s", [64, 128, 256])
@pytest.mark.parametrize("segmented", [False, True])
def test_with_lse_matches_flash_attention_chunk(s, segmented):
    q, k, v, keep, seg = _inputs(100 + s, s=s)
    bias = np.where(keep, 0.0, pt.NEG_INF).astype(np.float32)
    segs = (jnp.asarray(seg), jnp.asarray(seg)) if segmented else ()
    o_ref, lse_ref = jx.flash_attention_chunk(
        _jax(q), _jax(k), _jax(v), jnp.asarray(bias), *segs)
    tsegs = (torch.from_numpy(seg),) * 2 if segmented else ()
    o, lse = pt.flash_attention_with_lse(
        _torch(q), _torch(k), _torch(v), torch.from_numpy(bias), *tsegs)
    assert lse.shape == (2, s, 4, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), _np(o_ref), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), _np(lse_ref), **F32_TOL)


# The shapes at which chip_smoke.py phase 3 holds the CUDA kernel to this
# plain version, at CPU size: D = 64 and 128, and the ragged S = 96 (below
# BLOCK_Q, so both packages take it; not a multiple of the kernel's 64-row
# tiles). Each in the four masking cases of phase 3.
KERNEL_SHAPES = [(2, 256, 2, 64), (2, 256, 2, 128), (2, 96, 3, 32)]
CASES = ("none", "padding", "segments", "masked_row")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,s,h,d", KERNEL_SHAPES,
                         ids=lambda x: str(x))
def test_with_lse_matches_jax_at_kernel_shapes(b, s, h, d, case, dtype):
    """o against ``flash_attention_chunk`` at the o tolerance of the dtype;
    lse (f32 from exact products in both dtypes) at the f32 one. A
    fully-masked row averages V uniformly."""
    q, k, v, keep, seg = _inputs(1000 + s + d, b=b, s=s, h=h, d=d)
    if case == "masked_row":
        keep[1, :] = False
    if case == "none":
        keep[:] = True
    bias = np.where(keep, 0.0, pt.NEG_INF).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    segs = case == "segments"
    o_ref, lse_ref = jx.flash_attention_chunk(
        *(_jax(t, jdt) for t in (q, k, v)), jnp.asarray(bias),
        *((jnp.asarray(seg),) * 2 if segs else ()))
    o, lse = pt.flash_attention_with_lse(
        *(_torch(t, tdt) for t in (q, k, v)), torch.from_numpy(bias),
        *((torch.from_numpy(seg),) * 2 if segs else ()))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert o.dtype == tdt and o.shape == q.shape
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.float().numpy(), _np(o_ref), **tol)
    np.testing.assert_allclose(lse.numpy(), _np(lse_ref), **F32_TOL)
    if case == "masked_row":
        v1 = _torch(v[1], tdt).float().mean(dim=0)
        np.testing.assert_allclose(o[1].float().numpy(), np.broadcast_to(
            v1.numpy(), o[1].shape), **tol)


def test_matches_xla_reference():
    q, k, v, keep, _ = _inputs(3, s=256, d=64)
    bias = np.where(keep, 0.0, pt.NEG_INF).astype(np.float32)
    to_bhsd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
    ref = jx._xla_reference(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                            jnp.asarray(bias)[:, None, :])
    out = pt.flash_attention(_torch(q), _torch(k), _torch(v),
                             mask=torch.from_numpy(keep[:, None, None, :]))
    np.testing.assert_allclose(out.numpy(), _np(ref.transpose(0, 2, 1, 3)),
                               **F32_TOL)


def test_fully_masked_row_is_finite_and_matches_jax():
    """A row whose keys are all masked averages V uniformly (the finite
    NEG_INF semantics) and its lse sits at NEG_INF + log(S)."""
    q, k, v, keep, _ = _inputs(5, s=64)
    keep[1, :] = False
    bias = np.where(keep, 0.0, pt.NEG_INF).astype(np.float32)
    o_ref, lse_ref = jx.flash_attention_chunk(
        _jax(q), _jax(k), _jax(v), jnp.asarray(bias))
    o, lse = pt.flash_attention_with_lse(
        _torch(q), _torch(k), _torch(v), torch.from_numpy(bias))
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o[1].numpy(), np.broadcast_to(
        v[1].mean(axis=0), o[1].shape), **F32_TOL)
    np.testing.assert_allclose(o.numpy(), _np(o_ref), **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), _np(lse_ref), rtol=1e-6)


@pytest.mark.parametrize("s", [192, 320])
def test_length_guard_raises_like_jax(s):
    q = np.zeros((1, s, 2, 32), np.float32)
    with pytest.raises(ValueError, match="multiple of 128"):
        jx.flash_attention(_jax(q), _jax(q), _jax(q))
    with pytest.raises(ValueError, match="multiple of 128"):
        pt.flash_attention(_torch(q), _torch(q), _torch(q))
    with pytest.raises(ValueError, match="multiple of 128"):
        pt.flash_attention_with_lse(_torch(q), _torch(q), _torch(q),
                                    torch.zeros(1, s))


def test_unequal_shapes_and_half_segments_raise():
    q = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError, match="equal-shape"):
        pt.flash_attention(q, torch.zeros(1, 128, 2, 32), q)
    with pytest.raises(ValueError, match="both q_seg and kv_seg"):
        pt.flash_attention_with_lse(q, q, q, torch.zeros(1, 64),
                                    torch.zeros(1, 64))


def test_cpu_tensors_take_the_plain_path_without_counting():
    q = torch.randn(1, 64, 2, 32)
    before = pt.flash_attention.launches
    out = pt.flash_attention(q, q, q)
    assert pt.flash_attention.launches == before
    ref, _ = pt.flash_attention_reference(q, q, q, torch.zeros(1, 64))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_kernel_entry_refuses_cpu_tensors():
    q = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        pt.flash_attention_kernel(q, q, q, torch.zeros(1, 64))


def test_kernel_library_path_tracks_source_and_flags(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    first = _build.library_path(src)
    src.write_text("// b\n")
    assert _build.library_path(src) != first
    assert first.parent == _build.BUILD_DIR
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_missing_nvcc_raises_build_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()
