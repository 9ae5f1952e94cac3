"""PyTorch port of the streaming flash-attention regime vs the JAX package.

Both packages get small thresholds by monkeypatch, as
tests/test_attention.py forces them: ``MAX_SEQ_VMEM`` → 128 and
``BLOCK_Q_KB``/``BLOCK_K_KB`` → 128, so s = 384 runs a real 3 × 3 grid of
(q-block, k-block) pairs. The same numpy inputs (made from a seed) go
through the JAX kernels (Pallas in interpret mode on the CPU: the
streaming forward ``_flash_fwd_kb``, the two-pass streaming backward with
``FUSED_BWD=False`` and the fused one-pass backward with ``FUSED_BWD=True``)
and through the port on CPU tensors, where the forward takes
``flash_attention_kb_reference`` and every backward route the plain
backward. The CUDA kernels are held against those plain versions on the
card by chip_smoke.py (phase 3c).

Each case runs in f32 and bf16, with a key mask (trailing padding), with
segment ids, and with one fully-masked row. Tolerances, as max|port − JAX|
over max(1, max|JAX|):
  * f32: 1e-5 — the same f32 arithmetic summed in other orders;
  * bf16: 1.6e-2, four bf16 ulps at the largest value — both sides round p
    (against the same running max) and ds at the same points, but an f32
    summation-order difference can flip a rounding by one ulp;
  * lse (f32 in both dtypes): 1e-5 relative, as for o in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.ops import flash_attention as pt
from distributed_tensorflow_framework_tpu.ops import flash_attention as jx

TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
S = 384
CASES = ("padding", "segments", "masked_row")


@pytest.fixture()
def small_tiles(monkeypatch):
    """The streaming regime at s = 384 in both packages."""
    for mod in (pt, jx):
        monkeypatch.setattr(mod, "MAX_SEQ_VMEM", 128)
        monkeypatch.setattr(mod, "BLOCK_Q_KB", 128)
        monkeypatch.setattr(mod, "BLOCK_K_KB", 128)
    return monkeypatch


def _inputs(seed, case, b=2, s=S, h=2, d=32):
    """q, k, v, the output and lse cotangents, the (B, S) key bias and the
    (B, S) segment ids (or None) of one case."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    glse = rng.standard_normal((b, s, h, 1)).astype(np.float32)
    keep = np.ones((b, s), bool)
    keep[0, s - 84:] = False  # padding that ends inside a k-block
    seg = None
    if case == "segments":
        seg = np.zeros((b, s), np.int32)
        seg[:, 150:] = 1      # boundaries inside a block
        seg[1, 300:] = 2
    if case == "masked_row":
        keep[1, :] = False
    bias = np.where(keep, 0.0, pt.NEG_INF).astype(np.float32)
    return q, k, v, g, glse, bias, seg


def _assert_close(got, ref, tol, what):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"


def _jax_segs(seg):
    return () if seg is None else (jnp.asarray(seg),) * 2


def _torch_segs(seg):
    return () if seg is None else (torch.from_numpy(seg),) * 2


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_streaming_forward_matches_jax(small_tiles, dtype_name, case):
    """The port's CPU forward beyond MAX_SEQ_VMEM (the streaming plain
    version) against JAX ``_flash_fwd_kb`` on the same inputs."""
    jdt, tdt = DTYPES[dtype_name]
    q, k, v, _, _, bias, seg = _inputs(1, case)
    qt, kt, vt = (jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3)
                  for a in (q, k, v))
    segs = () if seg is None else tuple(
        jnp.asarray(seg).astype(jnp.float32)[:, None, :] for _ in range(2))
    ref_o, ref_lse = jx._flash_fwd_kb(
        qt, kt, vt, jnp.asarray(bias)[:, None, :], *(segs or (None, None)),
        segmented=seg is not None, interpret=True)
    o, lse = pt.flash_attention_with_lse(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(bias), *_torch_segs(seg))
    assert o.dtype == tdt
    _assert_close(o, ref_o.transpose(0, 2, 1, 3), TOL[dtype_name], "o")
    ref_lse = np.asarray(ref_lse.transpose(0, 2, 1, 3))
    err = np.abs(lse.numpy() - ref_lse) / np.maximum(1.0, np.abs(ref_lse))
    assert err.max() <= TOL["float32"], f"lse: relative error {err.max()}"


def _gradients_vs_jax(case, dtype_name, seed):
    """q, k, v and key-bias gradients through o and lse: the JAX
    ``flash_attention_chunk`` against the port's
    ``flash_attention_with_lse``, under whatever FUSED_BWD is set."""
    jdt, tdt = DTYPES[dtype_name]
    q, k, v, g, glse, bias, seg = _inputs(seed, case)

    def loss(q, k, v, bias):
        o, lse = jx.flash_attention_chunk(q, k, v, bias, *_jax_segs(seg))
        return (jnp.sum(o.astype(jnp.float32) * g)
                + jnp.sum(jnp.where(jnp.asarray(bias)[:, :, None, None] == 0,
                                    lse, 0.0) * glse))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    tbias = torch.from_numpy(bias).requires_grad_()
    o, lse = pt.flash_attention_with_lse(*leaves, tbias, *_torch_segs(seg))
    keep = (tbias == 0)[:, :, None, None]
    ((o.float() * torch.from_numpy(g)).sum()
     + (torch.where(keep, lse, 0.0) * torch.from_numpy(glse)).sum()
     ).backward()
    for name, leaf, r in zip(("dq", "dk", "dv"), leaves, ref):
        assert leaf.grad.dtype == tdt
        _assert_close(leaf.grad, r, TOL[dtype_name], name)
    _assert_close(tbias.grad, ref[3], TOL[dtype_name], "dbias")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_two_pass_streaming_gradients_match_jax(small_tiles, dtype_name,
                                                case):
    small_tiles.setattr(pt, "FUSED_BWD", False)
    small_tiles.setattr(jx, "FUSED_BWD", False)
    q = torch.zeros(1, S, 2, 32)
    assert pt.backward_route(q, q) == "stream"
    _gradients_vs_jax(case, dtype_name, seed=2)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_route_gradients_match_jax(small_tiles, dtype_name, case):
    small_tiles.setattr(pt, "FUSED_BWD", True)
    small_tiles.setattr(jx, "FUSED_BWD", True)
    q = torch.zeros(1, S, 2, 32)
    assert pt.backward_route(q, q) == "fused"
    _gradients_vs_jax(case, dtype_name, seed=3)


def _jax_route(monkeypatch, s, dtype):
    """Which backward the JAX package runs at length ``s``: a spy on its
    fused and streaming entry points around one ``jax.grad``. Its jitted
    ``_flash_bwd`` reads MAX_SEQ_VMEM while tracing, so the trace caches
    are cleared first."""
    jax.clear_caches()
    calls = []
    for name in ("_flash_bwd_fused_kb", "_flash_bwd_kb"):
        orig = getattr(jx, name)

        def spy(*a, _name=name, _orig=orig, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(jx, name, spy)
    q = jnp.asarray(np.random.default_rng(s).standard_normal(
        (1, s, 1, 32)), dtype)
    jax.grad(lambda q: jnp.sum(jx.flash_attention(q, q, q).astype(
        jnp.float32)))(q)
    if "_flash_bwd_fused_kb" in calls:
        return "fused"
    return "stream" if calls else "whole_k"


# (MAX_SEQ_VMEM, FUSED_BWD, FUSED_BWD_MAX, FUSED_WHOLE_K_MIN, s, dtype):
# the FUSED_BWD_MAX gate and the dtype-aware whole-K takeover, scaled down
# as tests/test_attention.py scales them (MIN 256 / VMEM 512 ≈ 2048 / 4096).
ROUTES = [
    (128, False, 8192, None, 256, "float32"),     # stream
    (128, True, 8192, None, 256, "float32"),      # fused
    (128, True, 128, None, 256, "float32"),       # over FUSED_BWD_MAX
    (512, True, 8192, None, 256, "float32"),      # f32 parked: whole-K
    (512, True, 8192, None, 256, "bfloat16"),     # bf16 at 2048: whole-K
    (512, True, 8192, 256, 256, "float32"),       # forced takeover
    (512, True, 8192, 384, 256, "bfloat16"),      # below the takeover
    (512, False, 8192, 256, 256, "bfloat16"),     # takeover needs FUSED_BWD
]


@pytest.mark.parametrize("vmem, fused, fused_max, wk_min, s, dtype", ROUTES)
def test_backward_route_matches_jax_dispatch(monkeypatch, vmem, fused,
                                             fused_max, wk_min, s, dtype):
    for mod in (pt, jx):
        monkeypatch.setattr(mod, "MAX_SEQ_VMEM", vmem)
        monkeypatch.setattr(mod, "BLOCK_Q_KB", 128)
        monkeypatch.setattr(mod, "BLOCK_K_KB", 128)
        monkeypatch.setattr(mod, "FUSED_BWD", fused)
        monkeypatch.setattr(mod, "FUSED_BWD_MAX", fused_max)
        monkeypatch.setattr(mod, "FUSED_WHOLE_K_MIN", wk_min)
    want = _jax_route(monkeypatch, s, getattr(jnp, dtype))
    q = torch.zeros(1, s, 1, 32, dtype=getattr(torch, dtype))
    assert pt.backward_route(q, q) == want


def test_bf16_takeover_default_matches_jax():
    """Unset, the whole-K takeover sits at 2048 for bf16 and above
    MAX_SEQ_VMEM for f32, in both packages."""
    assert pt.fused_whole_k_min(torch.bfloat16) == jx.fused_whole_k_min(
        jnp.bfloat16) == 2048
    assert pt.fused_whole_k_min(torch.float32) == jx.fused_whole_k_min(
        jnp.float32) == pt.MAX_SEQ_VMEM + 1


@pytest.mark.parametrize("s, target", [
    (8192, 1024), (8192, 512), (4224, 1024), (4352, 1024), (256, 64),
    (96, 1024), (16384, 1024), (384, 128)])
def test_pick_block_matches_jax(s, target):
    assert pt._pick_block(s, target) == jx._pick_block(s, target)


def test_pick_block_policy():
    """tests/test_attention.py's cases: the largest 128-multiple ≤ target
    dividing s, clamped to 128, and short sequences whole."""
    assert pt._pick_block(8192, 1024) == 1024
    assert pt._pick_block(4224, 1024) == 384
    assert pt._pick_block(4352, 1024) == 256
    assert pt._pick_block(256, 64) == 128
    assert pt._pick_block(96, 1024) == 96


def test_fused_auto_follows_the_verified_device_list(monkeypatch):
    """Auto (FUSED_BWD None) is off on the CPU, off on a card not in
    FUSED_BWD_VERIFIED_DEVICES, on for one that is; a bool always wins."""
    monkeypatch.setattr(pt, "FUSED_BWD", None)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    card = torch.device("cuda", 0)
    assert not pt.fused_bwd_enabled(torch.device("cpu"))
    monkeypatch.setattr(pt, "FUSED_BWD_VERIFIED_DEVICES", ())
    assert not pt.fused_bwd_enabled(card)
    monkeypatch.setattr(pt, "FUSED_BWD_VERIFIED_DEVICES", ("h100",))
    assert pt.fused_bwd_enabled(card)
    assert not pt.fused_bwd_enabled(torch.device("cpu"))
    monkeypatch.setattr(pt, "FUSED_BWD", False)
    assert not pt.fused_bwd_enabled(card)
    monkeypatch.setattr(pt, "FUSED_BWD", True)
    assert pt.fused_bwd_enabled(torch.device("cpu"))


def test_fused_kernel_entry_refuses_cpu_tensors():
    q = torch.zeros(1, 64, 2, 32)
    lse = torch.zeros(1, 64, 2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        pt.flash_attention_bwd_fused_kernel(q, q, q, torch.zeros(1, 64),
                                            None, None, lse, q, lse)
    assert pt.flash_attention_bwd_fused_kernel.launches == 0


def test_streaming_plain_forward_equals_whole_k_in_f32(small_tiles):
    """In f32 the rounding of p against the running max is exact, so the
    streaming plain version equals the whole-K one to f32 round-off."""
    q, k, v, _, _, bias, seg = _inputs(4, "segments")
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    segs = _torch_segs(seg)
    o_kb, lse_kb = pt.flash_attention_kb_reference(*args, *segs)
    o, lse = pt.flash_attention_reference(*args, *segs)
    torch.testing.assert_close(o_kb, o, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse_kb, lse, rtol=1e-6, atol=1e-6)
