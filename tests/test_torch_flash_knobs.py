"""The flash-attention dispatch knobs of the PyTorch port against the JAX
package's.

Both packages read ``FLASH_BLOCK_Q_KB``, ``FLASH_BLOCK_K_KB``,
``FLASH_MAX_SEQ_VMEM``, ``FLASH_FUSED_BWD_MAX`` and
``FLASH_FUSED_WHOLE_K_MIN`` once, at import. Each case sets one knob to a
value other than its default in a fresh interpreter, imports both packages
there and checks:
  * the port's module globals equal the JAX module's;
  * ``backward_route`` names the backward the JAX package takes, over a grid
    of lengths and dtypes with ``FUSED_BWD`` forced on and off, and the
    port's CPU forward takes the plain version of the regime the JAX
    forward takes (the JAX routes are seen by spies on its entry points
    while ``jax.make_jaxpr`` traces, so no kernel runs);
  * for the tile knobs, the port's CPU forward and gradients match the JAX
    kernels in interpret mode at (B, S, H, D) = (2, 512, 2, 32) with
    ``MAX_SEQ_VMEM`` set to 256 in both, so that 512 streams through 256-row
    tiles. Tolerances, as max|port − JAX| over max(1, max|JAX|): 1e-5 in f32
    (the same arithmetic summed in other orders), 1.6e-2 in bf16 (four bf16
    ulps at the largest value: an f32 summation-order difference can flip a
    rounding of p or ds by one ulp); lse 1e-5 relative.

The last tests hold auto's choice of the fused backward on a card: with
``torch.cuda.get_device_name`` patched to a card in
``FUSED_BWD_VERIFIED_DEVICES`` it is taken exactly at 8192 and in the bf16
band 2048–4096, and on a card not in the list nowhere.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.ops import flash_attention as pt
from distributed_tensorflow_framework_tpu.ops import flash_attention as jx

ROOT = pathlib.Path(__file__).resolve().parent.parent
KNOBS = {
    "FLASH_MAX_SEQ_VMEM": "1024",
    "FLASH_FUSED_BWD_MAX": "2048",
    "FLASH_FUSED_WHOLE_K_MIN": "512",
    "FLASH_BLOCK_Q_KB": "256",
    "FLASH_BLOCK_K_KB": "256",
}
GLOBALS = ("MAX_SEQ_VMEM", "BLOCK_Q_KB", "BLOCK_K_KB", "FUSED_BWD",
           "FUSED_BWD_MAX", "FUSED_WHOLE_K_MIN", "FUSED_WHOLE_K_MIN_BF16")
ROUTE_LENGTHS = (256, 512, 1024, 2048, 4096, 8192)
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_route(s, dtype):
    """Which backward the JAX package takes at length ``s``: spies on its
    fused and streaming entry points while one gradient is traced. Its
    jitted ``_flash_bwd`` reads MAX_SEQ_VMEM while tracing, so the trace
    caches are cleared first."""
    jax.clear_caches()
    calls, saved = [], {}
    for name in ("_flash_bwd_fused_kb", "_flash_bwd_kb"):
        orig = saved[name] = getattr(jx, name)

        def spy(*a, _name=name, _orig=orig, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        setattr(jx, name, spy)
    try:
        q = jnp.zeros((1, s, 1, 32), dtype)
        jax.make_jaxpr(jax.grad(lambda q: jnp.sum(
            jx.flash_attention(q, q, q).astype(jnp.float32))))(q)
    finally:
        for name, orig in saved.items():
            setattr(jx, name, orig)
    if "_flash_bwd_fused_kb" in calls:
        return "fused"
    return "stream" if calls else "whole_k"


def _routes_match():
    """Port and JAX routes over ROUTE_LENGTHS × dtypes × FUSED_BWD on/off;
    returns the disagreements."""
    bad = []
    for fused in (True, False):
        pt.FUSED_BWD = jx.FUSED_BWD = fused
        for s in ROUTE_LENGTHS:
            for name, (jdt, tdt) in DTYPES.items():
                q = torch.zeros(1, s, 1, 32, dtype=tdt)
                got, want = pt.backward_route(q, q), _jax_route(s, jdt)
                if got != want:
                    bad.append((fused, s, name, got, want))
    return bad


def _forward_routes_match():
    """The forward the port's CPU path takes (the streaming plain version
    or the whole-K one) against the JAX package's choice (``_flash_fwd_kb``
    or the whole-K kernel, seen by a spy while one forward is traced), over
    ROUTE_LENGTHS; returns the disagreements. The port's plain versions are
    replaced by recorders, so nothing of size S×S is formed."""
    taken, saved = [], {}
    for name in ("flash_attention_reference", "flash_attention_kb_reference"):
        saved[name] = getattr(pt, name)
        setattr(pt, name, lambda *a, _name=name: taken.append(_name))
    orig_kb = jx._flash_fwd_kb
    calls = []

    def spy(*a, **kw):
        calls.append("kb")
        return orig_kb(*a, **kw)

    jx._flash_fwd_kb = spy
    bad = []
    try:
        for s in ROUTE_LENGTHS:
            taken.clear()
            calls.clear()
            q = torch.zeros(1, s, 1, 32)
            pt._forward(q, q, q, torch.zeros(1, s), None, None)
            jax.clear_caches()
            jq = jnp.zeros((1, s, 1, 32), jnp.float32)
            jax.make_jaxpr(lambda x: jx.flash_attention(x, x, x))(jq)
            got = ("stream" if taken == ["flash_attention_kb_reference"]
                   else "whole_k")
            want = "stream" if calls else "whole_k"
            if got != want:
                bad.append((s, got, want))
    finally:
        jx._flash_fwd_kb = orig_kb
        for name, fn in saved.items():
            setattr(pt, name, fn)
    return bad


def _close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max())), tol


def _tiled_errors():
    """The tile knobs at work: (what, error, tolerance) of the port's CPU
    forward (o, lse) and gradients (dq, dk, dv, dbias through o and lse,
    FUSED_BWD off and on) against the JAX interpret-mode kernels, with
    trailing padding, at s = 512 streamed in BLOCK_*_KB tiles."""
    pt.MAX_SEQ_VMEM = jx.MAX_SEQ_VMEM = 256
    b, s, h, d = 2, 512, 2, 32
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    glse = rng.standard_normal((b, s, h, 1)).astype(np.float32)
    keep = np.ones((b, s), bool)
    keep[0, s - 84:] = False  # padding that ends inside a tile
    bias = np.where(keep, 0.0, pt.NEG_INF).astype(np.float32)
    out = []
    for name, (jdt, tdt) in DTYPES.items():
        tol = TOL[name]
        qt, kt, vt = (jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3)
                      for a in (q, k, v))
        ref_o, ref_lse = jx._flash_fwd_kb(
            qt, kt, vt, jnp.asarray(bias)[:, None, :], None, None,
            segmented=False, interpret=True)
        o, lse = pt.flash_attention_with_lse(
            *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
            torch.from_numpy(bias))
        out.append((f"{name} o", *_close(o, ref_o.transpose(0, 2, 1, 3),
                                          tol)))
        ref_lse = np.asarray(ref_lse.transpose(0, 2, 1, 3))
        out.append((f"{name} lse", float((np.abs(lse.numpy() - ref_lse)
                                          / np.maximum(1.0, np.abs(ref_lse))
                                          ).max()), TOL["float32"]))
        for fused in (False, True):
            pt.FUSED_BWD = jx.FUSED_BWD = fused

            def loss(q_, k_, v_, bias_):
                o_, lse_ = jx.flash_attention_chunk(q_, k_, v_, bias_)
                return (jnp.sum(o_.astype(jnp.float32) * g)
                        + jnp.sum(jnp.where(keep[:, :, None, None], lse_, 0.0)
                                  * glse))

            ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
                *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                jnp.asarray(bias))
            leaves = [torch.from_numpy(a).to(tdt).requires_grad_()
                      for a in (q, k, v)]
            tbias = torch.from_numpy(bias).requires_grad_()
            o, lse = pt.flash_attention_with_lse(*leaves, tbias)
            tkeep = torch.from_numpy(keep)[:, :, None, None]
            ((o.float() * torch.from_numpy(g)).sum()
             + (torch.where(tkeep, lse, 0.0) * torch.from_numpy(glse)).sum()
             ).backward()
            grads = [leaf.grad for leaf in leaves] + [tbias.grad]
            for what, got, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
                out.append((f"{name} fused={fused} {what}",
                            *_close(got, r, tol)))
    return out


def check_knob(knob):
    """Run in a fresh interpreter with ``knob`` set: prints one JSON line
    with the two packages' globals, the route disagreements and, for the
    tile knobs, the errors of the tiled CPU results."""
    res = {"port": {n: getattr(pt, n) for n in GLOBALS},
           "jax": {n: getattr(jx, n) for n in GLOBALS},
           "min": [[pt.fused_whole_k_min(t), jx.fused_whole_k_min(j)]
                   for j, t in DTYPES.values()],
           "route_mismatches": _routes_match(),
           "forward_mismatches": _forward_routes_match()}
    if knob.startswith("FLASH_BLOCK"):
        res["errors"] = _tiled_errors()
    print(json.dumps(res))


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_steers_the_port_as_the_jax_package(knob):
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLASH_")}
    env.update({knob: KNOBS[knob], "JAX_PLATFORMS": "cpu"})
    code = ("import sys, jax\n"
            "jax.config.update('jax_platforms', 'cpu')\n"
            f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
            "import test_torch_flash_knobs as t\n"
            f"t.check_knob({knob!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    name = knob[len("FLASH_"):]
    assert res["port"] == res["jax"]
    assert str(res["port"][name]) == KNOBS[knob]
    assert all(p == j for p, j in res["min"]), res["min"]
    assert res["route_mismatches"] == []
    assert res["forward_mismatches"] == []
    for what, err, tol in res.get("errors", []):
        assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"


def test_knobs_default_as_in_the_jax_package():
    """With no FLASH_* variable set (as in this process) the defaults are
    the JAX package's: 512, 1024, 4096, 8192 and no whole-K threshold."""
    if any(k in os.environ for k in KNOBS):
        pytest.skip("a FLASH_* knob is set in this environment")
    assert (pt.BLOCK_Q_KB, pt.BLOCK_K_KB, pt.MAX_SEQ_VMEM, pt.FUSED_BWD_MAX,
            pt.FUSED_WHOLE_K_MIN) == (512, 1024, 4096, 8192, None)
    assert all(getattr(pt, n) == getattr(jx, n) for n in GLOBALS)


LISTED = "NVIDIA H100 80GB HBM3"
UNLISTED = "NVIDIA A100-SXM4-80GB"
# (S, dtype) → the backward auto takes on a listed card, with the JAX
# package's defaults: fused at 8192 (≤ FUSED_BWD_MAX) and in the bf16
# whole-K band 2048–4096, the whole-K pair below it (and for f32 up to
# MAX_SEQ_VMEM), the streaming pair above FUSED_BWD_MAX.
LISTED_ROUTES = {
    (512, "bfloat16"): "whole_k", (1024, "bfloat16"): "whole_k",
    (2048, "bfloat16"): "fused", (4096, "bfloat16"): "fused",
    (8192, "bfloat16"): "fused", (16384, "bfloat16"): "stream",
    (512, "float32"): "whole_k", (2048, "float32"): "whole_k",
    (4096, "float32"): "whole_k", (8192, "float32"): "fused",
    (16384, "float32"): "stream",
}


@pytest.fixture()
def auto_defaults(monkeypatch):
    """FUSED_BWD on auto with the JAX package's default thresholds, and a
    verified-device list that names the H100, so the test holds whichever
    cards the module lists."""
    for name, value in (("FUSED_BWD", None), ("MAX_SEQ_VMEM", 4096),
                        ("FUSED_BWD_MAX", 8192), ("FUSED_WHOLE_K_MIN", None),
                        ("FUSED_WHOLE_K_MIN_BF16", 2048),
                        ("FUSED_BWD_VERIFIED_DEVICES", ("h100",))):
        monkeypatch.setattr(pt, name, value)
    return monkeypatch


def _on_card(s, dtype):
    """Stand-in for a (1, s, 12, 64) tensor on cuda:0: what backward_route
    reads of it (shape, device, dtype), with no card needed."""
    return types.SimpleNamespace(shape=(1, s, 12, 64), dtype=dtype,
                                 device=torch.device("cuda", 0))


@pytest.mark.parametrize("card, listed", [(LISTED, True), (UNLISTED, False)])
def test_auto_takes_the_fused_backward_only_on_a_listed_card(
        auto_defaults, card, listed):
    auto_defaults.setattr(torch.cuda, "get_device_name",
                          lambda device=None: card)
    assert pt.fused_bwd_enabled("cuda") is listed
    assert not pt.fused_bwd_enabled("cpu")
    for (s, name), fused_route in LISTED_ROUTES.items():
        q = _on_card(s, getattr(torch, name))
        want = fused_route if listed else (
            "whole_k" if s <= pt.MAX_SEQ_VMEM else "stream")
        assert pt.backward_route(q, q) == want, (card, s, name)
    cpu = torch.zeros(1, 8192, 1, 32, dtype=torch.bfloat16)
    assert pt.backward_route(cpu, cpu) == "stream"


def test_the_shipped_card_list_matches_the_name_the_card_reports(
        monkeypatch):
    """The module's own FUSED_BWD_VERIFIED_DEVICES, unpatched, against the
    name torch reports for the card the fused kernel was measured on, so a
    typo in a shipped entry cannot send auto back to the pair there."""
    monkeypatch.setattr(pt, "FUSED_BWD", None)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: LISTED)
    assert pt.FUSED_BWD_VERIFIED_DEVICES
    assert pt.fused_bwd_enabled("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: UNLISTED)
    assert not pt.fused_bwd_enabled("cuda")


@pytest.mark.parametrize("forced", [True, False])
def test_forced_fused_backward_wins_over_the_card_list(auto_defaults, forced):
    """FLASH_FUSED_BWD=1/0 (FUSED_BWD True/False) decides on any card."""
    auto_defaults.setattr(torch.cuda, "get_device_name",
                          lambda device=None: UNLISTED if forced else LISTED)
    auto_defaults.setattr(pt, "FUSED_BWD", forced)
    q = _on_card(8192, torch.bfloat16)
    assert pt.backward_route(q, q) == ("fused" if forced else "stream")
