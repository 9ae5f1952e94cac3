"""PyTorch port of BERT-MLM vs the JAX package, weight for weight.

JAX ``BertForMLM`` is initialised, its parameter tree goes to numpy, then
through models/convert.py into the port; both run the same numpy batch
(made from a seed) and their logits are compared. The JAX side runs the
Pallas kernel in interpret mode, as its own tests do; the port runs on the
CPU, where its flash attention is the kernel's plain PyTorch version.

Tolerances. f32: rtol 1e-4, atol 1e-5 — the same f32 arithmetic summed in
other orders (observed max gap ~1e-6 on logits of std ~0.23). bf16: atol
3e-2 — both models round at the same points (bf16 matmuls and bias adds,
f32 LayerNorms, p cast to bf16), but a GEMM that sums in another order can
flip a bf16 rounding (one ulp is 2**-8 near 1) and two layers carry such
flips into the logits; observed max gap ~9e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    ModelConfig as PortModelConfig,
)
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.models.bert import BertForMLM
from distributed_tensorflow_framework_torch.models.convert import (
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_tpu.core.config import (
    ModelConfig as JaxModelConfig,
)
from distributed_tensorflow_framework_tpu.models import get_model as jax_model

TINY = dict(name="bert", vocab_size=1000, hidden_size=128, num_layers=2,
            num_heads=4, mlp_dim=512, max_seq_len=256)
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=0.0, atol=3e-2)}


def _batch(seed, b=2, s=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, s - 28:] = 0
    seg = np.zeros((b, s), np.int32)
    seg[:, 50:] = 1
    seg[1, 90:] = 2
    return ids, mask, seg


@pytest.fixture(scope="module")
def jax_params():
    """One JAX init per parameter layout (params are f32 whatever the
    compute dtype)."""
    out = {}
    for fused in (False, True):
        model = jax_model(JaxModelConfig(**TINY, fused_qkv=fused))
        ids = jnp.zeros((1, 128), jnp.int32)
        params = model.init({"params": jax.random.key(int(fused))}, ids,
                            train=False)["params"]
        out[fused] = jax.tree.map(np.asarray, jax.device_get(params))
    return out


def _logits_pair(params, *, dtype, fused, impl, inputs):
    kw = dict(TINY, dtype=dtype, fused_qkv=fused, attention_impl=impl)
    jm = jax_model(JaxModelConfig(**kw))
    ref = jm.apply({"params": params},
                   *(jnp.asarray(x) for x in inputs), train=False)
    pm = get_model(PortModelConfig(**kw), device="cpu")
    pm.load_state_dict(flax_to_state_dict(params))
    with torch.inference_mode():
        out = pm(*(torch.from_numpy(x).long() for x in inputs))
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("with_segments", [False, True])
def test_logits_match_jax(jax_params, dtype, fused, with_segments):
    ids, mask, seg = _batch(int(fused) + 2 * int(with_segments))
    inputs = (ids, mask, seg) if with_segments else (ids, mask)
    out, ref = _logits_pair(jax_params[fused], dtype=dtype, fused=fused,
                            impl="pallas", inputs=inputs)
    assert out.shape == (2, 128, TINY["vocab_size"])
    assert out.dtype == np.float32 and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_attention_impl_matches_jax(jax_params, dtype):
    ids, mask, seg = _batch(11)
    out, ref = _logits_pair(jax_params[True], dtype=dtype, fused=True,
                            impl="xla", inputs=(ids, mask, seg))
    np.testing.assert_allclose(out, ref, **TOL[dtype])


@pytest.mark.parametrize("fused", [False, True])
def test_convert_round_trips_the_flax_tree(jax_params, fused):
    params = jax_params[fused]
    model = BertForMLM(**{k: v for k, v in TINY.items() if k != "name"},
                       fused_qkv=fused, device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    back = flatten_tree(to_flax(model))
    want = flatten_tree(params)
    assert back.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))


def test_fused_qkv_split_matches_flax_layout(jax_params):
    """Row c*H + o of the port's fused weight is column (c, o) of the
    (H, 3, H) Flax kernel, so q/k/v are the kernel's [:, i, :] slices."""
    kernel = jax_params[True]["layer0"]["attn"]["qkv"]["kernel"]
    sd = flax_to_state_dict(jax_params[True])
    w = sd["layer0.attn.qkv.weight"].numpy()
    h = TINY["hidden_size"]
    for i in range(3):
        np.testing.assert_array_equal(w[i * h:(i + 1) * h], kernel[:, i, :].T)


@pytest.mark.parametrize("fused", [False, True])
def test_param_count_matches_jax_at_bert_base(fused):
    """The port's BERT-base, built on the meta device (no memory, no
    init), holds exactly the JAX model's parameter count, taken with
    jax.eval_shape as tests/test_models_big.py takes it."""
    cfg = JaxModelConfig(name="bert", dtype="float32", fused_qkv=fused)
    model = jax_model(cfg)
    rng = jax.random.key(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": rng, "dropout": rng}, jnp.ones((1, 16), jnp.int32),
        train=False))["params"]
    jax_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    port = BertForMLM(fused_qkv=fused, device="meta")
    port_count = sum(p.numel() for p in port.parameters())
    assert port_count == jax_count
    assert 108_000_000 < port_count < 112_000_000


def test_init_distributions_match_flax(jax_params):
    """Same distributions, not the same bits: dense kernels truncated
    normal of std sqrt(1/fan_in) inside ±2σ/0.8796, tables normal(0.02),
    biases zero, LayerNorm scales one."""
    cfg = PortModelConfig(**TINY, fused_qkv=True, dtype="float32")
    port = to_flax(get_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3)))
    ref = jax_params[True]
    for path in (("layer0", "mlp_in", "kernel"),
                 ("layer1", "attn", "qkv", "kernel"),
                 ("embed_block", "embed", "embedding"),
                 ("embed_block", "pos_embedding")):
        a, b = port, ref
        for key in path:
            a, b = a[key], b[key]
        assert a.shape == b.shape
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.05)
        assert np.abs(a).max() <= np.abs(b).max() * 1.1 + 1e-6
    for path, leaf in flatten_tree(port).items():
        if path[-1] == "bias" or path[-1] == "mlm_bias":
            assert not leaf.any(), path
        if path[-1] == "scale":
            assert (leaf == 1).all(), path


@pytest.mark.parametrize("override,match", [
    ({"name": "inception_v3", "remat": True}, "A18"),
    ({"name": "resnet50", "remat": True}, "A18"),
    ({"num_experts": 4}, "A8"),
    ({"pipeline_stages": 2}, "A12"),
    ({"name": "resnet18_cifar", "remat": True}, "A18"),
])
def test_unported_configs_name_their_roadmap_item(override, match):
    cfg = PortModelConfig(**dict(TINY, **override))
    with pytest.raises(NotImplementedError, match=match):
        get_model(cfg, device="cpu")
