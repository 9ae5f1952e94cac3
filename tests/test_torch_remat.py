"""Per-layer rematerialisation in the PyTorch port (``model.remat``).

The port checkpoints each encoder layer with ``torch.utils.checkpoint``,
the counterpart of the JAX package's ``nn.remat(EncoderLayer)``. Checked:

  * with dropout 0.1 the remat model gives the same loss and every
    gradient bit for bit as the model without remat, and leaves the
    dropout generator in the same state: the recompute replays the
    forward's masks from the trainer's generator (exact: the same ops on
    the same inputs, on the CPU);
  * with dropout 0 the remat model matches the JAX package's ``remat=True``
    BERT on the same weights (converted by models/convert.py) and the same
    numpy batch: logits rtol 1e-4 / atol 1e-5 and every gradient within
    1e-5 of the largest gradient, the f32 tolerances of
    tests/test_torch_bert.py and tests/test_torch_train.py (the same f32
    arithmetic summed in other orders);
  * ``model.remat_policy`` other than "full" is refused for BERT, as the
    JAX package refuses it. ``precision.remat_policy`` and the image
    models' remat are tests/test_torch_remat_images.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    ModelConfig as PortModelConfig,
)
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import (
    get_dataset as port_dataset,
)
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.models.convert import (
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.train.step import StepBuilder
from distributed_tensorflow_framework_tpu.core.config import (
    ModelConfig as JaxModelConfig,
)
from distributed_tensorflow_framework_tpu.models import get_model as jax_model

TINY_BERT = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=3", "model.num_heads=4", "model.mlp_dim=128",
    "model.max_seq_len=128", "model.dtype=float32",
    "model.dropout_rate=0.1", "data.name=synthetic_mlm",
    "data.vocab_size=512", "data.seq_len=128", "data.global_batch_size=4",
    "optimizer.name=adamw", "train.total_steps=3", "mesh.data=1"]
TINY_MODEL = dict(name="bert", vocab_size=256, hidden_size=32, num_layers=3,
                  num_heads=4, mlp_dim=64, max_seq_len=64, dtype="float32",
                  dropout_rate=0.0, attention_impl="pallas")


def _one_micro_step(remat: bool, impl: str):
    cfg = port_config(overrides=TINY_BERT + [
        f"model.remat={str(remat).lower()}", f"model.attention_impl={impl}"])
    builder = StepBuilder(cfg, device="cpu")
    state = builder.init_state(0)
    batch = to_device(next(port_dataset(cfg.data)), torch.device("cpu"))
    state.optimizer.zero_grad()
    metrics = builder._micro_step(state, batch, 1.0)
    grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    return metrics["loss"], grads, state.dropout_generator.get_state()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_remat_with_dropout_is_bitwise_and_keeps_the_generator(impl):
    loss, grads, gen = _one_micro_step(False, impl)
    r_loss, r_grads, r_gen = _one_micro_step(True, impl)
    assert torch.equal(loss, r_loss)
    assert grads.keys() == r_grads.keys()
    for key in grads:
        assert torch.equal(grads[key], r_grads[key]), key
    assert torch.equal(gen, r_gen)


def test_remat_applies_only_under_autograd():
    """Evaluation and serving run the layers directly; the train forward
    runs each layer once more in the backward (the recompute)."""
    cfg = PortModelConfig(**TINY_MODEL, remat=True)
    model = get_model(cfg, device="cpu")
    ids = torch.randint(0, 256, (2, 64), generator=torch.Generator()
                        .manual_seed(0))
    calls = []
    model.layer0.register_forward_pre_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        model(ids)
    assert len(calls) == 1
    model(ids).float().square().mean().backward()
    assert len(calls) == 3


def test_remat_matches_jax_remat_bert():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 256, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.int32)
    mask[1, 50:] = 0
    g = rng.standard_normal((2, 64, 256)).astype(np.float32)

    jm = jax_model(JaxModelConfig(**TINY_MODEL, remat=True))
    params = jm.init({"params": jax.random.key(1)}, jnp.asarray(ids),
                     jnp.asarray(mask), train=False)["params"]

    def loss_fn(params):
        logits = jm.apply({"params": params}, jnp.asarray(ids),
                          jnp.asarray(mask), train=True)
        return jnp.sum(logits.astype(jnp.float32) * g), logits

    (_, ref_logits), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    pm = get_model(PortModelConfig(**TINY_MODEL, remat=True), device="cpu")
    pm.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    pm.train()
    logits = pm(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    (logits * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), rtol=1e-4, atol=1e-5)
    ours = flatten_tree(to_flax(pm, {k: p.grad for k, p in
                                     pm.named_parameters()}))
    ref = flatten_tree(jax.device_get(ref_grads))
    assert ours.keys() == ref.keys()
    top = max(np.abs(r).max() for r in ref.values())
    for path, r in ref.items():
        err = np.abs(ours[path] - r).max()
        assert err <= 1e-5 * top, f"grad {path}: {err:.2e} of {top:.2e}"


def test_bert_refuses_the_conv_saved_policy_like_jax():
    kw = dict(name="bert", remat=True, remat_policy="conv_saved")
    with pytest.raises(ValueError, match="remat_policy"):
        jax_model(JaxModelConfig(**kw))
    with pytest.raises(ValueError, match="remat_policy"):
        get_model(PortModelConfig(**kw), device="cpu")

