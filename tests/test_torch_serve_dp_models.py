"""Data-parallel serving of the classification task and of decode, held
to the JAX package on the serving mesh.

Classification: a CIFAR-stem ResNet on non-trivial BatchNorm statistics,
and a LeNet-5 trained a few steps by the port's ``Trainer`` with the EMA
on and exported with ``serve.use_ema``, served by the port's engine at
``devices=[cpu, cpu]`` against the JAX engine at ``serving_mesh(2)`` on
the same artifact tree: the row ladder, ``padded_rows`` and the logits of
1-, 3- and 5-row requests. Within the port each request's logits equal
bit for bit its two shards (filler rows as the engine pads) served alone
at ``dp`` 1, and the whole request at ``dp`` 1 within the tolerance: on
the CPU a small GEMM's last bits depend on its row count, and LeNet's
dense layers run on a few rows. Every replica holds the statistics and
the EMA.

Decode: the port's ``DecodeEngine`` at ``devices=[cpu, cpu]`` and
``max_streams`` 3 has JAX's ladder ``[2, 4]`` (so four slots) and gives
the JAX engine's greedy tokens at ``serving_mesh(2)`` and its own at
``dp`` 1, for four prompts submitted together.

Tolerances: f32 logits rtol 1e-5, atol 1e-5 against JAX (those of
tests/test_torch_serve_classify.py); bitwise within the port; tokens
equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_load_config,
)
from distributed_tensorflow_framework_torch.models.resnet import ResNet
from distributed_tensorflow_framework_torch.serve import decode as pd
from distributed_tensorflow_framework_torch.serve import engine as pe
from distributed_tensorflow_framework_torch.serve import export as px
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_tpu.core.config import (
    load_config as jax_load_config,
)
from distributed_tensorflow_framework_tpu.models.resnet import (
    ResNet as JaxResNet,
)
from distributed_tensorflow_framework_tpu.serve import decode as jd
from distributed_tensorflow_framework_tpu.serve import engine as je
from distributed_tensorflow_framework_tpu.serve import export as jx
from tests.test_torch_decode import MAX_LEN, MODEL, PAGE
from tests.test_torch_decode import _jax_params as _decode_params
from tests.test_torch_decode import _save_port as _save_decode
from tests.test_torch_hygiene import torch_threads  # noqa: F401
from tests.test_torch_serve_classify import LENET, _images, _tree

TOL = dict(rtol=1e-5, atol=1e-5)
SERVE = ["serve.data=1", "serve.max_batch_size=8", "serve.max_wait_ms=5",
         "serve.report_interval_s=60"]
ROWS = (1, 3, 5)


def _serve(engine, images: list[np.ndarray], timeout=300):
    """Each request alone; the logits and ``padded_rows``, the engine
    drained."""
    try:
        outs = [np.asarray(engine.predict({"image": x}, timeout=timeout))
                for x in images]
        return outs, engine.stats()["padded_rows"]
    finally:
        engine.drain(30)


def _shards_alone(engine, images: list[np.ndarray], dp: int) -> list:
    """Each request padded as an engine at ``dp`` pads it (filler rows
    copies of row 0), its ``dp`` shards served alone by ``engine`` (at dp
    1, so at the shard's own row count), joined; the engine drained."""
    ladder = pe.batch_buckets(engine.cfg.max_batch_size, dp)
    try:
        outs = []
        for x in images:
            fill = pe.pick_bucket(len(x), ladder) - len(x)
            padded = np.concatenate([x, np.repeat(x[:1], fill, axis=0)])
            outs.append(np.concatenate([
                engine.predict({"image": part}, timeout=60)
                for part in np.split(padded, dp)])[:len(x)])
        return outs
    finally:
        engine.drain(30)


def _against_jax(port_art, ref_art, pcfg, jcfg, shape) -> list:
    """The port at dp 2 against the JAX engine at serving_mesh(2) and the
    port at dp 1; returns the dp-2 engine's replicas' state_dicts."""
    images = [_images(20 + r, r, shape) for r in ROWS]
    one, one_padded = _serve(pe.InferenceEngine(
        port_art, pcfg.serve, devices=["cpu"]), images)
    alone = _shards_alone(pe.InferenceEngine(
        port_art, pcfg.serve, devices=["cpu"]), images, 2)
    port = pe.InferenceEngine(port_art, pcfg.serve, devices=["cpu"] * 2)
    ref = je.InferenceEngine(ref_art, jcfg.serve, mesh=je.serving_mesh(2))
    assert port.row_buckets == ref.row_buckets == [2, 4, 8]
    states = [m.state_dict() for m in port.replicas]
    got, padded = _serve(port, images)
    want, ref_padded = _serve(ref, images)
    assert (one_padded, padded, ref_padded) == (13, 14, 14)
    for g, w, o, a in zip(got, want, one, alone):
        assert g.shape == w.shape == (o.shape[0], 10)
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(g, o, **TOL)
        np.testing.assert_array_equal(g, a)
    return states


def test_resnet_batchnorm_statistics_at_dp2(tmp_path, monkeypatch):
    """A CIFAR-stem ResNet at one bottleneck block a stage (width 8, the
    JAX ResNet built the same) on non-trivial running statistics."""
    def port_small(config, *, device="cuda", **kw):
        return ResNet((1, 1, 1, 1), 10, width=8, cifar_stem=True,
                      dtype=torch.float32, device=device).eval()

    jmodel = JaxResNet(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10,
                       dtype=jnp.float32, cifar_stem=True)
    monkeypatch.setattr(pe, "get_model", port_small)
    monkeypatch.setattr(je, "get_model", lambda config, **kw: jmodel)
    variables = jmodel.init(jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32),
                            train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(4)
    stats = jax.tree.map(
        lambda x: (np.asarray(x) + rng.uniform(0.1, 0.5, x.shape)
                   ).astype(np.float32), variables["batch_stats"])
    over = ["model.name=resnet18_cifar", "model.dtype=float32",
            "data.image_size=32", "data.channels=3", *SERVE]
    pcfg, jcfg = port_load_config(overrides=over), jax_load_config(
        overrides=over)
    port_art = px.load_artifact(px.save_artifact(
        str(tmp_path / "p"), model_config=pcfg.model,
        task="classification", params=params, batch_stats=stats, step=3,
        input_spec=px.input_spec_for(pcfg, "classification")))
    ref_art = jx.load_artifact(jx.save_artifact(
        str(tmp_path / "j"), model_config=jcfg.model, task="classification",
        params=params, batch_stats=stats, step=3,
        input_spec=jx.input_spec_for(jcfg, "classification")))
    states = _against_jax(port_art, ref_art, pcfg, jcfg, (32, 32, 3))
    running = [k for k in port_art.state_dict if k.endswith("running_var")]
    assert running
    for state in states:
        for k in running:
            assert torch.equal(state[k], port_art.state_dict[k])


def test_lenet_ema_export_at_dp2(tmp_path):
    """Ten LeNet steps with the EMA on, exported under serve.use_ema:
    every replica serves the EMA, as the JAX engine does on its tree."""
    over = LENET + SERVE + [
        "optimizer.name=sgd_momentum", "optimizer.learning_rate=0.05",
        "optimizer.ema_decay=0.5", "train.total_steps=10",
        "train.log_interval=5", f"checkpoint.directory={tmp_path / 'ckpt'}",
        "checkpoint.async_save=false", "checkpoint.save_interval_steps=10",
        "resilience.rollback=false"]
    pcfg = port_load_config(overrides=over)
    assert pcfg.serve.use_ema
    Trainer(pcfg, device="cpu").train()
    port_art = px.load_artifact(px.export_checkpoint(
        pcfg, str(tmp_path / "art"), device="cpu"))
    assert port_art.meta["source"]["used_ema"] is True
    params, stats = _tree(port_art)
    jcfg = jax_load_config(overrides=LENET + SERVE)
    ref_art = jx.load_artifact(jx.save_artifact(
        str(tmp_path / "jax"), model_config=jcfg.model,
        task="classification", params=params, batch_stats=stats,
        step=port_art.step, input_spec=jx.input_spec_for(
            jcfg, "classification")))
    states = _against_jax(port_art, ref_art, pcfg, jcfg, (28, 28, 1))
    ema = torch.load(os.path.join(tmp_path, "ckpt", "10", "state.pt"),
                     weights_only=True)["ema"]
    for state in states:
        for k, v in ema.items():
            assert torch.equal(state[k], v)


# -------------------------------------------------------------- decode


def _decode_cfgs(max_streams: int):
    decode = {"enabled": True, "max_len": MAX_LEN, "page_size": PAGE,
              "num_pages": 64, "max_streams": max_streams,
              "max_new_tokens": 8}
    cfgs = (port_load_config(base={"model": dict(MODEL), "decode": decode}),
            jax_load_config(base={"model": dict(MODEL), "decode": decode}))
    for cfg in cfgs:
        cfg.serve.report_interval_s = 60.0
    return cfgs


@pytest.fixture(scope="module")
def decode_artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode_dp")
    params = _decode_params()
    _, jcfg = _decode_cfgs(3)
    port = px.load_artifact(_save_decode(root / "port", params))
    ref = jx.load_artifact(jx.save_artifact(
        str(root / "jax"), model_config=jcfg.model, task="mlm",
        params=params, batch_stats={}, step=0,
        input_spec=jx.input_spec_for(jcfg, "mlm")))
    return port, ref


def _generate(engine, prompts) -> list[list[int]]:
    """The prompts submitted together (batched steps, page growth); the
    engine drained."""
    try:
        streams = [engine.submit(p, max_new_tokens=8) for p in prompts]
        return [s.result(300)["tokens"] for s in streams]
    finally:
        engine.drain(30)


def test_decode_at_dp2_has_the_jax_ladder_and_tokens(decode_artifacts):
    port_art, ref_art = decode_artifacts
    cfg, jcfg = _decode_cfgs(3)
    prompts = [[5, 6, 7], [3, 1, 4, 1, 5], list(range(1, 12)), [2, 7]]
    one = pd.DecodeEngine(port_art, cfg.decode, cfg.serve, devices=["cpu"])
    two = pd.DecodeEngine(port_art, cfg.decode, cfg.serve,
                          devices=["cpu", "cpu"])
    ref = jd.DecodeEngine(ref_art, jcfg.decode, jcfg.serve,
                          mesh=je.serving_mesh(2))
    assert one.row_buckets == [1, 2, 3]
    assert two.row_buckets == ref.row_buckets == [2, 4]
    assert two.dp == 2 and two.device == torch.device("cpu")
    got = _generate(two, prompts)
    assert got == _generate(ref, prompts)
    assert got == _generate(one, prompts)
