"""PyTorch port's classification serving and live reload on the CPU.

Mirrors ``tests/test_serve.py``: a LeNet-5 trained a few steps by the
port's ``Trainer`` is exported from its checkpoint (``export_checkpoint``,
with and without ``serve.use_ema``), its artifact's fields and digest held
against the JAX export of the same tree, and its logits through the
port's ``InferenceEngine`` against the JAX ``InferenceEngine``'s on the
same weights and images. Then the engine against itself: filler rows
inert, and the reload contract — bitwise the cold engine on the new
artifact, a tampered artifact or another input spec rejected while the old
weights keep serving, no reload after drain — directly and through
``POST /reload``. A ResNet (CIFAR stem, one bottleneck block a stage) with
non-trivial BatchNorm statistics goes through both packages' engines too.

Tolerances: f32 logits rtol 1e-5 (atol 1e-6; the same arithmetic in
other summation orders); the reload comparisons are bitwise.
"""

import dataclasses
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core import faults
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_load_config,
)
from distributed_tensorflow_framework_torch.models import get_model
from distributed_tensorflow_framework_torch.models.convert import (
    batch_stats_to_flax,
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.models.resnet import ResNet
from distributed_tensorflow_framework_torch.serve import engine as pe
from distributed_tensorflow_framework_torch.serve import export as px
from distributed_tensorflow_framework_torch.serve.server import ServingServer
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_tpu.core.config import (
    load_config as jax_load_config,
)
from distributed_tensorflow_framework_tpu.models.resnet import (
    ResNet as JaxResNet,
)
from distributed_tensorflow_framework_tpu.serve import engine as je
from distributed_tensorflow_framework_tpu.serve import export as jx
from tests.test_torch_hygiene import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)
LENET = ["model.name=lenet5", "model.num_classes=10", "model.dtype=float32",
         "data.name=synthetic_images", "data.image_size=28",
         "data.channels=1", "data.global_batch_size=16", "mesh.data=1"]
SERVE = ["serve.data=1", "serve.max_batch_size=8", "serve.max_wait_ms=5",
         "serve.report_interval_s=60"]


def _images(seed: int, rows: int, shape=(28, 28, 1)) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(rows, *shape)).astype(np.float32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Ten LeNet steps through the port's Trainer with the EMA on and a
    committed sync checkpoint; the config exports from it."""
    root = tmp_path_factory.mktemp("classify")
    over = LENET + SERVE + [
        "optimizer.name=sgd_momentum", "optimizer.learning_rate=0.05",
        "optimizer.ema_decay=0.5", "train.total_steps=10",
        "train.log_interval=5", f"checkpoint.directory={root / 'ckpt'}",
        "checkpoint.async_save=false", "checkpoint.save_interval_steps=10",
        "resilience.rollback=false"]
    cfg = port_load_config(overrides=over)
    Trainer(cfg, device="cpu").train()
    return {"cfg": cfg, "root": root}


@pytest.fixture(scope="module")
def artifact_dir(trained):
    return px.export_checkpoint(trained["cfg"],
                                str(trained["root"] / "art"), device="cpu")


@pytest.fixture(scope="module")
def artifact(artifact_dir):
    return px.load_artifact(artifact_dir)


def _engine(artifact, **serve):
    cfg = port_load_config(overrides=SERVE)
    for key, value in serve.items():
        setattr(cfg.serve, key, value)
    return pe.InferenceEngine(artifact, cfg.serve, device="cpu")


def _direct(artifact, images):
    model = get_model(artifact.model_config, device="cpu")
    model.load_state_dict(artifact.state_dict)
    with torch.inference_mode():
        return model(torch.from_numpy(images)).numpy()


def _tree(artifact):
    model = get_model(artifact.model_config, device="cpu")
    model.load_state_dict(artifact.state_dict)
    return to_flax(model), batch_stats_to_flax(model)


def _resave(artifact, path, *, params=None, step=None, input_spec=None):
    p, stats = _tree(artifact)
    return px.save_artifact(
        str(path), model_config=artifact.model_config, task=artifact.task,
        params=p if params is None else params, batch_stats=stats,
        step=artifact.step if step is None else step,
        input_spec=input_spec or artifact.input_spec)


def _perturbed(artifact, path):
    params, _ = _tree(artifact)
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda x: x + rng.normal(scale=0.05, size=x.shape).astype(x.dtype),
        params)
    return _resave(artifact, path, params=params, step=artifact.step + 1)


# ------------------------------------------------------------- export


def test_export_fields_and_digest_match_the_jax_export(trained, artifact,
                                                       tmp_path):
    params, stats = _tree(artifact)
    jcfg = jax_load_config(overrides=LENET + SERVE)
    ref = jx.load_artifact(jx.save_artifact(
        str(tmp_path / "jax"), model_config=jcfg.model,
        task="classification", params=params, batch_stats=stats,
        step=artifact.step, input_spec=jx.input_spec_for(
            jcfg, "classification")))
    assert artifact.task == ref.task == "classification"
    assert artifact.step == 10
    assert artifact.param_spec_digest == ref.param_spec_digest
    assert artifact.meta.keys() == ref.meta.keys()
    assert artifact.input_spec == ref.input_spec == {
        "image": {"shape": [28, 28, 1], "dtype": "float32"}}
    assert artifact.meta["model"] == ref.meta["model"]
    assert artifact.meta["source"]["used_ema"] is True  # serve.use_ema
    assert artifact.version_digest and os.path.isfile(
        os.path.join(trained["root"] / "art", "manifest.json"))


def test_export_takes_the_ema_under_serve_use_ema(trained, artifact):
    """serve.use_ema (its default, true) freezes the checkpoint's EMA
    parameters; false freezes the trained ones. The BatchNorm-free
    LeNet carries no statistics."""
    saved = torch.load(os.path.join(trained["root"], "ckpt", "10",
                                    "state.pt"), weights_only=True)
    cfg = dataclasses.replace(trained["cfg"], serve=dataclasses.replace(
        trained["cfg"].serve, use_ema=False))
    raw = px.load_artifact(px.export_checkpoint(
        cfg, str(trained["root"] / "raw"), device="cpu"))
    assert raw.meta["source"]["used_ema"] is False
    assert saved["ema"].keys() == raw.state_dict.keys()
    for key in saved["ema"]:
        assert torch.equal(artifact.state_dict[key], saved["ema"][key])
        assert torch.equal(raw.state_dict[key], saved["model"][key])
    assert any(not torch.equal(saved["ema"][k], saved["model"][k])
               for k in saved["ema"])


def test_export_refuses_a_nonempty_dir(trained, artifact_dir):
    with pytest.raises(ValueError, match="immutable"):
        px.export_checkpoint(trained["cfg"], artifact_dir, device="cpu")


# --------------------------------------------------- against the JAX engine


def test_logits_match_the_jax_engine(artifact, tmp_path):
    params, stats = _tree(artifact)
    jcfg = jax_load_config(overrides=LENET + SERVE)
    ref_art = jx.load_artifact(jx.save_artifact(
        str(tmp_path / "jax"), model_config=jcfg.model,
        task="classification", params=params, batch_stats=stats,
        step=artifact.step,
        input_spec=jx.input_spec_for(jcfg, "classification")))
    port, ref = _engine(artifact), je.InferenceEngine(
        ref_art, jcfg.serve, mesh=je.serving_mesh(1))
    try:
        for rows, seed in ((1, 0), (3, 1), (8, 2)):
            images = _images(seed, rows)
            got = port.predict({"image": images}, timeout=60)
            want = np.asarray(ref.predict({"image": images}, timeout=300))
            assert got.shape == want.shape == (rows, 10)
            np.testing.assert_allclose(got, want, **TOL)
        one = _images(5, 1)[0]  # a single row without the batch dim
        np.testing.assert_allclose(port.predict({"image": one}, timeout=60),
                                   _direct(artifact, one[None]), **TOL)
    finally:
        assert port.drain(10.0)
        ref.drain(10.0)


def test_filler_rows_are_inert(artifact):
    """Three rows pad to the 4-row bucket with copies of row 0; the three
    answers equal the model's on the three rows alone."""
    eng = _engine(artifact)
    try:
        images = _images(6, 3)
        out = eng.predict({"image": images}, timeout=60)
        assert eng.stats()["padded_rows"] == 4
        assert eng.stats()["used_buckets"] == ["(0, 4)"]
        np.testing.assert_allclose(out, _direct(artifact, images), **TOL)
    finally:
        assert eng.drain(10.0)


@pytest.mark.parametrize("inputs, err", [
    ({"image": np.zeros((9, 28, 28, 1), np.float32)},
     pe.OversizeRequestError),
    ({"image": np.zeros((2, 14, 14, 1), np.float32)}, pe.ServeError),
    ({"image": np.zeros((2, 28, 28, 1), np.float32), "extra": [1]},
     pe.ServeError),
    ({"input_ids": [1, 2]}, pe.ServeError),
    ({"image": np.zeros((28, 28), np.float32)}, pe.ServeError),
])
def test_bad_image_requests_are_rejected(artifact, inputs, err):
    eng = _engine(artifact)
    try:
        with pytest.raises(err):
            eng.submit(inputs)
    finally:
        eng.drain(10.0)


def test_resnet_artifact_with_batchnorm_stats_matches_jax(tmp_path,
                                                          monkeypatch):
    """A CIFAR-stem ResNet at one bottleneck block a stage (width 8, the
    JAX ResNet built the same) on non-trivial running statistics: the
    port's engine against the JAX engine, both on the artifact."""
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
    assert len(flatten_tree(stats)) == sum(
        k.endswith("running_mean") or k.endswith("running_var")
        for k in port_art.state_dict)
    ref_art = jx.load_artifact(jx.save_artifact(
        str(tmp_path / "j"), model_config=jcfg.model, task="classification",
        params=params, batch_stats=stats, step=3,
        input_spec=jx.input_spec_for(jcfg, "classification")))
    port, ref = pe.InferenceEngine(port_art, pcfg.serve, device="cpu"), \
        je.InferenceEngine(ref_art, jcfg.serve, mesh=je.serving_mesh(1))
    try:
        images = _images(7, 5, (32, 32, 3))
        got = port.predict({"image": images}, timeout=60)
        want = np.asarray(ref.predict({"image": images}, timeout=300))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    finally:
        assert port.drain(10.0)
        ref.drain(10.0)


# -------------------------------------------------------------- reload


def test_reload_bitwise_parity_with_cold_engine(artifact, tmp_path):
    new_dir = _perturbed(artifact, tmp_path / "v2")
    new = px.load_artifact(new_dir)
    assert new.version_digest != artifact.version_digest
    images = _images(11, 3)
    eng, cold = _engine(artifact), _engine(new)
    try:
        before = eng.predict({"image": images}, timeout=30.0)
        result = eng.reload(new_dir, timeout=60.0)
        assert result["from_step"] == artifact.step
        assert result["to_step"] == artifact.step + 1
        assert result["from_digest"] != result["to_digest"]
        after = eng.predict({"image": images}, timeout=30.0)
        cold_out = cold.predict({"image": images}, timeout=30.0)
        assert not np.array_equal(after, before)
        np.testing.assert_array_equal(after, cold_out)
        info = eng.artifact_info()
        assert info["reloads"] == 1
        assert info["content_digest"] == new.version_digest
        assert info["step"] == artifact.step + 1
    finally:
        assert eng.drain(10.0)
        assert cold.drain(10.0)


def test_reload_rejects_tampered_artifact_and_keeps_serving(
        artifact, artifact_dir, tmp_path):
    tampered = tmp_path / "tampered"
    shutil.copytree(artifact_dir, tampered)
    assert faults.corrupt_checkpoint_dir(str(tampered)) is not None
    images = _images(12, 2)
    eng = _engine(artifact)
    try:
        before = eng.predict({"image": images}, timeout=30.0)
        with pytest.raises(pe.ReloadError, match="still serving step"):
            eng.reload(str(tampered), timeout=60.0)
        after = eng.predict({"image": images}, timeout=30.0)
        np.testing.assert_array_equal(after, before)
        assert eng.artifact_info()["reloads"] == 0
        assert eng.artifact_info()["content_digest"] == \
            artifact.version_digest
    finally:
        assert eng.drain(10.0)


def test_reload_rejects_incompatible_input_spec(artifact, tmp_path):
    bad = _resave(artifact, tmp_path / "wrong_spec", input_spec={
        "image": {"shape": [14, 14, 1], "dtype": "float32"}})
    eng = _engine(artifact)
    try:
        with pytest.raises(pe.ReloadError, match="input spec"):
            eng.reload(bad, timeout=60.0)
        params, stats = _tree(artifact)
        other = px.save_artifact(
            str(tmp_path / "other"), model_config=dataclasses.replace(
                artifact.model_config, num_classes=7),
            task=artifact.task, params=params, batch_stats=stats, step=1,
            input_spec=artifact.input_spec)
        with pytest.raises(pe.ReloadError, match="model config"):
            eng.reload(other, timeout=60.0)
        assert eng.artifact_info()["reloads"] == 0
    finally:
        assert eng.drain(10.0)


def test_reload_refused_after_drain(artifact, artifact_dir):
    eng = _engine(artifact)
    assert eng.drain(10.0)
    with pytest.raises(pe.EngineClosedError):
        eng.reload(artifact_dir, timeout=10.0)


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_predict_and_reload(artifact, artifact_dir, tmp_path):
    """``POST /predict`` of image rows, ``POST /reload`` 200 to a new
    artifact (``/healthz`` then names it) and 409 for a tampered one with
    the new weights still serving; ``/generate`` is 404 without decode."""
    new_dir = _perturbed(artifact, tmp_path / "v2")
    tampered = tmp_path / "tampered"
    shutil.copytree(new_dir, tampered)
    faults.corrupt_checkpoint_dir(str(tampered))
    cfg = port_load_config(overrides=SERVE + ["serve.port=0"])
    server = ServingServer(_engine(artifact), cfg.serve)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://{server.host}:{server.port}"
    images = _images(13, 2)
    try:
        status, reply = _http("POST", url + "/predict",
                              {"inputs": {"image": images.tolist()}})
        assert status == 200 and reply["rows"] == 2 and reply["step"] == 10
        np.testing.assert_allclose(np.asarray(reply["outputs"]),
                                   _direct(artifact, images), **TOL)
        status, reply = _http("POST", url + "/reload",
                              {"artifact_dir": new_dir})
        assert status == 200 and reply["reloaded"] is True
        assert reply["to_step"] == 11
        status, health = _http("GET", url + "/healthz")
        assert health["artifact"]["step"] == 11
        assert health["artifact"]["reloads"] == 1
        assert health["decode"] is None
        status, reply = _http("POST", url + "/reload",
                              {"artifact_dir": str(tampered)})
        assert status == 409 and reply["reloaded"] is False
        status, reply = _http("POST", url + "/predict",
                              {"inputs": {"image": images.tolist()}})
        assert status == 200 and reply["step"] == 11
        np.testing.assert_allclose(np.asarray(reply["outputs"]),
                                   _direct(px.load_artifact(new_dir),
                                           images), **TOL)
        status, reply = _http("POST", url + "/reload", {"x": 1})
        assert status == 400
        status, reply = _http("POST", url + "/generate", {"prompt": [1]})
        assert status == 404 and "decode disabled" in reply["error"]
    finally:
        assert server.shutdown("test") is True
        thread.join(30)
    assert not thread.is_alive()


def test_cli_refuses_decode_on_a_classification_artifact(artifact_dir,
                                                         tmp_path):
    from distributed_tensorflow_framework_torch.cli import serve as cli

    assert cli.main(["--artifact", artifact_dir, "--device", "cpu",
                     "--set", "decode.enabled=true",
                     "--set", f"serve.log_dir={tmp_path}"]) == 2


def test_image_artifact_round_trips_its_batchnorm_stats(tmp_path):
    """A BN model's running statistics survive save → load exactly, and
    a tree without them loads with none."""
    cfg = port_load_config(overrides=["model.name=resnet18_cifar",
                                      "model.dtype=float32",
                                      "data.image_size=32",
                                      "data.channels=3"])
    model = get_model(cfg.model, device="cpu")
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.add_(torch.rand(buf.shape))
    art = px.load_artifact(px.save_artifact(
        str(tmp_path / "a"), model_config=cfg.model, task="classification",
        params=to_flax(model), batch_stats=batch_stats_to_flax(model),
        step=0, input_spec=px.input_spec_for(cfg, "classification")))
    for key, value in model.state_dict().items():
        assert torch.equal(art.state_dict[key], value), key
    assert flax_to_state_dict(to_flax(model)).keys() < art.state_dict.keys()
