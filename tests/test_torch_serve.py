"""PyTorch port's serving path on the CPU: artifact, engine, HTTP, CLI.

Weights come from the JAX ``BertForMLM`` initialiser, so the end-to-end
test can hold the port's engine against the JAX package's engine on the
same weights and requests — the slice's parity check. Everything else
drives the port alone: buckets, padding, typed rejections, the HTTP front
end, tamper detection, and the CLI's SIGTERM drain in a subprocess.

Tolerances: f32 logits rtol 1e-4, atol 1e-5 (same arithmetic, other
summation orders and GEMM shapes); bf16 atol 3e-2 as in
tests/test_torch_bert.py.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_load_config,
)
from distributed_tensorflow_framework_torch.serve import engine as pe
from distributed_tensorflow_framework_torch.serve import export as px
from distributed_tensorflow_framework_torch.serve.server import ServingServer
from distributed_tensorflow_framework_tpu.core import telemetry as jax_telemetry
from distributed_tensorflow_framework_tpu.core.config import (
    load_config as jax_load_config,
)
from distributed_tensorflow_framework_tpu.models import get_model as jax_model
from distributed_tensorflow_framework_tpu.serve import export as jx
from distributed_tensorflow_framework_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from distributed_tensorflow_framework_tpu.serve.engine import serving_mesh
from tests.test_torch_hygiene import torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"name": "bert", "vocab_size": 1000, "hidden_size": 128,
         "num_layers": 2, "num_heads": 4, "mlp_dim": 512,
         "max_seq_len": 256, "attention_impl": "pallas", "fused_qkv": True}
SERVE = ["serve.max_batch_size=4", "serve.max_wait_ms=20",
         "serve.seq_buckets=[64,128]", "serve.report_interval_s=60"]


def _overrides(dtype="float32", extra=()):
    model = [f"model.{k}={v}" for k, v in MODEL.items()]
    return model + [f"model.dtype={dtype}", "data.seq_len=128",
                    *SERVE, *extra]


def _configs(dtype="float32", extra=()):
    ov = _overrides(dtype, extra)
    return port_load_config(overrides=ov), jax_load_config(overrides=ov)


def _jax_params(jcfg):
    model = jax_model(jcfg.model)
    params = model.init({"params": jax.random.key(0)},
                        jnp.zeros((1, 64), jnp.int32), train=False)["params"]
    return jax.tree.map(np.asarray, jax.device_get(params))


def _save_port(path, cfg, params):
    return px.save_artifact(
        str(path), model_config=cfg.model, task="mlm", params=params,
        step=7, input_spec=px.input_spec_for(cfg, "mlm"))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg, jcfg = _configs()
    params = _jax_params(jcfg)
    root = tmp_path_factory.mktemp("torch_serve")
    port_dir = _save_port(root / "port", cfg, params)
    jax_dir = jx.save_artifact(
        str(root / "jax"), model_config=jcfg.model, task="mlm",
        params=params, batch_stats={}, step=7,
        input_spec=jx.input_spec_for(jcfg, "mlm"))
    return {"params": params, "port_dir": port_dir, "jax_dir": jax_dir,
            "root": root}


@pytest.fixture()
def engine(weights):
    cfg, _ = _configs()
    eng = pe.InferenceEngine(px.load_artifact(weights["port_dir"]),
                             cfg.serve, device="cpu")
    yield eng
    eng.drain(30)


def _ids(seed, n, rows=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if rows is None else (rows, n)
    return rng.integers(0, MODEL["vocab_size"], shape).astype(np.int32)


def _direct(artifact, ids, mask=None, seg=None):
    """The artifact's model run directly on the unpadded rows."""
    from distributed_tensorflow_framework_torch.models import get_model

    model = get_model(artifact.model_config, device="cpu")
    model.load_state_dict(artifact.state_dict)
    ids = np.atleast_2d(ids)
    mask = np.ones_like(ids) if mask is None else np.atleast_2d(mask)
    args = [torch.from_numpy(ids).long(), torch.from_numpy(mask).long()]
    if seg is not None:
        args.append(torch.from_numpy(np.atleast_2d(seg)).long())
    with torch.inference_mode():
        return model(*args).numpy()


def test_predict_matches_direct_forward(engine):
    ids = _ids(0, 40)
    out = engine.predict({"input_ids": ids}, timeout=60)
    assert out.shape == (1, 40, MODEL["vocab_size"])
    np.testing.assert_allclose(out, _direct(engine.artifact, ids),
                               rtol=1e-4, atol=1e-5)


def test_segment_ids_reach_attention(engine):
    ids = _ids(1, 60)
    seg = np.repeat([0, 1, 2], 20).astype(np.int32)
    out = engine.predict({"input_ids": ids, "segment_ids": seg}, timeout=60)
    np.testing.assert_allclose(out, _direct(engine.artifact, ids, seg=seg),
                               rtol=1e-4, atol=1e-5)
    plain = engine.predict({"input_ids": ids}, timeout=60)
    assert np.abs(out - plain).max() > 1e-3  # the mask changed the result


def test_seq_buckets_hold(engine):
    engine.predict({"input_ids": _ids(2, 5)}, timeout=60)
    assert engine._used == {(64, 1)}
    engine.predict({"input_ids": _ids(3, 100)}, timeout=60)
    assert engine._used == {(64, 1), (128, 1)}
    engine.predict({"input_ids": _ids(4, 64)}, timeout=60)
    assert engine._used == {(64, 1), (128, 1)}
    with pytest.raises(pe.SequenceTooLongError):
        engine.submit({"input_ids": _ids(5, 129)})
    assert pe.pick_bucket(65, [64, 128]) == 128
    assert pe.batch_buckets(6, 1) == [1, 2, 4, 6]
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        pe.pick_bucket(129, [64, 128])


def test_padding_is_inert(engine):
    """A short request padded to its bucket and batched with longer,
    filler-padded rows gives the logits it gets alone, unpadded."""
    short = _ids(6, 9)
    masked = np.ones((2, 30), np.int32)
    masked[1, 20:] = 0
    futs = [engine.submit({"input_ids": short}),
            engine.submit({"input_ids": _ids(7, 30, rows=2),
                           "attention_mask": masked})]
    out = futs[0].result(60)
    assert engine.stats()["padded_rows"] >= 3
    np.testing.assert_allclose(out, _direct(engine.artifact, short),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("inputs,err", [
    ({"input_ids": np.zeros((5, 8), np.int32)}, pe.OversizeRequestError),
    ({"input_ids": np.full(8, 1000, np.int32)}, pe.ServeError),
    ({"attention_mask": np.ones(8, np.int32)}, pe.ServeError),
    ({"input_ids": np.zeros(8, np.int32), "pixels": [1]}, pe.ServeError),
    ({"input_ids": np.zeros(8, np.int32),
      "attention_mask": np.ones(7, np.int32)}, pe.ServeError),
])
def test_bad_requests_are_rejected(engine, inputs, err):
    with pytest.raises(err):
        engine.submit(inputs)


def test_drain_refuses_new_work(engine):
    assert engine.drain(30) is True
    with pytest.raises(pe.EngineClosedError):
        engine.submit({"input_ids": _ids(8, 8)})


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_predict_and_healthz_round_trip(engine):
    cfg, _ = _configs(extra=["serve.port=0"])
    server = ServingServer(engine, cfg.serve)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://{server.host}:{server.port}"
    try:
        ids = _ids(9, 12)
        status, reply = _http("POST", url + "/predict",
                              {"inputs": {"input_ids": ids.tolist()}})
        assert status == 200 and reply["rows"] == 1 and reply["step"] == 7
        np.testing.assert_allclose(np.asarray(reply["outputs"]),
                                   _direct(engine.artifact, ids),
                                   rtol=1e-4, atol=1e-5)
        status, health = _http("GET", url + "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["engine"]["requests"] == 1
        assert health["input_spec"]["input_ids"]["shape"] == [128]
        status, reply = _http("POST", url + "/predict",
                              {"inputs": {"input_ids": _ids(10, 200).tolist()}})
        assert status == 400 and "exceeds the largest" in reply["error"]
        status, reply = _http("POST", url + "/generate", {"prompt": [1]})
        assert status == 404 and "decode disabled" in reply["error"]
        status, reply = _http("POST", url + "/reload", {"artifact_dir": "x"})
        assert status == 409 and "still serving step 7" in reply["error"]
    finally:
        assert server.shutdown("test") is True
        thread.join(30)
    assert not thread.is_alive()


def test_tampered_artifact_is_rejected(weights, tmp_path):
    cfg, _ = _configs()
    path = _save_port(tmp_path / "a", cfg, weights["params"])
    npz = os.path.join(path, px.PARAMS_NPZ)
    with open(npz, "r+b") as fh:
        fh.seek(os.path.getsize(npz) // 2)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(ValueError, match="integrity"):
        px.load_artifact(path)
    os.remove(os.path.join(path, "manifest.json"))
    with pytest.raises(ValueError, match="no integrity manifest"):
        px.load_artifact(path)


def test_each_package_refuses_the_others_artifact(weights):
    with pytest.raises(ValueError, match="schema"):
        px.load_artifact(weights["jax_dir"])
    with pytest.raises(ValueError, match="schema"):
        jx.load_artifact(weights["port_dir"])
    assert px.ARTIFACT_SCHEMA != jx.ARTIFACT_SCHEMA


def test_artifact_fields_and_digest_match_the_jax_export(weights):
    port = px.load_artifact(weights["port_dir"])
    ref = jx.load_artifact(weights["jax_dir"])
    assert port.param_spec_digest == ref.param_spec_digest
    assert port.meta.keys() == ref.meta.keys()
    assert port.input_spec == ref.input_spec
    assert port.meta["model"] == ref.meta["model"]


@pytest.mark.parametrize("dtype,tol", [
    ("float32", dict(rtol=1e-4, atol=1e-5)),
    ("bfloat16", dict(rtol=0.0, atol=3e-2)),
])
def test_engine_matches_jax_engine(weights, tmp_path, dtype, tol):
    """The slice end to end: the same weights and requests through the JAX
    package's InferenceEngine and the port's, padding and batching
    included."""
    cfg, jcfg = _configs(dtype)
    port_art = px.load_artifact(_save_port(tmp_path / "p", cfg,
                                           weights["params"]))
    jax_art = jx.load_artifact(jx.save_artifact(
        str(tmp_path / "j"), model_config=jcfg.model, task="mlm",
        params=weights["params"], batch_stats={}, step=7,
        input_spec=jx.input_spec_for(jcfg, "mlm")))
    masked = np.ones((2, 70), np.int32)
    masked[0, 50:] = 0
    requests = [{"input_ids": _ids(20, 17)},
                {"input_ids": _ids(21, 70, rows=2),
                 "attention_mask": masked},
                {"input_ids": _ids(22, 128)}]
    port = pe.InferenceEngine(port_art, cfg.serve, device="cpu")
    ref = JaxEngine(jax_art, jcfg.serve, mesh=serving_mesh(1))
    try:
        for req in requests:
            got = port.predict(req, timeout=120)
            want = ref.predict(req, timeout=300)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, np.asarray(want), **tol)
    finally:
        port.drain(30)
        ref.drain(30)


def test_cli_serves_and_drains_on_sigterm(weights, tmp_path):
    """``python -m ...cli.serve --device cpu``: endpoint.json appears, a
    request is answered, SIGTERM drains to exit 0, and the JAX package's
    telemetry reader accepts the port's events.jsonl."""
    log_dir = tmp_path / "logs"
    cmd = [sys.executable, "-m",
           "distributed_tensorflow_framework_torch.cli.serve",
           "--artifact", weights["port_dir"], "--device", "cpu",
           *sum((["--set", o] for o in SERVE), []),
           "--set", "serve.port=0", "--set", f"serve.log_dir={log_dir}"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        endpoint = log_dir / "endpoint.json"
        deadline = time.monotonic() + 120
        while not endpoint.exists() and proc.poll() is None:
            assert time.monotonic() < deadline, "server never came up"
            time.sleep(0.1)
        time.sleep(0.1)  # the file is written whole before this point
        url = json.loads(endpoint.read_text())["url"]
        status, reply = _http("POST", url + "/predict",
                              {"inputs": {"input_ids": [1, 2, 3]}})
        assert status == 200 and np.asarray(reply["outputs"]).shape == (
            1, 3, MODEL["vocab_size"])
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "drain complete (clean=True)" in out
    events = list(jax_telemetry.read_events(str(log_dir / "events.jsonl")))
    kinds = {ev["kind"] for ev in events}
    assert {jax_telemetry.KIND_RUN_META, jax_telemetry.KIND_SERVE_REQUEST,
            jax_telemetry.KIND_SERVE_BATCH, jax_telemetry.KIND_SERVE_RECOMPILE,
            jax_telemetry.KIND_SERVE_LATENCY,
            jax_telemetry.KIND_HEALTH} <= kinds
    summary = jax_telemetry.summarize_events(str(log_dir / "events.jsonl"))
    assert summary
