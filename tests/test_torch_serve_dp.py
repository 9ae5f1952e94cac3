"""Data-parallel serving in the port's engine, held to the JAX engine on
the serving mesh.

The port's ``InferenceEngine`` at ``devices=[cpu] * dp`` (one replica a
listed device, the batch cut into ``dp`` contiguous shards) against the
JAX package's at ``serving_mesh(dp)`` over the conftest's virtual CPU
devices, on the same weights and requests: 1-, 3- and 5-row requests, one
with an attention mask, at ``dp`` 2 and 4 give the JAX row ladders and
``padded_rows``, logits within the f32 tolerance of
tests/test_torch_serve.py, and bit for bit the port's own ``dp`` 1. A
5-row request with segment ids follows; the JAX engine drops a request's
segment ids (ROADMAP.md, deliberate differences), so there the port at
``dp`` is held bit for bit to its ``dp`` 1, which
tests/test_torch_serve.py holds to the model's forward. MoE
BERT at ``dp`` 2 the same (capacity is per batch row, so a split by rows
changes nothing). A live reload at ``dp`` 2 reaches every replica: each
answers as a cold engine on the new artifact, and a tampered artifact
leaves all of them on the old one.

Tolerances: f32 logits rtol 1e-4, atol 1e-5 against JAX (same
arithmetic, other summation orders and GEMM shapes); bitwise within the
port.
"""

import shutil

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core import faults
from distributed_tensorflow_framework_torch.serve import engine as pe
from distributed_tensorflow_framework_torch.serve import export as px
from distributed_tensorflow_framework_tpu.serve import export as jx
from distributed_tensorflow_framework_tpu.serve.engine import (
    InferenceEngine as JaxEngine,
)
from distributed_tensorflow_framework_tpu.serve.engine import serving_mesh
from tests.test_torch_hygiene import torch_threads  # noqa: F401
from tests.test_torch_serve import _configs, _ids, _jax_params

F32_TOL = dict(rtol=1e-4, atol=1e-5)
# max_batch_size 8, as the JAX numbers of the ladders are taken at.
WIDE = ("serve.max_batch_size=8",)
MOE = ("model.num_experts=4", "model.moe_every=2", "model.expert_topk=2",
       "model.capacity_factor=1.25", "model.moe_dispatch=sorted")
LADDERS = {1: [1, 2, 4, 8], 2: [2, 4, 8], 4: [4, 8]}
PADDED_ROWS = {1: 13, 2: 14, 4: 16}  # requests of 1, 3 and 5 rows


def _requests() -> list[dict]:
    """1, 3 and 5 rows (the second with an attention mask), then the 5
    rows again with segment ids."""
    mask = np.ones((3, 70), np.int32)
    mask[0, 50:] = 0
    mask[2, 33:] = 0
    seg = np.repeat([[0, 1, 2, 3]], 5, axis=0).repeat(25, axis=1)
    five = _ids(42, 100, rows=5)
    return [{"input_ids": _ids(40, 17)},
            {"input_ids": _ids(41, 70, rows=3), "attention_mask": mask},
            {"input_ids": five},
            {"input_ids": five, "segment_ids": seg.astype(np.int32)}]


def _artifacts(root, extra=()):
    cfg, jcfg = _configs(extra=WIDE + tuple(extra))
    params = _jax_params(jcfg)
    port = px.load_artifact(px.save_artifact(
        str(root / "port"), model_config=cfg.model, task="mlm",
        params=params, step=7, input_spec=px.input_spec_for(cfg, "mlm")))
    ref = jx.load_artifact(jx.save_artifact(
        str(root / "jax"), model_config=jcfg.model, task="mlm",
        params=params, batch_stats={}, step=7,
        input_spec=jx.input_spec_for(jcfg, "mlm")))
    return cfg, jcfg, port, ref, params


def _serve(engine, requests, timeout=300):
    """Each request alone, so each is one batch: the logits and the
    ``padded_rows`` after the first three; the engine drained."""
    try:
        outs, padded = [], []
        for r in requests:
            outs.append(np.asarray(engine.predict(r, timeout=timeout)))
            padded.append(engine.stats()["padded_rows"])
        return outs, padded[2]
    finally:
        engine.drain(30)


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_dp")
    cfg, jcfg, port, ref, params = _artifacts(root)
    one = pe.InferenceEngine(port, cfg.serve, devices=["cpu"])
    assert one.row_buckets == LADDERS[1]
    outs, padded = _serve(one, _requests())
    assert padded == PADDED_ROWS[1]
    return {"cfg": cfg, "jcfg": jcfg, "port": port, "ref": ref,
            "one": outs, "params": params, "port_dir": str(root / "port")}


@pytest.mark.parametrize("dp", [2, 4])
def test_bert_at_dp_matches_the_jax_serving_mesh(bert, dp):
    port = pe.InferenceEngine(bert["port"], bert["cfg"].serve,
                              devices=["cpu"] * dp)
    ref = JaxEngine(bert["ref"], bert["jcfg"].serve, mesh=serving_mesh(dp))
    assert port.dp == ref.dp == dp
    assert port.row_buckets == ref.row_buckets == LADDERS[dp]
    got, padded = _serve(port, _requests())
    want, ref_padded = _serve(ref, _requests()[:3])
    assert padded == ref_padded == PADDED_ROWS[dp]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **F32_TOL)
    for g, one in zip(got, bert["one"]):
        np.testing.assert_array_equal(g, one)
    assert np.abs(got[3] - got[2]).max() > 1e-3  # the segments reached it


def test_moe_bert_at_dp2_matches_the_jax_serving_mesh(tmp_path):
    cfg, jcfg, port_art, ref_art, _ = _artifacts(tmp_path, MOE)
    assert cfg.model.num_experts == 4
    requests = _requests()
    one, _ = _serve(pe.InferenceEngine(port_art, cfg.serve,
                                       devices=["cpu"]), requests)
    got, padded = _serve(pe.InferenceEngine(
        port_art, cfg.serve, devices=["cpu", "cpu"]), requests)
    want, ref_padded = _serve(JaxEngine(ref_art, jcfg.serve,
                                        mesh=serving_mesh(2)), requests[:3])
    assert padded == ref_padded == PADDED_ROWS[2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F32_TOL)
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g, o)


def test_replicas_share_no_tensor(bert):
    eng = pe.InferenceEngine(bert["port"], bert["cfg"].serve,
                             devices=["cpu"] * 4)
    try:
        assert len(eng.replicas) == 4 and eng.model is eng.replicas[0]
        ptrs = [{t.data_ptr() for t in m.state_dict().values()}
                for m in eng.replicas]
        for i in range(4):
            for j in range(i):
                assert not ptrs[i] & ptrs[j]
        assert eng.dp == 4 and eng.stats()["device"] == "cpu"
        assert eng.memory_snapshot()["device_count"] == 1
    finally:
        eng.drain(30)


def _replica_states(engine) -> list[dict]:
    return [{k: v.clone() for k, v in m.state_dict().items()}
            for m in engine.replicas]


def _holds(engine, artifact) -> bool:
    """Every replica holds exactly ``artifact``'s tensors."""
    return all(torch.equal(m.state_dict()[k], v)
               for m in engine.replicas
               for k, v in artifact.state_dict.items())


def test_live_reload_reaches_every_replica(bert, tmp_path):
    cfg = bert["cfg"]
    new_dir = px.save_artifact(
        str(tmp_path / "v2"), model_config=cfg.model, task="mlm",
        params=_perturb(bert["params"], np.random.default_rng(5)), step=8,
        input_spec=px.input_spec_for(cfg, "mlm"))
    new = px.load_artifact(new_dir)
    tampered = tmp_path / "tampered"
    shutil.copytree(bert["port_dir"], tampered)
    assert faults.corrupt_checkpoint_dir(str(tampered)) is not None
    # 4 rows at dp 2: two shards, each replica serves two of them.
    req = {"input_ids": _ids(43, 60, rows=4)}
    eng = pe.InferenceEngine(bert["port"], cfg.serve, devices=["cpu"] * 2)
    cold = pe.InferenceEngine(new, cfg.serve, devices=["cpu"] * 2)
    try:
        before = eng.predict(req, timeout=60)
        result = eng.reload(new_dir, timeout=60)
        assert (result["from_step"], result["to_step"]) == (7, 8)
        assert _holds(eng, new)
        after = eng.predict(req, timeout=60)
        assert not np.array_equal(after, before)
        np.testing.assert_array_equal(after, cold.predict(req, timeout=60))
        # Each shard alone: the rows of replica 0 and of replica 1.
        for rows in (slice(0, 2), slice(2, 4)):
            part = {"input_ids": req["input_ids"][rows]}
            np.testing.assert_array_equal(
                eng.predict(part, timeout=60),
                cold.predict(part, timeout=60))
        states = _replica_states(eng)
        with pytest.raises(pe.ReloadError, match="still serving step 8"):
            eng.reload(str(tampered), timeout=60)
        assert all(torch.equal(m.state_dict()[k], v)
                   for m, state in zip(eng.replicas, states)
                   for k, v in state.items())
        np.testing.assert_array_equal(eng.predict(req, timeout=60), after)
        assert eng.artifact_info()["reloads"] == 1
        assert eng.artifact_info()["content_digest"] == new.version_digest
    finally:
        assert eng.drain(30)
        assert cold.drain(30)


def _perturb(params, rng):
    if isinstance(params, dict):
        return {k: _perturb(v, rng) for k, v in params.items()}
    return (params + rng.normal(scale=0.05, size=params.shape)).astype(
        params.dtype)
