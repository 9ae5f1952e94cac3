"""PyTorch port's in-process recovery ladder (train/anomaly.py).

Every rung alone — the detector's thresholds, the snapshot ring, the
RecoveryManager's cadence, budget, telemetry and escalation — then the
ladder end to end in the port's Trainer on a tiny BERT (2 layers, hidden
64, 2 heads, seq 32, vocab 512): a ``nan_grads`` step rolls back once and
the run finishes with finite metrics; ``loss_spike`` rolls back through
the EWMA z-score; ``repeat_nan`` exhausts the ladder and the CLI returns
85. A snapshot is a real copy: training on after it, and rolling back to
it twice, leave it as it was.

Against the JAX package (same numpy-seeded data, weights carried by
models/convert.py, dropout 0, losses within rtol 1e-5 as
tests/test_torch_train.py states for the tiny BERT): with
``nan_grads`` at step 5 both trainers roll back 6 → 4, record the same
skipped batch ordinals, take the same number of steps and log the same
losses. The JAX package's ``nan_grads`` scales a batch's floating-point
inputs, and a masked-LM batch has none, so on the JAX side the test makes
the poisoned step's update non-finite itself — what the port's
``nan_grads`` does (core/faults.py) — and the JAX ladder takes it from
there.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.cli import train as port_cli
from distributed_tensorflow_framework_torch.core import faults, telemetry
from distributed_tensorflow_framework_torch.core.config import (
    ResilienceConfig,
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.models.convert import (
    flax_to_state_dict,
)
from distributed_tensorflow_framework_torch.train import anomaly
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_tpu.core import faults as jax_faults
from distributed_tensorflow_framework_tpu.core.config import (
    MeshConfig,
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.core.mesh import initialize_runtime
from distributed_tensorflow_framework_tpu.train import Trainer as JaxTrainer
from distributed_tensorflow_framework_tpu.train import loop as jax_loop
from tests.test_torch_ckpt import TINY, losses_of, train_run
from tests.test_torch_hygiene import torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_plans():
    yield
    faults.install(faults.FaultPlan())
    jax_faults.install(jax_faults.FaultPlan())


def _events(path, kind):
    with open(path) as fh:
        return [e for e in map(json.loads, fh) if e["kind"] == kind]


# ------------------------------------------------------------ detector

def _warm(det, losses):
    for x in losses:
        det.observe({"loss": x})


def test_detector_flags_non_finite_any_metric():
    det = anomaly.AnomalyDetector(ResilienceConfig())
    assert det.classify(3, {"loss": 1.0, "grad_norm": 2.0}) is None
    v = det.classify(4, {"loss": float("nan"), "grad_norm": 2.0})
    assert v.anomaly == "non_finite_metric" and v.metric == "loss"
    assert v.step == 4
    assert det.classify(5, {"loss": 1.0,
                            "grad_norm": float("inf")}).metric == "grad_norm"
    assert det.classify(6, {"loss": 1.0, "note": "fine"}) is None


def test_detector_grad_norm_ceiling():
    det = anomaly.AnomalyDetector(ResilienceConfig(grad_norm_max=100.0))
    assert det.classify(1, {"loss": 1.0, "grad_norm": 99.0}) is None
    v = det.classify(2, {"loss": 1.0, "grad_norm": 150.0})
    assert v.anomaly == "grad_norm_explosion"
    assert v.detail["grad_norm_max"] == 100.0
    det0 = anomaly.AnomalyDetector(ResilienceConfig(grad_norm_max=0.0))
    assert det0.classify(2, {"loss": 1.0, "grad_norm": 1e12}) is None


def test_loss_spike_needs_warmup_then_fires():
    cfg = ResilienceConfig(loss_spike_zscore=5.0, min_observations=5,
                           loss_ewma_beta=0.9)
    det = anomaly.AnomalyDetector(cfg)
    assert det.classify(1, {"loss": 1e9}) is None
    _warm(det, [1.0, 1.01, 0.99, 1.02, 0.98])
    assert det.observations == 5
    assert det.classify(10, {"loss": 1.03}) is None
    v = det.classify(11, {"loss": 50.0})
    assert v.anomaly == "loss_spike" and v.detail["zscore"] > 5.0
    assert v.detail["ewma_mean"] == pytest.approx(1.0, abs=0.1)


def test_loss_spike_std_floor_tolerates_constant_loss():
    det = anomaly.AnomalyDetector(ResilienceConfig(loss_spike_zscore=10.0,
                                                   min_observations=3))
    _warm(det, [2.0] * 10)
    assert det.std >= 1e-3 * 2.0
    assert det.classify(20, {"loss": 2.0 + 1e-4}) is None


def test_loss_spike_zero_disables():
    det = anomaly.AnomalyDetector(ResilienceConfig(loss_spike_zscore=0.0,
                                                   min_observations=1))
    _warm(det, [1.0] * 10)
    assert det.classify(11, {"loss": 1e9}) is None


@pytest.mark.parametrize("key,bad", [
    ("resilience.snapshot_depth", 0), ("resilience.max_rollbacks", 0),
    ("resilience.loss_ewma_beta", 1.5), ("resilience.loss_ewma_beta", 0.0),
])
def test_resilience_config_validation(key, bad):
    with pytest.raises(ValueError, match=key.split(".")[1]):
        port_config(overrides=[f"{key}={bad}"])


def test_resilience_defaults_armed():
    res = port_config().resilience
    assert res.rollback is True
    assert res.snapshot_depth >= 1 and res.max_rollbacks >= 1


# ----------------------------------------------------------- snapshots

def test_snapshot_ring_depth_evicts_oldest():
    ring = anomaly.SnapshotRing(depth=2)
    for step in (10, 20, 30):
        ring.push(anomaly.Snapshot(step=step, host=None))
    assert len(ring) == 2 and ring.steps == [20, 30]
    assert ring.latest().step == 30


def _clone_state(state):
    return {"model": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "slots": {i: {k: v.clone() for k, v in s.items()} for i, s in
                      state.optimizer.inner.state_dict()["state"].items()},
            "count": state.optimizer.count, "step": state.step,
            "gen": state.dropout_generator.get_state()}


def _assert_equal_to(state, ref):
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, ref["model"][k]), k
    for i, slots in state.optimizer.inner.state_dict()["state"].items():
        for k, v in slots.items():
            assert torch.equal(v, ref["slots"][i][k]), (i, k)
    assert state.optimizer.count == ref["count"]
    assert state.step == ref["step"]
    assert torch.equal(state.dropout_generator.get_state(), ref["gen"])


def test_snapshot_restore_bit_exact_and_not_aliased():
    """A snapshot is a copy: training on leaves it unchanged (on the CPU a
    ``.to("cpu")`` snapshot would be the live tensors, overwritten by the
    next step), restoring it lands its exact bytes, and a second rollback
    to the same snapshot after more training lands them again."""
    trainer = train_run(None, 2)
    batch = to_device(next(trainer.dataset), torch.device("cpu"))
    ref = _clone_state(trainer.state)
    host = anomaly.snapshot_state(trainer.state)
    before = {k: v.clone() for k, v in host["model"].items()}
    step_before = host["optimizer"]["inner"]["state"][0]["step"].clone()
    for _ in range(2):
        trainer.builder.train_step(trainer.state, batch)
    for k, v in host["model"].items():
        assert torch.equal(v, before[k]), f"snapshot aliases live {k}"
    for _ in range(2):
        anomaly.restore_state(host, trainer.state)
        _assert_equal_to(trainer.state, ref)
        trainer.builder.train_step(trainer.state, batch)
    assert torch.equal(host["optimizer"]["inner"]["state"][0]["step"],
                       step_before)


# ------------------------------------------------------ the manager

def _manager(tmp_path=None, **over):
    writer = path = None
    if tmp_path is not None:
        path = str(tmp_path / "events.jsonl")
        writer = telemetry.TelemetryWriter(path, run_id="anomaly-test")
    return anomaly.RecoveryManager(ResilienceConfig(**over),
                                   telemetry_writer=writer), path


def test_manager_snapshot_cadence_and_force(monkeypatch):
    rec, _ = _manager(snapshot_interval_steps=10)
    monkeypatch.setattr(anomaly, "snapshot_state", lambda s: "host")
    assert rec.take_snapshot(0, object(), force=True)
    assert not rec.take_snapshot(5, object())
    assert rec.take_snapshot(10, object())
    assert rec.ring.steps == [0, 10]


def test_manager_classify_emits_and_resets_streak(tmp_path):
    rec, path = _manager(tmp_path, min_observations=1)
    rec.consecutive_rollbacks = 2
    assert rec.classify(10, {"loss": 1.0}) is None
    assert rec.consecutive_rollbacks == 0
    assert rec.detector.observations == 1
    assert rec.classify(20, {"loss": float("nan")}) is not None
    assert rec.detector.observations == 1  # no anomaly in the baseline
    assert rec.anomalies_detected == 1
    rec._telemetry.close()
    evs = _events(path, telemetry.KIND_ANOMALY)
    assert len(evs) == 1 and evs[0]["step"] == 20
    assert evs[0]["health"]["anomaly"] == "non_finite_metric"


def test_manager_rollback_budget_and_exhaustion(monkeypatch):
    rec, _ = _manager(max_rollbacks=2)
    assert not rec.can_rollback()
    rec.ring.push(anomaly.Snapshot(step=10, host=None))
    monkeypatch.setattr(anomaly, "restore_state", lambda host, live: live)
    assert rec.can_rollback()
    rec.rollback("state", from_step=30)
    assert rec.consecutive_rollbacks == 1 and rec.total_rollbacks == 1
    rec.rollback("state", from_step=30)
    assert not rec.can_rollback()
    rec.classify(40, {"loss": 1.0})  # a clean fetch resets the streak
    assert rec.can_rollback()


def test_manager_rollback_telemetry_and_skip_accounting(tmp_path,
                                                        monkeypatch):
    rec, path = _manager(tmp_path)
    rec.ring.push(anomaly.Snapshot(step=20, host=None))
    monkeypatch.setattr(anomaly, "restore_state", lambda host, live: live)
    _, snap = rec.rollback("state", from_step=30)
    assert snap.step == 20
    rec._telemetry.close()
    assert _events(path, telemetry.KIND_ROLLBACK)[0]["health"] == {
        "from_step": 30, "to_step": 20, "consecutive_rollbacks": 1}
    assert _events(path, telemetry.KIND_BATCH_SKIPPED)[0][
        "health"]["batches"] == 10


def test_escalation_provenance_names_the_verdict():
    rec, _ = _manager(max_rollbacks=2)
    rec.classify(30, {"loss": float("nan")})
    rec.consecutive_rollbacks = 2
    prov = rec.provenance()
    assert prov["anomaly"] == "non_finite_metric" and prov["step"] == 30
    assert prov["max_rollbacks"] == 2
    msg = rec.escalation_message()
    assert "non_finite_metric" in msg and "poisoned data region" in msg
    assert "no snapshot" in msg


def test_persistent_anomaly_error_is_a_floating_point_error():
    err = anomaly.PersistentAnomalyError("boom", provenance={"step": 3})
    assert isinstance(err, FloatingPointError)
    assert err.provenance == {"step": 3}


# ------------------------------------------------- end to end, port

LADDER = ["train.log_interval=2", "resilience.snapshot_interval_steps=2",
          "checkpoint.async_save=false"]


def test_nan_batch_rolls_back_and_finishes(tmp_path):
    faults.install("nan_grads:5")
    d = tmp_path / "ckpt"
    t = train_run(str(d), 8, *LADDER)
    rec = t.recovery
    assert rec.total_rollbacks == 1 and rec.anomalies_detected == 1
    assert not rec.exhausted and t.host_step == 8
    logged = losses_of(d)
    assert sorted(logged) == [2, 4, 6, 8]
    assert all(math.isfinite(v) for v in logged.values())
    rb = _events(d / "events.jsonl", telemetry.KIND_ROLLBACK)
    assert rb[0]["health"]["from_step"] == 6
    assert rb[0]["health"]["to_step"] == 4
    assert t.dataset._state["batches_skipped"] == [5, 6]
    # Steps 5-8 trained on batches 7-10: the final checkpoint's data
    # state is past the skipped ordinals (so they are pruned from it).
    with open(d / "8" / "data_iter.json") as fh:
        assert json.load(fh)["consumed"] == 10


def test_loss_spike_rolls_back(tmp_path):
    faults.install("loss_spike:8")
    t = train_run(str(tmp_path / "ckpt"), 10, "train.log_interval=1",
                  "resilience.snapshot_interval_steps=1",
                  "resilience.min_observations=3",
                  "checkpoint.async_save=false")
    assert t.recovery.total_rollbacks == 1
    assert t.recovery.last_verdict.anomaly == "loss_spike"
    assert t.host_step == 10


def test_rewarmup_scales_the_rate_after_a_rollback(tmp_path):
    faults.install("nan_grads:5")
    d = tmp_path / "ckpt"
    train_run(str(d), 8, *LADDER, "resilience.lr_rewarmup_steps=4")
    rates = {e["step"]: e["metrics"]["learning_rate"]
             for e in _events(d / "events.jsonl", telemetry.KIND_TRAIN_STEP)}
    base = 1e-3 / 100  # linear warm-up: lr * step / warmup_steps
    # step 6 after the rollback to 4 ran at learning_rate(5) * 2/4
    assert rates[6] == pytest.approx(base * 5 * 2 / 4)
    assert rates[8] == pytest.approx(base * 7 * 4 / 4)


def test_rollback_disabled_falls_back_to_nan_guard(tmp_path):
    faults.install("nan_grads:3")
    with pytest.raises(FloatingPointError) as ei:
        train_run(None, 6, "train.log_interval=2",
                  "resilience.rollback=false")
    assert not isinstance(ei.value, anomaly.PersistentAnomalyError)


def test_repeat_nan_exhausts_the_ladder_and_returns_85(tmp_path):
    faults.install("repeat_nan:3:8")
    d = str(tmp_path / "ckpt")
    over = TINY + [f"checkpoint.directory={d}", "train.total_steps=8",
                   *LADDER, "resilience.max_rollbacks=2"]
    rc = port_cli.main(["--device", "cpu",
                        *sum((["--set", o] for o in over), [])])
    assert rc == 85
    events = os.path.join(d, "events.jsonl")
    assert len(_events(events, telemetry.KIND_ROLLBACK)) == 2
    failure = _events(events, telemetry.KIND_FAILURE)[0]
    assert failure["health"]["failure"] == "non_finite_metric"


# ------------------------------------------------- against the JAX side

def test_nan_rollback_matches_jax_trainer(tmp_path, monkeypatch):
    over = [o for o in TINY if not o.startswith(("model.dropout_rate",
                                                 "model.attention_impl"))]
    over += ["model.dropout_rate=0.0", "model.attention_impl=xla",
             "train.total_steps=8", *LADDER]
    poisoned = []
    monkeypatch.setattr(jax_loop, "_poison_batch",
                        lambda batch: poisoned.append(1) or batch)

    def nan_update(step):
        def run(state, batch):
            state, metrics = step(state, batch)
            if poisoned:
                poisoned.clear()
                nan = jnp.float32(jnp.nan)
                state = state.replace(
                    params=jax.tree.map(lambda p: p * nan, state.params))
                metrics = {**metrics, "loss": metrics["loss"] * nan,
                           "grad_norm": metrics["grad_norm"] * nan}
            return state, metrics
        return run

    jd, pd = tmp_path / "jax", tmp_path / "port"
    jax_faults.install("nan_grads:5")
    jt = JaxTrainer(jax_config(overrides=over + [f"checkpoint.directory={jd}"]),
                    initialize_runtime(MeshConfig(data=1),
                                       devices=jax.devices()[:1]))
    jt.build()
    params = jax.device_get(jt.state.params)
    jt.train_step = nan_update(jt.train_step)
    jt.train()
    jt._ckpt_manager.close()

    faults.install("nan_grads:5")
    pt = Trainer(port_config(overrides=over + [f"checkpoint.directory={pd}"]),
                 device="cpu")
    pt.build()
    pt.state.model.load_state_dict(flax_to_state_dict(params))
    pt.train()

    assert jt.recovery.total_rollbacks == pt.recovery.total_rollbacks == 1
    assert jt.host_step == pt.host_step == 8
    for kind in (telemetry.KIND_ROLLBACK, telemetry.KIND_BATCH_SKIPPED):
        assert ([e["health"] for e in _events(jd / "events.jsonl", kind)]
                == [e["health"] for e in _events(pd / "events.jsonl", kind)])
    assert (jt.dataset._state["batches_skipped"]
            == pt.dataset._state["batches_skipped"] == [5, 6])
    assert jt.data_ckpt_state["consumed"] == pt.data_ckpt_state["consumed"]
    ours, ref = losses_of(pd), losses_of(jd)
    assert sorted(ours) == sorted(ref) == [2, 4, 6, 8]
    for step in ref:
        np.testing.assert_allclose(ours[step], ref[step], rtol=1e-5,
                                   err_msg=f"step {step}")
