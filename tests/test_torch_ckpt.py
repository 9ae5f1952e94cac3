"""PyTorch port's checkpoints: resume, restore, integrity, the async saver,
the data-state record, ``--eval-only``, export and SIGTERM.

Within the port everything is bit-exact (``torch.equal``): a tiny BERT
(2 layers, hidden 64, 2 heads, seq 32, vocab 512) with dropout 0.1 trained
N steps in one run equals N/2 steps, a save, a fresh ``Trainer`` and N/2
more — parameters, AdamW slots and steps, ``AdamW.count``, the dropout
generator and the loss trajectory. The learning-rate warm-up (100 steps)
is longer than every run here, so splitting a run does not move the
schedule (it depends on ``train.total_steps``).

Against the JAX package, on the same numpy-seeded data and with the
weights carried by models/convert.py and dropout 0: a JAX ``Trainer`` and
the port's, each saving at step k and restored by a fresh trainer, log
the same losses within rtol 1e-5 (the tolerance tests/test_torch_train.py
states for the tiny BERT); the port's data-state record, restore gate and
digest give the JAX functions' outputs; and the JAX manifest code reads
the port's step directory as committed and intact.
"""

import json
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.ckpt import manifest as mf
from distributed_tensorflow_framework_torch.ckpt.async_saver import (
    AsyncSaver,
    AsyncSaverError,
)
from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
    CheckpointManager,
)
from distributed_tensorflow_framework_torch.cli import export as port_export
from distributed_tensorflow_framework_torch.cli import train as port_cli
from distributed_tensorflow_framework_torch.core import faults, supervision
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import shard
from distributed_tensorflow_framework_torch.data.pipeline import HostDataset
from distributed_tensorflow_framework_torch.models.convert import (
    flax_to_state_dict,
)
from distributed_tensorflow_framework_torch.train import hooks as hooks_lib
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_tpu.ckpt import manifest as jax_mf
from distributed_tensorflow_framework_tpu.core.config import (
    MeshConfig,
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.core.mesh import initialize_runtime
from distributed_tensorflow_framework_tpu.data import shard as jax_shard
from distributed_tensorflow_framework_tpu.train import Trainer as JaxTrainer
from tests.test_torch_hygiene import torch_threads  # noqa: F401

TINY = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=2", "model.num_heads=2", "model.mlp_dim=128",
    "model.max_seq_len=32", "model.dtype=float32",
    "model.attention_impl=pallas", "model.dropout_rate=0.1",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=32",
    "data.global_batch_size=4", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=100",
    "optimizer.schedule=linear", "optimizer.grad_clip_norm=1.0",
    "train.log_interval=1", "train.eval_steps=0", "mesh.data=1",
]


@pytest.fixture(autouse=True)
def _clean_faults_and_preemption():
    yield
    faults.install(faults.FaultPlan())
    supervision.reset_preemption()


def tiny_config(ckpt_dir=None, *over):
    extra = [f"checkpoint.directory={ckpt_dir or ''}"]
    return port_config(overrides=TINY + extra + list(over))


def train_run(ckpt_dir, steps, *over, build_only=False):
    cfg = tiny_config(ckpt_dir, f"train.total_steps={steps}", *over)
    trainer = Trainer(cfg, device="cpu")
    trainer.build()
    if not build_only:
        trainer.train()
    return trainer


def losses_of(directory):
    with open(os.path.join(directory, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    return {e["step"]: e["metrics"]["loss"] for e in events
            if e["kind"] == "train_step"}


def assert_states_equal(a, b):
    assert a.step == b.step
    for (ka, ta), (kb, tb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb), ka
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["count"] == ob["count"]
    assert oa["inner"]["state"].keys() == ob["inner"]["state"].keys()
    for i, slots in oa["inner"]["state"].items():
        for name, t in slots.items():
            assert torch.equal(t, ob["inner"]["state"][i][name]), (i, name)
    assert torch.equal(a.dropout_generator.get_state(),
                       b.dropout_generator.get_state())


# ------------------------------------------------------------ resume

@pytest.mark.parametrize("async_save", [False, True])
def test_resume_is_bit_exact(tmp_path, async_save):
    full = train_run(str(tmp_path / "full"), 6)
    leg = f"checkpoint.async_save={str(async_save).lower()}"
    a = train_run(str(tmp_path / "ckpt"), 3, leg)
    assert a._ckpt_manager.latest_step() == 3
    b = train_run(str(tmp_path / "ckpt"), 6, leg, build_only=True)
    assert b.host_step == 3 and b.restored_step == 3
    b.train()
    assert_states_equal(b.state, full.state)
    assert b.state.optimizer.count == 6
    split = {**losses_of(tmp_path / "ckpt")}
    assert split == losses_of(tmp_path / "full")
    assert sorted(split) == [1, 2, 3, 4, 5, 6]


def test_rerun_of_a_finished_run_trains_nothing(tmp_path):
    d = str(tmp_path / "ckpt")
    first = train_run(d, 4)
    again = train_run(d, 4)
    assert again.restored_step == 4
    assert_states_equal(again.state, first.state)
    with open(tmp_path / "ckpt" / "events.jsonl") as fh:
        gates = [json.loads(x) for x in fh
                 if json.loads(x)["kind"] == "data_state"]
    assert gates[-1]["step"] == 4
    assert gates[-1]["extra"]["plan"]["action"] == "resume"


def test_restore_specific_step(tmp_path):
    d = str(tmp_path / "ckpt")
    t = train_run(d, 6, "checkpoint.save_interval_steps=3")
    assert t._ckpt_manager.all_steps() == [3, 6]
    pinned = train_run(d, 6, "checkpoint.restore_step=3", build_only=True)
    assert pinned.host_step == 3
    assert not torch.equal(pinned.state.model.state_dict()["head.mlm_bias"],
                           t.state.model.state_dict()["head.mlm_bias"])
    with pytest.raises(ValueError, match="fresh checkpoint.directory"):
        pinned.train()
    with pytest.raises(ValueError, match="restore_step=5"):
        train_run(d, 6, "checkpoint.restore_step=5", build_only=True)
    with pytest.raises(ValueError, match="restoring is disabled"):
        train_run(None, 6, "checkpoint.restore_step=3", build_only=True)


def test_fused_qkv_layout_mismatch_names_the_fix(tmp_path):
    d = str(tmp_path / "ckpt")
    train_run(d, 2, "model.fused_qkv=false")
    with pytest.raises(ValueError, match=r"model\.fused_qkv") as exc:
        train_run(d, 2, "model.fused_qkv=true", build_only=True)
    assert "transplant" in str(exc.value)
    assert train_run(d, 2, "model.fused_qkv=false",
                     build_only=True).restored_step == 2


def test_generator_of_another_device_type_is_refused(tmp_path):
    d = str(tmp_path / "ckpt")
    train_run(d, 2)
    meta_path = tmp_path / "ckpt" / "2" / "meta.json"
    meta = json.loads(meta_path.read_text())
    assert meta["generator_device"] == "cpu"
    meta["generator_device"] = "cuda"
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="cuda generator.*on cpu"):
        train_run(d, 2, "checkpoint.verify_restore=false", build_only=True)


def test_max_to_keep_collects_old_steps(tmp_path):
    d = str(tmp_path / "ckpt")
    t = train_run(d, 8, "checkpoint.save_interval_steps=2",
                  "checkpoint.max_to_keep=2")
    assert t._ckpt_manager.all_steps() == [6, 8]
    assert sorted(mf.step_dirs(d)) == [6, 8]


def test_heartbeat_records_the_finished_step(tmp_path):
    train_run(str(tmp_path / "ckpt"), 2)
    beat = json.loads((tmp_path / "ckpt" / "heartbeat.json").read_text())
    assert beat["status"] == "finished"
    assert beat["last_completed_step"] == 2
    assert beat["pid"] == os.getpid()


# --------------------------------------------------------- integrity

def _two_checkpoints(d):
    t = train_run(d, 6, "checkpoint.save_interval_steps=3",
                  "checkpoint.async_save=false")
    assert t._ckpt_manager.all_steps() == [3, 6]
    return t


def test_save_commits_manifest(tmp_path):
    d = str(tmp_path / "ckpt")
    _two_checkpoints(d)
    for step in (3, 6):
        step_dir = os.path.join(d, str(step))
        manifest = mf.read_manifest(step_dir)
        assert manifest["step"] == step and manifest["file_count"] == 3
        assert mf.verify_step_dir(step_dir, manifest) == []
        record = manifest[shard.DATA_RECORD_KEY]
        assert record["position"]["consumed"] == step
    assert mf.committed_steps(d) == [3, 6]
    assert mf.latest_committed_step(d) == 6


def test_torn_checkpoint_quarantined_with_fallback(tmp_path):
    d = str(tmp_path / "ckpt")
    _two_checkpoints(d)
    assert faults.corrupt_checkpoint_dir(os.path.join(d, "6")) is not None
    t = train_run(d, 6, build_only=True)
    assert t.host_step == 3
    record = json.loads((tmp_path / "ckpt" / "6.corrupt" /
                         "quarantine.json").read_text())
    assert record["step"] == 6
    assert record["reason"] == "integrity verification failed"
    assert any("truncated" in e for e in record["errors"])
    assert t._ckpt_manager.all_steps() == [3]
    with open(tmp_path / "ckpt" / "events.jsonl") as fh:
        events = [json.loads(line) for line in fh]
    kinds = [e["kind"] for e in events]
    assert "ckpt_quarantined" in kinds
    fallback = next(e for e in events if e["kind"] == "restore_fallback")
    assert fallback["health"]["from_step"] == 6
    assert fallback["health"]["to_step"] == 3


def test_uncommitted_step_skipped(tmp_path):
    d = str(tmp_path / "ckpt")
    _two_checkpoints(d)
    os.remove(os.path.join(d, "6", mf.MANIFEST_NAME))
    assert train_run(d, 6, build_only=True).host_step == 3
    record = json.loads((tmp_path / "ckpt" / "6.corrupt" /
                         "quarantine.json").read_text())
    assert record["reason"] == "uncommitted save"


def test_legacy_store_without_manifests_restores(tmp_path):
    d = str(tmp_path / "ckpt")
    _two_checkpoints(d)
    for step in (3, 6):
        os.remove(os.path.join(d, str(step), mf.MANIFEST_NAME))
    t = train_run(d, 6, build_only=True)
    assert t.host_step == 6
    assert t._ckpt_manager.all_steps() == [3, 6]


def test_explicit_restore_step_fails_loudly_on_corruption(tmp_path):
    d = str(tmp_path / "ckpt")
    _two_checkpoints(d)
    faults.corrupt_checkpoint_dir(os.path.join(d, "3"))
    with pytest.raises(ValueError, match="integrity verification"):
        train_run(d, 6, "checkpoint.restore_step=3", build_only=True)


def test_quarantine_suffix_collision(tmp_path):
    root = str(tmp_path)
    for _ in range(2):
        os.makedirs(os.path.join(root, "5"))
        assert mf.quarantine(root, 5, "test", ["e"]) is not None
    assert os.path.isdir(os.path.join(root, "5.corrupt"))
    assert os.path.isdir(os.path.join(root, "5.corrupt.1"))
    assert mf.quarantine(root, 5, "gone") is None


def test_serving_manifest_is_unchanged(tmp_path):
    """Artifacts call write_manifest without extra fields: the record has
    exactly the reserved keys, and an extra field cannot shadow one."""
    (tmp_path / "a.bin").write_bytes(b"x")
    mf.write_manifest(str(tmp_path), 7)
    assert set(mf.read_manifest(str(tmp_path))) == {
        "schema", "step", "created_t", "file_count", "files"}
    with pytest.raises(ValueError, match="reserved"):
        mf.build_manifest(str(tmp_path), 7, extra={"step": 1})


# --------------------------------------------------------- async saver

def test_overlapping_saves_serialize():
    saver = AsyncSaver()
    running, release = threading.Event(), threading.Event()
    order = []

    def slow_job():
        running.set()
        assert release.wait(timeout=10)
        order.append("first")

    assert saver.submit(slow_job, step=1) < 1.0
    assert running.wait(timeout=10)
    timer = threading.Timer(0.2, release.set)
    timer.start()
    try:
        blocked = saver.submit(lambda: order.append("second"), step=2)
    finally:
        timer.cancel()
    assert blocked >= 0.15 and order[0] == "first"
    saver.wait()
    assert order == ["first", "second"]
    assert saver.submitted == 2 and saver.completed == 2 and saver.idle
    saver.close()


def test_wait_is_a_barrier():
    saver = AsyncSaver()
    done = []
    saver.submit(lambda: (time.sleep(0.1), done.append(1)))
    saver.wait()
    assert done == [1]
    saver.close()


def test_background_error_surfaces_on_training_thread():
    saver = AsyncSaver()

    def boom():
        raise OSError("disk full")

    saver.submit(boom, step=7)
    with pytest.raises(AsyncSaverError) as exc:
        saver.wait()
    assert exc.value.step == 7
    assert isinstance(exc.value.__cause__, OSError)
    saver.submit(lambda: None, step=8)  # the pipe is usable again
    saver.wait()
    saver.close()


def test_close_drains_and_raises_pending_error():
    saver = AsyncSaver()
    done = []
    saver.submit(lambda: done.append(1))
    saver.close()
    assert done == [1]
    with pytest.raises(RuntimeError, match="closed"):
        saver.submit(lambda: None)
    saver2 = AsyncSaver()
    saver2.submit(lambda: (_ for _ in ()).throw(ValueError("late")), step=3)
    deadline = time.monotonic() + 10
    while not saver2.idle and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(AsyncSaverError):
        saver2.close()


def test_async_save_emits_blocked_below_total(tmp_path):
    d = tmp_path / "ckpt"
    train_run(str(d), 4, "checkpoint.save_interval_steps=2")
    with open(d / "events.jsonl") as fh:
        saves = [json.loads(x) for x in fh
                 if json.loads(x)["kind"] == "ckpt_save"]
    assert [e["step"] for e in saves] == [2, 4]
    for e in saves:
        assert e["extra"]["async_save"] is True
        m = e["metrics"]
        assert 0.0 <= m["ckpt_save_blocked_ms"] < m["ckpt_save_total_ms"]


def test_exit_barrier_flushes_inflight_commit(tmp_path):
    d = str(tmp_path / "ckpt")
    t = train_run(d, 4, "checkpoint.save_interval_steps=2")
    for step in (2, 4):
        step_dir = os.path.join(d, str(step))
        assert mf.verify_step_dir(step_dir) == []
    assert t._ckpt_manager._saver.idle
    t._ckpt_manager.save(99, t.state, dataset_state=t.data_ckpt_state)
    t._ckpt_manager.wait_until_finished()
    assert mf.read_manifest(os.path.join(d, "99")) is not None
    t._ckpt_manager.close()


def test_queued_state_is_snapshotted(tmp_path, monkeypatch):
    """The async save copies the tensors and the iterator state at the
    step boundary: a step trained and the dict cleared after ``save``
    returns, before the commit runs, change nothing in the committed
    step."""
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    d = str(tmp_path / "ckpt")
    t = train_run(d, 2)
    mgr = t._ckpt_manager
    ref = {k: v.clone() for k, v in t.state.model.state_dict().items()}
    commit, go = mgr._write_and_commit, threading.Event()

    def held(*args, **kwargs):
        assert go.wait(10)
        commit(*args, **kwargs)

    monkeypatch.setattr(mgr, "_write_and_commit", held)
    ds_state = dict(t.data_ckpt_state)
    assert mgr.save(50, t.state, dataset_state=ds_state)
    ds_state.clear()
    t.builder.train_step(t.state, to_device(next(t.dataset),
                                            torch.device("cpu")))
    assert not torch.equal(t.state.model.state_dict()["head.mlm_bias"],
                           ref["head.mlm_bias"])
    go.set()
    mgr.wait_until_finished()
    saved = torch.load(os.path.join(d, "50", "state.pt"), weights_only=True)
    for k, v in ref.items():
        assert torch.equal(saved["model"][k], v), k
    with open(os.path.join(d, "50", "data_iter.json")) as fh:
        assert json.load(fh)["consumed"] == 2
    mgr.close()


# ------------------------------------------------------- data state

def _counting_dataset():
    def make_iter(state):
        state.setdefault("n", 0)
        while True:
            state["n"] += 1
            yield {"x": np.full((2,), state["n"], np.int32)}

    return HostDataset(make_iter, element_spec={"x": ((2,), np.int32)})


def test_synthetic_state_round_trip_resumes_bit_exact():
    cfg = tiny_config()
    from distributed_tensorflow_framework_torch.data import get_dataset

    ds = get_dataset(cfg.data)
    for _ in range(3):
        next(ds)
    snap = ds.state()
    expected = [next(ds) for _ in range(3)]
    fresh = get_dataset(cfg.data)
    fresh.restore(snap)
    for want in expected:
        got = next(fresh)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert fresh.state() == ds.state()
    assert ds.repartition == shard.REPARTITION_INVARIANT


def test_skip_records_survive_round_trip_and_discard_on_replay():
    ds = _counting_dataset()
    for _ in range(3):
        next(ds)
    ds.record_skipped([4, 5])
    snap = ds.state()
    assert snap["batches_skipped"] == [4, 5]
    fresh = _counting_dataset()
    fresh.restore(snap)
    assert int(next(fresh)["x"][0]) == 6
    assert fresh.state()["consumed"] == 6
    assert "batches_skipped" not in fresh.state()


def test_record_skipped_rebinds_not_mutates():
    ds = _counting_dataset()
    next(ds)
    ds.record_skipped([2])
    queued = ds.state()
    ds.record_skipped([3])
    assert queued["batches_skipped"] == [2]
    assert ds.state()["batches_skipped"] == [2, 3]


def test_skip_records_merge_sorted_union():
    ds = _counting_dataset()
    ds.record_skipped([5, 3])
    ds.record_skipped([4, 3])
    assert ds.state()["batches_skipped"] == [3, 4, 5]


STATES = [{"step": 3, "consumed": 3},
          {"step": 7, "consumed": 9, "batches_skipped": [10, 11]},
          {"epoch": 1, "batch_in_epoch": 4, "emitted": 12, "seed": [1, 2]}]


def _gate(fn, err, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except err:
        return "refused"


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("repartition", [shard.REPARTITION_INVARIANT,
                                         shard.REPARTITION_NONE])
def test_data_state_record_and_gate_match_jax(state, repartition):
    assert shard.state_digest(state) == jax_shard.state_digest(state)
    for count in (1, 2):
        ours = shard.data_state_record(state, process_count=count,
                                       repartition=repartition, watermark=2)
        assert ours == jax_shard.data_state_record(
            state, process_count=count, repartition=repartition,
            watermark=2)
        for strict in (True, False):
            got = _gate(shard.check_restore_data, shard.DataShardError,
                        ours, state, process_count=1, resume_strict=strict)
            want = _gate(jax_shard.check_restore_data,
                         jax_shard.DataShardError, ours, state,
                         process_count=1, resume_strict=strict)
            assert got == want, (count, strict)
    tampered = {**state, "step": -1}
    for fn, err in ((shard.check_restore_data, shard.DataShardError),
                    (jax_shard.check_restore_data, jax_shard.DataShardError)):
        with pytest.raises(err, match="does not match"):
            fn(ours, tampered, process_count=2)
    assert shard.check_restore_data(None, state, process_count=1) is None


def test_jax_manifest_code_reads_the_port_step_dir(tmp_path):
    """The port's commit record is the JAX package's: its manifest code
    lists the step as committed and verifies it, and rebuilding the
    manifest with the JAX builder gives the same record (but the time)."""
    d = str(tmp_path / "ckpt")
    train_run(d, 2)
    step_dir = os.path.join(d, "2")
    ours = mf.read_manifest(step_dir)
    assert jax_mf.committed_steps(d) == [2]
    assert jax_mf.verify_step_dir(step_dir) == []
    theirs = jax_mf.build_manifest(
        step_dir, 2, extra={shard.DATA_RECORD_KEY:
                            ours[shard.DATA_RECORD_KEY]})
    for record in (ours, theirs):
        record.pop("created_t")
    assert ours == theirs
    data_state = json.loads(open(os.path.join(step_dir,
                                              "data_iter.json")).read())
    assert jax_shard.check_restore_data(
        ours[shard.DATA_RECORD_KEY], data_state,
        process_count=1)["action"] == "resume"


# ------------------------------------------ eval-only, export, SIGTERM

def _cli(ckpt_dir, *over, extra=()):
    overrides = TINY + [f"checkpoint.directory={ckpt_dir}", *over]
    return [*extra, "--device", "cpu",
            *sum((["--set", o] for o in overrides), [])]


def test_eval_only_equals_the_trainers_final_eval(tmp_path):
    d = str(tmp_path / "ckpt")
    assert port_cli.main(_cli(d, "train.total_steps=3",
                              "train.eval_steps=2")) == 0
    assert port_cli.main(_cli(d, "train.total_steps=3", "train.eval_steps=2",
                              extra=["--eval-only"])) == 0
    with open(tmp_path / "ckpt" / "events.jsonl") as fh:
        evals = [json.loads(x) for x in fh if json.loads(x)["kind"] == "eval"]
    assert [e["step"] for e in evals] == [3, 3]
    assert evals[0]["metrics"] == evals[1]["metrics"]
    assert evals[0]["metrics"]["eval_examples"] > 0


def test_eval_only_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(ValueError, match="--eval-only needs a committed"):
        port_cli.main(_cli(str(tmp_path / "empty"), "train.total_steps=3",
                           extra=["--eval-only"]))


def test_export_serves_the_trained_model(tmp_path):
    from distributed_tensorflow_framework_torch.serve.engine import (
        InferenceEngine,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        load_artifact,
    )

    d = str(tmp_path / "ckpt")
    trainer = train_run(d, 3)
    out = str(tmp_path / "artifact")
    assert port_export.main(_cli(d, extra=["--output", out])) == 0
    art = load_artifact(out)
    assert art.step == 3 and art.meta["source"]["checkpoint_dir"] == d
    cfg = tiny_config(d, "serve.seq_buckets=[32]", "serve.max_batch_size=2")
    engine = InferenceEngine(art, cfg.serve, device="cpu")
    try:
        ids = np.random.default_rng(0).integers(0, 512, 32).astype(np.int32)
        got = engine.predict({"input_ids": ids}, timeout=60)
    finally:
        engine.drain(30)
    model = trainer.state.model.eval()
    with torch.inference_mode():
        want = model(torch.from_numpy(ids[None]).long(),
                     torch.ones(1, 32, dtype=torch.long)).numpy()
    # The engine pads to its row bucket: other GEMM shapes, so the
    # serving tests' f32 tolerance.
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="no committed checkpoint"):
        port_export.main(_cli(str(tmp_path / "none"),
                              extra=["--output", str(tmp_path / "a2")]))


class _SigtermAt(hooks_lib.BaseHook):
    """Sends this process a SIGTERM at ``step``, once the CLI's handler is
    armed (never otherwise: the default disposition would end the test
    process)."""

    def __init__(self, step):
        self.step = step

    def after_step(self, trainer, step, metrics):
        if step == self.step:
            assert signal.getsignal(signal.SIGTERM) is \
                supervision._on_sigterm, "the SIGTERM handler is not armed"
            os.kill(os.getpid(), signal.SIGTERM)


def test_sigterm_saves_and_exits_83(tmp_path, monkeypatch):
    """The SIGTERM contract in process: the handler is armed around
    train(), the flag set at step 2 stops the loop at the next boundary,
    the final save commits step 2, the CLI returns 83, and a fresh run
    restores step 2 and finishes."""
    d = str(tmp_path / "ckpt")
    hooks = Trainer.default_hooks
    monkeypatch.setattr(Trainer, "default_hooks",
                        lambda self: hooks(self) + [_SigtermAt(2)])
    before = signal.getsignal(signal.SIGTERM)
    assert port_cli.main(_cli(d, "train.total_steps=5")) == \
        supervision.GRACEFUL_PREEMPT_RC
    assert signal.getsignal(signal.SIGTERM) == before
    assert mf.committed_steps(d) == [2]
    beat = json.loads((tmp_path / "ckpt" / "heartbeat.json").read_text())
    assert beat["status"] == "preempted"
    supervision.reset_preemption()
    monkeypatch.setattr(Trainer, "default_hooks", hooks)
    again = train_run(d, 5)
    assert again.restored_step == 2 and again.host_step == 5


# --------------------------------------------------- against the JAX side

def test_checkpointed_runs_match_jax_trainer(tmp_path):
    """A JAX Trainer and the port's, each 4 steps in two legs (save at 2,
    a fresh trainer restores and trains to 4), from the same weights and
    data: the same loss at every step within rtol 1e-5."""
    over = [o for o in TINY if not o.startswith(("model.dropout_rate",
                                                 "model.attention_impl"))]
    # XLA attention: the Pallas kernel in interpret mode would double the
    # JAX side's compile time, and attention parity is held elsewhere
    # (tests/test_torch_flash_attention*.py).
    over += ["model.dropout_rate=0.0", "model.attention_impl=xla",
             "checkpoint.async_save=false"]
    runtime = initialize_runtime(MeshConfig(data=1),
                                 devices=jax.devices()[:1])
    losses = {}
    for side in ("jax", "port"):
        d = str(tmp_path / side)
        for steps in (2, 4):
            cfg_over = over + [f"checkpoint.directory={d}",
                               f"train.total_steps={steps}"]
            if side == "jax":
                t = JaxTrainer(jax_config(overrides=cfg_over), runtime)
                t.build()
                if steps == 2:
                    params = jax.device_get(t.state.params)
            else:
                t = Trainer(port_config(overrides=cfg_over), device="cpu")
                t.build()
                if steps == 2:
                    t.state.model.load_state_dict(flax_to_state_dict(params))
            assert t.host_step == steps - 2
            t.train()
            if side == "jax":
                t._ckpt_manager.close()
        losses[side] = losses_of(d)
    assert sorted(losses["port"]) == [1, 2, 3, 4]
    for step, ref in losses["jax"].items():
        np.testing.assert_allclose(losses["port"][step], ref, rtol=1e-5,
                                   err_msg=f"step {step}")
