"""The mesh gate on restore and export, held to the JAX package's
(tests/test_reshard.py).

The axis helpers and ``MeshTopologyError``'s text equal the JAX
functions'. Two-rank gangs of the port's trainer (gloo on the CPU, the
shared gang helper) write checkpoints under ``{data: 2}``, ``{model: 2}``
and ``{pipe: 2}`` and a LeNet ``{data: 2}`` run under ``shard_map`` on
the int8 wire (its error-feedback residual rows); then one process:
  * finds the mesh record in every manifest;
  * is refused each checkpoint without ``checkpoint.allow_reshard``, with
    JAX's message for the same pair of meshes, and the export without
    ``serve.allow_reshard``, with JAX's export hint;
  * with the knob restores tiny BERT's whole tensors and LeNet's folded
    residual bit for bit as ``fold_residual`` gives them, and emits
    ``ckpt_resharded`` whose axes are what JAX's ``plan_reshard`` gives
    for the same meshes;
  * restores a manifest without a record with the warning, and the same
    mesh with no gate; ``validate_restored`` names drift.

ZeRO's stacked slots cannot restore into one process (ZeRO needs two
replicas, in both packages); their refold under the gate is
tests/test_torch_zero.py's 4 → 2 rank restore.
"""

from __future__ import annotations

import json
import logging
import os
import shutil

import pytest
import torch

from distributed_tensorflow_framework_torch.ckpt import manifest as mf
from distributed_tensorflow_framework_torch.ckpt import reshard
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.core.mesh import MESH_AXES
from distributed_tensorflow_framework_torch.serve.export import (
    export_checkpoint,
)
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_tpu.ckpt import reshard as jreshard
from tests.test_torch_gang import Gang
from tests.test_torch_hygiene import torch_threads  # noqa: F401

TINY = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=2", "model.num_heads=2", "model.mlp_dim=128",
    "model.max_seq_len=32", "model.dtype=float32",
    "model.attention_impl=pallas", "model.dropout_rate=0.0",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=32",
    "data.global_batch_size=4", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=1",
    "optimizer.schedule=linear", "train.log_interval=1",
    "train.eval_steps=0", "train.total_steps=2",
    "checkpoint.async_save=false", "resilience.rollback=false",
]
LENET = [
    "model.name=lenet5", "model.dtype=float32", "data.name=synthetic_images",
    "data.image_size=28", "data.channels=1", "data.seed=4",
    "data.global_batch_size=8", "optimizer.name=sgd_momentum",
    "optimizer.learning_rate=0.1", "optimizer.momentum=0.9",
    "train.total_steps=2", "train.log_interval=1", "train.eval_steps=0",
    "checkpoint.async_save=false", "resilience.rollback=false",
    "train.spmd_mode=shard_map", "parallel.collective_dtype=int8",
    "parallel.error_feedback=true", "parallel.collective_block_size=64",
]
# name → the two-rank gang's overrides
WORLDS = {
    "data2": TINY + ["mesh.data=2"],
    "model2": TINY + ["mesh.data=1", "mesh.model=2"],
    "pipe2": TINY + ["mesh.data=1", "mesh.pipe=2", "model.pipeline_stages=2"],
    "lenet": LENET + ["mesh.data=2"],
}
ONE = {a: 1 for a in MESH_AXES}


def _argv(ckpt: str, overrides: list[str]) -> list[str]:
    return ["-m", "distributed_tensorflow_framework_torch.cli.train",
            "--device", "cpu",
            *sum((["--set", o] for o in overrides
                  + [f"checkpoint.directory={ckpt}"]), [])]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's checkpoint directory, the gangs run together."""
    root = tmp_path_factory.mktemp("reshard")
    gangs = {name: Gang(_argv(str(root / name), over),
                        [str(root / f"{name}{r}.log") for r in range(2)])
             for name, over in WORLDS.items()}
    for gang in gangs.values():
        gang.join(timeout=300)
    return {name: str(root / name) for name in WORLDS}


def _copy(src: str, tmp_path) -> str:
    dst = str(tmp_path / "ck")
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "events*", "heartbeat*", "supervisor*"))
    return dst


def _one_process(name: str, ckpt: str, *extra) -> Trainer:
    """The world's config in one process (mesh and stages back to 1)."""
    over = [o for o in WORLDS[name]
            if not o.startswith(("mesh.", "model.pipeline_stages"))]
    return Trainer(port_config(overrides=over + [
        f"checkpoint.directory={ckpt}", *extra]), device="cpu",
        log_dir=os.path.dirname(ckpt))


def _record(ckpt: str, step: int = 2) -> dict:
    return mf.read_manifest(os.path.join(ckpt, str(step)))[
        reshard.MESH_RECORD_KEY]


# ---------------------------------------------------------- the helpers

AXES = [{}, {"data": 8}, {"data": 8, "fsdp": 1}, {"fsdp": 2, "pipe": 4},
        {"model": 2, "data": 1, "seq": 2}, {"expert": 4, "custom": 3},
        {"custom": 1}, dict(ONE)]


@pytest.mark.parametrize("axes", AXES)
def test_axis_helpers_equal_jax(axes):
    assert reshard.describe_axes(axes) == jreshard.describe_axes(axes)
    assert reshard.normalize_axes(axes) == jreshard.normalize_axes(axes)
    for other in AXES + [None]:
        assert reshard.axes_equal(axes, other) == \
            jreshard.axes_equal(axes, other)


@pytest.mark.parametrize("hint", [None, "Another knob."])
def test_mesh_topology_error_text_equals_jax(hint):
    ours = reshard.MeshTopologyError({"data": 8}, {"data": 4},
                                     directory="/ck", step=30, hint=hint)
    theirs = jreshard.MeshTopologyError({"data": 8}, {"data": 4},
                                        directory="/ck", step=30, hint=hint)
    assert str(ours) == str(theirs)
    assert (ours.saved_axes, ours.requested_axes, ours.step, ours.hint) == \
        (theirs.saved_axes, theirs.requested_axes, theirs.step, theirs.hint)


# ----------------------------------------------------------- the record

def test_manifest_records_the_mesh(worlds, tmp_path):
    trainer = _one_process("data2", str(tmp_path / "single"))
    trainer.build()
    trainer.train()
    trainer._ckpt_manager.close()
    one = _record(str(tmp_path / "single"))
    assert one["axes"] == ONE
    assert (one["device_count"], one["process_count"]) == (1, 1)
    assert one["spec_digest"] == reshard.spec_digest(trainer.state)
    for name, want in (("data2", {"data": 2}), ("model2", {"model": 2}),
                       ("pipe2", {"pipe": 2}), ("lenet", {"data": 2})):
        rec = _record(worlds[name])
        assert rec["axes"] == {**ONE, **want}, name
        assert (rec["device_count"], rec["process_count"]) == (2, 2)
        assert len(rec["spec_digest"]) == 64
    # The layouts differ, so do the digests.
    assert len({_record(worlds[n])["spec_digest"]
                for n in ("data2", "model2", "pipe2")}) == 3


# -------------------------------------------------------------- refusal

@pytest.mark.parametrize("name", ["data2", "model2", "pipe2"])
def test_restore_refuses_another_mesh_without_the_knob(worlds, name,
                                                       tmp_path):
    ckpt = _copy(worlds[name], tmp_path)
    saved = _record(ckpt)["axes"]
    with pytest.raises(reshard.MeshTopologyError) as ei:
        _one_process(name, ckpt).build()
    want = jreshard.MeshTopologyError(saved, dict(ONE), directory=ckpt,
                                      step=2)
    assert str(ei.value) == str(want)
    assert reshard.describe_axes(saved) in str(ei.value)
    assert "{1 device}" in str(ei.value)


def test_export_refuses_and_names_the_serve_knob(worlds, tmp_path):
    from distributed_tensorflow_framework_tpu.serve.export import (
        RESHARD_HINT,
    )

    ckpt = _copy(worlds["data2"], tmp_path)
    cfg = port_config(overrides=TINY + [f"checkpoint.directory={ckpt}"])
    with pytest.raises(reshard.MeshTopologyError) as ei:
        export_checkpoint(cfg, str(tmp_path / "art"), device="cpu")
    want = jreshard.MeshTopologyError(
        {**ONE, "data": 2}, dict(ONE), directory=ckpt, step=2,
        hint=RESHARD_HINT)
    assert str(ei.value) == str(want)
    assert "serve.allow_reshard" in str(ei.value)
    cfg.serve.allow_reshard = True
    assert os.path.isdir(export_checkpoint(cfg, str(tmp_path / "art2"),
                                           device="cpu"))


# ----------------------------------------------------- with the knob on

def _resharded(log_dir: str) -> list[dict]:
    with open(os.path.join(log_dir, "events.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    return [e["extra"] for e in events if e["kind"] == "ckpt_resharded"]


def _jax_plan_axes(saved: dict) -> tuple[dict, dict]:
    """JAX's plan_reshard for the saved record onto a one-device mesh."""
    import jax

    from distributed_tensorflow_framework_tpu.core.config import (
        load_config as jax_config,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.data import get_dataset
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.train.step import StepBuilder

    cfg = jax_config(base={
        "mesh": {"data": 1},
        "model": {"name": "lenet5", "num_classes": 10, "dtype": "float32"},
        "data": {"name": "synthetic_images", "global_batch_size": 8,
                 "image_size": 28, "channels": 1}})
    mesh = create_mesh(cfg.mesh, devices=jax.devices()[:1])
    template = StepBuilder(cfg, mesh).init_state(
        0, to_global(next(get_dataset(cfg.data)), mesh))
    plan = jreshard.plan_reshard(saved, template, step=2)
    return plan["from_axes"], plan["to_axes"]


def test_reshard_bert_data2_into_one_process(worlds, tmp_path):
    ckpt = _copy(worlds["data2"], tmp_path)
    stored = torch.load(os.path.join(ckpt, "2", "state.pt"),
                        weights_only=True)
    trainer = _one_process("data2", ckpt, "checkpoint.allow_reshard=true")
    trainer.build()
    assert trainer.restored_step == 2
    for key, t in trainer.state.model.state_dict().items():
        assert torch.equal(t, stored["model"][key]), key
    trainer.writer.close()
    (event,) = _resharded(str(tmp_path))
    saved = _record(ckpt)
    assert (event["from_axes"], event["to_axes"]) == _jax_plan_axes(saved)
    assert event["to_axes"] == ONE
    assert event["leaf_count"] == len(stored["model"])
    assert event["from_spec_digest"] == saved["spec_digest"]
    assert event["to_spec_digest"] == reshard.spec_digest(trainer.state)
    n = len(dict(trainer.state.model.named_parameters()))
    assert event["respec_agreement"] == f"{n}/{n}"


def test_reshard_lenet_folds_the_residual(worlds, tmp_path):
    ckpt = _copy(worlds["lenet"], tmp_path)
    stored = torch.load(os.path.join(ckpt, "2", "state.pt"),
                        weights_only=True)
    trainer = _one_process("lenet", ckpt, "checkpoint.allow_reshard=true")
    trainer.build()
    state = trainer.state
    assert trainer.restored_step == 2
    # The two rows folded into one, each leaf's sum kept.
    folded = reshard.fold_residual(stored["collective_residual"], 1)
    assert state.collective_residual.keys() == folded.keys()
    for key, r in state.collective_residual.items():
        assert torch.equal(r, folded[key][0]), key
        assert not torch.equal(stored["collective_residual"][key][0],
                               stored["collective_residual"][key][1]), key
    for key, t in state.model.state_dict().items():
        assert torch.equal(t, stored["model"][key]), key
    trainer.writer.close()
    (event,) = _resharded(str(tmp_path))
    assert event["from_axes"] == {**ONE, "data": 2}
    assert event["to_axes"] == ONE


# ---------------------------------------------- legacy and the same mesh

def test_legacy_manifest_restores_with_a_warning(worlds, tmp_path, caplog):
    ckpt = _copy(worlds["data2"], tmp_path)
    path = os.path.join(ckpt, "2", mf.MANIFEST_NAME)
    with open(path) as fh:
        record = json.load(fh)
    record.pop(reshard.MESH_RECORD_KEY)
    with open(path, "w") as fh:
        json.dump(record, fh)
    with caplog.at_level(logging.WARNING):
        trainer = _one_process("data2", ckpt)
        trainer.build()
    assert trainer.restored_step == 2
    assert "no mesh topology record" in caplog.text
    trainer.writer.close()
    assert _resharded(str(tmp_path)) == []


def test_same_mesh_restores_with_no_gate(tmp_path):
    ckpt = str(tmp_path / "ck")
    first = _one_process("data2", ckpt)
    first.build()
    first.train()
    first._ckpt_manager.close()
    first.writer.close()
    again = _one_process("data2", ckpt, "train.total_steps=3")
    again.build()  # allow_reshard is off
    assert again.restored_step == 2
    again.writer.close()
    assert _resharded(str(tmp_path)) == []


def test_validate_restored_names_drift():
    template = {"model": {"a": torch.zeros(4, 2), "b": torch.zeros(3)}}
    assert reshard.validate_restored(template, {
        "model": {"a": torch.ones(4, 2), "b": torch.ones(3)}}, step=5) == 2
    with pytest.raises(ValueError, match=r"changed global leaf shapes "
                       r"\(1 of 2\).*'a'.*\(4, 2\) vs restored \(2, 4\)"):
        reshard.validate_restored(template, {
            "model": {"a": torch.zeros(2, 4), "b": torch.zeros(3)}}, step=5)
    with pytest.raises(ValueError, match="dtype"):
        reshard.validate_restored(template, {
            "model": {"a": torch.zeros(4, 2), "b": torch.zeros(
                3, dtype=torch.float64)}}, step=5)
    with pytest.raises(ValueError, match="tree structure.*missing"):
        reshard.validate_restored(template, {"model": {"a": torch.zeros(
            4, 2)}}, step=5)
