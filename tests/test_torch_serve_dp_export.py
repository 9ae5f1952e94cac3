"""The export onto the serving mesh, held to the JAX export.

Two gloo ranks of the port's trainer (the shared gang helper) write a
LeNet checkpoint under ``{data: 2}`` with the EMA on. ``export_checkpoint``
resolves the serving mesh ``{data: n}`` (the other axes 1) from its
``devices`` or from ``serve.data``, as the JAX export does from
``serving_mesh``, and gates the checkpoint against it:
  * at ``{data: 2}`` the checkpoint exports without
    ``serve.allow_reshard``, records ``serve_mesh`` and the port's
    ``sharding_spec_digest``, and serves at ``dp`` 2;
  * at ``serve.data=1`` it raises ``MeshTopologyError`` with the JAX
    message and ``RESHARD_HINT``, and at ``{data: 4}`` too, unless
    ``serve.allow_reshard``;
  * ``serve.data=2`` where one device is visible raises MeshSizeError, as
    ``serving_mesh`` does;
  * the ``source`` record has the JAX export's keys: a JAX LeNet of the
    same config, trained on the conftest's eight devices, exported at
    ``serve.data=8``.
The digests never compare with JAX's (each hashes its own layout).
"""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.ckpt import reshard
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.core.mesh import (
    MESH_AXES,
    MeshSizeError,
)
from distributed_tensorflow_framework_torch.serve import engine as pe
from distributed_tensorflow_framework_torch.serve import export as px
from distributed_tensorflow_framework_tpu.ckpt import reshard as jreshard
from distributed_tensorflow_framework_tpu.core.config import (
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.serve import export as jx
from tests.test_torch_gang import Gang
from tests.test_torch_hygiene import torch_threads  # noqa: F401

LENET = [
    "model.name=lenet5", "model.dtype=float32", "data.name=synthetic_images",
    "data.image_size=28", "data.channels=1", "data.global_batch_size=8",
    "optimizer.name=sgd_momentum", "optimizer.learning_rate=0.05",
    "optimizer.ema_decay=0.5", "train.total_steps=2", "train.log_interval=1",
    "train.eval_steps=0", "checkpoint.async_save=false",
    "resilience.rollback=false",
]
ONE = {a: 1 for a in MESH_AXES}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The ``{data: 2}`` checkpoint of two gloo ranks."""
    root = tmp_path_factory.mktemp("serve_dp_export")
    ckpt = str(root / "ckpt")
    Gang(["-m", "distributed_tensorflow_framework_torch.cli.train",
          "--device", "cpu", *sum((["--set", o] for o in LENET + [
              "mesh.data=2", f"checkpoint.directory={ckpt}"]), [])],
         [str(root / f"r{r}.log") for r in range(2)]).join(timeout=300)
    return ckpt


def _config(ckpt: str, *extra: str):
    return port_config(overrides=LENET + [f"checkpoint.directory={ckpt}",
                                          *extra])


def test_data2_exports_at_serve_data_2_without_the_knob(ckpt, tmp_path):
    cfg = _config(ckpt, "serve.data=2")
    assert cfg.serve.allow_reshard is False
    art = px.load_artifact(px.export_checkpoint(
        cfg, str(tmp_path / "art"), device="cpu", devices=["cpu", "cpu"]))
    source = art.meta["source"]
    assert source["serve_mesh"] == {**ONE, "data": 2}
    assert len(source["sharding_spec_digest"]) == 64
    assert source["used_ema"] is True
    saved = torch.load(os.path.join(ckpt, "2", "state.pt"),
                       weights_only=True)
    for key, value in saved["ema"].items():
        assert torch.equal(art.state_dict[key], value)
    images = np.random.default_rng(0).normal(size=(3, 28, 28, 1)).astype(
        np.float32)
    eng = pe.InferenceEngine(art, cfg.serve, devices=["cpu", "cpu"])
    try:
        assert eng.predict({"image": images}, timeout=60).shape == (3, 10)
    finally:
        assert eng.drain(30)


@pytest.mark.parametrize("data, devices", [(1, None), (4, ["cpu"] * 4)])
def test_another_serving_mesh_needs_the_knob(ckpt, tmp_path, data,
                                             devices):
    """The JAX gate's verdict and message for the same pair of meshes;
    with ``serve.allow_reshard`` the export goes through."""
    cfg = _config(ckpt, f"serve.data={data}")
    with pytest.raises(reshard.MeshTopologyError) as ei:
        px.export_checkpoint(cfg, str(tmp_path / "gated"), device="cpu",
                             devices=devices)
    want = jreshard.MeshTopologyError(
        {**ONE, "data": 2}, {**ONE, "data": data}, directory=ckpt, step=2,
        hint=jx.RESHARD_HINT)
    assert str(ei.value) == str(want)
    assert not os.path.exists(tmp_path / "gated")
    cfg.serve.allow_reshard = True
    art = px.load_artifact(px.export_checkpoint(
        cfg, str(tmp_path / "art"), device="cpu", devices=devices))
    assert art.meta["source"]["serve_mesh"] == {**ONE, "data": data}


def test_serve_data_above_the_visible_devices_raises(ckpt, tmp_path):
    with pytest.raises(MeshSizeError, match="needs 2 devices but 1"):
        px.export_checkpoint(_config(ckpt, "serve.data=2"),
                             str(tmp_path / "art"), device="cpu")


def test_source_has_the_jax_export_keys(ckpt, tmp_path, devices):
    from distributed_tensorflow_framework_tpu.train import Trainer

    jcfg = jax_config(overrides=LENET + [
        f"checkpoint.directory={tmp_path / 'jax_ckpt'}"])
    trainer = Trainer(copy.deepcopy(jcfg))
    trainer.build()
    trainer.train()
    jcfg.serve.data = len(devices)
    ref = jx.load_artifact(jx.export_checkpoint(jcfg, str(tmp_path / "j")))
    port = px.load_artifact(px.export_checkpoint(
        _config(ckpt), str(tmp_path / "p"), device="cpu",
        devices=["cpu", "cpu"]))
    theirs, ours = ref.meta["source"], port.meta["source"]
    assert theirs["serve_mesh"] == {**ONE, "data": len(devices)}
    assert ours.keys() == theirs.keys()
    assert ours["serve_mesh"].keys() == theirs["serve_mesh"].keys()
    assert ours["used_ema"] is theirs["used_ema"] is True
