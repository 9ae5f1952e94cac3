"""The port's config system reads every shipped YAML exactly as the JAX
package's does: same dataclasses, same values, same validation. And each
image config builds its trainer and steps as written (the helper is in
tests/test_torch_train_image.py; it runs here, in a file of many tests,
which xdist's ``--dist loadfile`` hands out early)."""

import dataclasses
import pathlib

import pytest

from distributed_tensorflow_framework_torch.core import config as pc
from distributed_tensorflow_framework_tpu.core import config as jc
from tests.test_torch_train_image import _image_config_builds_and_steps
from tests.test_torch_hygiene import torch_threads  # noqa: F401

CONFIGS = sorted(
    (pathlib.Path(__file__).resolve().parent.parent / "configs").glob(
        "*.yaml"))


def test_configs_are_found():
    assert len(CONFIGS) >= 6


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_every_config_loads_identically(path):
    assert pc.load_config(path).to_dict() == jc.load_config(path).to_dict()


@pytest.mark.parametrize("override", [
    "serve.seq_buckets=[128,256,512]",
    "model.num_layers=2",
    "optimizer.learning_rate=1e-3",
    "train.grad_allreduce_dtype=bfloat16",
])
def test_overrides_apply_identically(override):
    path = CONFIGS[0]
    assert (pc.load_config(path, overrides=[override]).to_dict()
            == jc.load_config(path, overrides=[override]).to_dict())


def test_defaults_and_field_sets_match():
    assert pc.ExperimentConfig().to_dict() == jc.ExperimentConfig().to_dict()
    for name in ("ModelConfig", "ServeConfig", "DataConfig", "TrainConfig"):
        ours = [f.name for f in dataclasses.fields(getattr(pc, name))]
        theirs = [f.name for f in dataclasses.fields(getattr(jc, name))]
        assert ours == theirs, name


@pytest.mark.parametrize("override,match", [
    ("train.totl_steps=5", "Unknown key"),
    ("serve.seq_buckets=[256,128]", "strictly ascending"),
    ("serve.max_batch_size=0", "max_batch_size"),
    ("model", "must look like"),
])
def test_bad_overrides_raise_like_jax(override, match):
    for mod in (pc, jc):
        with pytest.raises(ValueError, match=match):
            mod.load_config(CONFIGS[0], overrides=[override])


@pytest.mark.parametrize("overrides, world", [
    ([], 8),
    (["mesh.seq=2"], 4),
    (["mesh.seq=4", "data.seq_len=8192", "model.max_seq_len=8192"], 4),
])
def test_long_ring_config_passes_the_step_checks_as_written(overrides,
                                                            world):
    """configs/bert_long_ring.yaml (``mesh.seq: 8``, ring attention) loads
    and resolves as the JAX mesh resolves it, and the port's step accepts
    it: every rank's chunk is one the kernels take (2048 tokens at seq 8,
    8192 at seq 2)."""
    from distributed_tensorflow_framework_torch.core import mesh as pm
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
        sequence_parallel,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import (
        _resolve_axis_sizes,
    )

    path = CONFIGS[0].parent / "bert_long_ring.yaml"
    cfg = pc.load_config(path, overrides=overrides)
    assert cfg.model.attention_impl == "ring"
    sizes = check_step_config(cfg, world)
    assert sizes == _resolve_axis_sizes(
        jc.load_config(path, overrides=overrides).mesh, world)
    assert sequence_parallel(cfg, sizes)
    assert sizes == pm.resolve_mesh(cfg.mesh, world)


@pytest.mark.parametrize("name", ["lenet_mnist", "resnet50_cifar10",
                                  "resnet50_imagenet", "inception_v3"])
def test_image_configs_build_and_step_as_written(tmp_path, name):
    """Each image config builds its trainer with no override but
    ``checkpoint.directory`` (mesh.data -1 is one device; the datasets
    fall back to synthetic data) and takes one step on two images of its
    shape and dtype."""
    _image_config_builds_and_steps(tmp_path, name)
