"""The port's image-classification training against the JAX package's.

Three ``StepBuilder`` steps on LeNet-5 and on a small ResNet
(``stage_sizes=(1, 1)``, width 8, CIFAR stem, 32×32) go through the JAX
``StepBuilder`` (``mesh.data=1``) and the port's, from the same
parameters and BN statistics (models/convert.py) on the same synthetic
batches: ``sgd_momentum`` with weight decay and warmup, label smoothing,
and ``grad_accum_steps=2``, where the BN running statistics move
micro-batch by micro-batch. Then a CPU ``cli.train`` run of a cut
``configs/lenet_mnist.yaml`` from a tiny ``mnist.npz``, the four image
configs (Inception-v3's included) built as written, and resume with the
BN buffers, the momentum and the EMA.

Tolerances, with their reasons (f32):
  * loss, top-1 and the learning rate: rtol 1e-5 (f32 sums in other
    orders); grad_norm: rtol 1e-4;
  * parameters: within 1e-5 × lr of JAX's — an SGD step moves a parameter
    by lr × (gradient + momentum), and the gradients agree to 1e-5 of
    their largest (tests/test_torch_image_models.py);
  * BN running statistics: within 1e-5 of each leaf's largest value;
  * resume: bit-equal (the same CPU kernels on the same inputs).

The three StepBuilder steps run in tests/test_torch_image_models.py and
the four configs in tests/test_torch_config.py, from the helpers here: a
file with few tests is handed out last under xdist's ``--dist
loadfile``, and this one's ~4 minutes ended the suite's run.
"""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.cli import train as port_cli
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import (
    get_dataset as port_dataset,
)
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.models.convert import (
    batch_stats_to_flax,
    flatten_tree,
    flax_to_state_dict,
    to_flax,
)
from distributed_tensorflow_framework_torch.models.resnet import ResNet
from distributed_tensorflow_framework_torch.train import step as port_step
from distributed_tensorflow_framework_torch.train.loop import Trainer
from distributed_tensorflow_framework_torch.train.step import StepBuilder
from distributed_tensorflow_framework_tpu.core.config import (
    MeshConfig,
    load_config as jax_config,
)
from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
from distributed_tensorflow_framework_tpu.data.infeed import to_global
from distributed_tensorflow_framework_tpu.models.resnet import (
    ResNet as JaxResNet,
)
from distributed_tensorflow_framework_tpu.train.step import (
    StepBuilder as JaxStepBuilder,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"

TRAIN = ["mesh.data=1", "data.name=synthetic_images", "data.seed=2",
         "data.global_batch_size=8", "optimizer.name=sgd_momentum",
         "optimizer.learning_rate=0.1", "optimizer.momentum=0.9",
         "optimizer.weight_decay=0.001", "optimizer.warmup_steps=1",
         "optimizer.schedule=cosine", "optimizer.grad_clip_norm=0.0",
         "train.total_steps=3", "train.label_smoothing=0.1"]
LENET = ["model.name=lenet5", "model.dtype=float32", "data.image_size=28",
         "data.channels=1"]
SMALL_RESNET = ["model.name=resnet18_cifar", "model.dtype=float32",
                "data.image_size=32", "data.channels=3"]


def _small_resnets():
    return (JaxResNet(stage_sizes=(1, 1), width=8, num_classes=10,
                      dtype=jnp.float32, cifar_stem=True),
            ResNet((1, 1), 10, width=8, cifar_stem=True,
                   dtype=torch.float32))


@pytest.fixture()
def small_resnet(monkeypatch):
    """The port's StepBuilder builds the small ResNet for
    ``resnet18_cifar``; returns the Flax twin for the JAX builder."""
    jm, _ = _small_resnets()

    def build(config, *, device, generator=None, in_channels=None,
              precision=None):
        pm = _small_resnets()[1]
        pm.init_weights(generator)
        return pm.to(device).eval()

    monkeypatch.setattr(port_step, "get_model", build)
    return jm


def _close(got, ref, scale, what):
    err = np.abs(np.asarray(got) - np.asarray(ref)).max()
    assert err <= scale, f"{what}: {err:.2e} > {scale:.2e}"


def _three_steps_match_the_jax_step_builder(request, model, accum):
    """Three StepBuilder steps against the JAX StepBuilder's
    (tests/test_torch_image_models.py runs it for each case)."""
    over = TRAIN + (LENET if model == "lenet" else SMALL_RESNET) + [
        f"train.grad_accum_steps={accum}"]
    pcfg, jcfg = port_config(overrides=over), jax_config(overrides=over)
    mesh = create_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jbuilder = JaxStepBuilder(jcfg, mesh)
    if model == "resnet":
        jbuilder.model = request.getfixturevalue("small_resnet")
    ds = port_dataset(pcfg.data)
    batches = [next(ds) for _ in range(3)]
    jstate = jbuilder.init_state(0, to_global(batches[0], mesh))
    jstep = jbuilder.make_train_step(to_global(batches[0], mesh))

    pbuilder = StepBuilder(pcfg, device="cpu")
    pstate = pbuilder.init_state(0)
    pstate.model.load_state_dict(flax_to_state_dict(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)))
    lr = pcfg.optimizer.learning_rate
    for i, host in enumerate(batches):
        jstate, jm = jstep(jstate, to_global(host, mesh))
        pm = pbuilder.train_step(pstate, to_device(host, torch.device("cpu")))
        jm = jax.device_get(jm)
        for key in ("loss", "top1", "top5"):
            np.testing.assert_allclose(float(pm[key]), jm[key], rtol=1e-5,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(float(pm["grad_norm"]), jm["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(pm["learning_rate"],
                                   jm["learning_rate"], rtol=1e-5)
        ours = flatten_tree(to_flax(pstate.model))
        for path, ref in flatten_tree(jax.device_get(jstate.params)).items():
            _close(ours[path], ref, 1e-5 * lr, f"step {i} param {path}")
        ours = flatten_tree(batch_stats_to_flax(pstate.model))
        for path, ref in flatten_tree(
                jax.device_get(jstate.batch_stats)).items():
            _close(ours[path], ref, 1e-5 * np.abs(ref).max(),
                   f"step {i} stats {path}")
    assert pstate.step == 3


def _write_mnist(root, n_train=64, n_test=20, seed=0):
    """Digits whose class is the brightest of ten vertical bands, so that
    a few steps learn something."""
    rng = np.random.default_rng(seed)

    def split(n):
        y = rng.integers(0, 10, n)
        x = rng.integers(0, 60, (n, 28, 28))
        for i, label in enumerate(y):
            x[i, :, 2 * label + 4:2 * label + 6] += 180
        return x.astype(np.uint8), y.astype(np.uint8)

    (xt, yt), (xe, ye) = split(n_train), split(n_test)
    np.savez(os.path.join(root, "mnist.npz"), x_train=xt, y_train=yt,
             x_test=xe, y_test=ye)


def _events(path):
    return [json.loads(line) for line in
            (path / "events.jsonl").read_text().splitlines()]


def test_cli_trains_the_lenet_config_on_cpu(tmp_path):
    """configs/lenet_mnist.yaml cut to 8 steps of 16 on a 64-image npz:
    train_step events with images/s, an exact eval over all 20 test
    images (two batches, the second padded) and a committed checkpoint."""
    data = tmp_path / "data"
    data.mkdir()
    _write_mnist(data)
    ckpt = tmp_path / "ckpt"
    over = [f"data.data_dir={data}", f"checkpoint.directory={ckpt}",
            "data.global_batch_size=16", "train.total_steps=8",
            "train.log_interval=4", "train.eval_steps=20",
            "checkpoint.save_interval_steps=4"]
    rc = port_cli.main(["--config", str(CONFIGS / "lenet_mnist.yaml"),
                        "--device", "cpu",
                        *sum((["--set", o] for o in over), [])])
    assert rc == 0
    events = _events(ckpt)
    train = [e for e in events if e["kind"] == "train_step"]
    assert [e["step"] for e in train] == [4, 8]
    for e in train:
        assert set(e["metrics"]) >= {"loss", "top1", "top5", "grad_norm",
                                     "learning_rate"}
        assert e["throughput"]["examples_per_sec"] > 0
    (final,) = [e for e in events if e["kind"] == "eval"]
    assert final["metrics"]["eval_examples"] == 20
    assert set(final["metrics"]) == {"eval_loss", "eval_top1", "eval_top5",
                                     "eval_examples"}
    assert not [e for e in events if e["kind"] == "data_packing"]
    assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [4, 8]


def _image_config_builds_and_steps(tmp_path, name):
    """Each image config builds its trainer with no override but
    ``checkpoint.directory`` (mesh.data -1 is one device; the datasets
    fall back to synthetic data) and takes one step on two images of its
    shape and dtype (tests/test_torch_config.py runs it for each
    config)."""
    cfg = port_config(str(CONFIGS / f"{name}.yaml"),
                      overrides=[f"checkpoint.directory={tmp_path}"])
    trainer = Trainer(cfg, device="cpu")
    trainer.build()
    d = cfg.data
    shape, dtype = trainer.dataset.element_spec["image"]
    assert shape == (d.global_batch_size, d.image_size, d.image_size,
                     d.channels)
    image = torch.randn(2, *shape[1:]).to(
        torch.bfloat16 if d.image_dtype == "bfloat16" else torch.float32)
    metrics = trainer.builder.train_step(
        trainer.state, {"image": image,
                        "label": torch.tensor([1, 2], dtype=torch.int32)})
    assert np.isfinite(float(metrics["loss"]))
    assert trainer.state.step == 1
    trainer.writer.close()


RESUME = TRAIN + SMALL_RESNET + [
    "optimizer.ema_decay=0.9", "train.log_interval=2",
    "checkpoint.save_interval_steps=2", "checkpoint.async_save=false",
    "train.eval_steps=0", "resilience.rollback=false"]


def test_resume_restores_bn_buffers_momentum_and_ema(tmp_path, small_resnet):
    """Four steps straight equal two steps, a restore, and two more: the
    model (BN running statistics included), the momentum buffers and the
    EMA, bit for bit."""
    def run(directory, steps):
        cfg = port_config(overrides=RESUME + [
            f"checkpoint.directory={directory}",
            f"train.total_steps={steps}"])
        trainer = Trainer(cfg, device="cpu")
        trainer.train()
        trainer._ckpt_manager.close()
        trainer.writer.close()
        return trainer

    straight = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    resumed = run(tmp_path / "b", 4)
    assert resumed.restored_step == 2
    a, b = straight.state.state_dict(), resumed.state.state_dict()
    assert any("running_var" in k for k in a["model"])
    for key in a["model"]:
        torch.testing.assert_close(b["model"][key], a["model"][key],
                                   rtol=0, atol=0)
    for key in a["ema"]:
        torch.testing.assert_close(b["ema"][key], a["ema"][key], rtol=0,
                                   atol=0)
    sa, sb = a["optimizer"]["inner"]["state"], b["optimizer"]["inner"][
        "state"]
    assert sa.keys() == sb.keys() and sa
    for idx in sa:
        torch.testing.assert_close(sb[idx]["momentum_buffer"],
                                   sa[idx]["momentum_buffer"], rtol=0,
                                   atol=0)
    assert b["optimizer"]["count"] == a["optimizer"]["count"] == 4


def test_ema_toggle_across_resume(tmp_path, small_resnet):
    """``optimizer.ema_decay`` flipped across a restart, as
    tests/test_ema.py holds the JAX trainer to: saved without an EMA and
    resumed with one, the EMA is re-seeded from the restored parameters;
    saved with one and resumed without, it is dropped."""
    def trainer(directory, ema, steps):
        return Trainer(port_config(overrides=RESUME + [
            f"checkpoint.directory={directory}", f"optimizer.ema_decay={ema}",
            f"train.total_steps={steps}"]), device="cpu")

    for saved_ema, resumed_ema in ((0.0, 0.9), (0.9, 0.0)):
        directory = tmp_path / f"ema{saved_ema}"
        first = trainer(directory, saved_ema, 2)
        first.train()
        first._ckpt_manager.close()
        first.writer.close()
        second = trainer(directory, resumed_ema, 4)
        second.build()
        assert second.host_step == 2
        params = dict(second.state.model.named_parameters())
        if resumed_ema:
            for key, e in second.state.ema_params.items():
                torch.testing.assert_close(e, params[key].detach(), rtol=0,
                                           atol=0)
        else:
            assert not second.state.ema_params
        second.train()
        second._ckpt_manager.close()
        second.writer.close()
