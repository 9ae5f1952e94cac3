"""Data parallel across ranks: the port's DDP step (train/step.py), its
cross-rank BatchNorm (models/layers.py), exact eval and chief-written
checkpoints (train/loop.py, ckpt/checkpoint.py), on the CPU over gloo.

Three worlds of ranks, each a child process that runs this file with the
gang environment of core/cluster.py (``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) and imports torch alone:

  * world A, two ranks: three steps of a tiny BERT (MLM, whose two halves
    of each global batch hold different masked-token counts) at
    ``grad_accum_steps`` 1 and 2, of LeNet-5 at 2 and of a small ResNet
    with BatchNorm, each rank feeding its block of the global batch; exact
    eval over uneven shards (21 MNIST test images; MLM records in three
    files of 5, 9 and 2 records); the ImageNet record reader on both paths
    over uneven shards; and a 4-step trainer run whose chief writes
    checkpoints at steps 2 and 4, with dropout on;
  * world B, two ranks: the same trainer run from a copy of world A's
    directory that holds step 2 only;
  * world C, one rank: the world-A steps with no group, then in a gloo
    group of one.

In this process the JAX ``StepBuilder`` runs the same global batches on a
``data=2`` mesh over two of conftest's eight CPU devices (Pallas in
interpret mode), from the port's initial parameters, and the port runs
them in one process on the whole batch. JAX is imported only inside those
reference functions.

Tolerances (f32), with their reasons: loss and accuracy rtol 1e-5 (sums
in other orders), grad_norm rtol 1e-4; BERT parameters within 1e-3 × lr
(AdamW divides by √v̂ + ε, so gradient noise moves a parameter by up to
noise/ε × lr; tests/test_torch_train.py saw 6e-4 × lr), LeNet and ResNet
parameters within 1e-5 × lr (SGD moves them by lr × gradient), the
ResNet's running statistics within 1e-5 of each leaf's largest value.
Exact eval: equal ``eval_examples``, metrics rtol 1e-6. The world-1 group
and the resume: bit-equal.
"""

import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from distributed_tensorflow_framework_torch.data import get_dataset
from distributed_tensorflow_framework_torch.data.infeed import to_device
from distributed_tensorflow_framework_torch.models.resnet import ResNet
from distributed_tensorflow_framework_torch.train import step as port_step
from tests.test_torch_gang import Gang
from tests.test_torch_hygiene import torch_threads  # noqa: F401

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
STEPS = 3

TINY_BERT = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=2", "model.num_heads=4", "model.mlp_dim=128",
    "model.max_seq_len=128", "model.dtype=float32",
    "model.attention_impl=pallas", "model.dropout_rate=0.0",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=128",
    "data.global_batch_size=8", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=2",
    "optimizer.schedule=linear", "optimizer.weight_decay=0.01",
    "optimizer.grad_clip_norm=1.0", "optimizer.eps=1e-6",
    f"train.total_steps={STEPS}", "checkpoint.directory=",
    "resilience.rollback=false"]
SMALL_RESNET = [
    "model.name=resnet18_cifar", "model.dtype=float32",
    "data.name=synthetic_images", "data.image_size=32", "data.channels=3",
    "data.seed=2", "data.global_batch_size=8",
    "optimizer.name=sgd_momentum", "optimizer.learning_rate=0.1",
    "optimizer.momentum=0.9", "optimizer.weight_decay=0.001",
    "optimizer.warmup_steps=1", "optimizer.schedule=cosine",
    "optimizer.grad_clip_norm=0.0", f"train.total_steps={STEPS}",
    "train.label_smoothing=0.1", "checkpoint.directory=",
    "resilience.rollback=false"]
LENET = [o for o in SMALL_RESNET if not o.startswith(("model.", "data."))] + [
    "model.name=lenet5", "model.dtype=float32", "data.name=synthetic_images",
    "data.image_size=28", "data.channels=1", "data.seed=4",
    "data.global_batch_size=8"]
# Accumulation across ranks splits each rank's block where the JAX package
# splits the global batch: the same sum without BatchNorm (BERT, LeNet),
# so the BN model runs at accum 1 only (ROADMAP.md queue C).
CASES = {"bert_accum1": TINY_BERT + ["train.grad_accum_steps=1"],
         "bert_accum2": TINY_BERT + ["train.grad_accum_steps=2"],
         "lenet_accum2": LENET + ["train.grad_accum_steps=2"],
         "resnet": SMALL_RESNET}
MNIST_TEST = 21
MLM_EVAL_FILES = (5, 9, 2)
# ImageNet records (data/imagenet_records.py's images, 10 classes) in
# uneven shards: train 3/2/3 records, validation 3/5/1.
IMAGENET_FILES = {"train": (3, 2, 3), "validation": (3, 5, 1)}


def _small_resnet(config, *, device, generator=None, in_channels=None,
                  precision=None):
    """What the port's StepBuilder builds for ``resnet18_cifar`` here:
    stages (1, 1), width 8, the CIFAR stem (tests/test_torch_train_image.py
    holds it against its Flax twin)."""
    model = ResNet((1, 1), 10, width=8, cifar_stem=True,
                   dtype=torch.float32)
    model.init_weights(generator)
    return model.to(device).eval()


def _global_batches(config):
    ds = get_dataset(config.data)
    return [next(ds) for _ in range(STEPS)]


def _port_steps(name, runtime=None) -> dict:
    """STEPS port steps of a case, each rank on its block of the global
    batches: the (global) metrics of every step, the final tensors."""
    config = port_config(overrides=CASES[name])
    builder = port_step.StepBuilder(config, device="cpu", runtime=runtime)
    state = builder.init_state(0)
    world = 1 if runtime is None else runtime.process_count
    rank = 0 if runtime is None else runtime.process_index
    metrics = []
    for batch in _global_batches(config):
        b = config.data.global_batch_size // world
        block = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        m = builder.global_metrics(builder.train_step(
            state, to_device(block, torch.device("cpu"))))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "tensors": {k: v.detach().clone()
                        for k, v in state.model.state_dict().items()}}


# ------------------------------------------------------------ the ranks

def _eval_data(workdir):
    """21 MNIST test images (ranks hold 11 and 10) and MLM eval records in
    three files of 5, 9 and 2 (ranks hold 7 and 9)."""
    from distributed_tensorflow_framework_torch.data import progression

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(workdir, "mnist"))
    np.savez(os.path.join(workdir, "mnist", "mnist.npz"),
             x_train=rng.integers(0, 256, (16, 28, 28), np.uint8),
             y_train=rng.integers(0, 10, 16, np.uint8),
             x_test=rng.integers(0, 256, (MNIST_TEST, 28, 28), np.uint8),
             y_test=rng.integers(0, 10, MNIST_TEST, np.uint8))
    from distributed_tensorflow_framework_torch.data import imagenet_records

    os.makedirs(os.path.join(workdir, "imagenet"))
    templates = imagenet_records.class_templates(10, 0)
    for split, counts in IMAGENET_FILES.items():
        n = 0
        for f, count in enumerate(counts):
            progression.write_tfrecords(
                os.path.join(workdir, "imagenet",
                             f"{split}-{f:05d}-of-{len(counts):05d}"),
                [imagenet_records.image_record(templates, 0, split, n + i,
                                               90) for i in range(count)])
            n += count
    os.makedirs(os.path.join(workdir, "mlm"))
    for i, n in enumerate(MLM_EVAL_FILES):
        progression.write_tfrecords(
            os.path.join(workdir, "mlm", f"eval-{i:05d}.tfrecord"),
            (progression.encode_example(r)
             for r in rng.integers(200, 500, (n, 32))))


EVAL_CONFIGS = {
    "mnist": lambda d: [
        "model.name=lenet5", "model.dtype=float32", "data.name=mnist",
        f"data.data_dir={d}/mnist", "data.image_size=28", "data.channels=1",
        "data.global_batch_size=8", "train.eval_steps=100",
        "checkpoint.directory="],
    "mlm": lambda d: [
        *TINY_BERT, "data.name=text_mlm", f"data.data_dir={d}/mlm",
        "data.vocab_size=512", "data.seq_len=32", "model.max_seq_len=32",
        "data.global_batch_size=4", "train.eval_steps=100"],
}


def _evaluate(name, workdir, runtime=None) -> dict:
    """Exact eval of the initial model (the same on every rank) over the
    whole eval set; with it the eval stream's batch count and, for MLM,
    this rank's own count of masked positions in its real records."""
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    config = port_config(overrides=EVAL_CONFIGS[name](workdir))
    trainer = Trainer(config, device="cpu", runtime=runtime)
    try:
        trainer.build()
        out = trainer.evaluate()
        ds = trainer._ensure_eval()
        out["batches"] = ds.cardinality
        if name == "mlm":
            ds.restore(trainer._eval_start)
            # The padded tail is all-zero tokens, which are never masked.
            out["local_masked"] = int(sum(
                (next(ds)["targets"] >= 0).sum()
                for _ in range(ds.cardinality)))
    finally:
        trainer.writer.close()
    return out


def _imagenet_ranks(workdir, runtime) -> dict:
    """Each rank's ImageNet streams on both paths: the labels of its first
    train batch, and its exact eval's batch count, real records and their
    labels."""
    from distributed_tensorflow_framework_torch.data.imagenet import (
        make_imagenet,
    )

    out = {}
    for native in (True, False):
        config = port_config(overrides=[
            "data.name=imagenet", f"data.data_dir={workdir}/imagenet",
            "data.image_size=32", "data.num_classes=10",
            "data.global_batch_size=4", "data.shuffle_buffer=4",
            f"data.use_native_reader={native}"]).data
        args = (runtime.process_index, runtime.process_count)
        train = next(make_imagenet(config, *args))
        evals = list(make_imagenet(config, *args, train=False))
        out["native" if native else "tf"] = {
            "train_labels": sorted(train["label"].tolist()),
            "eval_batches": len(evals),
            "eval_records": int(sum(b["weight"].sum() for b in evals)),
            "eval_labels": sorted(
                int(v) for b in evals for v in b["label"][b["weight"] > 0])}
    return out


def _train_run(workdir, directory, runtime):
    """The trainer for 4 steps of the tiny BERT with dropout 0.1, the
    chief saving at steps 2 and 4."""
    from distributed_tensorflow_framework_torch.train.loop import Trainer

    config = port_config(overrides=[
        *TINY_BERT, "model.dropout_rate=0.1", "train.total_steps=4",
        "train.log_interval=2", "checkpoint.save_interval_steps=2",
        "checkpoint.max_to_keep=5", f"checkpoint.directory={directory}",
        "resilience.rollback=true"])
    trainer = Trainer(config, device="cpu", runtime=runtime,
                      log_dir=directory)
    try:
        trainer.build()
        final = trainer.train()
    finally:
        trainer._ckpt_manager.close()
        trainer.writer.close()
    return {"final": final, "restored": trainer.restored_step}


def _rank_main(task: str, workdir: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    out = {}
    if task == "world1":
        # No group first, then a gloo group of one in the same process.
        names = ("bert_accum2", "resnet")
        out["nogroup"] = {n: _with_model(n, _port_steps) for n in names}
        runtime = initialize_runtime(MeshConfig(), "cpu")
        out["group"] = {n: _with_model(n, _port_steps, runtime)
                        for n in names}
        out["backend"] = runtime.backend
    else:
        runtime = initialize_runtime(MeshConfig(), "cpu")
        out["backend"] = runtime.backend
        if task == "main":
            out["steps"] = {n: _with_model(n, _port_steps, runtime)
                            for n in CASES}
            out["eval"] = {n: _evaluate(n, workdir, runtime)
                           for n in EVAL_CONFIGS}
            out["imagenet"] = _imagenet_ranks(workdir, runtime)
            out["train"] = _train_run(workdir, f"{workdir}/ckpt_a", runtime)
        else:
            out["train"] = _train_run(workdir, f"{workdir}/ckpt_b", runtime)
    runtime.shutdown()
    torch.save(out, os.path.join(workdir,
                                 f"{task}_rank{runtime.process_index}.pt"))


def _with_model(name, fn, *args):
    """Run ``fn(name, *args)`` with the small ResNet for the resnet case."""
    saved = port_step.get_model
    if name == "resnet":
        port_step.get_model = _small_resnet
    try:
        return fn(name, *args)
    finally:
        port_step.get_model = saved


# ------------------------------------------------------- the test side


def _start(task, workdir, world):
    return Gang([HERE, task, workdir],
                [os.path.join(workdir, f"{task}_rank{rank}.log")
                 for rank in range(world)])


def _join(gang, timeout=240):
    gang.join(timeout)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("ddp"))
    _eval_data(workdir)
    main, world1 = _start("main", workdir, 2), _start("world1", workdir, 1)
    _join(main)
    _join(world1)
    # World B resumes from a copy of world A's directory at step 2.
    shutil.copytree(f"{workdir}/ckpt_a", f"{workdir}/ckpt_b",
                    ignore=shutil.ignore_patterns("4", "events*",
                                                  "heartbeat*"))
    _join(_start("resume", workdir, 2))

    def load(task, rank):
        return torch.load(os.path.join(workdir, f"{task}_rank{rank}.pt"),
                          weights_only=True)

    return {"dir": workdir, "main": [load("main", r) for r in range(2)],
            "world1": load("world1", 0),
            "resume": [load("resume", r) for r in range(2)]}


def _jax_steps(name, port_init) -> dict:
    """The JAX StepBuilder on a data=2 mesh over the same global batches,
    from the port's initial parameters and statistics."""
    import jax

    from distributed_tensorflow_framework_torch.models.convert import (
        batch_stats_to_flax,
        flatten_tree,
        to_flax,
    )
    from distributed_tensorflow_framework_tpu.core.config import (
        MeshConfig,
        load_config,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.train.step import StepBuilder

    config = port_config(overrides=CASES[name])
    jcfg = load_config(overrides=CASES[name] + ["mesh.data=2"])
    mesh = create_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    builder = StepBuilder(jcfg, mesh)
    if name == "resnet":
        import jax.numpy as jnp

        from distributed_tensorflow_framework_tpu.models.resnet import (
            ResNet as JaxResNet,
        )

        builder.model = JaxResNet(stage_sizes=(1, 1), width=8,
                                  num_classes=10, dtype=jnp.float32,
                                  cifar_stem=True)
    batches = _global_batches(config)
    state = builder.init_state(0, to_global(batches[0], mesh))
    model = _with_model(name, lambda n: port_step.get_model(
        config.model, device="cpu", in_channels=(
            None if "bert" in n else config.data.channels)))
    model.load_state_dict(port_init)

    def placed(tree, like):
        return jax.tree.map(lambda x, ref: jax.device_put(x, ref.sharding),
                            tree, like)

    state = state.replace(params=placed(to_flax(model), state.params))
    if name == "resnet":
        state = state.replace(batch_stats=placed(batch_stats_to_flax(model),
                                                 state.batch_stats))
    step = builder.make_train_step(to_global(batches[0], mesh))
    metrics = []
    for batch in batches:
        state, m = step(state, to_global(batch, mesh))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    out = {"metrics": metrics,
           "params": flatten_tree(jax.device_get(state.params))}
    if name == "resnet":
        out["stats"] = flatten_tree(jax.device_get(state.batch_stats))
    return out, batches


def _port_tree(name, tensors):
    """A rank's final tensors as flat Flax trees (params, batch stats)."""
    from distributed_tensorflow_framework_torch.models.convert import (
        batch_stats_to_flax,
        flatten_tree,
        to_flax,
    )

    config = port_config(overrides=CASES[name])
    model = _with_model(name, lambda n: port_step.get_model(
        config.model, device="cpu", in_channels=(
            None if "bert" in n else config.data.channels)))
    model.load_state_dict(tensors)
    return (flatten_tree(to_flax(model)),
            flatten_tree(batch_stats_to_flax(model)) if name == "resnet"
            else {})


def _assert_steps_close(name, got, ref):
    config = port_config(overrides=CASES[name])
    lr = config.optimizer.learning_rate
    for i, (g, r) in enumerate(zip(got["metrics"], ref["metrics"])):
        for key in ("loss", "mlm_acc", "top1"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], rtol=1e-5,
                                           atol=1e-7,
                                           err_msg=f"step {i} {key}")
        np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                   rtol=1e-4, err_msg=f"step {i} grad_norm")
    params, stats = _port_tree(name, got["tensors"])
    ref_params = (ref["params"] if "params" in ref
                  else _port_tree(name, ref["tensors"])[0])
    atol = (1e-3 if "bert" in name else 1e-5) * lr
    for path, want in ref_params.items():
        np.testing.assert_allclose(params[path], want, rtol=0, atol=atol,
                                   err_msg=f"param {path}")
    ref_stats = (ref.get("stats") if "params" in ref
                 else _port_tree(name, ref["tensors"])[1])
    for path, want in (ref_stats or {}).items():
        err = np.abs(stats[path] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), f"stats {path}: {err:.2e}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_the_jax_data_mesh(worlds, name):
    init = _with_model(name, lambda n: port_step.StepBuilder(
        port_config(overrides=CASES[n]), device="cpu").init_state(0)
        .model.state_dict())
    ref, batches = _jax_steps(name, init)
    if "bert" in name:
        halves = [[int((b["targets"][h * 4:(h + 1) * 4] >= 0).sum())
                   for h in range(2)] for b in batches]
        assert all(a != b for a, b in halves), halves
    for rank in worlds["main"]:
        assert rank["backend"] == "gloo"
        _assert_steps_close(name, rank["steps"][name], ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_match_one_rank_with_the_whole_batch(worlds, name):
    whole = _with_model(name, _port_steps)
    a, b = (rank["steps"][name] for rank in worlds["main"])
    for key in a["tensors"]:
        assert torch.equal(a["tensors"][key], b["tensors"][key]), key
    _assert_steps_close(name, a, whole)


@pytest.mark.parametrize("name", sorted(EVAL_CONFIGS))
def test_exact_eval_over_uneven_shards(worlds, name):
    a, b = (rank["eval"][name] for rank in worlds["main"])
    assert {k: v for k, v in a.items() if k != "local_masked"} == \
        {k: v for k, v in b.items() if k != "local_masked"}
    if name == "mnist":
        one = _evaluate(name, worlds["dir"])
        # 11 and 10 images in batches of 4: three batches on each rank.
        assert a["batches"] == 3 and a["eval_examples"] == MNIST_TEST
        assert one["eval_examples"] == MNIST_TEST
        for key in ("eval_loss", "eval_top1", "eval_top5"):
            np.testing.assert_allclose(a[key], one[key], rtol=1e-6)
    else:
        # Rank 0 holds files 0 and 2 (7 records), rank 1 file 1 (9): in
        # batches of 2 that is 4 and 5, and both run the larger count.
        assert a["batches"] == 5
        assert a["eval_examples"] == a["local_masked"] + b["local_masked"]
        assert a["local_masked"] != b["local_masked"]


@pytest.mark.parametrize("path", ["native", "tf"])
def test_imagenet_reader_across_two_ranks(worlds, path):
    """Rank r reads files[r::2]: its eval covers exactly those records
    (rank 0 files 0 and 2, 3 + 1 records; rank 1 file 1, 5), both ranks
    run the larger batch count (batches of 2: 2 and 3, so 3), and its
    first train batch comes from its own files."""
    from distributed_tensorflow_framework_torch.data.native_reader import (
        NativeRecordReader,
    )

    def labels(split, rank):
        files = sorted(glob.glob(f"{worlds['dir']}/imagenet/{split}-*"))
        reader = NativeRecordReader(files[rank::2])
        try:
            return sorted(int(row[0]) - 1 for rows, _ in reader.rows_i32(
                "image/class/label", 1) for row in rows)
        finally:
            reader.close()

    for rank, got in enumerate(r["imagenet"][path] for r in worlds["main"]):
        own = labels("validation", rank)
        assert got["eval_batches"] == 3
        assert got["eval_records"] == len(own) == (4, 5)[rank]
        assert got["eval_labels"] == own
        train = labels("train", rank)
        assert all(got["train_labels"].count(v) <= train.count(v)
                   for v in set(got["train_labels"]))


def test_chief_checkpoint_resumes_bit_equal_on_two_ranks(worlds):
    from distributed_tensorflow_framework_torch.ckpt import manifest

    d = worlds["dir"]
    straight, resumed = f"{d}/ckpt_a", f"{d}/ckpt_b"
    assert manifest.committed_steps(straight) == [2, 4]
    assert manifest.committed_steps(resumed) == [2, 4]
    assert [r["train"]["restored"] for r in worlds["resume"]] == [2, 2]
    assert [r["train"]["restored"] for r in worlds["main"]] == [None, None]
    a = torch.load(f"{straight}/4/state.pt", weights_only=True)
    b = torch.load(f"{resumed}/4/state.pt", weights_only=True)
    flat_a, flat_b = _leaves(a), _leaves(b)
    assert len(flat_a) == len(flat_b) > 0
    assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    # Each rank draws its own dropout stream; the chief saves both.
    gens = a["dropout_generators"]
    assert len(gens) == 2 and not torch.equal(gens[0], gens[1])
    assert torch.equal(gens[0], a["dropout_generator"])
    with open(f"{straight}/4/meta.json") as fh:
        assert json.load(fh)["process_count"] == 2
    record = manifest.read_manifest(f"{straight}/4")["data_state"]
    assert record["process_count"] == 2
    # Per-rank heartbeats and telemetry; metrics from the chief only.
    assert os.path.exists(f"{straight}/heartbeat-p0.json")
    assert os.path.exists(f"{straight}/heartbeat-p1.json")
    chief = [json.loads(x) for x in open(f"{straight}/events.jsonl")]
    other = [json.loads(x) for x in open(f"{straight}/events-p1.jsonl")]
    assert [e["step"] for e in chief if e["kind"] == "train_step"] == [2, 4]
    assert not [e for e in other if e["kind"] == "train_step"]
    assert {e["extra"]["process_id"] for e in other} == {1}
    meta = next(e for e in chief if e["kind"] == "run_meta")["extra"]
    assert (meta["process_count"], meta["process_group"], meta["ddp"]) == \
        (2, "gloo", True)
    shards = [e["extra"]["shard"] for e in chief + other
              if e["kind"] == "data_shard"]
    assert [(s["process_index"], s["host_batch"]) for s in shards] == \
        [(0, 4), (1, 4)]
    # Both ranks end on the same global metrics.
    finals = [r["train"]["final"] for r in worlds["main"]]
    assert finals[0]["loss"] == finals[1]["loss"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("name", ["bert_accum2", "resnet"])
def test_world_one_group_step_is_bit_equal(worlds, name):
    w = worlds["world1"]
    assert w["backend"] == "gloo"
    got, ref = w["group"][name], w["nogroup"][name]
    assert got["metrics"] == ref["metrics"]
    for key, value in ref["tensors"].items():
        assert torch.equal(got["tensors"][key], value), key


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
