"""Pipeline parallelism (``mesh.pipe > 1``, ``model.pipeline_stages``;
parallel/pipeline.py, ``MeshRuntime.ppermute_`` along ``pipe``,
``collectives.take_member``/``from_member``) against the JAX package and
against the port's own one-process step.

Mirrors ``tests/test_pipeline.py`` (``test_pipeline_matches_reference``,
``test_schedule_parity_logits_and_grads``, ``test_fsdp_pipe_parity``,
``test_pipeline_trains_dp_pp``, ``test_pipeline_validation``) at its
sizes: vocab 64, hidden 32, 8 layers, 2 heads, MLP 64, 16 tokens, 4
microbatches. One gloo world of four ranks, each rank a child process
running this file with the gang environment of core/cluster.py (torch
alone), runs every case on the three meshes ``{pipe: 4}``, ``{data: 2,
pipe: 2}`` and ``{fsdp: 2, pipe: 2}`` (``MeshRuntime.remesh``):

  * each schedule (gpipe, 1f1b, interleaved at v = 2): the logits and
    every leaf's gradient of the global masked-LM loss (the data-parallel
    ranks' gradients summed, as DDP's reduction does), which the test
    holds against JAX's pipelined ``PipelinedBert.apply`` and its
    ``apply_reference`` on the same weights;
  * dropout 0.1 under the three schedules: the same gradients, so the
    1f1b recompute replays the forward's masks;
  * the StepBuilder's step at ``{data: 2, pipe: 2}`` (held against the
    JAX StepBuilder's jit step on the same mesh) and at ``{fsdp: 2,
    pipe: 2}`` with FSDP under 1f1b and with ZeRO-1 under interleaved
    (held against one process);
  * a checkpointed run and its bit-exact resume, the checkpoint read by
    one process and by a run under another schedule;
  * the CLI with ``mesh.pipe=2`` (its events: ``run_meta`` and the
    ``pipeline_schedule`` record).

In this process the JAX models run on meshes over conftest's CPU devices
(computed once per module), and the conversions and refusals run alone.

Tolerances (f32). Logits against JAX: rtol 1e-5, atol 1e-5 (JAX's own
test's). Gradients against JAX: atol 2e-5 per leaf (JAX's test holds
its schedules to 2e-4 of its reference; the port and JAX sum the f32
products in other orders). The schedules against each other with dropout:
rtol 1e-5, atol 1e-7 (the same masks; the microbatch gradients add in
another order). The steps: losses rtol 1e-5, grad_norm rtol 1e-4, the
parameters within 1e-3 × lr after 2 steps (AdamW divides each gradient by
its root mean square, so a zero gradient moves by its rounding noise, as
tests/test_torch_ring.py holds them). Exact: the embedding and head
gradients on every stage of a line, the ranks' losses, the resume, the
checkpoint read, the bubble metric.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_config,
)
from tests.test_torch_hygiene import torch_threads  # noqa: F401

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
LAYERS, M = 8, 4
TINY = [
    "model.name=bert", "model.vocab_size=64", "model.hidden_size=32",
    f"model.num_layers={LAYERS}", "model.num_heads=2", "model.mlp_dim=64",
    "model.max_seq_len=16", "model.dtype=float32",
    "model.attention_impl=xla", "model.dropout_rate=0.0",
    "data.name=synthetic_mlm", "data.vocab_size=64", "data.seq_len=16",
    "data.global_batch_size=16", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=2",
    "optimizer.schedule=linear", "optimizer.weight_decay=0.01",
    "optimizer.grad_clip_norm=1.0", "optimizer.eps=1e-6",
    "train.total_steps=4", "checkpoint.directory=",
    "resilience.rollback=false"]
MESHES = {"p4": {"data": 1, "pipe": 4}, "dp": {"data": 2, "pipe": 2},
          "fp": {"fsdp": 2, "pipe": 2}}
SCHEDULES = [("gpipe", 0), ("1f1b", 0), ("interleaved", 2)]
LOGIT_TOL = {"rtol": 1e-5, "atol": 1e-5}
GRAD_ATOL = 2e-5
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL_LR = 1e-3
STEPS = 2
BUBBLE = {"gpipe": 1 / 5, "1f1b": 1 / 5}   # (S-1)/(M+S-1) at S 2, M 4
ZERO1 = ["optimizer.zero_sharding=jit"]


def _mesh_over(name: str) -> list[str]:
    sizes = {"data": 1, "fsdp": 1, **MESHES[name]}
    return [f"mesh.{k}={v}" for k, v in sizes.items()] + [
        f"model.pipeline_stages={sizes['pipe']}",
        f"model.pipeline_microbatches={M}"]


def _schedule_over(schedule: str, v: int) -> list[str]:
    return [f"model.pipeline_schedule={schedule}",
            f"model.pipeline_virtual_stages={v}"]


def _problem():
    """The shared inputs: 16 rows of 16 ids and their MLM targets."""
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 64, (16, 16))
    tgt = np.where(rng.random((16, 16)) < 0.3, ids, -1)
    return torch.from_numpy(ids), torch.from_numpy(tgt)


# ------------------------------------------------------------ the ranks

def _builder(overrides, runtime, seed=0):
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    builder = StepBuilder(port_config(overrides=overrides), device="cpu",
                          runtime=runtime)
    return builder, builder.init_state(seed)


def _whole(state) -> dict:
    """The whole model's tensors, gathered over ``pipe`` (every rank
    calls it)."""
    live = state.model.state_dict()
    if state.layout is not None and state.layout.at_rest:
        live = state.layout.whole(live)
    if state.pipe is not None:
        live = state.pipe.whole(live)
    return {k: v.detach().clone() for k, v in live.items()}


def _model_case(runtime, over, ids, tgt) -> dict:
    """One forward and backward of the global masked-LM loss on this
    rank's rows: the logits, the rows, and every local leaf's gradient
    summed over the data-parallel ranks."""
    from distributed_tensorflow_framework_torch.train import losses

    builder, state = _builder(over, runtime)
    model, group = state.model, builder.data_group
    n, r = group.size, group.index
    init = _whole(state)
    if state.layout is not None:
        state.layout.begin_step_(model)
    rows = slice(r * 16 // n, (r + 1) * 16 // n)
    logits = model(ids[rows])
    weight = losses.mlm_mask(tgt).sum()
    local = losses.mlm_mask(tgt[rows]).sum()
    loss = losses.mlm_loss(logits, tgt[rows])[0] * local / weight
    loss.backward()
    grads = {k: p.grad.detach().clone()
             for k, p in model.named_parameters()}
    for g in grads.values():
        builder.runtime.all_reduce_(g, group)
    return {"logits": logits.detach(), "rows": (rows.start, rows.stop),
            "grads": grads, "stage": model.stage, "layers": model.layer_ids,
            "init": init if r == 0 else None,
            "reference": model.apply_reference(init, ids[rows])}


def _run(overrides, runtime, steps=STEPS, state=None, builder=None,
         skip=0) -> dict:
    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    if state is None:
        builder, state = _builder(overrides, runtime)
    ds = get_dataset(builder.config.data)
    for _ in range(skip):
        next(ds)
    n, r = (1, 0) if builder.data_group is None else (
        builder.data_group.size, builder.data_group.index)
    b = builder.config.data.global_batch_size // n

    def block(batch):
        return to_device({k: v[r * b:(r + 1) * b] for k, v in batch.items()},
                         torch.device("cpu"))

    metrics = []
    for _ in range(steps):
        m = builder.global_metrics(builder.train_step(state,
                                                      block(next(ds))))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "tensors": _whole(state),
            "eval": {k: float(v) for k, v in builder.eval_step(
                state, block(next(ds))).items()},
            "generator": state.dropout_generator.get_state(),
            "ddp": state.ddp is not None, "state": state,
            "builder": builder}


def _clean(result: dict) -> dict:
    return {k: v for k, v in result.items() if k not in ("state", "builder")}


def _slots(state) -> list:
    return [t for s in state.optimizer.state_dict()["inner"]["state"]
            .values()
            for t in s.values() if isinstance(t, torch.Tensor)]


def _resume(workdir, runtime) -> dict:
    """2 steps, a save, a restore into a state from another seed and 2
    more steps, against 4 straight steps, at {data: 2, pipe: 2} with
    dropout 0.1 under 1f1b; the checkpoint read by one process and by a
    run under the interleaved schedule."""
    import torch.distributed as dist

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    one_over = TINY + ["model.dropout_rate=0.1",
                       "checkpoint.async_save=false"]
    over = one_over + _mesh_over("dp") + _schedule_over("1f1b", 0)
    straight = _run(over, runtime, 4)
    legs = _run(over, runtime, 2)
    ck = dataclasses.replace(legs["builder"].config.checkpoint,
                             directory=f"{workdir}/ck_pipe")
    manager = CheckpointManager(ck, runtime=runtime)
    manager.save(2, legs["state"])
    manager.close()
    builder, fresh = _builder(over, runtime, seed=1)
    manager = CheckpointManager(ck, runtime=runtime)
    restored = manager.restore(fresh)
    manager.close()
    tail = _run(over, runtime, 2, state=fresh, builder=builder, skip=2)
    out = {"restored": restored,
           "metrics_equal": tail["metrics"] == straight["metrics"][2:],
           "equal": all(torch.equal(v, tail["tensors"][k])
                        for k, v in straight["tensors"].items()),
           "slots_equal": all(
               torch.equal(a, b) for a, b in zip(
                   _slots(straight["state"]), _slots(fresh))),
           "generator_equal": torch.equal(straight["generator"],
                                          tail["generator"])}
    # Another schedule reads it: its stage's layers are other ones.
    inter = TINY + _mesh_over("dp") + _schedule_over("interleaved", 2)
    _, other = _builder(inter, runtime, seed=3)
    manager = CheckpointManager(ck, runtime=runtime)
    out["other_restored"] = manager.restore(other)
    manager.close()
    out["other_equal"] = all(torch.equal(v, legs["tensors"][k])
                             for k, v in _whole(other).items())
    out["other_slots"] = len(_slots(other)) == len(_slots(legs["state"]))
    dist.barrier()
    if runtime.process_index == 0:
        _, one = _builder(one_over, None, seed=2)
        manager = CheckpointManager(dataclasses.replace(ck), runtime=None)
        out["one_restored"] = manager.restore(one)
        manager.close()
        out["one_equal"] = all(
            torch.equal(one.model.state_dict()[k], v)
            for k, v in legs["tensors"].items())
        out["one_slots"] = len([t for t in _slots(one) if t.dim()]) == (
            2 * len(list(one.model.parameters())))
        out["one_count"] = one.optimizer.count
    dist.barrier()
    return out


def _dropout_cases(runtime, ids, tgt) -> dict:
    """Dropout 0.1 at {pipe: 4}: each schedule's gradients (train mode,
    the same dropout stream)."""
    from distributed_tensorflow_framework_torch.core import prng
    from distributed_tensorflow_framework_torch.train import losses

    out = {}
    for schedule, v in SCHEDULES:
        over = (TINY + ["model.dropout_rate=0.1"] + _mesh_over("p4")
                + _schedule_over(schedule, v))
        _, state = _builder(over, runtime)
        gen = prng.torch_generator(0, prng.ROLE_DROPOUT, "cpu")
        logits = state.model(ids, dropout_generator=gen)
        losses.mlm_loss(logits, tgt)[0].backward()
        out[schedule] = {
            "grads": {k: p.grad.detach().clone()
                      for k, p in state.model.named_parameters()},
            "logits": logits.detach()}
    return out


def _hop(runtime) -> dict:
    """One tensor shifted +1 along ``pipe`` at {pipe: 4}, natively and
    through the host transport (gloo's CUDA tensors' path, forced here on
    a CPU tensor), and -1 back."""
    rt = runtime.remesh({**{k: 1 for k in runtime.sizes}, "pipe": 4})
    host = dataclasses.replace(rt)
    host.p2p_transport = lambda device: "host"
    x = torch.full((2, 3), float(rt.process_index))
    out = {}
    for name, r in (("native", rt), ("host", host)):
        fwd = r.ppermute_([torch.empty_like(x)], [x], 1, "pipe")[0]
        back = r.ppermute_([torch.empty_like(x)], [fwd], -1, "pipe")[0]
        out[name] = (fwd, back)
    # The differentiable shift along pipe: the gradient of Σ w·y goes
    # back to the sender.
    from distributed_tensorflow_framework_torch.parallel import (
        collectives as coll,
    )

    leaf = x.clone().requires_grad_()
    y = coll.ppermute_shift(leaf * 2.0, rt, 1, axis="pipe")
    (y * (rt.pipe_group.index + 1.0)).sum().backward()
    out["shift"] = (y.detach(), leaf.grad)
    out["stage"] = rt.pipe_group.index
    out["own_group"] = rt.pipe_group.group is not None
    return out


def _cli(workdir) -> dict:
    """The tiny BERT through cli/train.py at {data: 2, pipe: 2} under
    gpipe, with a checkpoint. The CLI destroys the process group as it
    exits, so this runs last."""
    import json

    from distributed_tensorflow_framework_torch.cli import train as cli

    args = ["--device", "cpu", "--log-dir", f"{workdir}/cli_logs"]
    for o in TINY + _mesh_over("dp") + [
            "train.total_steps=2", "train.log_interval=1",
            "train.eval_steps=1", f"checkpoint.directory={workdir}/cli_ckpt"]:
        args += ["--set", o]
    rc = cli.main(args)
    out = {"rc": rc}
    if int(os.environ["JAX_PROCESS_ID"]) == 0:
        with open(f"{workdir}/cli_logs/events.jsonl") as fh:
            events = [json.loads(line) for line in fh]
        out["steps"] = [e["metrics"] for e in events
                        if e["kind"] == "train_step"]
        out["meta"] = next(e for e in events
                           if e["kind"] == "run_meta")["extra"]
        out["schedule"] = [e for e in events
                           if e["kind"] == "pipeline_schedule"]
        out["saved"] = sorted(os.listdir(f"{workdir}/cli_ckpt"))
    return out


def _rank_main(workdir: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    runtime = initialize_runtime(MeshConfig(data=-1), "cpu")
    ids, tgt = _problem()
    out = {"models": {}}
    for mesh in MESHES:
        for schedule, v in SCHEDULES:
            over = TINY + _mesh_over(mesh) + _schedule_over(schedule, v)
            out["models"][(mesh, schedule)] = _model_case(runtime, over,
                                                          ids, tgt)
    out["hop"] = _hop(runtime)
    out["dropout"] = _dropout_cases(runtime, ids, tgt)
    _, state = _builder(TINY + _mesh_over("p4"), runtime)
    try:
        state.model(ids, torch.ones_like(ids), torch.ones_like(ids))
        out["packed"] = None
    except TypeError as e:
        out["packed"] = str(e)
    out["steps"] = {
        "dp": _clean(_run(TINY + _mesh_over("dp"), runtime)),
        "fp": _clean(_run(TINY + _mesh_over("fp")
                          + _schedule_over("1f1b", 0), runtime)),
        "zp": _clean(_run(TINY + _mesh_over("fp") + ZERO1
                          + _schedule_over("interleaved", 2), runtime))}
    out["resume"] = _resume(workdir, runtime)
    if runtime.process_index == 0:
        out["one"] = _clean(_run(TINY, None))
    out["cli"] = _cli(workdir)
    runtime.shutdown()
    torch.save(out, os.path.join(workdir, f"rank{runtime.process_index}.pt"))


# ------------------------------------------------------- the test side

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory, request):
    """The four ranks' results. The JAX references are computed here
    while the ranks run."""
    workdir = str(tmp_path_factory.mktemp("pipe"))
    port, n = _free_port(), 4
    procs = []
    for rank in range(n):
        env = {**os.environ, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(rank),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, HERE, workdir], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=ROOT), log))
    try:
        request.getfixturevalue("jax_runs")
        for proc, _ in procs:
            proc.wait(timeout=240)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for proc, log in procs:
        if proc.returncode != 0:
            with open(log.name) as fh:
                pytest.fail(f"{log.name} exited {proc.returncode}:\n"
                            f"{fh.read()[-3000:]}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def _port_init() -> dict:
    """The port's seed-0 whole BERT (what every stage is cut from)."""
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    return StepBuilder(port_config(overrides=TINY),
                       device="cpu").init_state(0).model


def _jax_model(mesh, schedule, v):
    import jax.numpy as jnp

    from distributed_tensorflow_framework_tpu.parallel.pipeline import (
        PipelinedBert,
    )

    return PipelinedBert(
        vocab_size=64, hidden_size=32, num_layers=LAYERS, num_heads=2,
        mlp_dim=64, max_seq_len=16, dropout_rate=0.0, dtype=jnp.float32,
        mesh=mesh, num_stages=mesh.shape["pipe"], num_microbatches=M,
        schedule=schedule, virtual_stages=v)


@pytest.fixture(scope="module")
def jax_runs(devices):
    """JAX's pipelined apply on each (mesh, schedule) and its
    apply_reference, from the port's seed-0 weights: logits and the
    per-leaf gradients (the port's keys) of the global MLM loss."""
    import jax

    from distributed_tensorflow_framework_torch.models.convert import (
        flax_to_state_dict,
        stack_pipeline,
        to_flax,
        unstack_pipeline,
    )
    from distributed_tensorflow_framework_tpu.core.config import MeshConfig
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.train import losses

    whole = _port_init()
    params = stack_pipeline(to_flax(whole))
    ids, tgt = (t.numpy() for t in _problem())

    def run(fn):
        def loss(p):
            logits = fn({"params": p}, ids, train=False)
            return losses.mlm_loss(logits, tgt)[0], logits
        grads, logits = jax.device_get(jax.jit(jax.grad(loss, has_aux=True))(
            params))
        return {"logits": np.asarray(logits),
                "grads": {k: v.numpy() for k, v in flax_to_state_dict(
                    unstack_pipeline(grads)).items()}}

    out = {}
    for name, sizes in MESHES.items():
        mesh = create_mesh(MeshConfig(**sizes),
                           devices=jax.devices()[:4])
        for schedule, v in SCHEDULES:
            out[(name, schedule)] = run(_jax_model(mesh, schedule,
                                                   v).apply)
    out["reference"] = run(_jax_model(mesh, "gpipe", 0).apply_reference)
    out["init"] = {k: v.detach().clone()
                   for k, v in whole.state_dict().items()}
    return out


def _assembled(world, key) -> tuple[np.ndarray, dict]:
    """The ranks' logits at their rows, and each leaf's gradient from the
    first rank that holds it."""
    logits = np.zeros((16, 16, 64), np.float32)
    grads = {}
    for w in world:
        case = w["models"][key]
        lo, hi = case["rows"]
        logits[lo:hi] = case["logits"].numpy()
        for k, g in case["grads"].items():
            grads.setdefault(k, g.numpy())
    return logits, grads


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("schedule", [s for s, _ in SCHEDULES])
def test_logits_and_grads_match_jax(world, jax_runs, mesh, schedule):
    """Every schedule on every mesh: the logits and each leaf's gradient
    against JAX's pipelined apply on the same mesh and its
    apply_reference, and each rank's logits against the port's
    apply_reference; the embedding and head gradients equal on every
    stage of a line; every stage holds its layers of the schedule."""
    from distributed_tensorflow_framework_torch.parallel.pipeline import (
        stage_chunks,
    )

    key = (mesh, schedule)
    logits, grads = _assembled(world, key)
    init = world[0]["models"][key]["init"]
    for k, v in jax_runs["init"].items():
        assert torch.equal(init[k], v), k
    for ref in (jax_runs[key], jax_runs["reference"]):
        np.testing.assert_allclose(logits, ref["logits"], **LOGIT_TOL)
        assert set(grads) == set(ref["grads"])
        for k, want in ref["grads"].items():
            np.testing.assert_allclose(grads[k], want, rtol=0,
                                       atol=GRAD_ATOL, err_msg=k)
    v = dict(SCHEDULES)[schedule] or 1
    s = {**{"pipe": 1}, **MESHES[mesh]}["pipe"]
    for w in world:
        case = w["models"][key]
        # The port's own apply_reference: the whole layout straight
        # through one BertForMLM in the rank's process.
        np.testing.assert_allclose(case["logits"].numpy(),
                                   case["reference"].numpy(), **LOGIT_TOL)
        assert case["layers"] == [g for c in stage_chunks(
            LAYERS, s, v, case["stage"]) for g in c]
        for k, g in case["grads"].items():
            if not k.startswith("layer"):
                assert torch.equal(g, world[0]["models"][key]["grads"][k]), k


def test_the_pipe_hop_moves_one_tensor_both_ways(world):
    """``ppermute_`` along ``pipe`` on the line's own group: stage s
    receives stage s - 1's tensor and the -1 shift returns it, natively
    and through the packed host buffer (one tensor alone too); and
    ``ppermute_shift`` along ``pipe`` sends the cotangent back."""
    for w in world:
        hop = w["hop"]
        s = hop["stage"]
        assert hop["own_group"]
        for name in ("native", "host"):
            fwd, back = hop[name]
            assert torch.equal(fwd, torch.full((2, 3), float((s - 1) % 4)))
            assert torch.equal(back, torch.full((2, 3), float(s)))
        y, grad = hop["shift"]
        assert torch.equal(y, torch.full((2, 3), 2.0 * ((s - 1) % 4)))
        # Stage s + 1 received this stage's tensor and weighed it s + 2.
        assert torch.equal(grad, torch.full((2, 3), 2.0 * ((s + 1) % 4 + 1)))


def test_packed_rows_are_refused(world):
    """Segment ids raise a TypeError on every stage (the JAX
    PipelinedBert.apply takes none), before any collective."""
    for w in world:
        assert "takes no segment_ids" in w["packed"]


def test_schedules_replay_the_dropout_masks(world):
    """Dropout 0.1: gpipe, 1f1b and interleaved draw the same masks for
    each (microbatch, layer), so their logits are equal and their
    gradients equal within the order of the microbatch sums; the masks
    do drop (the logits differ from the eval forward's)."""
    grads = {}
    for w in world:
        d = w["dropout"]
        for schedule, _ in SCHEDULES:
            assert torch.equal(d[schedule]["logits"], d["gpipe"]["logits"])
            for k, g in d[schedule]["grads"].items():
                grads.setdefault(schedule, {}).setdefault(k, g.numpy())
    for schedule in ("1f1b", "interleaved"):
        assert set(grads[schedule]) == set(grads["gpipe"])
        for k, g in grads[schedule].items():
            np.testing.assert_allclose(g, grads["gpipe"][k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{schedule} {k}")
    nodrop = world[0]["models"][("p4", "gpipe")]["logits"]
    assert not torch.allclose(world[0]["dropout"]["gpipe"]["logits"],
                              nodrop, atol=1e-3)


def _close(got: dict, ref: dict, lr: float) -> None:
    for a, b in zip(got["metrics"], ref["metrics"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=NORM_RTOL)
    for k, v in ref["tensors"].items():
        np.testing.assert_allclose(got["tensors"][k].numpy(), v.numpy(),
                                   rtol=0, atol=PARAM_ATOL_LR * lr,
                                   err_msg=k)


def _jax_steps(port_init):
    """The JAX StepBuilder's jit step at {data: 2, pipe: 2} (gpipe, 4
    microbatches) over the port's global batches, from the port's initial
    parameters: its metrics and its parameters (the port's keys)."""
    import jax

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.models.convert import (
        flax_to_state_dict,
        stack_pipeline,
        to_flax,
        unstack_pipeline,
    )
    from distributed_tensorflow_framework_tpu.core.config import (
        MeshConfig,
        load_config,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.train.step import (
        StepBuilder as JaxStepBuilder,
    )

    over = TINY + _mesh_over("dp")
    mesh = create_mesh(MeshConfig(data=2, pipe=2), devices=jax.devices()[:4])
    builder = JaxStepBuilder(load_config(overrides=over), mesh)
    ds = get_dataset(port_config(overrides=over).data)
    batches = [next(ds) for _ in range(STEPS)]
    state = builder.init_state(0, to_global(batches[0], mesh))
    state = state.replace(params=jax.tree.map(
        lambda x, ref: jax.device_put(x, ref.sharding),
        stack_pipeline(to_flax(port_init)), state.params))
    step = builder.make_train_step(to_global(batches[0], mesh))
    metrics = []
    for batch in batches:
        state, m = step(state, to_global(batch, mesh))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    tensors = flax_to_state_dict(unstack_pipeline(
        jax.device_get(state.params)))
    return {"metrics": metrics, "tensors": tensors}


def test_dp_pipe_step_matches_the_jax_jit_step(world, devices):
    """f32, gpipe, dropout 0, clipping 1.0, at {data: 2, pipe: 2}: the
    losses, grad_norm, pipe_bubble_frac and the parameters after 2 steps
    against the JAX StepBuilder; the four ranks' metrics equal; DDP over
    the data-parallel pair."""
    ref = _jax_steps(_port_init())
    got = world[0]["steps"]["dp"]
    _close(got, ref, 1e-3)
    for a, b in zip(got["metrics"], ref["metrics"]):
        assert a["pipe_bubble_frac"] == BUBBLE["gpipe"]
        assert b["pipe_bubble_frac"] == pytest.approx(BUBBLE["gpipe"],
                                                      abs=1e-7)
    for w in world:
        assert w["steps"]["dp"]["metrics"] == got["metrics"]
        assert w["steps"]["dp"]["ddp"]


@pytest.mark.parametrize("case", ["fp", "zp"])
def test_fsdp_pipe_step_matches_one_process(world, case):
    """At {fsdp: 2, pipe: 2}, against one process's BertForMLM step (the
    losses, grad_norm, the eval and the whole parameters after 2 steps):
    FSDP under 1f1b ("fp": the embedding and head sharded over fsdp, the
    stages whole) and ZeRO-1 under interleaved ("zp": the embedding's and
    head's slots sharded, the stages' whole)."""
    one = world[0]["one"]
    for w in world:
        got = w["steps"][case]
        _close(got, one, 1e-3)
        assert got["metrics"] == world[0]["steps"][case]["metrics"]
    # Each rank scores its fsdp block; ranks 0 and 2 are stage 0's two.
    for k, v in one["eval"].items():
        np.testing.assert_allclose(
            world[0]["steps"][case]["eval"][k]
            + world[2]["steps"][case]["eval"][k], v, rtol=LOSS_RTOL)


def test_pipe_resume_is_exact_and_read_whole(world):
    """A 1f1b run with dropout 0.1 resumes bit for bit (the parameters,
    the slots, the metrics, every rank's dropout generator); one process
    and an interleaved run read its checkpoint whole."""
    for w in world:
        r = w["resume"]
        assert r["restored"] == 2
        assert r["metrics_equal"] and r["equal"] and r["slots_equal"]
        assert r["generator_equal"]
        assert r["other_restored"] == 2 and r["other_equal"]
        assert r["other_slots"]
    r = world[0]["resume"]
    assert r["one_restored"] == 2 and r["one_equal"]
    assert r["one_slots"] and r["one_count"] == 2


def test_cli_trains_with_mesh_pipe(world):
    """cli/train.py at {data: 2, pipe: 2}: rc 0, two logged steps with the
    bubble, the pipeline_schedule record and run_meta."""
    for w in world:
        assert w["cli"]["rc"] == 0
    cli = world[0]["cli"]
    assert len(cli["steps"]) == 2
    for m in cli["steps"]:
        assert np.isfinite(m["loss"])
        assert m["pipe_bubble_frac"] == pytest.approx(BUBBLE["gpipe"])
    meta = cli["meta"]
    assert meta["mesh"]["pipe"] == 2 and meta["pipeline_stages"] == 2
    assert meta["pipeline_schedule"] == "gpipe"
    assert meta["p2p_transport"] == "native"
    (event,) = cli["schedule"]
    assert {k: v for k, v in event["extra"].items() if k != "process_id"} == {
        "schedule": "gpipe", "stages": 2, "microbatches": M,
        "virtual_stages": 1, "bubble_frac": BUBBLE["gpipe"],
        "peak_inflight": 5.0}
    assert "2" in cli["saved"]


# ------------------------------------------------ conversions, refusals

def test_convert_round_trips_the_stack(devices):
    """JAX's pipelined tree → the whole BERT tree → the port's state_dict
    and back; a stage's part of the stack (gpipe and interleaved) is the
    layers the port's stage holds."""
    import jax

    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        flax_to_state_dict,
        pipeline_part,
        stack_pipeline,
        to_flax,
        unstack_pipeline,
    )
    from distributed_tensorflow_framework_torch.parallel.pipeline import (
        stage_chunks,
    )
    from distributed_tensorflow_framework_tpu.core.config import MeshConfig
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.parallel.pipeline import (
        _interleave_perm,
    )

    mesh = create_mesh(MeshConfig(pipe=4), devices=jax.devices()[:4])
    model = _jax_model(mesh, "gpipe", 0)
    tree = jax.device_get(model.init({"params": jax.random.key(0)},
                                     np.ones((2, 16), np.int32))["params"])
    whole = _port_init()
    whole.load_state_dict(flax_to_state_dict(unstack_pipeline(tree)))
    back = flatten_tree(stack_pipeline(to_flax(whole)))
    for path, leaf in flatten_tree(tree).items():
        np.testing.assert_array_equal(back[path], np.asarray(leaf))
    stack = tree["pipeline_layers"]
    for s, v in ((4, 1), (4, 2), (2, 4)):
        perm = np.asarray(_interleave_perm(LAYERS, s, v))
        for idx in range(s):
            layers, part = pipeline_part(stack, s, v, idx)
            assert layers == [g for c in stage_chunks(LAYERS, s, v, idx)
                              for g in c]
            per = LAYERS // s
            for path, leaf in flatten_tree(part).items():
                rows = np.asarray(flatten_tree(stack)[path])[
                    perm[idx * per:(idx + 1) * per]]
                np.testing.assert_array_equal(leaf, rows)


def _refusal_cases():
    return [
        ("stages", TINY + _mesh_over("p4") + ["model.pipeline_stages=2"],
         "must equal"),
        ("ring", TINY + _mesh_over("p4") + ["model.attention_impl=ring"],
         "ring"),
        ("lenet", TINY + _mesh_over("p4") + ["model.name=lenet5"],
         "only wired"),
        ("micro", TINY + ["model.pipeline_microbatches=2"], "require"),
        ("shard_map", TINY + _mesh_over("p4")
         + ["train.spmd_mode=shard_map"], "spmd_mode='jit'"),
        ("model_axis", TINY + ["mesh.data=1", "mesh.pipe=2", "mesh.model=2",
                               "model.pipeline_stages=2"], "v1 pipeline"),
        ("moe", TINY + _mesh_over("p4") + ["model.num_experts=4"],
         "v1 pipeline"),
        ("interleave", TINY + _mesh_over("p4")
         + _schedule_over("interleaved", 3), "divisible"),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _refusal_cases()])
def test_refusals_match_jax(case, devices):
    """The JAX StepBuilder's pipeline refusals, raised by the port's
    check_step_config at four ranks with the same type and message."""
    import jax

    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )
    from distributed_tensorflow_framework_tpu.core.config import load_config
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.train.step import (
        StepBuilder as JaxStepBuilder,
    )

    _, over, match = next(c for c in _refusal_cases() if c[0] == case)
    with pytest.raises(ValueError, match=match) as ours:
        check_step_config(port_config(overrides=over), 4)
    jcfg = load_config(overrides=over)
    with pytest.raises(ValueError, match=match) as theirs:
        JaxStepBuilder(jcfg, create_mesh(jcfg.mesh,
                                         devices=jax.devices()[:4]))
    assert str(ours.value) == str(theirs.value)


def test_model_refusals_keep_jax_types():
    """remat and MoE beside the pipeline raise the JAX package's
    ValueErrors at model build; a
    pipelined model without a runtime and a pipelined export are
    refused; ZeRO-1 beside the pipeline is not."""
    from distributed_tensorflow_framework_torch.models import (
        get_model,
        model_kwargs,
    )
    from distributed_tensorflow_framework_torch.serve.export import (
        export_checkpoint,
    )
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    cfg = port_config(overrides=TINY + _mesh_over("p4"))
    with pytest.raises(ValueError, match="remat inside the pipelined"):
        model_kwargs(dataclasses.replace(cfg.model, remat=True))
    with pytest.raises(ValueError, match="MoE inside the pipelined"):
        model_kwargs(dataclasses.replace(cfg.model, num_experts=4))
    with pytest.raises(ValueError, match="needs the mesh runtime"):
        get_model(cfg.model, device="cpu")
    with pytest.raises(ValueError, match="export of pipelined models"):
        export_checkpoint(cfg, "/nonexistent", device="cpu")
    # ZeRO-1 beside the pipeline passes, as in the JAX package.
    zero = port_config(overrides=TINY + _mesh_over("fp") + ZERO1)
    assert check_step_config(zero, 4)["pipe"] == 2


if __name__ == "__main__":
    _rank_main(sys.argv[1])
