"""Sequence parallelism with ring attention (``mesh.seq > 1``,
``attention_impl: ring``; parallel/ring.py, ``MeshRuntime.ppermute_``,
``collectives.ppermute_shift``) against the JAX package and against the
port's own one-process step.

Mirrors ``tests/test_attention.py``'s ``test_ring_attention_matches_xla``,
``test_ring_attention_mask_and_gradients``,
``test_ring_attention_data_seq_mesh_trailing_padding``,
``test_ring_chunk_dispatch_policy`` and ``test_flash_chunk_guards``,
``tests/test_packed_attention.py::test_ring_segmented_matches_per_segment``
and ``tests/test_train_models.py::test_bert_trains[ring]``. One gloo world
of four ranks, each rank a child process running this file with the gang
environment of core/cluster.py (torch alone), runs every case:

  * the ring itself at ``{data: 1, seq: 4}`` and ``{data: 2, seq: 2}``,
    on both chunk routes (``FLASH_CHUNK_MIN`` 0: the kernels' plain
    versions on the CPU; and its default: the plain chain): the forward
    and the q, k and v gradients of a weighted ``Σ sin(out)``, with a key
    mask that cuts the last chunk, trailing padding that empties whole
    chunks, and the packed layout of tests/test_packed_attention.py,
    whose documents cross the chunk boundaries;
  * ``ppermute_shift`` and its transpose, the subgroups, the ring's own
    process group;
  * a tiny BERT (f32, 2 layers, width 64, 128 tokens): the jit step at
    ``{data: 2, seq: 2}`` (the test holds it against the JAX StepBuilder
    on the same mesh) and at ``{data: 1, seq: 4}`` with dropout 0.1 and
    remat (against one process: the masks are one process's); a packed
    forward and backward; ``seq`` with the plain attention, whose ranks
    repeat the step; a checkpointed run and its resume; the Trainer with
    an exact eval. Rank 0 also runs the one-process references.

In this process the JAX ``ring_attention_sharded`` and the JAX
StepBuilder run on meshes over conftest's CPU devices.

Tolerances. The ring against JAX's ring in f32: the outputs within
2e-5 (the JAX test's), the gradients within rtol 5e-4 / atol 5e-5 (the
JAX test's): the chunks merge in another order of f32 sums than one
softmax. The tiny BERT against one process or the JAX step in f32:
losses rtol 1e-5, grad_norm rtol 1e-4, the parameters within 1e-3 × lr
after 3 steps (AdamW divides each gradient by its root mean square, so
a gradient that is zero in exact arithmetic moves by its rounding noise,
as tests/test_torch_tensor_parallel.py holds them). Exact: the ranks of a
seq line against each other, the resume, the checkpoint read by one
process, the dropout masks, everything ``ppermute_shift`` moves.
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
STEPS = 3
TINY_BERT = [
    "model.name=bert", "model.vocab_size=512", "model.hidden_size=64",
    "model.num_layers=2", "model.num_heads=4", "model.mlp_dim=128",
    "model.max_seq_len=128", "model.dtype=float32",
    "model.attention_impl=ring", "model.dropout_rate=0.0",
    "data.name=synthetic_mlm", "data.vocab_size=512", "data.seq_len=128",
    "data.global_batch_size=8", "optimizer.name=adamw",
    "optimizer.learning_rate=1e-3", "optimizer.warmup_steps=2",
    "optimizer.schedule=linear", "optimizer.weight_decay=0.01",
    "optimizer.grad_clip_norm=1.0", "optimizer.eps=1e-6",
    f"train.total_steps={STEPS}", "checkpoint.directory=",
    "resilience.rollback=false"]
DS = ["mesh.data=2", "mesh.seq=2"]
S4 = ["mesh.data=1", "mesh.seq=4"]
DROP_REMAT = ["model.dropout_rate=0.1", "model.remat=true"]
# The step cases each rank runs, and the one-process references of rank 0.
STEP_CASES = {
    "ds": TINY_BERT + DS,
    "s4_drop_remat": TINY_BERT + DROP_REMAT + S4,
    "ds_accum": TINY_BERT + DS + ["train.grad_accum_steps=2"],
    "xla_repeat": TINY_BERT + DS + ["model.attention_impl=xla"],
}
ONE = {
    "ring": TINY_BERT,
    "drop_remat": TINY_BERT + DROP_REMAT,
    "xla": TINY_BERT + ["model.attention_impl=xla"],
}
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL_LR = 1e-3
OUT_TOL = 2e-5
GRAD_TOL = {"rtol": 5e-4, "atol": 5e-5}

# The ring's unit inputs: B rows of S tokens, H heads of D (the JAX tests'
# shapes), drawn from a numpy seed.
B, S, H, D = 2, 256, 2, 32
# tests/test_packed_attention.py's segment layout (crosses the chunk
# boundaries at every seq; 0 marks padding).
SEGS = np.zeros((B, S), np.int32)
SEGS[0, :100] = 1
SEGS[0, 100:180] = 2
SEGS[0, 180:230] = 3
SEGS[1, :130] = 1
SEGS[1, 130:256] = 2
MESHES = {"s4": {"data": 1, "seq": 4}, "ds": {"data": 2, "seq": 2}}
ROUTES = {"flash": 0, "plain": 10**9}


def _inputs(case: str) -> dict:
    """q, k, v (B', S, H, D) f32, the key mask (B', S) bool or None, the
    segment ids or None, and the loss weight (B', S) of a ring case."""
    rng = np.random.default_rng({"plain": 2, "mask": 5, "pad": 23,
                                 "packed": 0}[case])
    b = 4 if case == "pad" else B
    q, k, v = (rng.standard_normal((b, S, H, D)).astype(np.float32)
               for _ in range(3))
    mask = segs = None
    weight = np.ones((b, S), np.float32)
    if case == "mask":
        mask = np.ones((b, S), bool)
        mask[:, 216:] = False          # cuts the last chunk
    elif case == "pad":
        mask = np.ones((b, S), bool)
        mask[:2, 80:] = False          # rows 0-1: the last chunks all pad
        weight = mask.astype(np.float32)
    elif case == "packed":
        segs = SEGS
    return {"q": q, "k": k, "v": v, "mask": mask, "segs": segs,
            "weight": weight}


RING_CASES = [(m, r, c) for m in MESHES for r in ROUTES
              for c in ("plain", "mask", "pad", "packed")]


# ------------------------------------------------------------ the ranks

def _ring_case(runtime, route: str, case: str) -> dict:
    """This rank's rows and part of the ring's output and of the q, k and
    v gradients of ``Σ weight · sin(out)``."""
    from distributed_tensorflow_framework_torch.parallel import ring

    inp = _inputs(case)
    rows = np.array_split(np.arange(inp["q"].shape[0]),
                          runtime.sizes["data"])[runtime.data_group.index]
    part = ring.seq_part(runtime, S)

    def local(x):
        return torch.from_numpy(np.ascontiguousarray(x[rows][:, part]))

    q, k, v = (local(inp[n]).requires_grad_() for n in "qkv")
    mask = (None if inp["mask"] is None
            else local(inp["mask"])[:, None, None, :])
    segs = None if inp["segs"] is None else local(inp["segs"])
    saved = ring.FLASH_CHUNK_MIN
    ring.FLASH_CHUNK_MIN = ROUTES[route]
    try:
        out = ring.ring_attention_masked(q, k, v, mask=mask,
                                         segment_ids=segs, runtime=runtime)
        (torch.sin(out) * local(inp["weight"])[:, :, None, None]).sum() \
            .backward()
    finally:
        ring.FLASH_CHUNK_MIN = saved
    return {"rows": rows.tolist(), "part": (part.start, part.stop),
            "out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _ppermute(runtime) -> dict:
    """``ppermute_shift`` by 1 and by -1 at {data: 2, seq: 2} and
    {data: 1, seq: 4}, its transpose, and the tally."""
    from distributed_tensorflow_framework_torch.parallel import (
        collectives as coll,
    )

    out = {}
    for name, sizes in MESHES.items():
        rt = runtime.remesh({**{k: 1 for k in runtime.sizes}, **sizes})
        g = rt.seq_group
        x = torch.full((3,), float(rt.process_index), requires_grad=True)
        ids = torch.tensor([rt.process_index * 10], dtype=torch.int32)
        with coll.tally() as t:
            y, moved = coll.ppermute_shift([x * 2.0, ids], rt)
        back = coll.ppermute_shift(ids, rt, shift=-1)
        # The transpose: the gradient of Σ w·y reaches the sender.
        (y * (g.index + 1.0)).sum().backward()
        # The host transport (gloo's CUDA tensors) packs the tensors into
        # one buffer each way: forced here on CPU tensors of three dtypes.
        host = dataclasses.replace(rt)
        host.p2p_transport = lambda device: "host"
        mixed = [torch.full((3, 5), rt.process_index, dtype=torch.bfloat16),
                 torch.arange(7, dtype=torch.float32) + rt.process_index,
                 torch.full((2,), rt.process_index, dtype=torch.int64)]
        via_host = host.ppermute_([torch.empty_like(t) for t in mixed],
                                  mixed)
        native = rt.ppermute_([torch.empty_like(t) for t in mixed], mixed)
        out[name] = {"host_equal": all(
            torch.equal(a, b) and a.dtype == b.dtype
            for a, b in zip(via_host, native)),
            "seq": (g.index, g.size), "data": (
            rt.data_group.index, rt.data_group.size),
            "ring_group_own": g.group is not None and g.group is not (
                torch.distributed.group.WORLD),
            "y": y.detach().tolist(), "ids": moved.tolist(),
            "back": back.tolist(), "grad": x.grad.tolist(),
            "tally": t.summary(), "y_requires_grad": y.requires_grad,
            "ids_requires_grad": moved.requires_grad,
            "transport": rt.p2p_transport("cpu")}
    return out


def _builder(overrides, runtime, seed=0):
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    builder = StepBuilder(port_config(overrides=overrides), device="cpu",
                          runtime=runtime)
    return builder, builder.init_state(seed)


def _block(batch, builder):
    """This rank's block of a global batch: its data-parallel index's rows
    (the ranks along ``seq`` take the same ones, whole)."""
    from distributed_tensorflow_framework_torch.data.infeed import to_device

    n, r = (1, 0) if builder.data_group is None else (
        builder.data_group.size, builder.data_group.index)
    b = builder.config.data.global_batch_size // n
    return to_device({k: v[r * b:(r + 1) * b] for k, v in batch.items()},
                     torch.device("cpu"))


def _run(overrides, runtime, steps=STEPS, state=None, builder=None,
         skip=0) -> dict:
    from distributed_tensorflow_framework_torch.data import get_dataset

    if state is None:
        builder, state = _builder(overrides, runtime)
    ds = get_dataset(builder.config.data)
    for _ in range(skip):
        next(ds)
    metrics = []
    for _ in range(steps):
        m = builder.global_metrics(builder.train_step(
            state, _block(next(ds), builder)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "tensors": {k: v.detach().clone() for k, v in
                        state.model.state_dict().items()},
            "eval": {k: float(v) for k, v in builder.eval_step(
                state, _block(next(ds), builder)).items()},
            "generator": state.dropout_generator.get_state(),
            "ddp": state.ddp is not None,
            "seq_parallel": builder.seq_parallel,
            "reduce": None if builder.reduce_group is None else (
                builder.reduce_group.index, builder.reduce_group.size),
            "state": state, "builder": builder}


def _packed_forward(runtime) -> dict:
    """A packed forward and backward of the tiny ring BERT (segment ids
    crossing the chunks, positions that keep counting across them): this
    rank's part of the logits and every parameter's gradient, summed over
    the ranks."""
    import torch.distributed as dist

    from distributed_tensorflow_framework_torch.parallel import ring

    builder, state = _builder(TINY_BERT + DS, runtime)
    model = state.model
    ids, mask, segs = _packed_batch()
    rows = slice(builder.data_group.index * 2,
                 (builder.data_group.index + 1) * 2)
    logits = model(ids[rows], mask[rows], segs[rows])
    # Padding tokens are weighed out: a query whose every key is masked
    # gets the chunks' averages summed over the ring (as in the JAX
    # package), one process's average over the row.
    keep = mask[rows][:, ring.seq_part(runtime, 128)]
    (logits.float().square() * keep[..., None]).sum().div(
        logits.numel()).backward()
    grads = {k: p.grad.detach().clone()
             for k, p in model.named_parameters()}
    for g in grads.values():
        dist.all_reduce(g)
    return {"logits": logits.detach(), "rows": (rows.start, rows.stop),
            "grads": grads}


def _packed_batch():
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(1, 512, (4, 128)).astype(np.int64))
    segs = np.zeros((4, 128), np.int64)
    segs[:, :50] = 1
    segs[:, 50:90] = 2
    segs[:2, 90:120] = 3
    segs[2:, 90:] = 3
    mask = torch.from_numpy((segs > 0).astype(np.int64))
    return ids, mask, torch.from_numpy(segs)


def _one_packed() -> dict:
    builder, state = _builder(TINY_BERT, None)
    ids, mask, segs = _packed_batch()
    grads = {}
    logits = []
    for rows in (slice(0, 2), slice(2, 4)):
        out = state.model(ids[rows], mask[rows], segs[rows])
        logits.append(out.detach())
        # The two seq ranks' losses, each over its 2 x 64 tokens.
        (out.float().square() * mask[rows][..., None]).sum().div(
            out[:, :64].numel()).backward()
    grads = {k: p.grad.detach().clone()
             for k, p in state.model.named_parameters()}
    return {"logits": torch.cat(logits), "grads": grads}


def _resume(workdir, runtime) -> dict:
    """2 steps, a save, a restore into a state from another seed and 2
    more steps, against 4 straight steps; and the checkpoint read by one
    process."""
    import torch.distributed as dist

    from distributed_tensorflow_framework_torch.ckpt.checkpoint import (
        CheckpointManager,
    )

    one_over = TINY_BERT + ["model.dropout_rate=0.1",
                            "checkpoint.async_save=false"]
    over = one_over + DS
    straight = _run(over, runtime, 4)
    legs = _run(over, runtime, 2)
    ck = dataclasses.replace(legs["builder"].config.checkpoint,
                             directory=f"{workdir}/ck_seq")
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
    dist.barrier()
    if runtime.process_index == 0:
        _, one = _builder(one_over, None, seed=2)
        manager = CheckpointManager(dataclasses.replace(ck), runtime=None)
        out["one_restored"] = manager.restore(one)
        manager.close()
        out["one_equal"] = all(
            torch.equal(one.model.state_dict()[k], v)
            for k, v in legs["tensors"].items())
    dist.barrier()
    return out


def _slots(state) -> list:
    return [t for s in state.optimizer.state_dict()["inner"]["state"]
            .values()
            for t in s.values() if isinstance(t, torch.Tensor)]


def _trainer(workdir, runtime, mesh) -> dict:
    """Two steps through the Trainer with an exact eval; its run_meta."""
    import json

    from distributed_tensorflow_framework_torch.train.loop import Trainer

    from distributed_tensorflow_framework_torch.core import mesh as mesh_lib

    logs = f"{workdir}/trainer_{runtime is None}"
    cfg = port_config(overrides=TINY_BERT + mesh + [
        "train.total_steps=2", "train.log_interval=1", "train.eval_steps=2"])
    if runtime is None:
        # One process beside the world: a runtime without a group.
        runtime = mesh_lib.MeshRuntime(mesh_lib.resolve_mesh(cfg.mesh, 1),
                                       0, 1, torch.device("cpu"))
    trainer = Trainer(cfg, device="cpu", log_dir=logs, runtime=runtime)
    final = trainer.train()
    result = trainer.evaluate()
    trainer.writer.close()
    out = {"final": final, "eval": result}
    if runtime is None or runtime.is_chief:
        with open(f"{logs}/events.jsonl") as fh:
            events = [json.loads(line) for line in fh]
        out["run_meta"] = next(e for e in events
                               if e["kind"] == "run_meta")["extra"]
    return out


LONG_TINY = ["mesh.data=1", "mesh.seq=4", "model.vocab_size=512",
             "data.vocab_size=512", "model.hidden_size=32",
             "model.num_layers=2", "model.num_heads=2", "model.mlp_dim=64",
             "model.max_seq_len=256", "data.seq_len=256",
             "data.global_batch_size=4", "train.grad_accum_steps=2",
             "train.total_steps=2", "train.log_interval=1",
             "resilience.rollback=false"]


def _cli(workdir) -> dict:
    """configs/bert_long_ring.yaml through cli/train.py at tiny width on
    the world (bf16, remat, dropout 0.1, ring attention at seq 4), with a
    checkpoint. The CLI destroys the process group as it exits, so this
    runs last."""
    import json

    from distributed_tensorflow_framework_torch.cli import train as cli

    args = ["--config", os.path.join(ROOT, "configs", "bert_long_ring.yaml"),
            "--device", "cpu", "--log-dir", f"{workdir}/cli_logs"]
    for o in LONG_TINY + [f"checkpoint.directory={workdir}/cli_ckpt"]:
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
        out["saved"] = sorted(os.listdir(f"{workdir}/cli_ckpt"))
    return out


def _clean(result: dict) -> dict:
    return {k: v for k, v in result.items() if k not in ("state", "builder")}


def _rank_main(workdir: str) -> None:
    from distributed_tensorflow_framework_torch.core.config import MeshConfig
    from distributed_tensorflow_framework_torch.core.mesh import (
        initialize_runtime,
    )

    torch.set_num_threads(1)
    runtime = initialize_runtime(MeshConfig(data=-1), "cpu")
    base = {k: 1 for k in runtime.sizes}
    rts = {name: runtime.remesh({**base, **sizes})
           for name, sizes in MESHES.items()}
    out = {"ring": {(m, r, c): _ring_case(rts[m], r, c)
                    for m, r, c in RING_CASES},
           "ppermute": _ppermute(runtime)}
    out["steps"] = {n: _clean(_run(o, runtime))
                    for n, o in STEP_CASES.items()}
    out["packed"] = _packed_forward(rts["ds"])
    out["resume"] = _resume(workdir, rts["ds"])
    out["trainer"] = _trainer(workdir, rts["s4"], S4)
    if runtime.process_index == 0:
        out["one"] = {n: _clean(_run(o, None)) for n, o in ONE.items()}
        out["one_packed"] = _one_packed()
        out["one_trainer"] = _trainer(workdir, None, [])
    out["cli"] = _cli(workdir)
    runtime.shutdown()
    torch.save(out, os.path.join(workdir, f"rank{runtime.process_index}.pt"))


# ------------------------------------------------------- the test side

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("ring"))
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
        for proc, _ in procs:
            proc.wait(timeout=300)
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


def _assemble(world, key, what):
    """The ranks' parts of ``what`` put back at (rows, tokens)."""
    first = world[0]["ring"][key][what]
    b = len({r for w in world for r in w["ring"][key]["rows"]})
    out = torch.zeros((b, S) + tuple(first.shape[2:]))
    for w in world:
        part = w["ring"][key]
        lo, hi = part["part"]
        out[part["rows"], lo:hi] = part[what]
    return out.numpy()


@pytest.fixture(scope="module")
def jax_ring():
    """JAX's ring_attention_sharded on each case: the output and the q, k
    and v gradients of the same weighted loss, per (mesh, route, case)."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_framework_tpu.core.config import MeshConfig
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.parallel import ring

    cache = {}

    def run(mesh_name, route, case):
        key = (mesh_name, route, case)
        if key in cache:
            return cache[key]
        inp = _inputs(case)
        mesh = create_mesh(MeshConfig(**MESHES[mesh_name]),
                           devices=jax.devices()[:4])
        mask = (None if inp["mask"] is None
                else jnp.asarray(inp["mask"])[:, None, None, :])
        segs = None if inp["segs"] is None else jnp.asarray(inp["segs"])
        w = jnp.asarray(inp["weight"])[:, :, None, None]

        def attend(q, k, v):
            return ring.ring_attention_sharded(q, k, v, mesh=mesh, mask=mask,
                                               segment_ids=segs)

        def loss(q, k, v):
            return jnp.sum(jnp.sin(attend(q, k, v)) * w)

        saved = ring.FLASH_CHUNK_MIN
        ring.FLASH_CHUNK_MIN = ROUTES[route]
        try:
            qkv = [jnp.asarray(inp[n]) for n in "qkv"]
            out = np.asarray(jax.jit(attend)(*qkv))
            grads = [np.asarray(g) for g in jax.jit(jax.grad(
                loss, argnums=(0, 1, 2)))(*qkv)]
        finally:
            ring.FLASH_CHUNK_MIN = saved
        cache[key] = (out, grads)
        return cache[key]

    return run


@pytest.mark.parametrize("mesh, route, case", RING_CASES,
                         ids=["-".join(c) for c in RING_CASES])
def test_ring_matches_jax_ring_attention_sharded(world, jax_ring, mesh,
                                                 route, case, devices):
    """The forward and the q, k, v gradients against JAX's ring on the
    same mesh and route (the JAX tests' tolerances). Padded rows are held
    where the loss weighs them, as the JAX padding test holds them."""
    want, grads = jax_ring(mesh, route, case)
    w = _inputs(case)["weight"][:, :, None, None]
    np.testing.assert_allclose(_assemble(world, (mesh, route, case), "out")
                               * w, want * w, rtol=OUT_TOL, atol=OUT_TOL)
    for name, ref in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(
            _assemble(world, (mesh, route, case), name), ref, **GRAD_TOL,
            err_msg=name)


def test_ring_segmented_matches_per_segment(world):
    """Packed rows: each document attended alone and scattered back (the
    JAX test's independent construction), on both routes and meshes."""
    from distributed_tensorflow_framework_torch.models.bert import (
        dot_product_attention,
    )

    inp = _inputs("packed")
    q, k, v = (torch.from_numpy(inp[n]) for n in "qkv")
    ref = np.zeros(q.shape, np.float32)
    for b in range(B):
        for seg in np.unique(SEGS[b]):
            idx = np.where(SEGS[b] == seg)[0]
            ref[b, idx] = dot_product_attention(
                q[b:b + 1, idx], k[b:b + 1, idx], v[b:b + 1, idx])[0]
    for mesh in MESHES:
        for route in ROUTES:
            np.testing.assert_allclose(
                _assemble(world, (mesh, route, "packed"), "out"), ref,
                rtol=OUT_TOL, atol=OUT_TOL, err_msg=f"{mesh} {route}")


def test_ring_chunk_dispatch_policy():
    """As the JAX test: an odd chunk within MAX_SEQ_VMEM takes the plain
    chain even above the crossover; an odd chunk above MAX_SEQ_VMEM
    raises naming mesh.seq; a 128-multiple at the crossover takes the
    kernels (here their plain versions)."""
    from distributed_tensorflow_framework_torch.ops import (
        flash_attention as fa,
    )
    from distributed_tensorflow_framework_torch.parallel import ring

    c = 2112
    q = torch.zeros((1, c, 1, 8))
    o, lse = ring._chunk_attention(q, q, q, torch.zeros((1, c)))
    assert o.shape == (1, c, 1, 8) and lse.shape == (1, c, 1, 1)
    assert o.dtype == torch.float32
    c = 8200
    q = torch.zeros((1, c, 1, 8))
    with pytest.raises(ValueError, match="mesh.seq"):
        ring._chunk_attention(q, q, q, torch.zeros((1, c)))
    with pytest.raises(ValueError, match="mesh.seq"):
        ring.check_ring_shape(8200, 1)
    with pytest.raises(ValueError, match="does not split"):
        ring.check_ring_shape(16384, 3)
    ring.check_ring_shape(16384, 8)
    seen = []
    chunk = fa.flash_attention_chunk
    try:
        fa.flash_attention_chunk = lambda *a: seen.append(1) or chunk(*a)
        q = torch.zeros((1, ring.FLASH_CHUNK_MIN, 1, 8))
        ring._chunk_attention(q, q, q, torch.zeros((1, q.shape[1])))
    finally:
        fa.flash_attention_chunk = chunk
    assert seen == [1]


def test_flash_chunk_guards():
    """flash_attention_chunk refuses what JAX's refuses, with its
    messages, and takes a chunk shorter than BLOCK_Q."""
    from distributed_tensorflow_framework_torch.ops.flash_attention import (
        chunk_supported,
        flash_attention_chunk,
    )
    from distributed_tensorflow_framework_tpu.ops import (
        flash_attention as jfa,
    )

    def qkv(s, sk=None):
        sk = s if sk is None else sk
        q = torch.zeros((1, s, 2, 8))
        k = torch.zeros((1, sk, 2, 8))
        return q, k, k, torch.zeros((1, sk))

    with pytest.raises(ValueError, match="multiple of"):
        flash_attention_chunk(*qkv(192))
    with pytest.raises(ValueError, match="equal-length"):
        flash_attention_chunk(*qkv(128, sk=256))
    o, lse = flash_attention_chunk(*qkv(32))
    assert o.shape == (1, 32, 2, 8) and lse.shape == (1, 32, 2, 1)
    for s in (1, 32, 127, 128, 192, 256, 2048, 2112, 8192, 8200):
        assert chunk_supported(s) == jfa.chunk_supported(s), s


def test_lse_cotangent_and_empty_chunks():
    """The kernel route's backward with an lse cotangent: a chunk whose
    keys are all masked gets merge weight 0 exactly, so its do and dlse
    are 0, and the gradients equal autograd through the plain chain."""
    from distributed_tensorflow_framework_torch.parallel import ring

    rng = np.random.default_rng(3)
    q, k, v, k2, v2 = (torch.from_numpy(rng.standard_normal(
        (1, 64, 2, 16)).astype(np.float32)).requires_grad_()
        for _ in range(5))
    bias = torch.zeros((1, 64))
    empty = torch.full((1, 64), torch.finfo(torch.float32).min)
    grads = {}
    for route, m in ROUTES.items():
        ring.FLASH_CHUNK_MIN, saved = m, ring.FLASH_CHUNK_MIN
        try:
            o, lse = ring._chunk_attention(q, k, v, bias)
            o_c, lse_c = ring._chunk_attention(q, k2, v2, empty)
            o_c.retain_grad()
            lse_c.retain_grad()
            o_m, lse_m = ring._merge_chunks(o, lse, o_c, lse_c)
            (torch.sin(o_m).sum() + lse_m.sum()).backward()
        finally:
            ring.FLASH_CHUNK_MIN = saved
        assert torch.equal(o_m, o)
        assert not o_c.grad.any() and not lse_c.grad.any()
        grads[route] = [t.grad.clone() for t in (q, k, v, k2, v2)]
        for t in (q, k, v, k2, v2):
            t.grad = None
    for a, b in zip(grads["flash"], grads["plain"]):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    assert not grads["flash"][3].any() and not grads["flash"][4].any()


def test_dropout_part_is_the_whole_mask_part():
    """A part's dropout mask is that part of the whole row's mask, and the
    generator ends where the whole row's draw leaves it."""
    from distributed_tensorflow_framework_torch.models.layers import dropout

    x = torch.ones((2, 64, 8))
    whole = dropout(x, 0.1, torch.Generator().manual_seed(3), True)
    for r in range(4):
        gen = torch.Generator().manual_seed(3)
        part = dropout(x[:, :16], 0.1, gen, True, (r, 4))
        assert torch.equal(part, whole[:, r * 16:(r + 1) * 16])
        ref = torch.Generator().manual_seed(3)
        torch.empty((2, 64, 8)).bernoulli_(0.9, generator=ref)
        assert torch.equal(gen.get_state(), ref.get_state())


def test_ppermute_shift_and_its_transpose(world):
    """Each rank receives its seq predecessor's tensors in one batch (the
    ids untouched, with no gradient), -1 returns them, the gradient goes
    back to the sender, the tally has one ``ppermute`` entry a leaf, and
    the ring runs on a process group of its own."""
    for name, sizes in MESHES.items():
        n = sizes["seq"]
        for rank, w in enumerate(world):
            p = w["ppermute"][name]
            i, size = p["seq"]
            data = rank // n
            prev = data * n + (i - 1) % n
            nxt = data * n + (i + 1) % n
            assert size == n and i == rank % n
            assert p["data"] == (data, sizes["data"])
            assert p["y"] == [2.0 * prev] * 3
            assert p["ids"] == [prev * 10] and p["back"] == [nxt * 10]
            # Rank r's x reaches rank r+1, whose loss weighs it by its
            # seq index + 1.
            assert p["grad"] == [2.0 * ((i + 1) % n + 1)] * 3
            assert p["tally"]["ppermute_calls"] == 2
            assert p["tally"]["ppermute_bytes"] == 3 * 4 + 4
            assert p["y_requires_grad"] and not p["ids_requires_grad"]
            assert p["ring_group_own"] and p["transport"] == "native"
            assert p["host_equal"]


def _close(got, want, lr, *, loss=LOSS_RTOL, norm=NORM_RTOL,
           params=PARAM_ATOL_LR):
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for key in ("loss", "mlm_acc"):
            np.testing.assert_allclose(g[key], w[key], rtol=loss,
                                       err_msg=f"step {i} {key}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=norm, err_msg=f"step {i}")
    for k, v in want["tensors"].items():
        np.testing.assert_allclose(got["tensors"][k], v, rtol=0,
                                   atol=params * lr, err_msg=k)


def _lr():
    return port_config(overrides=TINY_BERT).optimizer.learning_rate


@pytest.mark.parametrize("case, ref", [("ds", "ring"),
                                       ("ds_accum", "ring"),
                                       ("s4_drop_remat", "drop_remat")])
def test_seq_step_matches_one_process(world, case, ref):
    """The sequence-parallel step against one process on the same global
    batches (dropout 0.1 and remat: the same masks), and its exact eval
    sums; every rank of the world ends on the same parameters."""
    got = world[0]["steps"][case]
    want = world[0]["one"][ref]
    assert got["seq_parallel"] and got["ddp"]
    _close(got, want, _lr())
    for key, value in want["eval"].items():
        # Eval sums are this rank's: its rows' part; add the ranks'.
        total = sum(w["steps"][case]["eval"][key] for w in world)
        np.testing.assert_allclose(total, value, rtol=LOSS_RTOL, err_msg=key)
    for w in world[1:]:
        assert w["steps"][case]["metrics"] == got["metrics"]
        for k, v in got["tensors"].items():
            assert torch.equal(w["steps"][case]["tensors"][k], v), k
    if case == "s4_drop_remat":
        # The one-process generator state after the step's draws.
        assert torch.equal(got["generator"], want["generator"])


def test_seq_with_another_attention_repeats_the_step(world):
    """``seq`` with the plain attention: the ranks along ``seq`` repeat the
    data-parallel step (DDP over data only), bit for bit, within the f32
    tolerance of one process."""
    got = [w["steps"]["xla_repeat"] for w in world]
    assert not got[0]["seq_parallel"]
    assert [g["reduce"] for g in got] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    for a, b in ((0, 1), (2, 3)):
        assert got[a]["metrics"] == got[b]["metrics"]
        assert got[a]["eval"] == got[b]["eval"]
    _close(got[0], world[0]["one"]["xla"], _lr())


def _jax_ring_steps(overrides, port_init):
    """The JAX StepBuilder's jit step with ring attention on a
    {data: 2, seq: 2} mesh over the port's global batches, from the
    port's initial parameters."""
    import jax

    from distributed_tensorflow_framework_torch.data import get_dataset
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        to_flax,
    )
    from distributed_tensorflow_framework_torch.train.step import StepBuilder
    from distributed_tensorflow_framework_tpu.core.config import (
        MeshConfig,
        load_config,
    )
    from distributed_tensorflow_framework_tpu.core.mesh import create_mesh
    from distributed_tensorflow_framework_tpu.data.infeed import to_global
    from distributed_tensorflow_framework_tpu.train.step import (
        StepBuilder as JaxStepBuilder,
    )

    mesh = create_mesh(MeshConfig(data=2, seq=2), devices=jax.devices()[:4])
    builder = JaxStepBuilder(load_config(overrides=overrides + DS), mesh)
    ds = get_dataset(port_config(overrides=overrides).data)
    batches = [next(ds) for _ in range(STEPS)]
    state = builder.init_state(0, to_global(batches[0], mesh))
    model = StepBuilder(port_config(overrides=overrides),
                        device="cpu").init_state(0).model
    model.load_state_dict(port_init)
    state = state.replace(params=jax.tree.map(
        lambda x, ref: jax.device_put(x, ref.sharding), to_flax(model),
        state.params))
    step = builder.make_train_step(to_global(batches[0], mesh))
    metrics = []
    for batch in batches:
        state, m = step(state, to_global(batch, mesh))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return metrics, flatten_tree(jax.device_get(state.params)), model


def test_seq_step_matches_the_jax_jit_step(world, devices):
    """f32, ring attention on both sides (the plain chain: 64-token
    chunks), dropout 0, clipping 1.0, at {data: 2, seq: 2}: losses,
    grad_norm and the parameters against the JAX StepBuilder."""
    from distributed_tensorflow_framework_torch.models.convert import (
        flatten_tree,
        to_flax,
    )
    from distributed_tensorflow_framework_torch.train.step import StepBuilder

    init = StepBuilder(port_config(overrides=TINY_BERT),
                       device="cpu").init_state(0).model.state_dict()
    ref, params, model = _jax_ring_steps(TINY_BERT, init)
    got = world[0]["steps"]["ds"]
    _close(got, {"metrics": ref, "tensors": {}}, _lr())
    model.load_state_dict(got["tensors"])
    ours = flatten_tree(to_flax(model))
    assert set(ours) == set(params)
    for path, want in params.items():
        np.testing.assert_allclose(ours[path], want, rtol=0,
                                   atol=PARAM_ATOL_LR * _lr(),
                                   err_msg=str(path))


def test_packed_rows_split_over_seq(world):
    """Packed rows at {data: 2, seq: 2}: each rank's logits are its part
    of one process's (positions keep counting across the chunk boundary),
    and the gradients summed over the ranks are one process's."""
    one = world[0]["one_packed"]
    for w in world:
        p = w["packed"]
        lo, hi = p["rows"]
        part = (w is world[1] or w is world[3])
        tokens = slice(64, 128) if part else slice(0, 64)
        keep = _packed_batch()[1][lo:hi, tokens][..., None].numpy()
        np.testing.assert_allclose(p["logits"] * keep,
                                   one["logits"][lo:hi, tokens] * keep,
                                   rtol=1e-5, atol=1e-5)
    for k, v in one["grads"].items():
        np.testing.assert_allclose(world[0]["packed"]["grads"][k], v,
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_seq_resume_is_exact(world):
    """2 steps, save, restore into another seed's state, 2 steps: every
    parameter, slot, metric and the dropout generator bit-equal to 4
    straight steps; one process reads the checkpoint bit for bit."""
    for w in world:
        r = w["resume"]
        assert r["restored"] == 2
        assert r["metrics_equal"] and r["equal"] and r["slots_equal"]
        assert r["generator_equal"]
    assert world[0]["resume"]["one_restored"] == 2
    assert world[0]["resume"]["one_equal"]


def test_trainer_splits_the_rows_and_sums_the_eval(world):
    """The Trainer at {data: 1, seq: 4}: run_meta names the split, every
    rank logs the same metrics, and the exact eval (summed over the seq
    ranks) is one process's."""
    meta = world[0]["trainer"]["run_meta"]
    assert meta["sequence_parallel"] == 4 and meta["ddp"]
    assert meta["p2p_transport"] == "native"
    assert meta["mesh"]["seq"] == 4
    assert world[0]["one_trainer"]["run_meta"]["sequence_parallel"] == 1
    task = ("loss", "mlm_acc", "grad_norm")
    for w in world[1:]:
        assert all(w["trainer"]["final"][k] == world[0]["trainer"]["final"][k]
                   for k in task)
        assert w["trainer"]["eval"] == world[0]["trainer"]["eval"]
    one = world[0]["one_trainer"]
    for key, value in one["eval"].items():
        np.testing.assert_allclose(world[0]["trainer"]["eval"][key], value,
                                   rtol=LOSS_RTOL, err_msg=key)
    np.testing.assert_allclose(world[0]["trainer"]["final"]["loss"],
                               one["final"]["loss"], rtol=LOSS_RTOL)


def test_long_ring_config_trains_through_the_cli(world):
    """configs/bert_long_ring.yaml as written but for its size (bf16,
    remat, dropout, ring attention, seq 4 here) trains through
    cli/train.py on every rank: rc 0, finite metrics at both steps, a
    checkpoint, and run_meta naming the split."""
    assert [w["cli"]["rc"] for w in world] == [0] * 4
    cli = world[0]["cli"]
    assert len(cli["steps"]) == 2
    assert all(np.isfinite(v) for m in cli["steps"] for v in m.values())
    assert cli["meta"]["sequence_parallel"] == 4
    assert cli["meta"]["mesh"]["seq"] == 4
    assert "2" in cli["saved"]


def test_ring_under_shard_map_is_jax_failure():
    """Ring attention under shard_map raises the JAX package's cause."""
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    cfg = port_config(overrides=TINY_BERT + ["train.spmd_mode=shard_map"])
    with pytest.raises(ValueError, match="nests a shard_map"):
        check_step_config(cfg)
    cfg = port_config(overrides=TINY_BERT + DS + [
        "train.spmd_mode=shard_map"])
    with pytest.raises(ValueError, match="context mesh"):
        check_step_config(cfg, 4)


@pytest.mark.parametrize("mesh", [
    ["mesh.data=1", "mesh.seq=2", "mesh.fsdp=2"],
    ["mesh.data=1", "mesh.seq=2", "mesh.model=2"],
    ["mesh.data=1", "mesh.seq=2", "mesh.fsdp=2",
     "optimizer.zero_sharding=jit"]])
def test_seq_compositions_name_their_item(mesh):
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    cfg = port_config(overrides=TINY_BERT + mesh)
    with pytest.raises(NotImplementedError,
                       match="A11 \\(seq with fsdp/model/ZeRO\\)"):
        check_step_config(cfg, 4)


def test_seq_len_is_checked_before_anything_is_built():
    from distributed_tensorflow_framework_torch.ops import (
        flash_attention as fa,
    )
    from distributed_tensorflow_framework_torch.train.step import (
        check_step_config,
    )

    cfg = port_config(overrides=TINY_BERT + ["mesh.data=1", "mesh.seq=3"])
    with pytest.raises(ValueError, match="does not split"):
        check_step_config(cfg, 3)
    saved = fa.MAX_SEQ_VMEM
    fa.MAX_SEQ_VMEM = 32
    try:
        cfg = port_config(overrides=TINY_BERT + [
            "mesh.data=1", "mesh.seq=2", "data.seq_len=400",
            "model.max_seq_len=400"])
        with pytest.raises(ValueError, match="mesh.seq"):
            check_step_config(cfg, 2)
    finally:
        fa.MAX_SEQ_VMEM = saved


if __name__ == "__main__":
    _rank_main(sys.argv[1])
