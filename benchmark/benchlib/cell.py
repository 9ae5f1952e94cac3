"""One rank of a training cell: the port's trainer driven as users run
it, from set-up through the measured window.

Set-up builds one ``Trainer`` (train/loop.py) from the configuration as
run, with the benchmark's dataset registered through the port's
``register_dataset`` (a pool of host batches made from the seed, cycled),
puts the benchmark's weights into its model and seeds its dropout
generator with the benchmark's seed, and calls ``Trainer.train`` once
with the port's default hooks and :class:`BenchHook`. Everything below is
that one call:

  1. steps 1..CHECK_STEPS with ``train.log_interval`` 1: each step's loss
     as the loop fetches it, the first step's gradient from the optimizer
     state after step 1, each leaf's change after step CHECK_STEPS (the
     reference replays these steps after the window);
  2. ``warm_steps`` more, then ``timed_warm_steps`` timed between two
     synchronisations, which fix the window's step count N so that N
     steps take about ``--seconds`` (the largest estimate over ranks);
     the loop fetches once at the last of them and the window starts
     there, after a synchronisation;
  3. the window: N steps at the shipped ``train.log_interval``; a CUDA
     event recorded after each step's dispatch, no synchronisation; the
     window ends after a synchronisation at its last step;
  4. with ``--trace 1``, ``profile_steps`` more under a CUDA-only
     ``torch.profiler`` window, each optimizer call, and each forward and
     backward of the modules the cell's readers name (``MODULE_SPANS``),
     between two marker launches.

The loop ends by ``train.total_steps``, which the hook sets once N is
known. Nothing compiles in the window: every kernel ran in steps 1..W.
"""

from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import time

import numpy as np
import torch

from benchlib import seeds, traffic as traffic_lib, weights as weights_lib

CHECK_STEPS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "distributed_tensorflow_framework_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: the port's own name begins with the JAX package's)."""
    import sys
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


# ------------------------------------------------------------ the data --

# What the registered dataset makes its pool from; set before the trainer
# is built (one trainer at a time in a process).
_SOURCE: dict = {}
# The dataset names this process has registered (the program refuses a
# second registration of a name).
_REGISTERED: set[str] = set()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    from distributed_tensorflow_framework_torch.data.pipeline import BFLOAT16
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BFLOAT16)
    return t.numpy()


def _factory(config, process_index, process_count, *, train=True):
    """The benchmark's dataset: this rank's pool of host batches, made
    from the seed on the device in set-up, handed out in turn."""
    from distributed_tensorflow_framework_torch.data.pipeline import (
        HostDataset)
    src = _SOURCE
    if train:
        pool = traffic_lib.host_pool(src["traffic"], src["data"], src["seed"],
                                     process_index, src["device"])
    else:  # never pulled: no evaluation runs in a benchmark run
        pool = [traffic_lib.make_batch(src["traffic"], src["data"],
                                       src["seed"], process_index, 0,
                                       src["device"])]
    pool = [{k: _to_numpy(v.cpu()) for k, v in b.items()} for b in pool]

    def make_iter(state):
        state.setdefault("index", 0)
        while True:
            batch = pool[state["index"] % len(pool)]
            state["index"] += 1
            yield batch

    spec = {k: (v.shape, v.dtype) for k, v in pool[0].items()}
    return HostDataset(make_iter, element_spec=spec,
                       initial_state={"index": 0})


def _register(traffic: dict) -> str:
    from distributed_tensorflow_framework_torch.data import register_dataset
    name = traffic_lib.dataset_name(traffic)
    if name not in _REGISTERED:
        register_dataset(name)(_factory)
        _REGISTERED.add(name)
    return name


# ------------------------------------------------------- configuration --

def experiment_overrides(cfgfile: dict, work: dict, traffic: dict,
                         extra: list[str]) -> list[str]:
    """The overrides a run applies to the configuration's experiment:
    the configuration's own, the traffic's batch and lengths, the cell's
    mesh and its own, then ``extra`` (the tests' sizes, a control)."""
    chips = int(work["chips"])
    out = list(cfgfile["overrides"])
    out.append(f"data.name={traffic_lib.dataset_name(traffic)}")
    out.append("data.global_batch_size="
               f"{traffic_lib.rows_per_step(traffic, chips)}")
    out += traffic_lib.overrides(traffic)
    out.append(f"mesh.data={chips}")
    return out + list(work.get("overrides", [])) + list(extra)


def build_config(cfgfile: dict, work: dict, traffic: dict,
                 extra: list[str] = ()):
    from distributed_tensorflow_framework_torch.core.config import (
        load_config)
    return load_config(None, overrides=experiment_overrides(
        cfgfile, work, traffic, extra), base=cfgfile["experiment"])


# -------------------------------------------------------------- faults --

def plant(fault: str | None, trainer) -> None:
    """Break the timed path underneath (the fault tests and the readings
    of step 3's faults): ``frozen`` — the update does nothing;
    ``half_batch`` — the step sees the first half of its rows alone, its
    mean over them; ``no_exchange`` — the ranks' gradients are never
    averaged."""
    if fault is None:
        return
    state, builder = trainer.state, trainer.builder
    if fault == "frozen":
        state.optimizer.step = lambda grad_norm: None
    elif fault == "half_batch":
        step = builder.train_step

        def half(st, batch, **kw):
            return step(st, {k: v[: v.shape[0] // 2] for k, v in
                             batch.items()}, **kw)
        builder.train_step = half
    elif fault == "no_exchange":
        if state.ddp is None:
            raise ValueError("no_exchange needs ranks that exchange")
        state.ddp.require_backward_grad_sync = False
    else:
        raise ValueError(f"unknown fault {fault!r}")


# ------------------------------------------------------------ captures --

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def capture_grads(trainer, optimizer_name: str) -> dict[str, float]:
    """Each leaf's norm of the first step's gradient as the optimizer took
    it (after clipping), from the optimizer's state after that step, read
    back by ``optimizers/<optimizer_name>.py``; a leaf without state took
    no gradient."""
    from benchlib import spec as spec_lib
    rule = spec_lib.optimizer(optimizer_name)
    inner = trainer.state.optimizer.inner
    group_of = {id(p): g for g in inner.param_groups for p in g["params"]}
    names, grads = [], []
    with torch.no_grad():
        for name, p in trainer.state.model.named_parameters():
            g = rule.first_grad(p, inner.state.get(p, {}), group_of[id(p)])
            if g is None:
                g = torch.zeros_like(p)
            names.append(name)
            grads.append(torch.linalg.vector_norm(g.float()))
        return dict(zip(names, torch.stack(grads).tolist()))


def capture_change(trainer, ref, exp: dict, seed: int) -> dict[str, float]:
    """Each leaf's (and running statistic's) norm of its change from the
    benchmark's starting values, made again from the seed."""
    device = trainer.device
    start = weights_lib.make(ref.param_specs(exp), seed, device)
    start.update(weights_lib.make(ref.buffer_specs(exp), seed, device))
    model = trainer.state.model
    now = dict(model.named_parameters())
    now.update(dict(model.named_buffers()))
    with torch.no_grad():
        norms = torch.stack([torch.linalg.vector_norm(
            now[k].float() - start[k]) for k in start]).tolist()
    return dict(zip(start, norms))


def install(trainer, ref, exp: dict, seed: int) -> None:
    """The benchmark's weights and running statistics into the program's
    model (its names and shapes must be the reference's), and its dropout
    generator seeded with the benchmark's seed."""
    model = trainer.state.model
    for kind, specs, have in (
            ("parameters", ref.param_specs(exp),
             dict(model.named_parameters())),
            ("buffers", ref.buffer_specs(exp), dict(model.named_buffers()))):
        shapes = {k: tuple(v.shape) for k, v in have.items()}
        want = {k: tuple(s) for k, (s, _) in specs.items()}
        if shapes != want:
            names = sorted(set(shapes) ^ set(want))[:8]
            sized = [k for k in want if k in shapes and shapes[k] != want[k]]
            raise RuntimeError(
                f"the program's {kind} are not the reference's: {names} "
                f"differ in name, {sized[:8]} in shape")
        values = weights_lib.make(specs, seed, trainer.device)
        with torch.no_grad():
            for k, v in values.items():
                have[k].copy_(v)
        del values
    trainer.state.dropout_generator.manual_seed(
        seeds.derive(seed, seeds.DROPOUT))


# ---------------------------------------------------------------- hook --

def _last_nodes(out_node, in_node, limit: int = 64) -> list:
    """The autograd nodes between a module's output and its input that
    hand the gradient on to the input's node: where the module's backward
    ends. Empty where the walk passes ``limit`` nodes."""
    seen, todo, last = set(), [out_node], []
    while todo:
        node = todo.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if len(seen) > limit:
            return []
        nxt = [n for n, _ in node.next_functions if n is not None]
        if any(n is in_node for n in nxt):
            last.append(node)
        todo += [n for n in nxt if n is not in_node
                 and type(n).__name__ != "AccumulateGrad"]
    return last


class Spans:
    """Marker launches (``torch.cuda._sleep(0)``, whose kernel nothing
    else launches) around labelled stretches of host code, and the labels
    in launch order, so that the trace itself says which kernels each
    stretch launched (report.py pairs them). Off the card the labels are
    kept and nothing is launched."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.marks: list[list[str]] = []

    def mark(self, label: str, edge: str) -> None:
        if self.cuda:
            torch.cuda._sleep(0)
        self.marks.append([label, edge])

    def wrap(self, fn, label: str):
        def spanned(*args, **kwargs):
            self.mark(label, "begin")
            out = fn(*args, **kwargs)
            self.mark(label, "end")
            return out
        return spanned

    def bracket_module(self, module, label: str) -> None:
        """Each forward of ``module`` between two markers; each backward,
        from the gradient reaching its output's node to the node that
        hands it to its input's, between two more."""
        def pre(mod, args):
            self.mark(label, "begin")

        def post(mod, args, out):
            self.mark(label, "end")
            x = args[0] if args else None
            if (not isinstance(out, torch.Tensor) or out.grad_fn is None
                    or not isinstance(x, torch.Tensor)
                    or x.grad_fn is None):
                return
            last = _last_nodes(out.grad_fn, x.grad_fn)
            if len(last) != 1:
                return
            out.grad_fn.register_prehook(
                lambda grads: self.mark(label, "begin"))
            last[0].register_hook(
                lambda grads_in, grads_out: self.mark(label, "end"))
        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)


class BenchHook:
    """The benchmark's hook: the captures, the window's clock and events,
    and the profile window (module docstring)."""

    def __init__(self, run: dict, ref, exp: dict, seed: int,
                 module_spans: dict[str, str] | None = None):
        self.run = run
        self.ref, self.exp, self.seed = ref, exp, seed
        self.module_spans = module_spans or {}
        self.events: list = []
        self.prof = None
        self.spans: Spans | None = None

    def on_start(self, trainer) -> None:
        pass

    def on_end(self, trainer) -> None:
        pass

    def _event(self, device):
        if device.type != "cuda":
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def after_step(self, trainer, step, metrics) -> None:
        r = self.run
        cfg = trainer.config.train
        dev = trainer.device
        if step <= CHECK_STEPS:
            r["losses"].append(float(metrics["loss"]))
            if step == 1:
                r["grad_norms"] = capture_grads(
                    trainer, self.exp["optimizer"]["name"])
            if step == CHECK_STEPS:
                r["change_norms"] = capture_change(trainer, self.ref,
                                                   self.exp, self.seed)
                # The next fetch is at the window's start, W (a multiple).
                cfg.log_interval = r["window_start"]
            return
        if step == CHECK_STEPS + r["warm_steps"]:
            _sync(dev)
            r["t_warm"] = time.time()
        elif step == r["window_start"]:
            _sync(dev)
            est = (time.time() - r["t_warm"]) / r["timed_warm_steps"]
            est = _max_over_ranks(trainer, est)
            n = max(r["min_steps"], math.ceil(r["seconds"] / est))
            r["steps"], r["step_estimate_s"] = n, est
            r["window_end"] = step + n
            cfg.log_interval = r["log_interval"]
            cfg.total_steps = r["window_end"] + (r["profile_steps"]
                                                 if r["trace"] else 0)
            _sync(dev)
            r["t0"] = time.time()
            self.events.append(self._event(dev))
        elif r["window_start"] < step <= r.get("window_end", -1):
            self.events.append(self._event(dev))
            if step == r["window_end"]:
                _sync(dev)
                r["t_end"] = time.time()
                if r["trace"]:
                    self._open_profile(trainer)

    def _open_profile(self, trainer) -> None:
        """A CUDA-only profile from here to the end; each call of the
        optimizer (span ``optimizer``), and each module whose class the
        cell's readers name, between marker launches."""
        from torch.profiler import ProfilerActivity, profile
        dev = trainer.device
        acts = ([ProfilerActivity.CUDA] if dev.type == "cuda"
                else [ProfilerActivity.CPU])
        self.prof = profile(activities=acts)
        self.prof.start()
        self.spans = Spans(cuda=dev.type == "cuda")
        opt = trainer.state.optimizer
        opt.step = self.spans.wrap(opt.step, "optimizer")
        for label, cls in self.module_spans.items():
            for m in trainer.state.model.modules():
                if type(m).__name__ == cls:
                    self.spans.bracket_module(m, label)

    def close(self, trainer, run_dir: pathlib.Path, rank: int) -> None:
        """After the loop: the window's step intervals, and the profile's
        trace written out."""
        r = self.run
        dev = trainer.device
        _sync(dev)
        ev = self.events
        if dev.type == "cuda":
            r["intervals_ms"] = [a.elapsed_time(b) for a, b in
                                 zip(ev[:-1], ev[1:])]
        else:
            r["intervals_ms"] = [1e3 * (b - a) for a, b in
                                 zip(ev[:-1], ev[1:])]
        r["marks"] = self.spans.marks if self.spans else []
        if self.prof is not None:
            self.prof.stop()
            path = run_dir / f"trace-r{rank}.json"
            self.prof.export_chrome_trace(str(path))
            r["trace_path"] = str(path)
            self.prof = None


def _max_over_ranks(trainer, value: float) -> float:
    rt = trainer.runtime
    if rt.process_count == 1:
        return value
    import torch.distributed as dist
    dev = (trainer.device if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


# ---------------------------------------------------------------- rank --

def run_rank(spec: dict) -> dict:
    """One rank's part of a run; returns what the report needs, as plain
    data. ``spec``: cfgfile, work, traffic, seed, seconds, trace, rank,
    device, run_dir, t_start, fault, readings_only, extra, module_spans."""
    from distributed_tensorflow_framework_torch.train.loop import Trainer
    from benchlib import spec as spec_lib

    cfgfile, work, traffic = spec["cfgfile"], spec["work"], spec["traffic"]
    device = torch.device(spec["device"])
    run_dir = pathlib.Path(spec["run_dir"])
    rank = spec["rank"]
    config = build_config(cfgfile, work, traffic, spec.get("extra", ()))
    exp = config.to_dict()
    ref = spec_lib.reference(cfgfile)
    seed = spec["seed"]
    _SOURCE.update(traffic=traffic, data=exp["data"], seed=seed,
                   device=device)
    _register(traffic)
    log_interval = config.train.log_interval
    check = CHECK_STEPS
    window_start = check + work["warm_steps"] + work["timed_warm_steps"]
    run = {"rank": rank, "losses": [], "seconds": spec["seconds"],
           "trace": bool(spec["trace"]), "warm_steps": work["warm_steps"],
           "timed_warm_steps": work["timed_warm_steps"],
           "window_start": window_start, "min_steps": work["min_steps"],
           "profile_steps": work["profile_steps"],
           "log_interval": log_interval}
    config.train.log_interval = 1
    trainer = Trainer(config, device=device,
                      log_dir=str(run_dir / f"rank{rank}"))
    trainer.build()
    install(trainer, ref, exp, seed)
    plant(spec.get("fault"), trainer)
    if spec.get("readings_only"):
        config.train.total_steps = check
    hook = BenchHook(run, ref, exp, seed, spec.get("module_spans"))
    trainer.train(hooks=trainer.default_hooks() + [hook])
    hook.close(trainer, run_dir, rank)
    run["events_path"] = str(run_dir / f"rank{rank}" / "events.jsonl")
    if device.type == "cuda":
        run["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        run["device_name"] = torch.cuda.get_device_name(device)
    else:
        run["peak_bytes"], run["device_name"] = 0, "cpu"
    run["pool_tokens"], run["pool_flops"] = _pool_counts(
        traffic, exp, ref, seed, rank, device)
    run["exp"] = exp
    run["forbidden"] = forbidden_modules()
    del trainer, hook
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run


def _pool_counts(traffic: dict, exp: dict, ref, seed: int, rank: int,
                 device) -> tuple[list[int], list[float]]:
    """Each pool batch's real (non-padding) tokens (0 for images) and
    model FLOPs of a step on it (the reference's count)."""
    tokens, flops = [], []
    for i in range(int(traffic["pool_batches"])):
        batch = traffic_lib.make_batch(traffic, exp["data"], seed, rank, i,
                                       device)
        tokens.append(traffic_lib.real_tokens(traffic, batch))
        flops.append(float(ref.step_flops(exp, batch)))
    return tokens, flops


def write_json(path: pathlib.Path, data) -> None:
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as fh:
        json.dump(data, fh)
    os.replace(tmp, path)
