"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's files are found by name
(benchlib/spec.py). A cell on one chip runs in this process; a cell on
more starts one process per GPU (``--worker``, the port's gang
environment) and waits for each. After the window the program's state is
freed and the plain reference replays the first steps (in this process,
on the first card); the comparison decides ``correct``. The last line of
standard output is the result; the compared numbers, each beside its
limit, are the last lines of standard error. The exit code is 0 only
with a result: 2 without the cards the cell asks for, 3 when a forbidden
module (JAX, Flax, the JAX package) was loaded by a rank or is loaded in
this process when the result would be printed, 1 on any other failure.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# Kernel caches at fixed paths inside the checkout: only the first run of
# a cell there builds (the port's own nvcc builds go to build/kernels/).
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build"
                                         / "torch_extensions")
os.environ["USE_FLAX"] = "0"
for path in (str(CHECKOUT), str(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)

from benchlib import spec  # noqa: E402

WORKER_TIMEOUT_S = 330


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--worker", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(rank_spec: dict, chips: int, run_dir: pathlib.Path,
             timeout_s: float = WORKER_TIMEOUT_S) -> list:
    """One process per GPU, each running its rank; their records (with
    ``jobs`` in ``rank_spec``, one list of records per job)."""
    from distributed_tensorflow_framework_torch.core import cluster
    from benchlib import cell
    path = run_dir / "spec.json"
    cell.write_json(path, rank_spec)
    port = _free_port()
    procs = []
    try:
        for r in range(chips):
            env = cluster.worker_env(dict(os.environ),
                                     coordinator_port=port,
                                     num_processes=chips, process_id=r)
            if rank_spec["device"] == "cpu":  # the tests' gloo ranks
                env.setdefault("OMP_NUM_THREADS",
                               str(max(1, os.cpu_count() // chips)))
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "run.py"), "--worker", str(path),
                 "--rank", str(r)], env=env, stdout=sys.stderr,
                cwd=os.getcwd()))
        deadline = time.time() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                raise RuntimeError("a rank failed: exit codes "
                                   f"{[p.poll() for p in procs]}")
            if time.time() > deadline:
                raise RuntimeError(f"the ranks outlasted {timeout_s} s")
            time.sleep(0.2)
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"a rank failed: exit codes {codes}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if "jobs" in rank_spec:
        return [[spec.load_json(run_dir / f"rank{r}-job{i}.json")
                 for r in range(chips)]
                for i in range(len(rank_spec["jobs"]))]
    return [spec.load_json(run_dir / f"rank{r}.json") for r in range(chips)]


def worker(args) -> int:
    from benchlib import cell
    rank_spec = spec.load_json(pathlib.Path(args.worker))
    rank_spec["rank"] = args.rank
    run_dir = pathlib.Path(rank_spec["run_dir"])
    if "jobs" not in rank_spec:
        cell.write_json(run_dir / f"rank{args.rank}.json",
                        cell.run_rank(rank_spec))
        return 0
    for i, job in enumerate(rank_spec["jobs"]):  # benchmark/readings.py
        cell.write_json(run_dir / f"rank{args.rank}-job{i}.json",
                        cell.run_rank({**rank_spec, **job}))
    return 0


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", fault: str | None = None,
             tiny: dict | None = None, root: pathlib.Path = CHECKOUT
             ) -> tuple[int, dict | None]:
    """Run cell ``name`` once; returns (exit code, result). ``device``
    "cpu", ``fault`` and ``tiny`` serve the tests: ``tiny`` holds
    ``extra`` overrides of the experiment and entries that replace the
    traffic's and the workload's."""
    import torch
    from benchlib import cell, compare, report
    bench = spec.benchmark(root)
    spec.cell_entry(bench, name)
    work = spec.workload(name)
    cfgfile = spec.config(work["config"])
    traffic = spec.traffic(work["traffic"])
    tiny = tiny or {}
    work = {**work, **tiny.get("work", {})}
    traffic = {**traffic, **tiny.get("traffic", {})}
    chips = int(work["chips"])
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= chips):
        print(f"cell {name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2, None
    run_dir = pathlib.Path(tempfile.mkdtemp(prefix="bench-run-"))
    try:
        rank_spec = dict(cfgfile=cfgfile, work=work, traffic=traffic,
                         seed=seed, seconds=seconds, trace=trace,
                         device=device, run_dir=str(run_dir),
                         t_start=T_START, fault=fault,
                         extra=tiny.get("extra", []),
                         module_spans=(spec.module_spans(bench, name)
                                       if trace else {}),
                         rank=0)
        if chips == 1:
            ranks = [cell.run_rank(rank_spec)]
        else:
            ranks = run_gang(rank_spec, chips, run_dir)
        found = sorted({m for r in ranks for m in r["forbidden"]}
                       | set(cell.forbidden_modules()))
        if found:
            print("forbidden modules loaded: " + ", ".join(found),
                  file=sys.stderr)
            return 3, None
        run = report.Run(name, work, traffic, ranks, T_START, trace)
        exp = ranks[0]["exp"]
        ref_device = torch.device("cuda", 0) if device == "cuda" else \
            torch.device(device)
        reference = report.reference_readings(cfgfile, traffic, exp, seed,
                                              chips, ref_device)
        numbers = compare.gaps(report.program_readings(ranks), reference)
        correct, checks = compare.decide(numbers, work["limits"])
        print(f"worst leaves: grad {numbers['grad_leaf']}, change "
              f"{numbers['change_leaf']}; left out of the change: "
              f"{len(numbers['left_out'])}", file=sys.stderr)
        result = report.result_line(
            bench, run, correct, checks, ranks[0]["device_name"], trace,
            "gpu" if device == "cuda" else device)
        return 0, result
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def finish(code: int, result: dict | None) -> int:
    """Print the result, unless a forbidden module is loaded in this
    process now, after the reference's replay and the readers: then no
    result, exit code 3."""
    from benchlib import cell, report
    if result is None:
        return code
    found = cell.forbidden_modules()
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    report.emit(result)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    if args.worker:
        return worker(args)
    if args.workload is None or args.seed is None or args.seconds is None:
        print("--workload, --seed and --seconds are required",
              file=sys.stderr)
        return 1
    return finish(*run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace)))


if __name__ == "__main__":
    sys.exit(main())
