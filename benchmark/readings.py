"""The readings that the limits of ``correct`` are set from, at a cell's
own size on the chip (not run by the benchmark's runs):

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... \
        [--controls fp8 int8] [--control-seeds ...] \
        [--faults half_batch no_exchange] [--fault-seeds ...]

For each seed the program's first steps (``run.py``'s set-up, no window)
against the f32 reference's replay: the three gaps of benchlib/compare.py
and the leaves that set them. ``--controls``: ``fp8`` is the reference
computed with fp8 operands in the program's place; ``int8`` is the
program with its own int8 path (``precision.matmul_dtype=int8``), where
the configuration has one. ``--faults``: the program with that fault
planted (benchlib/cell.py ``plant``). All of one cell in one process (one
process per GPU on more chips); the lines go to standard output and, as
one JSON document, to ``--out``.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import run  # noqa: E402,F401  (the cache directories, the path)
from benchlib import compare, report, spec  # noqa: E402

CONTROL_OVERRIDES = {"int8": ["precision.matmul_dtype=int8"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    work = spec.workload(args.workload)
    cfgfile = spec.config(work["config"])
    traffic = spec.traffic(work["traffic"])
    chips = int(work["chips"])
    jobs = [{"seed": s, "label": "program"} for s in args.seeds]
    jobs += [{"seed": s, "label": c, "extra": CONTROL_OVERRIDES[c]}
             for c in args.controls if c in CONTROL_OVERRIDES
             for s in args.control_seeds]
    jobs += [{"seed": s, "label": f, "fault": f}
             for f in args.faults for s in args.fault_seeds]
    run_dir = pathlib.Path(tempfile.mkdtemp(prefix="bench-readings-"))
    base = dict(cfgfile=cfgfile, work=work, traffic=traffic, seconds=0,
                trace=False, device=args.device, run_dir=str(run_dir),
                t_start=T_START, fault=None, extra=[], rank=0,
                readings_only=True)
    lines = []
    from benchlib import cell
    try:
        dev = (torch.device("cuda", 0) if args.device == "cuda"
               else torch.device(args.device))
        exp0 = cell.build_config(cfgfile, work, traffic).to_dict()
        truths = {}

        def truth(seed):
            if seed not in truths:
                t0 = time.time()
                truths[seed] = report.reference_readings(
                    cfgfile, traffic, exp0, seed, chips, dev)
                truths[seed]["seconds"] = time.time() - t0
            return truths[seed]

        def line(job, ranks):
            ref = truth(job["seed"])
            g = compare.gaps(report.program_readings(ranks), ref)
            lines.append({"label": job["label"], "seed": job["seed"],
                          **{k: g[k] for k in ("loss_gap", "grad_gap",
                                               "change_gap", "grad_leaf",
                                               "change_leaf")},
                          "left_out": len(g["left_out"]),
                          "losses": ranks[0]["losses"],
                          "reference_losses": ref["losses"],
                          "reference_s": ref["seconds"]})
            print(json.dumps(lines[-1]), flush=True)

        if chips == 1:
            for job in jobs:
                try:
                    ranks = [cell.run_rank({**base, **job})]
                except Exception as e:  # a control that crashes has failed
                    lines.append({"label": job["label"], "seed": job["seed"],
                                  "error": repr(e)[:500]})
                    print(json.dumps(lines[-1]), flush=True)
                    torch.cuda.empty_cache() if dev.type == "cuda" else None
                    continue
                line(job, ranks)
        elif jobs:
            records = run.run_gang({**base, "jobs": jobs}, chips, run_dir,
                                   timeout_s=3000)
            for job, ranks in zip(jobs, records):
                line(job, ranks)
        if "fp8" in args.controls:
            for seed in args.control_seeds:
                ref = truth(seed)
                ctl = report.reference_readings(
                    cfgfile, traffic, exp0, seed, chips, dev, quant="fp8")
                g = compare.gaps(ctl, ref)
                lines.append({"label": "fp8", "seed": seed,
                              **{k: g[k] for k in ("loss_gap", "grad_gap",
                                                   "change_gap", "grad_leaf",
                                                   "change_leaf")}})
                print(json.dumps(lines[-1]), flush=True)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(lines, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
