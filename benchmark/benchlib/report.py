"""From the ranks' records to the result line: the :class:`Run` the
metric readers read, the reference's replay and the comparison, and the
last line of standard output.
"""

from __future__ import annotations

import bisect
import json
import math
import sys

from benchlib import kineto, seeds, spec, traffic as traffic_lib
from benchlib import weights as weights_lib

MARKER_NAME = "spin_kernel"


class Run:
    """What one run measured, for the metric readers (``read(run)``):

    * ``chips``, ``steps`` (N, the window's steps), ``window_s`` (the
      longest rank's window, host clock between synchronisations),
      ``setup_s`` (process start to the window's start, the last rank),
      ``intervals_ms`` (per window step, the slowest rank's interval
      between consecutive step completions, CUDA events),
      ``peak_bytes`` (the fullest rank's allocator peak);
    * ``window_rows``, ``window_tokens``, ``window_flops``: images or
      rows, real tokens and model FLOPs of every step of the window over
      every rank;
    * ``exp`` (the experiment as run), ``traffic``, ``work``;
    * traced runs: :meth:`device_events` and :meth:`span_events` of a
      rank's profile, ``profile_steps``, and :meth:`loop_events`, the
      loop's own ``events.jsonl`` records.
    """

    def __init__(self, cell: str, work: dict, traffic: dict, ranks: list,
                 t_start: float, trace: bool):
        self.cell, self.work, self.traffic = cell, work, traffic
        self.ranks = sorted(ranks, key=lambda r: r["rank"])
        self.trace = trace
        self.chips = len(ranks)
        r0 = self.ranks[0]
        self.exp = r0["exp"]
        self.steps = r0["steps"]
        self.profile_steps = r0["profile_steps"] if trace else 0
        self.window_s = max(r["t_end"] - r["t0"] for r in self.ranks)
        self.setup_s = max(r["t0"] for r in self.ranks) - t_start
        self.intervals_ms = [max(v) for v in
                             zip(*(r["intervals_ms"] for r in self.ranks))]
        self.peak_bytes = max(r["peak_bytes"] for r in self.ranks)
        first, last = r0["window_start"] + 1, r0["window_end"]
        self.window_rows = (self.steps * self.chips
                            * int(traffic["rows_per_chip"]))
        self.window_tokens = self.window_flops = 0
        for r in self.ranks:
            pool = len(r["pool_tokens"])
            for k in range(first, last + 1):
                self.window_tokens += r["pool_tokens"][(k - 1) % pool]
                self.window_flops += r["pool_flops"][(k - 1) % pool]
        self._parsed: dict = {}

    # ------------------------------------------------------- the trace --
    def _trace(self, rank: int):
        """(device events without the markers, each span's events)."""
        if rank not in self._parsed:
            path = self.ranks[rank].get("trace_path")
            events = (kineto.device_events(kineto.load_kineto(path))
                      if path else [])
            marks = sorted((e for e in events if MARKER_NAME in e.name
                            and e.launch_ps is not None),
                           key=lambda e: e.launch_ps)
            events = [e for e in events if MARKER_NAME not in e.name]
            self._parsed[rank] = (events, spans(
                events, marks, self.ranks[rank].get("marks", [])))
        return self._parsed[rank]

    def device_events(self, rank: int = 0) -> list:
        """The profiled steps' kernels, memcpys and memsets on the card."""
        return self._trace(rank)[0]

    def span_events(self, label: str, rank: int = 0) -> list | None:
        """The device events launched inside the spans ``label`` (the
        optimizer's calls, a module's forwards and backwards); None where
        the trace holds no such span or its markers do not pair."""
        found = self._trace(rank)[1]
        return None if found is None else found.get(label)

    def loop_events(self, rank: int = 0) -> list[dict]:
        path = self.ranks[rank].get("events_path")
        out = []
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        except OSError:
            return []
        return out

    def window_start_step(self) -> int:
        return self.ranks[0]["window_start"]

    def busy_and_window_s(self) -> tuple[float, float] | None:
        """The device's busy seconds (union of its events) and the traced
        window's seconds, averaged over the ranks."""
        pairs = []
        for rank in range(self.chips):
            ev = self.device_events(rank)
            if not ev:
                return None
            lo, hi = kineto.window(ev)
            busy = kineto.union_ps([(e.start_ps, e.end_ps) for e in ev])
            pairs.append((busy / 1e12, (hi - lo) / 1e12))
        n = len(pairs)
        return (sum(p[0] for p in pairs) / n, sum(p[1] for p in pairs) / n)


def spans(events: list, marks: list, labels: list) -> dict | None:
    """Each label's device events: those launched on a span's thread
    between its two markers. ``marks`` are the marker launches by launch
    time, ``labels`` the hook's [label, edge] in launch order, one for
    one; None where they do not match or a span does not close."""
    if len(marks) != len(labels):
        return None
    by_tid: dict = {}
    for e in events:
        if e.launch_ps is not None:
            by_tid.setdefault(e.launch_tid, []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: e.launch_ps)
    times = {t: [e.launch_ps for e in evs] for t, evs in by_tid.items()}
    out: dict[str, list] = {}
    open_: dict[str, list] = {}
    for m, (label, edge) in zip(marks, labels):
        if edge == "begin":
            open_.setdefault(label, []).append(m)
            continue
        if not open_.get(label):
            return None
        a = open_[label].pop()
        t = times.get(a.launch_tid, [])
        lo = bisect.bisect_right(t, a.launch_ps)
        hi = bisect.bisect_left(t, m.launch_ps)
        out.setdefault(label, []).extend(by_tid[a.launch_tid][lo:hi]
                                         if t else [])
    if any(open_.values()):
        return None
    return out


# --------------------------------------------------------- correctness --

def reference_readings(cfgfile: dict, traffic: dict, exp: dict, seed: int,
                       chips: int, device, quant: str | None = None,
                       steps: int | None = None) -> dict:
    """The reference's replay of the first steps: the benchmark's weights
    from the seed, each step's global batch (every rank's block of it, in
    rank order) made again from the seed, the dropout seed the program's
    generator was given."""
    import torch
    from benchlib.cell import CHECK_STEPS
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # what an earlier replay left cached
    ref = spec.reference(cfgfile)
    params = weights_lib.make(ref.param_specs(exp), seed, device)
    buffers = weights_lib.make(ref.buffer_specs(exp), seed, device)
    batches = []
    for i in range(steps or CHECK_STEPS):
        blocks = [traffic_lib.make_batch(traffic, exp["data"], seed, r, i,
                                         device) for r in range(chips)]
        batches.append({k: torch.cat([b[k] for b in blocks])
                        for k in blocks[0]})
    return ref.train_steps(exp, params, buffers, batches,
                           dropout_seed=seeds.derive(seed, seeds.DROPOUT),
                           quant=quant)


def program_readings(ranks: list) -> dict:
    r0 = min(ranks, key=lambda r: r["rank"])
    return {"losses": r0["losses"], "grad_norms": r0["grad_norms"],
            "change_norms": r0["change_norms"]}


# -------------------------------------------------------------- output --

def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def metric_values(bench: dict, run: Run, trace: bool) -> dict:
    out = {}
    for m in spec.cell_metrics(bench, run.cell, trace):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(run: Run, top: int = 10) -> dict | None:
    """The traced steps' device operations that took most time, and the
    longest idle gaps, each named by the operation that ended it (the
    trace holds no host activity), on the rank with the most idle time."""
    worst, idle = None, -1.0
    for rank in range(run.chips):
        ev = run.device_events(rank)
        if not ev:
            return None
        lo, hi = kineto.window(ev)
        gap = (hi - lo) - kineto.union_ps([(e.start_ps, e.end_ps)
                                           for e in ev])
        if gap > idle:
            worst, idle = rank, gap
    ev = run.device_events(worst)
    per_op: dict[str, int] = {}
    for e in ev:
        per_op[e.name] = per_op.get(e.name, 0) + e.dur_ps
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(kineto.idle_gaps(ev), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], d / 1e12] for n, d in ops],
            "idle_gaps": [["before " + n[:113], (b - a) / 1e12]
                          for a, b, n in gaps]}


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def result_line(bench: dict, run: Run, correct: bool, checks: dict,
                device_kind: str, trace: bool, platform: str) -> dict:
    device = {"platform": platform, "kind": device_kind, "count": run.chips,
              "memory_peak_bytes": run.peak_bytes}
    out = {"correct": bool(correct), "attempted": run.steps, "failed": 0,
           "metrics": metric_values(bench, run, trace), "device": device}
    if trace:
        bw = run.busy_and_window_s()
        if bw is not None:
            device["busy_s"], device["window_s"] = bw
        bd = breakdown(run)
        if bd is not None:
            out["breakdown"] = bd
    out["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out
