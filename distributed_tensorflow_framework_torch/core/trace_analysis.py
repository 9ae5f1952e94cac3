"""Kineto trace analysis: where did the traced step time actually go?

The port's copy of ``core/trace_analysis.py``. The profile window
(core/profiling.py, train/hooks.py ``ProfileHook``) writes a Kineto
chrome trace (``*.pt.trace.json``, gzip allowed); this module turns one
into a time-by-category breakdown — GEMM/conv, collectives, infeed/host
transfers, optimizer update, other compute, launch gaps — with the JAX
package's categories, report and ``trace_summary`` event, so
``scripts/analyze_trace.py`` and ``format_report`` read it as they read a
TPU trace.

Two things differ from the JAX file, which reads an XPlane:

  * Lines. Device kernels (``cat: "kernel"``), memcpys and memsets become
    events on their CUDA stream's line (``Stream #<n>``, plane
    ``/device:GPU:<i>``), which plays the part of the JAX executor line.
    CPU ops and runtime calls go on a host line (``host thread <tid>``)
    that the executor pattern does not match, as the JAX ``python`` host
    line does not; on a trace with no device events (the CPU) ``analyze``
    falls back to them, as the JAX function falls back to every timed
    event. ``record_function`` ranges (``user_annotation``), their GPU
    shadows and the profiler's own spans become no events.
  * Scope. An XLA event's scope comes from the optimized HLO's
    ``op_name`` metadata; a kernel's comes from the op that launched it:
    its ``correlation`` id leads to the ``cudaLaunchKernel`` (or driver
    launch) runtime event, and the ``record_function`` ranges on that
    thread around the launch are its scope, outermost first, joined by
    ``/``. A kernel launched under ``optimizer_update`` classifies as
    ``optimizer_update``, as an HLO op with that ``op_name`` does. A host
    event's scope is the ranges around it on its own thread.

The name patterns are the JAX file's, widened with the CUDA libraries'
kernel names: cuBLAS/cuBLASLt (``nvjet``, ``gemm``), CUTLASS and cuDNN
(``xmma``, convolution) kernels classify as ``gemm_conv``, NCCL and gloo
as ``collectives``, ``Memcpy HtoD``/``DtoH`` as ``infeed``; PyTorch's
elementwise ``*_copy_kernel`` (a cast on the device) is not an infeed.
The flash-attention kernels land in ``other_compute``, where a Pallas
custom call lands in the JAX package; ``top_ops`` names them.

The breakdown is exhaustive over the traced window: busy time (union of
executor-line event intervals) is split over categories proportionally to
their summed event durations (concurrent streams can sum past wall time —
the proportional split keeps categories + launch_gap == the window, so
fractions are honest wall-clock shares).
"""

from __future__ import annotations

import bisect
import dataclasses
import decimal
import gzip
import json
import os
import re
from typing import Any, Mapping

from distributed_tensorflow_framework_torch.core import telemetry


@dataclasses.dataclass
class TraceEvent:
    name: str
    start_ps: int  # absolute, within the trace's timebase
    duration_ps: int
    line: str
    plane: str
    # The record_function ranges around the launching op, outermost
    # first, "/"-joined ("" when none): the port's op_name scope.
    scope: str = ""


# ------------------------------------------------------- classification --

CATEGORIES = (
    "gemm_conv", "collectives", "infeed", "optimizer_update",
    "other_compute",
)
GAP = "launch_gap"

_COLLECTIVE_RE = re.compile(
    r"all-reduce|all-gather|all-to-all|reduce-scatter|collective-permute"
    r"|psum|ppermute|nccl|gloo|c10d::", re.I)
_GEMM_RE = re.compile(
    r"\bdot\b|^dot[._]|convolution|conv[._\d]|gemm|matmul"
    r"|nvjet|xmma|cutlass|cublas|gemv|convolve"
    r"|aten::(?:add|b|baddb)?mm\b|aten::linear\b", re.I)
_INFEED_RE = re.compile(
    r"infeed|outfeed|copy[-._](?!kernel)|^copy|transfer|buffer[- ]"
    r"|Memcpy (?:HtoD|DtoH)", re.I)
# Executor lines: XLA:CPU client threads (tf_XLATfrtCpuClient/<n>) or
# device streams (the port's "Stream #<n>"). The host line (CPU ops,
# runtime calls) wraps device time and must not be double counted.
_EXECUTOR_LINE_RE = re.compile(r"XLA|TfrtCpuClient|/device:|Stream|TensorFlow", re.I)
# Runtime bookkeeping spans that WRAP the real op events on the same lines
# (ThunkExecutor::Execute covers the whole dispatch including its waits).
# Dropped entirely: leaf ops define busy time, so wrapper-only time —
# genuinely waiting — lands in launch_gap instead of other_compute.
_WRAPPER_EVENT_RE = re.compile(
    r"ThunkExecutor|TfrtCpuExecutable|PjitFunction|ThreadpoolListener"
    r"|ExecuteGraph|BufferAllocations|RunId", re.I)


def classify(name: str, scope: str | None = None) -> str:
    if scope and "optimizer_update" in scope:
        return "optimizer_update"
    subject = f"{name} "
    if _COLLECTIVE_RE.search(subject):
        return "collectives"
    if _GEMM_RE.search(subject):
        return "gemm_conv"
    if _INFEED_RE.search(subject):
        return "infeed"
    return "other_compute"


# ---------------------------------------------------------------- kineto --

# Kineto event categories: device work on a stream's line, host work on
# its thread's line, the launch calls a kernel's correlation id names,
# and the record_function ranges that give scopes.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_SCOPE_CATS = ("user_annotation",)


def _ps(us) -> int:
    """Kineto microseconds (parsed as Decimal: exact) → picoseconds."""
    return int(decimal.Decimal(us) * 1_000_000)


def load_kineto(path: str) -> dict:
    """A Kineto chrome trace (``.json`` or ``.json.gz``) as parsed JSON,
    timestamps as Decimal."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh, parse_float=decimal.Decimal)


class _Scopes:
    """The record_function ranges of each (pid, tid), for lookups of the
    ranges around an instant."""

    def __init__(self, ranges: dict[tuple, list[tuple[int, int, str]]]):
        self._ranges = {k: sorted(v) for k, v in ranges.items()}
        self._starts = {k: [r[0] for r in v]
                        for k, v in self._ranges.items()}

    def at(self, thread: tuple, t_ps: int) -> str:
        ranges = self._ranges.get(thread)
        if not ranges:
            return ""
        n = bisect.bisect_right(self._starts[thread], t_ps)
        return "/".join(name for start, end, name in ranges[:n]
                        if end >= t_ps)


def parse_kineto(doc: Mapping[str, Any]) -> list[TraceEvent]:
    """Flatten a Kineto chrome trace into TraceEvents (timed ones only)."""
    raw = [e for e in doc.get("traceEvents", ())
           if e.get("ph") == "X" and e.get("cat")]
    ranges: dict[tuple, list] = {}
    launches: dict[int, tuple[tuple, int]] = {}
    for e in raw:
        cat, thread = e["cat"], (e.get("pid"), e.get("tid"))
        if cat in _SCOPE_CATS:
            start = _ps(e["ts"])
            ranges.setdefault(thread, []).append(
                (start, start + _ps(e.get("dur", 0)), e["name"]))
        elif cat in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[int(corr)] = (thread, _ps(e["ts"]))
    scopes = _Scopes(ranges)
    events: list[TraceEvent] = []
    for e in raw:
        cat = e["cat"]
        dur = _ps(e.get("dur", 0))
        if dur <= 0:
            continue  # instantaneous markers carry no time
        start = _ps(e["ts"])
        args = e.get("args") or {}
        if cat in _DEVICE_CATS:
            launch = launches.get(int(args.get("correlation", -1)))
            events.append(TraceEvent(
                name=e["name"], start_ps=start, duration_ps=dur,
                line=f"Stream #{args.get('stream', e.get('tid'))}",
                plane=f"/device:GPU:{args.get('device', e.get('pid'))}",
                scope=scopes.at(*launch) if launch else ""))
        elif cat in _HOST_CATS:
            thread = (e.get("pid"), e.get("tid"))
            events.append(TraceEvent(
                name=e["name"], start_ps=start, duration_ps=dur,
                line=f"host thread {e.get('tid')}",
                plane=f"/host:CPU:{e.get('pid')}",
                scope=scopes.at(thread, start)))
    return events


# ----------------------------------------------------------- aggregation --


def _union_ps(intervals: list[tuple[int, int]]) -> int:
    if not intervals:
        return 0
    intervals.sort()
    total = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def analyze(events: list[TraceEvent], *, top_n: int = 15) -> dict[str, Any]:
    """Category breakdown over the executor window (see module docstring).
    The report's keys are the JAX package's; ``hlo_map_used`` keeps its
    name and says whether any event carried a launching scope."""
    exe = [e for e in events if _EXECUTOR_LINE_RE.search(e.line)]
    if not exe:
        # Unknown runtime naming — degrade to every timed event rather
        # than an empty report.
        exe = events
    leaf = [e for e in exe if not _WRAPPER_EVENT_RE.search(e.name)]
    if leaf:
        exe = leaf
    if not exe:
        raise ValueError("trace contains no timed events")

    window_start = min(e.start_ps for e in exe)
    window_end = max(e.start_ps + e.duration_ps for e in exe)
    window_ps = window_end - window_start
    busy_ps = _union_ps([(e.start_ps, e.start_ps + e.duration_ps) for e in exe])
    busy_ps = min(busy_ps, window_ps)
    gap_ps = window_ps - busy_ps

    raw: dict[str, int] = {c: 0 for c in CATEGORIES}
    per_op: dict[str, int] = {}
    # A name launched under several scopes is listed in top_ops under
    # the category that took most of its time.
    op_cats: dict[str, dict[str, int]] = {}
    for e in exe:
        cat = classify(e.name, e.scope)
        raw[cat] += e.duration_ps
        per_op[e.name] = per_op.get(e.name, 0) + e.duration_ps
        cats = op_cats.setdefault(e.name, {})
        cats[cat] = cats.get(cat, 0) + e.duration_ps
    raw_total = sum(raw.values()) or 1

    # Proportional wall-clock attribution (see module docstring).
    breakdown: dict[str, dict[str, float]] = {}
    for cat in CATEGORIES:
        wall = busy_ps * raw[cat] / raw_total
        breakdown[cat] = {
            "time_ps": int(wall),
            "fraction_of_window": wall / window_ps if window_ps else 0.0,
            "summed_event_ps": raw[cat],
        }
    breakdown[GAP] = {
        "time_ps": int(gap_ps),
        "fraction_of_window": gap_ps / window_ps if window_ps else 0.0,
        "summed_event_ps": int(gap_ps),
    }
    covered = sum(v["time_ps"] for v in breakdown.values())

    top_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top_n]
    return {
        "window_ps": int(window_ps),
        "busy_ps": int(busy_ps),
        "launch_gap_ps": int(gap_ps),
        "coverage": covered / window_ps if window_ps else 0.0,
        "num_events": len(exe),
        "hlo_map_used": any(e.scope for e in exe),
        "breakdown": breakdown,
        "top_ops": [
            {"name": n, "summed_ps": d,
             "category": max(op_cats[n], key=op_cats[n].get)}
            for n, d in top_ops
        ],
    }


# ------------------------------------------------------------ entrypoints --


def find_trace_files(path: str) -> list[str]:
    """Accept a trace file or a directory holding traces."""
    if os.path.isfile(path):
        return [path]
    hits: list[str] = []
    for root, _, names in os.walk(path):
        hits.extend(os.path.join(root, n) for n in names
                    if n.endswith((".pt.trace.json", ".pt.trace.json.gz")))
    return sorted(hits)


def analyze_trace_file(trace_path: str, *, top_n: int = 15
                       ) -> dict[str, Any]:
    report = analyze(parse_kineto(load_kineto(trace_path)), top_n=top_n)
    report["trace_path"] = trace_path
    return report


def format_report(report: dict[str, Any]) -> str:
    """Human-readable breakdown table."""
    def ms(ps: float) -> str:
        return f"{ps / 1e9:10.3f} ms"

    lines = [
        f"trace: {report.get('trace_path', '<memory>')}",
        f"window: {ms(report['window_ps'])}   busy: {ms(report['busy_ps'])}   "
        f"events: {report['num_events']}   "
        f"hlo attribution: {'yes' if report['hlo_map_used'] else 'no'}",
        "",
        f"{'category':<18} {'wall time':>13} {'% window':>9} {'event sum':>13}",
    ]
    for cat in (*CATEGORIES, GAP):
        b = report["breakdown"][cat]
        lines.append(
            f"{cat:<18} {ms(b['time_ps']):>13} "
            f"{100 * b['fraction_of_window']:>8.1f}% {ms(b['summed_event_ps']):>13}"
        )
    lines.append(f"{'TOTAL':<18} {'':>13} {100 * report['coverage']:>8.1f}%")
    lines.append("")
    lines.append("top ops by summed event time:")
    for op in report["top_ops"]:
        lines.append(
            f"  {ms(op['summed_ps'])}  [{op['category']:<16}] {op['name']}"
        )
    return "\n".join(lines)


def write_summary_event(report: dict[str, Any], out_path: str,
                        run_id: str | None = None) -> dict:
    """Persist the report as a schema-versioned trace_summary event."""
    writer = telemetry.TelemetryWriter(out_path, run_id=run_id)
    try:
        return writer.emit(
            telemetry.KIND_TRACE_SUMMARY,
            metrics={
                "window_ms": report["window_ps"] / 1e9,
                "busy_ms": report["busy_ps"] / 1e9,
                "launch_gap_ms": report["launch_gap_ps"] / 1e9,
                "coverage": report["coverage"],
            },
            phases={
                cat: report["breakdown"][cat]["time_ps"] / 1e9
                for cat in (*CATEGORIES, GAP)
            },
            trace_path=report.get("trace_path", ""),
            hlo_map_used=report["hlo_map_used"],
            top_ops=json.dumps(report["top_ops"][:5]),
        )
    finally:
        writer.close()
