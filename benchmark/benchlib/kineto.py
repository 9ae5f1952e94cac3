"""Reading a CUDA-only Kineto trace: device events, their launches, and
interval arithmetic.

The loader, the picosecond timestamps and the interval union are frozen
copies of the port's ``core/trace_analysis.py`` (``load_kineto``,
``_ps``, ``_union_ps``). The benchmark profiles with CUDA activity alone,
so a trace holds the device's kernels, memcpys and memsets on their
streams, and the runtime and driver calls that launched them on the host
threads, tied by ``correlation``; it holds no ``record_function`` ranges. A
device event carries its launch's host time and thread, which place it
between the benchmark's marker launches.
"""

from __future__ import annotations

import dataclasses
import decimal
import gzip
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceEvent:
    name: str
    cat: str
    start_ps: int
    end_ps: int
    stream: int
    launch_ps: int | None  # the launching call's host timestamp
    launch_tid: int | None

    @property
    def dur_ps(self) -> int:
        return self.end_ps - self.start_ps


def _ps(us) -> int:
    """Kineto microseconds (parsed as Decimal: exact) → picoseconds."""
    return int(decimal.Decimal(us) * 1_000_000)


def load_kineto(path: str) -> dict:
    """A Kineto chrome trace (``.json`` or ``.json.gz``) as parsed JSON,
    timestamps as Decimal."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        return json.load(fh, parse_float=decimal.Decimal)


def device_events(doc: dict) -> list[DeviceEvent]:
    """Every timed kernel, memcpy and memset, with its launch's host time
    where the trace names the launching call."""
    raw = [e for e in doc.get("traceEvents", ())
           if e.get("ph") == "X" and e.get("cat")]
    launches: dict[int, tuple[int, int]] = {}
    for e in raw:
        if e["cat"] in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[int(corr)] = (_ps(e["ts"]), e.get("tid"))
    out = []
    for e in raw:
        if e["cat"] not in DEVICE_CATS:
            continue
        dur = _ps(e.get("dur", 0))
        if dur <= 0:
            continue
        args = e.get("args") or {}
        start = _ps(e["ts"])
        launch = launches.get(int(args.get("correlation", -1)))
        out.append(DeviceEvent(
            name=e["name"], cat=e["cat"], start_ps=start, end_ps=start + dur,
            stream=int(args.get("stream", e.get("tid") or 0)),
            launch_ps=None if launch is None else launch[0],
            launch_tid=None if launch is None else launch[1]))
    out.sort(key=lambda ev: ev.start_ps)
    return out


def union_ps(intervals: list[tuple[int, int]]) -> int:
    """Total length of the union of [start, end) intervals."""
    return sum(e - s for s, e in merged(intervals))


def merged(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of [start, end) intervals as sorted disjoint ones."""
    out: list[tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_ps(a: list[tuple[int, int]], b: list[tuple[int, int]]) -> int:
    """Length of (union of a) ∩ (union of b)."""
    a, b = merged(a), merged(b)
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def window(events: list[DeviceEvent]) -> tuple[int, int]:
    """First start and last end of the device events."""
    return (min(e.start_ps for e in events), max(e.end_ps for e in events))


def idle_gaps(events: list[DeviceEvent]) -> list[tuple[int, int, str]]:
    """The device's idle gaps inside the window, as (start, end, name of
    the event that ended the gap)."""
    gaps, cur_end = [], None
    for e in events:
        if cur_end is not None and e.start_ps > cur_end:
            gaps.append((cur_end, e.start_ps, e.name))
        cur_end = e.end_ps if cur_end is None else max(cur_end, e.end_ps)
    return gaps
