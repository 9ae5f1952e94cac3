"""Device memory telemetry: the port's copy of ``core/memstats.py``.

Two sources, both emitted as ``KIND_MEMORY`` events with the JAX
package's fields:

  * ``device_memory_snapshot`` — the caching allocator's live view per
    CUDA device (``torch.cuda.memory_stats``: ``allocated_bytes.all``'s
    ``current`` and ``peak`` as ``bytes_in_use``/``peak_bytes_in_use``).
    Without a CUDA device the snapshot falls back to the process's RSS,
    with ``source_kind`` saying which ruler was used.
  * ``step_memory_analysis`` — the counterpart of the JAX package's
    ``compiled_memory_analysis``. An eager step has no compiled program
    to read, so the first train step is measured instead:
    ``argument_bytes`` is the bytes of the state and the batch the step
    takes (exact on any device); on CUDA ``temp_bytes`` is the
    allocator's peak over the step minus what was allocated before it;
    ``peak_bytes_est`` is their sum. What the port cannot know
    (``output_bytes`` apart from the state it updates in place,
    ``generated_code_bytes``, ``alias_bytes``) stays absent, as the JAX
    function leaves out what a backend does not give.

``MemoryMonitor`` owns the cadence: periodic ``maybe_sample`` from the
train loop and the serving engine's reporter, ``capture_step`` around the
first train step, and a no-emit ``snapshot()`` for ``/healthz``.
"""

from __future__ import annotations

import os
import resource
import time
from typing import Any, Callable

import torch

from distributed_tensorflow_framework_torch.core import telemetry


def host_rss_bytes() -> tuple[int, int]:
    """(current, peak) resident-set bytes of this process.

    ``ru_maxrss`` is KiB on Linux; the current figure comes from
    /proc/self/statm when available, else the peak stands in for both.
    """
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    current = peak
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        current = pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    return current, peak


def default_devices() -> list[torch.device]:
    """Every visible CUDA device, or the CPU alone without one."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_memory_snapshot(devices=None) -> dict:
    """One sample across ``devices`` (default :func:`default_devices`),
    each distinct device once (data-parallel serving may list a card
    twice).

    Returns per-device MAXIMA in the top-level fields — the binding
    constraint of a program over several cards is its worst card:

      {"device_count", "bytes_in_use", "peak_bytes_in_use",
       "source_kind": "device_memory_stats" | "host_rss",
       "devices": [{"id", "kind", "bytes_in_use", "peak_bytes_in_use"}]}
    """
    devices = list(dict.fromkeys(  # each device once, in order
        torch.device(d) for d in
        (default_devices() if devices is None else devices)))
    per_device = []
    for d in devices:
        if d.type != "cuda":
            continue
        stats = torch.cuda.memory_stats(d)
        current = int(stats.get("allocated_bytes.all.current", 0))
        per_device.append({
            "id": d.index if d.index is not None else
            torch.cuda.current_device(),
            "kind": torch.cuda.get_device_name(d),
            "bytes_in_use": current,
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               current)),
        })
    if per_device:
        return {
            "device_count": len(devices),
            "bytes_in_use": max(d["bytes_in_use"] for d in per_device),
            "peak_bytes_in_use": max(
                d["peak_bytes_in_use"] for d in per_device),
            "source_kind": "device_memory_stats",
            "devices": per_device,
        }
    current, peak = host_rss_bytes()
    return {
        "device_count": len(devices),
        "bytes_in_use": current,
        "peak_bytes_in_use": peak,
        "source_kind": "host_rss",
        "devices": [],
    }


def tensor_bytes(*trees: Any) -> int:
    """Bytes of every tensor in nests of dicts, lists and tuples, each
    storage counted once (a state dict's entries may view one tensor)."""
    seen: set[tuple] = set()
    total = 0

    def walk(tree):
        nonlocal total
        if isinstance(tree, torch.Tensor):
            key = (tree.device, tree.untyped_storage().data_ptr(),
                   tree.storage_offset(), tree.numel(), tree.dtype)
            if key not in seen:
                seen.add(key)
                total += tree.numel() * tree.element_size()
        elif isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)

    for tree in trees:
        walk(tree)
    return total


def step_memory_analysis(step_fn: Callable[[], Any],
                         argument_bytes: Callable[[], int],
                         device) -> tuple[Any, dict]:
    """Run ``step_fn`` once and measure it: returns its result and the
    analysis dict. ``argument_bytes`` is called after the step, when the
    optimizer's slots exist (torch creates them at the first update). On
    CUDA the allocator's peak counter is reset before the step."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    result = step_fn()
    out = {"argument_bytes": int(argument_bytes())}
    if cuda:
        torch.cuda.synchronize(device)
        out["temp_bytes"] = max(
            0, torch.cuda.max_memory_allocated(device) - before)
    out["peak_bytes_est"] = out["argument_bytes"] + out.get("temp_bytes", 0)
    return result, out


class MemoryMonitor:
    """Cadenced ``KIND_MEMORY`` emitter for one process.

    ``source`` tags who is sampling ("train", "serve") so a joined events
    file keeps the streams apart. Per-device rows ride in the event only
    up to ``max_device_rows``.
    """

    def __init__(self, writer: telemetry.TelemetryWriter | None = None,
                 *, interval_s: float = 60.0, source: str = "train",
                 devices=None, max_device_rows: int = 16):
        self._writer = writer
        self._interval_s = float(interval_s)
        self._source = source
        self._devices = devices
        self._max_device_rows = max_device_rows
        self._last_sample = time.perf_counter()
        self._last_snapshot: dict | None = None

    def snapshot(self) -> dict:
        """Fresh sample, no emission (the /healthz path)."""
        snap = device_memory_snapshot(self._devices)
        self._last_snapshot = snap
        return snap

    def sample(self, step: int | None = None, *,
               final: bool = False) -> dict:
        """Sample and emit one ``KIND_MEMORY`` event."""
        snap = self.snapshot()
        self._last_sample = time.perf_counter()
        if self._writer is not None:
            self._writer.emit(
                telemetry.KIND_MEMORY,
                step=step,
                metrics={
                    "bytes_in_use": snap["bytes_in_use"],
                    "peak_bytes_in_use": snap["peak_bytes_in_use"],
                    "device_count": snap["device_count"],
                },
                source=self._source,
                source_kind=snap["source_kind"],
                devices=snap["devices"][: self._max_device_rows] or None,
                final=final,
            )
        return snap

    def maybe_sample(self, step: int | None = None) -> dict | None:
        if time.perf_counter() - self._last_sample < self._interval_s:
            return None
        return self.sample(step)

    def capture_step(self, step_fn: Callable[[], Any],
                     argument_bytes: Callable[[], int], device, *,
                     step: int | None = None,
                     label: str = "train_step") -> tuple[Any, dict]:
        """Run and measure one step (:func:`step_memory_analysis`) and emit
        the analysis as the JAX package's ``capture_compiled`` does."""
        result, analysis = step_memory_analysis(step_fn, argument_bytes,
                                                device)
        if self._writer is not None:
            self._writer.emit(
                telemetry.KIND_MEMORY,
                step=step,
                metrics={"peak_bytes_est": analysis["peak_bytes_est"]},
                source=self._source,
                source_kind="memory_analysis",
                program=label,
                analysis=analysis,
            )
        return result, analysis
