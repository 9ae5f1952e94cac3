"""Roofline model: the card's peaks, ridge points, and the step-time
predictor.

The port's copy of ``core/roofline.py`` with a table of its own: the JAX
file's ``CHIP_PEAKS`` holds TPUs only, and none of its numbers carries
over. Stdlib only.

The model is the two-resource roofline. A step that must move ``B``
bytes through device memory and execute ``F`` operations cannot finish
faster than ``max(F / peak_flops, B / hbm_bw)`` per card; whichever term
is larger is the binding resource ("compute" or "hbm_bandwidth"), and the
crossover sits at the ridge point ``peak_flops / hbm_bw`` (the H100 SXM:
989e12 / 3.35e12 ≈ 295 FLOP/byte).

The bytes come from the port's measured artifacts: the first train
step's memory analysis (core/memstats.py: argument and temp bytes), the
collective tally's wire bytes and the optimizer state's bytes — see
:func:`traffic_bytes`.
"""

from __future__ import annotations

import dataclasses
import os

GIB = 1024 ** 3

# torch.cuda.get_device_name() → (peak bf16 dense FLOP/s, memory bytes/s,
# device memory bytes). The rates are NVIDIA's data-sheet peaks for the
# H100 SXM (dense, at the full 700 W), the ones chip_smoke.py's kernel
# bounds use; the capacity is torch.cuda.get_device_properties(0)
# .total_memory as read on an NVIDIA H100 80GB HBM3 at a 700.00 W limit
# (chip_smoke.py phase 18a checks it on every run).
CHIP_PEAKS: dict[str, tuple[float, float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12, 85_017_493_504),
}

# Ridge-point fallback for devices absent from CHIP_PEAKS (the CPU): the
# bound verdict is the program's position against a roofline, read
# against the H100's and tagged by ``bound_ridge_source`` so a fallback
# verdict is never mistaken for a measured card's.
RIDGE_FALLBACK_CHIP = "NVIDIA H100 80GB HBM3"


def chip_hbm_capacity(chip: str) -> float | None:
    """Per-chip HBM capacity, or host RAM when the chip isn't in the
    table (the CPU backend: headroom against physical memory is still a
    meaningful ceiling for the compiled step's working set)."""
    peak = CHIP_PEAKS.get(chip)
    if peak:
        return peak[2]
    try:
        return float(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):
        return None


def ridge_point(chip: str) -> tuple[float, str] | None:
    """(ridge FLOP/byte, source chip) for ``chip``, falling back to the
    RIDGE_FALLBACK_CHIP reference when the chip isn't in CHIP_PEAKS.
    Returns None only if the fallback itself were removed from the table."""
    source = chip if chip in CHIP_PEAKS else RIDGE_FALLBACK_CHIP
    peak = CHIP_PEAKS.get(source)
    if not peak:
        return None
    peak_flops, hbm_bw = peak[:2]
    return peak_flops / hbm_bw, source


def traffic_bytes(memory_analysis: dict | None, wire_bytes: float = 0.0,
                  opt_state_bytes: float = 0.0) -> float:
    """Device-memory + interconnect bytes/step from the measured
    artifacts.

    ``memory_analysis`` is the first train step's analysis
    (core/memstats.step_memory_analysis): argument + output + temp bytes
    is the footprint one step streams (the port measures no output bytes,
    so that term is 0). ``wire_bytes`` is the collective tally's total for
    the step. ``opt_state_bytes`` covers callers whose footprint was taken
    on a forward/backward only — a whole step's argument bytes already
    hold the optimizer state, so pass 0 there or it is counted twice.
    """
    analysis = memory_analysis or {}
    footprint = sum(int(analysis.get(f) or 0) for f in
                    ("argument_bytes", "output_bytes", "temp_bytes"))
    return float(footprint) + float(wire_bytes) + float(opt_state_bytes)


@dataclasses.dataclass
class RooflinePrediction:
    """Analytic step-time lower bound and the binding-resource verdict.

    ``sec_per_step`` is ``max(sec_compute, sec_hbm)`` — the roofline
    says the step can't beat the slower resource. ``bound`` names that
    resource; ``ridge_source`` records which chip's ridge judged it
    (``"<chip> (fallback)"`` when CHIP_PEAKS had no entry for the chip,
    as ``annotate_roofline``'s bound_ridge_source tag says).
    """

    chip: str
    flops_per_step: float
    bytes_per_step: float
    intensity: float | None
    ridge: float
    ridge_source: str
    sec_compute: float
    sec_hbm: float
    sec_per_step: float
    bound: str


def predict(chip: str, flops_per_step: float, bytes_per_step: float,
            n_chips: int = 1) -> RooflinePrediction:
    """Predict the per-step time floor for a program on ``chip``.

    Inputs are WHOLE-program flops and bytes (use :func:`traffic_bytes`
    to assemble bytes from footprint + wire + opt state); the work is
    assumed evenly divided across ``n_chips``. Unknown chips are judged
    against the RIDGE_FALLBACK_CHIP roofline and tagged.
    """
    n = max(1, int(n_chips))
    source = chip if chip in CHIP_PEAKS else RIDGE_FALLBACK_CHIP
    peak_flops, hbm_bw = CHIP_PEAKS[source][:2]
    ridge = peak_flops / hbm_bw
    sec_compute = flops_per_step / n / peak_flops
    sec_hbm = bytes_per_step / n / hbm_bw
    intensity = (flops_per_step / bytes_per_step) if bytes_per_step else None
    if intensity is not None:
        bound = "hbm_bandwidth" if intensity < ridge else "compute"
    else:
        bound = "compute"
    ridge_source = source if source == chip else f"{source} (fallback)"
    return RooflinePrediction(
        chip=chip, flops_per_step=float(flops_per_step),
        bytes_per_step=float(bytes_per_step), intensity=intensity,
        ridge=ridge, ridge_source=ridge_source, sec_compute=sec_compute,
        sec_hbm=sec_hbm, sec_per_step=max(sec_compute, sec_hbm),
        bound=bound)


def annotate_roofline(out: dict, result: dict, chip: str, n_chips: int,
                      *, accum_scaled: bool = False) -> None:
    """Achieved TFLOP/s, MFU, arithmetic intensity and the bottleneck
    verdict of a measured row (``result``: ``flops_per_step``,
    ``bytes_per_step``, ``sec_per_step``, optionally ``collectives`` and
    ``memory``) against the card's peaks — a bench row's annotator, the
    same function as the JAX package's.

    Two intensity numbers ride every row that can compute them:
    ``arith_intensity`` (operations / bytes accessed) and
    ``ai_flops_per_byte`` (operations / (the memory analysis's
    footprint + the collective tally's wire bytes)). The second is the
    one the precision levers move.

    ``accum_scaled``: the operations and bytes were multiplied by the
    accumulation trip count and the once-per-step optimizer traffic got
    scaled with them, so hbm_bw_util is an UPPER bound and
    arith_intensity a LOWER bound; the row is tagged.
    """
    peak = CHIP_PEAKS.get(chip)
    if not result["flops_per_step"]:
        return
    if accum_scaled:
        out["roofline_bound"] = "accum-scaled-upper"
    achieved = result["flops_per_step"] / result["sec_per_step"] / n_chips
    out["tflops_per_sec"] = round(achieved / 1e12, 2)
    intensity = None
    if result["bytes_per_step"]:
        intensity = result["flops_per_step"] / result["bytes_per_step"]
        out["arith_intensity"] = round(intensity, 1)
    wire = (result.get("collectives") or {}).get("total_bytes") or 0
    ai = None
    footprint_plus_wire = traffic_bytes(
        (result.get("memory") or {}).get("analysis"), wire)
    if footprint_plus_wire > wire:  # a footprint was actually present
        ai = result["flops_per_step"] / footprint_plus_wire
        out["ai_flops_per_byte"] = round(ai, 1)
    if peak:
        peak_flops, hbm_bw = peak[:2]
        out["mfu"] = round(achieved / peak_flops, 4)
        if intensity is not None:
            ridge = peak_flops / hbm_bw
            out["bound"] = "hbm_bandwidth" if intensity < ridge else "compute"
            # Fraction of peak HBM bandwidth actually sustained.
            out["hbm_bw_util"] = round(
                result["bytes_per_step"] / result["sec_per_step"]
                / n_chips / hbm_bw, 4,
            )
    if "bound" not in out:
        # Every row carries a verdict: on unknown backends (or when the
        # cost model's byte count is absent) fall back to the reference
        # ridge and the best intensity available, tagged as a fallback.
        best = intensity if intensity is not None else ai
        if best is not None:
            ref = ridge_point("")  # forces the fallback reference
            if ref is not None:
                ridge, source = ref
                out["bound"] = ("hbm_bandwidth" if best < ridge
                                else "compute")
                out["bound_ridge_source"] = f"{source} (fallback)"
