"""nccl_exposed_ms (ms, device trace): a profiled step's NCCL kernel time
that no other kernel overlaps on any stream, on the slowest rank: the
union of the NCCL kernels' intervals less its intersection with the union
of every other kernel's."""

from benchlib import bounds, kineto


def read(run):
    if run.chips < 2:
        return None
    worst = None
    for rank in range(run.chips):
        ev = [e for e in run.device_events(rank) if e.cat == "kernel"]
        nccl = [(e.start_ps, e.end_ps) for e in ev
                if bounds.is_collective(e.name)]
        if not nccl:
            return None
        other = [(e.start_ps, e.end_ps) for e in ev
                 if not bounds.is_collective(e.name)]
        exposed = kineto.union_ps(nccl) - kineto.overlap_ps(nccl, other)
        ms = exposed / 1e9 / run.profile_steps
        worst = ms if worst is None else max(worst, ms)
    return worst
