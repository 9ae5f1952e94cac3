"""device_idle_pct.image (%, device trace): one minus the union of the
kernels', memcpys' and memsets' intervals over the profiled steps'
window (first device event to last), on the rank idle longest."""

from benchlib import readers


def read(run):
    return readers.idle_pct(run)
