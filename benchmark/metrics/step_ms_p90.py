"""step_ms_p90 (ms, device trace): the 90th percentile of the intervals
between consecutive step completions over the window's steps, each taken
from CUDA events a hook records after each step's dispatch, with no
synchronisation; across ranks each step's interval is the slowest
rank's. ``statistics.quantiles(n=10)``, its default method."""

from benchlib import readers


def read(run):
    return readers.p90(run.intervals_ms)
