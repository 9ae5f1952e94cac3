"""optimizer_ms.image (ms, device trace): a profiled step's device time of
the kernels launched inside the optimizer's calls (``Optimizer.step``,
the port's ``optimizer_update`` scope: the clip and the update), which
the traced run brackets with two marker launches; the rank where it is
largest."""

from benchlib import readers


def read(run):
    return readers.span_ms_per_step(run, "optimizer")
