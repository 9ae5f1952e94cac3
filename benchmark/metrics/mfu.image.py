"""mfu.image (%, host clock and the benchmark's FLOP count): the window's
model FLOPs (the reference module's ``step_flops``: three times the
forward's products, no recompute) over the window's seconds, as a share
of the chips' bf16 peak (989 TFLOP/s each). Read from the traced run's
window, which closes before its profile opens."""

from benchlib import readers


def read(run):
    return readers.mfu_pct(run)
