"""batchnorm_ms.image (ms, device trace): a profiled step's device time of
the kernels launched inside the port's ``BatchNorm`` modules
(models/layers.py), forward and backward, which the traced run brackets
with marker launches: on one chip cuDNN's BatchNorm with the casts and
the running-statistics update around it, across chips the cross-rank
BatchNorm's reductions and elementwise passes (its all-reduces left out:
they are ``nccl_exposed_ms``'s); the rank where it is largest."""

from benchlib import readers

MODULE_SPANS = {"batchnorm": "BatchNorm"}


def read(run):
    return readers.span_ms_per_step(run, "batchnorm")
