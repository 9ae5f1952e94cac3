"""elementwise_ms.bert (ms, device trace): a profiled step's time in the
kernels that are neither GEMMs, nor flash attention, nor foreach
(``bounds.kernel_class``): LayerNorm, GELU, dropout, casts, the embedding
gather, the f32 logits' cross-entropy; rank 0."""

from benchlib import bounds, readers


def read(run):
    return readers.class_ms_per_step(run, bounds.kernel_class, "elementwise")
