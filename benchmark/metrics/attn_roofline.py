"""attn_roofline (%, device trace): the flash-attention kernels' least
time (benchlib/bounds.py, frozen from chip_smoke.py: the larger of their
bytes at 3.35 TB/s and their products at 989 TFLOP/s, counting the work
these inputs need: full rows, no segments) summed over their launches in
the profiled steps, over their summed device time; rank 0."""

from benchlib import bounds


def read(run):
    m = run.exp["model"]
    b, s = int(run.traffic["rows_per_chip"]), int(run.traffic["seq_len"])
    h = m["num_heads"]
    d = m["hidden_size"] // h
    least = spent = 0.0
    for e in run.device_events(0):
        kind = bounds.kernel_class(e.name)
        if e.cat == "kernel" and kind in bounds.PRODUCTS:
            least += bounds.attention_bound_ms(kind, b, h, s, d)
            spent += e.dur_ps / 1e9
    return 100.0 * least / spent if spent else None
