"""infeed_wait_ms (ms, program counter): the loop's own ``time_infeed_ms``
(train/loop.py's host timer around each batch pull) a step, from rank 0's
``events.jsonl``: the mean over every ``train_step`` record after the
window's start, weighted by the steps each covers. In a traced run the
last record also covers the profiled steps."""


def read(run):
    start = run.window_start_step()
    prev, total, steps = start, 0.0, 0
    for e in run.loop_events(0):
        if e.get("kind") != "train_step" or e.get("step", 0) <= start:
            continue
        infeed = (e.get("phases") or {}).get("infeed")
        if infeed is None:
            continue
        n = e["step"] - prev
        total += infeed * n
        steps += n
        prev = e["step"]
    return total / steps if steps else None
