"""PyTorch port's infeed (data/infeed.py): the prefetcher and its watchdog.

The background producer yields what the same-thread prefetcher yields,
batch for batch and snapshot for snapshot; closing it releases the
dataset; a pipeline error reaches the consumer. With a deadline, a stalled
pull raises ``InfeedStallError`` and the next ``next()`` resumes the same
pull (nothing skipped, nothing pulled twice); buffered batches cover a
stall; a zero deadline disables the watchdog. In the trainer, a
``stall_infeed`` fault past the deadline is retried with backoff and
logged as ``infeed_stall`` events, and the run finishes equal to an
unstalled one.
"""

import json
import time

import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core import faults
from distributed_tensorflow_framework_torch.data import get_dataset
from distributed_tensorflow_framework_torch.data.infeed import (
    InfeedStallError,
    prefetch_to_device,
)
from tests.test_torch_ckpt import tiny_config, train_run
from tests.test_torch_hygiene import torch_threads  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_plan():
    yield
    faults.install(faults.FaultPlan())


def _ds():
    return get_dataset(tiny_config().data)


def test_background_matches_sync():
    outs = []
    for background in (False, True):
        it = prefetch_to_device(_ds(), CPU, size=2, background=background)
        outs.append([next(it) for _ in range(5)])
        it.close()
    for (a, a_snap), (b, b_snap) in zip(*outs):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])
        assert a_snap == b_snap
    assert [snap["consumed"] for _, snap in outs[0]] == [1, 2, 3, 4, 5]


def test_background_close_releases_dataset():
    ds = _ds()
    it = prefetch_to_device(ds, CPU, size=2, background=True)
    next(it)
    it.close()
    ds.restore({"step": 0})
    first = next(ds)
    ds.restore({"step": 0})
    np.testing.assert_array_equal(first["input_ids"],
                                  next(ds)["input_ids"])


def test_background_propagates_errors():
    class Boom:
        def __iter__(self):
            return self

        def __next__(self):
            raise RuntimeError("boom in pipeline")

    it = prefetch_to_device(Boom(), CPU, size=2, background=True)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


class _StallingDataset:
    """Yields {"x": full(pull ordinal)}; sleeps on the chosen pulls."""

    def __init__(self, stall_on=(), stall_s=0.0):
        self.n = 0
        self.stall_on = set(stall_on)
        self.stall_s = stall_s

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.n in self.stall_on:
            time.sleep(self.stall_s)
        return {"x": np.full((8,), float(self.n), np.float32)}

    def state(self):
        return {"n": self.n}


def _value(item):
    batch, _ = item
    return float(batch["x"][0])


def test_sync_watchdog_raises_and_resumes_same_pull():
    ds = _StallingDataset(stall_on={1}, stall_s=0.6)
    it = prefetch_to_device(ds, CPU, size=1, deadline_s=0.1)
    t0 = time.monotonic()
    with pytest.raises(InfeedStallError) as ei:
        next(it)
    assert time.monotonic() - t0 < 0.5
    assert ei.value.deadline_s == 0.1
    time.sleep(0.7)
    assert [_value(next(it)) for _ in range(3)] == [1.0, 2.0, 3.0]
    assert ds.n == 3
    it.close()


def test_sync_watchdog_buffer_covers_stall():
    ds = _StallingDataset(stall_on={3}, stall_s=0.6)
    it = prefetch_to_device(ds, CPU, size=2, deadline_s=0.1)
    assert _value(next(it)) == 1.0
    assert _value(next(it)) == 2.0
    assert it.watermark() == 1  # the stalled pull is pending
    with pytest.raises(InfeedStallError):
        next(it)
    time.sleep(0.7)
    assert _value(next(it)) == 3.0
    it.close()


def test_background_watchdog_raises_then_recovers():
    ds = _StallingDataset(stall_on={2}, stall_s=0.6)
    it = prefetch_to_device(ds, CPU, size=1, background=True,
                            deadline_s=0.1)
    assert _value(next(it)) == 1.0
    stalls, deadline = 0, time.monotonic() + 5.0
    while True:
        try:
            got = _value(next(it))
            break
        except InfeedStallError:
            stalls += 1
            assert time.monotonic() < deadline, "stall never cleared"
    assert got == 2.0 and stalls >= 1
    assert _value(next(it)) == 3.0
    it.close()


def test_zero_deadline_disables_watchdog():
    ds = _StallingDataset(stall_on={1}, stall_s=0.3)
    it = prefetch_to_device(ds, CPU, size=1, deadline_s=0.0)
    t0 = time.monotonic()
    assert _value(next(it)) == 1.0
    assert time.monotonic() - t0 >= 0.3
    it.close()


# The trainer's retries see only InfeedStallError, whichever prefetcher
# raised it; the same-thread one pulls only when the step loop asks, so
# its stall always shows. (The background producer pulls while the loop
# trains, so whether a stall shows there depends on the step time; its
# watchdog is held above, without a trainer.)
def test_trainer_retries_a_stalled_pull(tmp_path):
    ref = train_run(str(tmp_path / "ref"), 4)
    faults.install("stall_infeed:0.5s:3")
    d = tmp_path / "ckpt"
    t = train_run(str(d), 4, "resilience.infeed_deadline_s=0.2",
                  "resilience.infeed_backoff_s=0.05",
                  "resilience.infeed_retries=40", "data.async_infeed=false",
                  "data.prefetch=1")
    with open(d / "events.jsonl") as fh:
        stalls = [e["health"] for e in map(json.loads, fh)
                  if e["kind"] == "infeed_stall"]
    assert stalls and all(h["deadline_s"] == 0.2 for h in stalls)
    assert max(h["attempt"] for h in stalls) >= 2
    for k, v in ref.state.model.state_dict().items():
        assert torch.equal(t.state.model.state_dict()[k], v), k


def test_trainer_escalates_past_the_retries():
    faults.install("stall_infeed:1s:2")
    with pytest.raises(InfeedStallError):
        train_run(None, 4, "resilience.infeed_deadline_s=0.05",
                  "resilience.infeed_backoff_s=0.01",
                  "resilience.infeed_retries=1", "data.async_infeed=false",
                  "data.prefetch=1")
