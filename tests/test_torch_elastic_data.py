"""The data drills on the CPU: two gloo ranks of the port's trainer (tiny
BERT) under the port's gang supervisor, with a fault at the data
pipeline's ``data_chaos`` point of one rank (tests/test_torch_elastic.py
has the gang drills and its helpers).

* ``corrupt_shard:1:3`` poisons rank 1's third pull (an MLM batch: the
  step's loss): the NaN guard names step 3 on the rank it hit.
* ``skew_shard:1:5s`` stalls rank 1's next pull past
  ``resilience.infeed_deadline_s``: its infeed watchdog gives up.
"""

from __future__ import annotations

import math

from tests.test_torch_elastic import _classes, _cluster, _events, _losses
from tests.test_torch_hygiene import torch_threads  # noqa: F401


def test_corrupt_shard_is_named_by_the_nan_guard_on_its_rank(tmp_path):
    ckpt = tmp_path / "ck"
    r = _cluster(tmp_path / "w", ckpt, "--max-attempts", "1",
                 "--chaos-tick", "0", faults="corrupt_shard:1:3")
    assert r.returncode != 0
    assert [a["classification"] for a in _classes(ckpt)] == ["crashed"]
    log1 = (tmp_path / "w" / "worker-1.log").read_text()
    assert "firing corrupt_shard:1:3 at point 'data_chaos'" in log1
    assert "corrupt_shard poisoned the step's loss" in log1
    assert "firing corrupt_shard" not in (
        tmp_path / "w" / "worker-0.log").read_text()
    failures = [ev for ev in _events(ckpt / "events-p1.jsonl", "failure")]
    assert failures and failures[0]["step"] == 3
    assert failures[0]["health"]["failure"] == "non_finite_metric"
    losses = _losses(ckpt)
    assert losses.keys() == {1, 2, 3}
    assert math.isfinite(losses[2]) and math.isnan(losses[3])


def test_skew_shard_is_caught_by_the_infeed_watchdog(tmp_path):
    ckpt = tmp_path / "ck"
    r = _cluster(tmp_path / "w", ckpt, "--max-attempts", "1",
                 "--chaos-tick", "0", faults="skew_shard:1:5s",
                 over=("resilience.infeed_deadline_s=1",
                       "resilience.infeed_retries=0"))
    assert r.returncode != 0
    assert [a["classification"] for a in _classes(ckpt)] == ["crashed"]
    log1 = (tmp_path / "w" / "worker-1.log").read_text()
    assert "skew_shard sleeping 5.0s" in log1
    stalls = _events(ckpt / "events-p1.jsonl", "infeed_stall")
    assert stalls and stalls[0]["health"]["deadline_s"] == 1.0
    assert "skew_shard sleeping" not in (
        tmp_path / "w" / "worker-0.log").read_text()
