"""The port's sequence packing (data/packing.py) against the JAX package's.

The same seeded numpy inputs go through both modules: ``pack_documents``
(documents laid end-to-end with segment ids, the overflow returned in
order, empty rows skipped), the token census that rides the iterator state,
and ``packing_stats``. Integer outputs are compared exactly; the efficiency
is one float division of equal integers on both sides, so it is compared
exactly too. Mirrors ``tests/test_packing.py``; the trainer's
``data_packing`` event is held in ``tests/test_torch_mlm_records.py``.
"""

import numpy as np
import pytest

from distributed_tensorflow_framework_torch.core import telemetry
from distributed_tensorflow_framework_torch.data import packing
from distributed_tensorflow_framework_tpu.core import (
    telemetry as jax_telemetry,
)
from distributed_tensorflow_framework_tpu.data import packing as jax_packing
from tests.test_torch_hygiene import torch_threads  # noqa: F401


def _docs(seed, n, s, lo, hi, empty_every=0):
    """``n`` zero-padded documents of ``lo``..``hi`` nonzero tokens in rows
    of ``s``; every ``empty_every``-th row empty."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, s), np.int32)
    for i, length in enumerate(rng.integers(lo, hi + 1, n)):
        if empty_every and i % empty_every == 0:
            continue
        rows[i, :length] = rng.integers(1, 30000, length)
    return rows


def _assert_packed_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed, n, rows, s, lo, hi, empty_every", [
    (0, 16, 4, 32, 4, 14, 0),     # fits: no leftover
    (1, 40, 4, 32, 8, 30, 0),     # overflow: the leftover comes back
    (2, 24, 3, 64, 1, 64, 3),     # empty rows skipped, full-width docs
    (3, 12, 8, 16, 16, 16, 0),    # one document per row, exactly full
])
def test_pack_documents_matches_jax(seed, n, rows, s, lo, hi, empty_every):
    docs = _docs(seed, n, s, lo, hi, empty_every)
    ours = packing.pack_documents(docs, rows, s)
    ref = jax_packing.pack_documents(docs, rows, s)
    _assert_packed_equal(ours, ref)
    packed, segs, leftover = ours
    # Every nonempty document is packed or left over, none twice.
    placed = int(np.count_nonzero(packed)) + int(np.count_nonzero(leftover))
    assert placed == int(np.count_nonzero(docs))
    assert (segs > 0).sum() == np.count_nonzero(packed)


def test_pack_documents_with_no_documents():
    docs = np.zeros((5, 16), np.int32)
    _assert_packed_equal(packing.pack_documents(docs, 2, 16),
                         jax_packing.pack_documents(docs, 2, 16))


def test_census_counters_and_stats_match_jax():
    ours, ref = {}, {}
    for seed in range(4):
        batch = _docs(seed, 6, 24, 0, 24)
        packing.accumulate_counters(ours, batch)
        jax_packing.accumulate_counters(ref, batch)
        assert ours == ref
        assert packing.count_tokens(batch) == jax_packing.count_tokens(batch)
    assert (packing.REAL_TOKENS_KEY, packing.PADDED_TOKENS_KEY) == (
        jax_packing.REAL_TOKENS_KEY, jax_packing.PADDED_TOKENS_KEY)
    real, pad = ours[packing.REAL_TOKENS_KEY], ours[packing.PADDED_TOKENS_KEY]
    assert packing.packing_stats(real, pad) == jax_packing.packing_stats(
        real, pad)
    assert packing.packing_stats(0, 0) == jax_packing.packing_stats(0, 0)


def test_data_packing_kind_matches_jax():
    assert telemetry.KIND_DATA_PACKING == jax_telemetry.KIND_DATA_PACKING
