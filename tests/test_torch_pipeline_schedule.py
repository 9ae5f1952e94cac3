"""The port's pipeline schedules (parallel/schedule.py, and the per-stage
plans parallel/pipeline.py walks) against the JAX package's.

Mirrors ``tests/test_pipeline.py``'s static tests
(``test_1f1b_slot_table``, ``test_forward_slot_tables_cover_all_chunks``,
``test_bubble_fractions``, ``test_1f1b_activation_residency_is_o_stages``,
``test_resolve_virtual_validation``) over the same grids: every slot
table, bubble, residency and resolved v of the port equals the JAX
package's, and the port's per-stage forward plans and chunk assignment
equal what the JAX executors compute in each slot. Pure Python: exact.
"""

import numpy as np
import pytest

from distributed_tensorflow_framework_torch.parallel import pipeline as pl
from distributed_tensorflow_framework_torch.parallel import schedule as ours
from distributed_tensorflow_framework_tpu.parallel import pipeline as jax_pl
from distributed_tensorflow_framework_tpu.parallel import schedule as ref
from tests.test_torch_hygiene import torch_threads  # noqa: F401

GRID_1F1B = [(2, 2), (2, 8), (4, 4), (4, 8), (8, 8)]
GRID_FWD = [(2, 2, 1), (4, 8, 1), (4, 8, 2), (2, 4, 4)]


def _table(mod, *args):
    return [(s.t, dict(s.fwd), dict(s.bwd), s.kind)
            for s in mod.slot_table(*args)]


def test_schedule_names_match():
    assert ours.SCHEDULES == ref.SCHEDULES


@pytest.mark.parametrize("s,m", GRID_1F1B)
def test_1f1b_slot_table_matches_jax(s, m):
    assert _table(ours, "1f1b", s, m) == _table(ref, "1f1b", s, m)
    assert ours.num_slots("1f1b", s, m) == ref.num_slots("1f1b", s, m)
    table = ours.slot_table("1f1b", s, m)
    assert len(table) == m + 2 * s - 2
    assert table[0].kind == "warmup" and table[-1].kind == "cooldown"


@pytest.mark.parametrize("s,m,v", GRID_FWD)
def test_forward_slot_tables_match_jax(s, m, v):
    for name in ("gpipe", "interleaved"):
        vv = v if name == "interleaved" else 1
        assert _table(ours, name, s, m, vv) == _table(ref, name, s, m, vv)
        assert ours.num_slots(name, s, m, vv) == ref.num_slots(name, s, m,
                                                               vv)


@pytest.mark.parametrize("name,s,m,v", [
    ("gpipe", 4, 8, 1), ("1f1b", 4, 8, 1), ("interleaved", 4, 8, 2),
    ("gpipe", 4, 16, 1), ("interleaved", 2, 4, 4), ("1f1b", 8, 8, 1)])
def test_bubble_and_residency_match_jax(name, s, m, v):
    assert ours.bubble_frac(name, s, m, v) == ref.bubble_frac(name, s, m, v)
    assert ours.peak_inflight(name, s, m, v) == ref.peak_inflight(
        name, s, m, v)


def test_bubble_fractions():
    assert ours.bubble_frac("gpipe", 4, 8) == pytest.approx(3 / 11)
    assert ours.bubble_frac("1f1b", 4, 8) == pytest.approx(3 / 11)
    assert ours.bubble_frac("interleaved", 4, 8, 2) == pytest.approx(3 / 19)
    assert (ours.bubble_frac("gpipe", 4, 16)
            < ours.bubble_frac("gpipe", 4, 8))


def test_1f1b_activation_residency_is_o_stages():
    for m in (8, 16, 64, 256):
        assert ours.peak_inflight("1f1b", 4, m) == 7
        assert ours.peak_inflight("gpipe", 4, m) == m + 3
    for s, m in [(2, 8), (4, 8), (4, 32)]:
        live = peak = 0
        for slot in ours.slot_table("1f1b", s, m):
            live += 0 in slot.fwd
            peak = max(peak, live)
            live -= 0 in slot.bwd
        assert peak == ours.peak_inflight("1f1b", s, m)


@pytest.mark.parametrize("args", [
    ("gpipe", 4, 8, 0, 8), ("interleaved", 4, 8, 0, 8),
    ("interleaved", 4, 8, 2, 16), ("interleaved", 4, 6, 0, 8),
    ("interleaved", 4, 8, 3, 8), ("gpipe", 4, 8, 2, 8),
    ("zigzag", 4, 8, 0, 8), ("1f1b", 0, 8, 0, 8)])
def test_resolve_virtual_matches_jax(args):
    def outcome(mod):
        try:
            return mod.resolve_virtual(*args)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(ours) == outcome(ref)


@pytest.mark.parametrize("layers,s,v", [(8, 4, 2), (12, 4, 3), (8, 2, 4),
                                        (4, 4, 1), (12, 4, 1)])
def test_stage_chunks_are_the_interleave_perm(layers, s, v):
    """Stage s's chunks, in order, are block s of the JAX package's
    ``_interleave_perm`` (the rows device s holds)."""
    perm = np.asarray(pl.interleave_perm(layers, s, v))
    assert np.array_equal(perm, jax_pl._interleave_perm(layers, s, v))
    per = layers // s
    for idx in range(s):
        chunks = pl.stage_chunks(layers, s, v, idx)
        assert len(chunks) == v
        assert [g for c in chunks for g in c] == list(
            perm[idx * per:(idx + 1) * per])


@pytest.mark.parametrize("name,s,m,v", [
    ("gpipe", 4, 8, 1), ("1f1b", 2, 4, 1), ("interleaved", 4, 8, 2),
    ("interleaved", 2, 4, 4), ("interleaved", 4, 8, 3)])
def test_forward_plan_is_the_jax_executor_clock(name, s, m, v):
    """In every slot each stage runs the microbatch and chunk the JAX
    executors compute there (``_circular_fwd_fn``'s ``t - idx``,
    ``_interleaved_fwd_fn``'s stage-local clock); stage 0 takes a
    microbatch in at chunk 0, the last stage emits it at chunk v - 1, and
    the interleaved emit slots are the ones JAX's ``out_slots`` gather."""
    emits = {}
    for idx in range(s):
        plan = pl.forward_plan(name, s, m, v, idx)
        assert len(plan) == ref.num_slots(name, s, m, v)
        for t, work in enumerate(plan):
            tp = t - idx
            if name == "interleaved":
                active = 0 <= tp < v * m
            else:
                active = 0 <= tp < m
            assert (work is not None) == active, (idx, t)
            if work is None:
                continue
            if name == "interleaved":
                g, r = divmod(tp, s * v)
                c, j = divmod(r, s)
                assert (work.mb, work.chunk) == (g * s + j, c)
            else:
                assert (work.mb, work.chunk) == (tp, 0)
            assert work.inject == (idx == 0 and work.chunk == 0)
            assert work.emit == (idx == s - 1 and work.chunk == v - 1)
            if work.emit:
                emits[work.mb] = t
    assert sorted(emits) == list(range(m))
    if name == "interleaved":
        want = [g * s * v + (v - 1) * s + j + s - 1
                for g in range(m // s) for j in range(s)]
        assert [emits[mb] for mb in range(m)] == want
    else:
        assert [emits[mb] for mb in range(m)] == [mb + s - 1
                                                  for mb in range(m)]


def test_layer_seeds_are_per_pair():
    base = 12345
    seeds = {(mb, g): pl.layer_seed(base, mb, g)
             for mb in range(4) for g in range(8)}
    assert len(set(seeds.values())) == len(seeds)
    assert pl.layer_seed(base, 1, 2) == seeds[(1, 2)]
    assert pl.layer_seed(base + 1, 1, 2) != seeds[(1, 2)]
