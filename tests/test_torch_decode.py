"""PyTorch port's autoregressive decode path on the CPU (serve/decode.py).

Each piece is held against the JAX package's ``serve/decode.py`` on the
same weights (the JAX ``BertForMLM`` initialiser) and the same numpy
inputs: the page arithmetic; the prefill and the decode step against
``make_prefill_fn`` / ``make_decode_fn`` with the same pool contents, in
both QKV layouts and both page dtypes; and the greedy streams of the two
``DecodeEngine``\\ s. The port's engine is then held against itself as
``tests/test_decode.py`` holds the JAX one: batched logits bit-equal to
solo ones, eviction resuming with identical tokens, int8 pages near f32,
the typed errors, backpressure, ``stream_interval``, the bucket grid,
reload and drain; its ``events.jsonl`` is read by the JAX package's
``summarize_events``; and ``POST /generate`` streams NDJSON.

Tolerances: logits and written f32 pages rtol 1e-5 (atol 1e-6: the same
f32 walk in other summation orders; measured gaps ~3e-7); int8 pages
equal as payload and within one quantization step (the block's scale)
once dequantized; int8 logits within 0.05 of f32 (the JAX test's bound).
"""

import json
import os
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_framework_torch.core import telemetry as pt
from distributed_tensorflow_framework_torch.core.config import (
    load_config as port_load_config,
)
from distributed_tensorflow_framework_torch.models.bert import decode_params
from distributed_tensorflow_framework_torch.models.convert import (
    flax_to_state_dict,
)
from distributed_tensorflow_framework_torch.serve import decode as pd
from distributed_tensorflow_framework_torch.serve import export as px
from distributed_tensorflow_framework_torch.serve.engine import (
    InferenceEngine,
    QueueFullError,
    pick_bucket,
)
from distributed_tensorflow_framework_torch.serve.server import ServingServer
from distributed_tensorflow_framework_tpu.core import telemetry as jt
from distributed_tensorflow_framework_tpu.core.config import (
    load_config as jax_load_config,
)
from distributed_tensorflow_framework_tpu.models import get_model as jax_model
from distributed_tensorflow_framework_tpu.models.bert import (
    bert_decode_head_params,
)
from distributed_tensorflow_framework_tpu.serve import decode as jd
from distributed_tensorflow_framework_tpu.serve import export as jx
from distributed_tensorflow_framework_tpu.serve.engine import serving_mesh
from tests.test_torch_hygiene import torch_threads  # noqa: F401

MAX_LEN = 32
MODEL = {"name": "bert", "vocab_size": 512, "hidden_size": 64,
         "num_layers": 2, "num_heads": 4, "mlp_dim": 128,
         "max_seq_len": MAX_LEN, "dtype": "float32",
         "attention_impl": "xla"}
PAGES = 16
PAGE = 4
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)


def _model_overrides(fused: bool = True) -> list[str]:
    return ([f"model.{k}={v}" for k, v in MODEL.items()]
            + [f"model.fused_qkv={str(fused).lower()}",
               f"data.seq_len={MAX_LEN}"])


def _jax_params(fused: bool = True, seed: int = 0) -> dict:
    jcfg = jax_load_config(overrides=_model_overrides(fused))
    params = jax_model(jcfg.model).init(
        {"params": jax.random.key(seed)}, jnp.zeros((1, 8), jnp.int32),
        train=False)["params"]
    return jax.tree.map(np.asarray, jax.device_get(params))


def _save_port(path, params, fused: bool = True, step: int = 0) -> str:
    cfg = port_load_config(overrides=_model_overrides(fused))
    return px.save_artifact(str(path), model_config=cfg.model, task="mlm",
                            params=params, step=step,
                            input_spec=px.input_spec_for(cfg, "mlm"))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_decode")
    params = _jax_params()
    jcfg = jax_load_config(overrides=_model_overrides())
    jax_dir = jx.save_artifact(
        str(root / "jax"), model_config=jcfg.model, task="mlm",
        params=params, batch_stats={}, step=0,
        input_spec=jx.input_spec_for(jcfg, "mlm"))
    return {"params": params, "port_dir": _save_port(root / "port", params),
            "jax_dir": jax_dir, "root": root}


@pytest.fixture(scope="module")
def artifact(weights):
    return px.load_artifact(weights["port_dir"])


def _decode_cfg(**extra):
    base = {
        "model": dict(MODEL),
        "decode": {"enabled": True, "max_len": MAX_LEN, "page_size": PAGE,
                   "num_pages": 64, "max_streams": 4,
                   "max_new_tokens": 8},
    }
    base["decode"].update(extra)
    cfg = port_load_config(base=base)
    cfg.serve.data = 1
    cfg.serve.report_interval_s = 60.0
    return cfg


def _engine(artifact, telemetry_writer=None, serve=None, **extra):
    cfg = _decode_cfg(**extra)
    for key, value in (serve or {}).items():
        setattr(cfg.serve, key, value)
    return pd.DecodeEngine(artifact, cfg.decode, cfg.serve, device="cpu",
                           telemetry_writer=telemetry_writer)


@pytest.fixture(scope="module")
def engine(artifact):
    eng = _engine(artifact)
    yield eng
    eng.drain(30.0)


# ------------------------------------------------- the page arithmetic


@pytest.mark.parametrize("tokens", [0, 1, 3, 4, 5, 16, 17, 31, 32, 512])
@pytest.mark.parametrize("page", [1, 4, 16])
def test_pages_for_matches_jax(tokens, page):
    assert pd.pages_for(tokens, page) == jd.pages_for(tokens, page)


@pytest.mark.parametrize("max_len, page, explicit", [
    (32, 4, []), (32, 4, [2, 3]), (512, 16, []), (512, 16, [4, 8]),
    (33, 4, []), (1, 16, []), (100, 7, [1, 30])])
def test_page_table_buckets_match_jax(max_len, page, explicit):
    assert (pd.page_table_buckets(max_len, page, explicit)
            == jd.page_table_buckets(max_len, page, explicit))


@pytest.mark.parametrize("hidden", [64, 256, 768, 1024, 1000])
def test_kv_block_size_matches_jax(hidden):
    assert pd.kv_block_size(hidden) == jd.kv_block_size(hidden)


def test_pick_bucket_edges():
    assert pick_bucket(8, [4, 8, 16]) == 8
    assert pick_bucket(5, [4, 8, 16]) == 8
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        pick_bucket(17, [4, 8, 16])
    with pytest.raises(ValueError, match="empty bucket ladder"):
        pick_bucket(1, [])


def test_pagepool_all_or_nothing():
    pool = pd.PagePool(8)  # page 0 reserved: 7 allocatable
    assert pool.capacity == 7
    got = pool.alloc(7)
    assert got is not None and len(got) == 7 and 0 not in got
    assert pool.alloc(1) is None
    pool.free(got[:3])
    assert pool.alloc(4) is None  # 3 free < 4 wanted: no partial grant
    assert len(pool.alloc(3)) == 3


def test_pagepool_race_for_last_block():
    """More threads than cores contend for the final page blocks, the
    interpreter switching threads as often as it can: exactly capacity
    pages are granted overall and no page twice."""
    pool = pd.PagePool(17)  # capacity 16
    grants: list[list[int]] = []
    lock = threading.Lock()
    start = threading.Event()

    def claim():
        start.wait()
        for _ in range(8):
            got = pool.alloc(2)
            if got is not None:
                with lock:
                    grants.append(got)

    threads = [threading.Thread(target=claim)
               for _ in range(2 * (os.cpu_count() or 8))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        start.set()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    granted = [p for g in grants for p in g]
    assert len(granted) == 16 and len(set(granted)) == 16
    assert pool.available() == 0
    pool.free(granted)
    assert pool.available() == 16


# ------------------------------------- the forwards against the JAX ones


def _random_pool(kv_dtype: str, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    pool = {k: np.asarray(v) for k, v in jd.make_kv_pool(
        MODEL["num_layers"], PAGES, PAGE, MODEL["hidden_size"],
        kv_dtype).items()}
    for name in ("k", "v"):
        if kv_dtype == "int8":
            pool[name] = rng.integers(-127, 128, pool[name].shape,
                                      dtype=np.int8)
            pool[f"{name}_scale"] = rng.uniform(
                1e-3, 2e-2, pool[f"{name}_scale"].shape).astype(np.float32)
        else:
            pool[name] = rng.standard_normal(
                pool[name].shape).astype(np.float32)
    return pool


def _check_pools(got: dict, want: dict, kv_dtype: str) -> None:
    """Every page but scratch page 0, which padding writes in an
    unspecified order on both sides."""
    if kv_dtype == "int8":
        block = pd.kv_block_size(MODEL["hidden_size"])
        for name in ("k", "v"):
            np.testing.assert_array_equal(got[name][:, 1:],
                                          want[name][:, 1:])
            deq = [jd._dequant_pages(jnp.asarray(p[name][:, 1:]),
                                     jnp.asarray(p[f"{name}_scale"][:, 1:]),
                                     block) for p in (got, want)]
            step = np.maximum(got[f"{name}_scale"][:, 1:],
                              want[f"{name}_scale"][:, 1:])
            gap = np.abs(np.asarray(deq[0]) - np.asarray(deq[1]))
            assert (gap.reshape(*step.shape, block)
                    <= step[..., None]).all()
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(got[name][:, 1:], want[name][:, 1:],
                                       **LOGIT_TOL)


def _forward_pair(fused: bool, kv_dtype: str):
    params = _jax_params(fused, seed=3)
    port = decode_params(flax_to_state_dict(params), "cpu")
    ref = bert_decode_head_params(jax.tree.map(jnp.asarray, params))
    return port, ref


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("fused", [True, False])
def test_prefill_and_decode_step_match_jax(fused, kv_dtype):
    """The prefill of an 11-token prompt into three pages (its table
    padded with scratch), then one decode step of four rows (one a
    filler), on the same pool contents as the JAX functions."""
    port, ref = _forward_pair(fused, kv_dtype)
    heads, kw = MODEL["num_heads"], dict(num_heads=MODEL["num_heads"],
                                         page_size=PAGE, kv_dtype=kv_dtype)
    rng = np.random.default_rng(7)
    pool = _random_pool(kv_dtype, seed=11)
    ppool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    n = 11
    ids = np.zeros((1, MAX_LEN), np.int32)
    ids[0, :n] = rng.integers(0, MODEL["vocab_size"], n)
    table = np.array([3, 5, 9, 0], np.int32)
    want, jpool = jd.make_prefill_fn(heads, PAGE, kv_dtype)(
        ref, {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(ids),
        jnp.asarray([n], jnp.int32), jnp.asarray(table))
    got = pd.prefill(port, ppool, torch.from_numpy(ids).long(),
                     torch.tensor([n]), torch.from_numpy(table).long(), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    jpool = {k: np.asarray(v) for k, v in jpool.items()}
    _check_pools({k: v.numpy() for k, v in ppool.items()}, jpool, kv_dtype)

    ids = rng.integers(0, MODEL["vocab_size"], 4).astype(np.int32)
    positions = np.array([12, 5, 17, 0], np.int32)
    table = np.array([[3, 5, 9, 0, 0], [7, 2, 0, 0, 0], [1, 4, 6, 8, 10],
                      [0, 0, 0, 0, 0]], np.int32)
    want, jpool = jd.make_decode_fn(heads, PAGE, kv_dtype)(
        ref, {k: jnp.asarray(v) for k, v in jpool.items()},
        jnp.asarray(ids), jnp.asarray(positions), jnp.asarray(table))
    got = pd.decode_step(port, ppool, torch.from_numpy(ids).long(),
                         torch.from_numpy(positions).long(),
                         torch.from_numpy(table).long(), **kw)
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3],
                               **LOGIT_TOL)
    _check_pools({k: v.numpy() for k, v in ppool.items()},
                 {k: np.asarray(v) for k, v in jpool.items()}, kv_dtype)


def test_greedy_streams_match_the_jax_engine(weights, artifact):
    """The same prompts through both engines, concurrently (so batched
    steps and page growth are exercised): the same greedy tokens."""
    prompts = [[5, 6, 7], [3, 1, 4, 1, 5], list(range(1, 12)), [2, 7]]
    cfg = _decode_cfg()
    jcfg = jax_load_config(base={"model": dict(MODEL), "decode": {
        "enabled": True, "max_len": MAX_LEN, "page_size": PAGE,
        "num_pages": 64, "max_streams": 4, "max_new_tokens": 8}})
    jcfg.serve.data = 1
    jcfg.serve.report_interval_s = 60.0
    ref = jd.DecodeEngine(jx.load_artifact(weights["jax_dir"]), jcfg.decode,
                          jcfg.serve, mesh=serving_mesh(1))
    port = pd.DecodeEngine(artifact, cfg.decode, cfg.serve, device="cpu")
    try:
        streams = [(port.submit(p, max_new_tokens=8),
                    ref.submit(p, max_new_tokens=8)) for p in prompts]
        for p, (got, want) in zip(prompts, streams):
            got, want = got.result(120), want.result(300)
            assert got["tokens"] == want["tokens"], p
            assert got["finish"] == want["finish"] == "length"
    finally:
        assert port.drain(30.0)
        ref.drain(30.0)


# ------------------------------------------- the engine against itself


def test_single_stream_greedy(engine):
    out = engine.generate([5, 6, 7], max_new_tokens=4, timeout=120)
    assert len(out["tokens"]) == 4
    assert out["finish"] == "length"
    assert out["admissions"] == 1
    assert out["ttft_ms"] is not None
    again = engine.generate([5, 6, 7], max_new_tokens=4, timeout=120)
    assert again["tokens"] == out["tokens"]


def test_stream_events_order(engine):
    stream = engine.submit([9, 10], max_new_tokens=3)
    seen = list(stream.events(timeout=120))
    assert [k for k, _ in seen] == ["token", "token", "token", "done"]
    tokens = [p["token"] for k, p in seen if k == "token"]
    assert seen[-1][1]["tokens"] == tokens
    assert [p["index"] for k, p in seen if k == "token"] == [0, 1, 2]


def test_stream_interval_batches_delivery(artifact):
    eng = _engine(artifact, stream_interval=4)
    try:
        stream = eng.submit([9, 10], max_new_tokens=7)
        seen = list(stream.events(timeout=120))
        assert [k for k, _ in seen] == ["token"] * 7 + ["done"]
        assert [p["index"] for k, p in seen if k == "token"] == \
            list(range(7))
        ref = eng.generate([9, 10], max_new_tokens=7, timeout=120)
        assert ref["tokens"] == seen[-1][1]["tokens"]
    finally:
        eng.drain(30.0)
    with pytest.raises(ValueError, match="stream_interval"):
        _decode_cfg(stream_interval=0)


def test_batched_logits_match_single(engine):
    """A stream decoded beside neighbours (other row buckets, other page
    buckets) gives bit-equal logits to the same stream alone."""
    prompt = [3, 1, 4, 1, 5]
    solo = [p for k, p in engine.submit(
        prompt, max_new_tokens=4, return_logits=True).events(timeout=120)
        if k == "token"]
    streams = [
        engine.submit(prompt, max_new_tokens=4, return_logits=True),
        engine.submit([2, 7], max_new_tokens=6),
        engine.submit(list(range(1, 12)), max_new_tokens=3),
        engine.submit(list(range(20)), max_new_tokens=9),
    ]
    batched = [p["logits"] for k, p in streams[0].events(timeout=120)
               if k == "token"]
    for s in streams[1:]:
        s.result(timeout=120)
    assert [int(np.argmax(lg)) for lg in batched] == \
        [p["token"] for p in solo]
    for got, ref in zip(batched, solo):
        np.testing.assert_array_equal(got, ref["logits"])


def test_compile_grid_bounded(engine):
    import ast

    stats = engine.stats()
    rows, pages = set(engine.row_buckets), set(engine.page_buckets)
    prompts = set(engine.prompt_buckets)
    assert stats["compiled_buckets"]
    for key in stats["compiled_buckets"]:
        kind, a, b = ast.literal_eval(key)
        if kind == "prefill":
            assert a in prompts and b in pages
        else:
            assert kind == "decode" and a in rows and b in pages
    assert len(stats["compiled_buckets"]) <= (
        len(prompts) * len(pages) + len(rows) * len(pages))


def test_submit_typed_errors(engine):
    with pytest.raises(pd.StreamTooLongError):
        engine.submit(list(range(MAX_LEN)), max_new_tokens=8)
    with pytest.raises(pd.DecodeError):
        engine.submit([], max_new_tokens=2)
    with pytest.raises(pd.DecodeError):
        engine.submit([1, 2], max_new_tokens=-1)
    with pytest.raises(pd.DecodeError, match="prompt ids"):
        engine.submit([MODEL["vocab_size"]], max_new_tokens=1)


def test_cache_full_refuses_never_fitting(artifact):
    eng = _engine(artifact, num_pages=5, max_streams=2, max_new_tokens=4)
    try:
        with pytest.raises(pd.CacheFullError):
            eng.submit(list(range(1, 20)), max_new_tokens=4)
        out = eng.generate(list(range(1, 14)), max_new_tokens=4,
                           timeout=120)
        assert len(out["tokens"]) == 4
    finally:
        eng.drain(30.0)


def test_queue_backpressure(artifact):
    eng = _engine(artifact, serve={"queue_capacity": 2})
    try:
        streams = []
        with pytest.raises(QueueFullError):
            for _ in range(64):
                streams.append(eng.submit([1, 2], max_new_tokens=8))
        for s in streams:
            s.result(timeout=120)
    finally:
        eng.drain(30.0)


def test_eviction_resumes_bitwise(artifact):
    """Under page pressure the newest stream is evicted and re-prefilled
    over prompt + generated: its tokens equal an uncontended run's."""
    long_prompt, short_prompt = list(range(1, 12)), [7, 3]
    ref = _engine(artifact, max_streams=2)
    try:
        ref_long = ref.generate(long_prompt, max_new_tokens=8, timeout=120)
        ref_short = ref.generate(short_prompt, max_new_tokens=8,
                                 timeout=120)
    finally:
        ref.drain(30.0)
    eng = _engine(artifact, num_pages=8, max_streams=2)
    try:
        s_long = eng.submit(long_prompt, max_new_tokens=8)
        s_short = eng.submit(short_prompt, max_new_tokens=8)
        out_long = s_long.result(timeout=120)
        out_short = s_short.result(timeout=120)
        assert out_long["tokens"] == ref_long["tokens"]
        assert out_short["tokens"] == ref_short["tokens"]
        assert (eng.stats()["evictions"] >= 1
                or out_long["admissions"] + out_short["admissions"] >= 3)
    finally:
        eng.drain(30.0)


def test_int8_kv_close_to_f32(artifact):
    eng8 = _engine(artifact, kv_dtype="int8")
    eng32 = _engine(artifact)
    try:
        prompt = [3, 1, 4, 1, 5, 9]
        lg8s, lg32s = ([p["logits"] for k, p in eng.submit(
            prompt, max_new_tokens=3, return_logits=True
        ).events(timeout=120) if k == "token"] for eng in (eng8, eng32))
        assert eng8.stats()["kv_dtype"] == "int8"
        assert len(lg8s) == len(lg32s) == 3
        diffs = [float(np.max(np.abs(lg8 - lg32)))
                 for lg8, lg32 in zip(lg8s, lg32s)]
        # The prefill's token attends in registers, not through the pool.
        assert diffs[0] == 0.0 and max(diffs) > 0.0, diffs
        assert max(diffs) < 0.05, f"int8 KV drifted {diffs} from f32"
    finally:
        eng8.drain(30.0)
        eng32.drain(30.0)


def test_reload_drains_then_swaps(artifact, weights):
    """The in-flight stream finishes on the old weights (drain, never
    kill), then the engine decodes on the new ones, bit for bit as a
    cold engine on them."""
    new_dir = _save_port(weights["root"] / "reload_v2",
                         _jax_params(seed=1), step=1)
    eng = _engine(artifact)
    cold = _engine(px.load_artifact(new_dir))
    try:
        before = eng.generate([2, 4, 6], max_new_tokens=4, timeout=120)
        stream = eng.submit([2, 4, 6], max_new_tokens=8)
        result = eng.reload(new_dir, timeout=120.0)
        out = stream.result(timeout=120)
        assert len(out["tokens"]) == 8
        assert out["tokens"][:4] == before["tokens"]
        assert result["from_step"] == 0 and result["to_step"] == 1
        assert eng.stats()["reloads"] == 1
        after = eng.generate([2, 4, 6], max_new_tokens=4,
                             return_logits=True, timeout=120)
        want = cold.generate([2, 4, 6], max_new_tokens=4, timeout=120)
        assert after["tokens"] == want["tokens"]
        with pytest.raises(pd.ReloadError, match="still serving step 1"):
            eng.reload(str(weights["root"] / "missing"), timeout=10.0)
    finally:
        eng.drain(30.0)
        cold.drain(30.0)


def test_drain_then_closed(artifact, weights):
    eng = _engine(artifact)
    assert eng.drain(30.0) is True
    with pytest.raises(pd.DecodeClosedError):
        eng.submit([1], max_new_tokens=1)
    with pytest.raises(pd.DecodeClosedError):
        eng.reload(weights["port_dir"], timeout=10.0)


def test_refuses_what_cannot_decode(artifact):
    import dataclasses

    cfg = _decode_cfg()
    moe = dataclasses.replace(
        artifact, model_config=dataclasses.replace(
            artifact.model_config, num_experts=4))
    with pytest.raises(pd.DecodeError, match="MoE"):
        pd.DecodeEngine(moe, cfg.decode, cfg.serve, device="cpu")
    with pytest.raises(pd.DecodeError, match="mlm task"):
        pd.DecodeEngine(dataclasses.replace(artifact, task="classification"),
                        cfg.decode, cfg.serve, device="cpu")


# ------------------------------------------------------------ telemetry


def test_decode_telemetry_rollup(artifact, tmp_path):
    """The port's decode events roll up through the JAX package's
    summarize_events and format_run_summary."""
    path = str(tmp_path / "events.jsonl")
    writer = pt.TelemetryWriter(path)
    eng = _engine(artifact, telemetry_writer=writer)
    try:
        eng.generate([1, 2, 3], max_new_tokens=4, timeout=120)
    finally:
        eng.drain(30.0)
        writer.close()
    kinds = {json.loads(line)["kind"] for line in open(path)}
    assert {jt.KIND_DECODE_STEP, jt.KIND_KV_CACHE,
            jt.KIND_SERVE_RECOMPILE} <= kinds
    assert (pt.KIND_DECODE_STEP, pt.KIND_KV_CACHE, pt.KIND_SERVE_RELOAD) == (
        jt.KIND_DECODE_STEP, jt.KIND_KV_CACHE, jt.KIND_SERVE_RELOAD)
    dec = jt.summarize_events(path)["decode"]
    assert dec["steps"] >= 3 and dec["tokens"] >= 3
    assert dec["kv_samples"] >= 1 and dec["pages_used_max"] >= 0
    text = jt.format_run_summary(jt.summarize_events(path))
    assert "decode:" in text and "kv cache:" in text


def test_decode_step_rollup_math(tmp_path):
    """Events written by the port's writer, summed by the JAX reader."""
    path = str(tmp_path / "events.jsonl")
    writer = pt.TelemetryWriter(path)
    writer.emit(pt.KIND_DECODE_STEP,
                metrics={"rows": 3, "padded_rows": 4, "step_ms": 10.0,
                         "per_token_ms": 10 / 3, "occupancy": 0.75})
    writer.emit(pt.KIND_DECODE_STEP,
                metrics={"rows": 1, "padded_rows": 4, "step_ms": 6.0,
                         "per_token_ms": 6.0, "occupancy": 0.25})
    for used, waiting in ((9, 2), (4, 0)):
        writer.emit(pt.KIND_KV_CACHE,
                    metrics={"pages_used": used, "pages_free": 63 - used,
                             "streams_active": 1,
                             "streams_waiting": waiting, "evictions": 1})
    writer.close()
    dec = jt.summarize_events(path)["decode"]
    assert (dec["steps"], dec["tokens"], dec["padded_rows"]) == (2, 4, 8)
    assert dec["step_ms_total"] == pytest.approx(16.0)
    assert dec["pages_used_max"] == 9 and dec["streams_waiting_max"] == 2
    assert dec["evictions"] == 1 and dec["kv_samples"] == 2


# ----------------------------------------------------------------- HTTP


@pytest.fixture()
def decode_server(artifact):
    cfg = _decode_cfg()
    cfg.serve.port = 0
    cfg.serve.max_wait_ms = 2.0
    eng = InferenceEngine(artifact, cfg.serve, device="cpu")
    dec = pd.DecodeEngine(artifact, cfg.decode, cfg.serve, device="cpu")
    srv = ServingServer(eng, cfg.serve, decode_engine=dec)
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown("test")
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post_generate(host, port, body, timeout=120):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/generate", json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        lines = [json.loads(line) for line in raw.splitlines()
                 if line.strip()]
        return resp.status, dict(resp.headers), lines
    finally:
        conn.close()


def test_http_generate_streams_ndjson(decode_server):
    status, headers, lines = _post_generate(
        decode_server.host, decode_server.port,
        {"prompt": [5, 6, 7], "max_new_tokens": 3})
    assert status == 200
    assert headers.get("Content-Type") == "application/x-ndjson"
    assert headers.get("Transfer-Encoding") == "chunked"
    assert headers.get("X-DTF-Step") == "0"
    tokens = [ln["token"] for ln in lines if "token" in ln]
    assert len(tokens) == 3
    assert lines[-1]["done"] is True and lines[-1]["tokens"] == tokens
    ref = decode_server.decode_engine.generate([5, 6, 7], max_new_tokens=3,
                                               timeout=120)
    assert ref["tokens"] == tokens


def test_http_generate_error_mapping(decode_server):
    status, _, _ = _post_generate(decode_server.host, decode_server.port,
                                  {"prompt": list(range(MAX_LEN + 8))})
    assert status == 400  # too long: can never be admitted
    status, _, _ = _post_generate(decode_server.host, decode_server.port,
                                  {"prompt": []})
    assert status == 400
    with urllib.request.urlopen(
            f"http://{decode_server.host}:{decode_server.port}/healthz",
            timeout=30) as resp:
        health = json.load(resp)
    assert health["decode"]["kv_dtype"] == "float32"
    assert health["decode"]["pages"]["total"] == 64
    assert health["artifact"]["reloads"] == 0
