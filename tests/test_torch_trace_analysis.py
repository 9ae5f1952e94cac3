"""The port's trace analyzer (core/trace_analysis.py), profile window
(core/profiling.py) and ProfileHook against the JAX package's.

Mirrors tests/test_trace_analysis.py and tests/test_profiling.py.
``classify`` and ``analyze`` give the JAX functions' outputs exactly: on a
corpus of XLA names, on identical TraceEvent lists, and on CUDA kernel
names held against the JAX functions given the HLO opcode XLA would give
the same work (a GEMM is a ``dot``, an NCCL all-reduce an ``all-reduce``,
a host-to-device copy an ``infeed``) and the scope through ``hlo_map``.
The Kineto reader is checked on a hand-written chrome trace (correlation
ids to ``optimizer_update``, CPU ops kept off the device line, the gaps
counted to the picosecond) and on a torch.profiler trace captured on the
CPU, whose categories cover the window (coverage 1 ± 1e-6).
"""

import gzip
import json

import pytest
import torch

from distributed_tensorflow_framework_torch.core import profiling
from distributed_tensorflow_framework_torch.core import telemetry as pt
from distributed_tensorflow_framework_torch.core import trace_analysis as pa
from distributed_tensorflow_framework_torch.train.hooks import ProfileHook
from distributed_tensorflow_framework_tpu.core import telemetry as jt
from distributed_tensorflow_framework_tpu.core import trace_analysis as ja
from tests.test_torch_hygiene import torch_threads  # noqa: F401

XLA_NAMES = [
    "dot.11", "dot_general.3", "convolution.4", "conv.2", "fusion.7",
    "all-reduce.3", "all-gather.1", "reduce-scatter.2", "all-to-all",
    "collective-permute.5", "psum", "ppermute", "infeed.1", "outfeed",
    "copy.3", "copy-start.2", "copy_fusion", "transfer", "buffer copy",
    "multiply_add_fusion", "loop_convert_fusion", "gemm_fusion.1",
    "cublas-gemm.1", "custom-call.4", "matmul.2", "ThunkExecutor::Execute",
]
# CUDA names with the HLO opcode XLA gives the same work.
CUDA_NAMES = {
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT": "dot",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "dot",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu>": "dot",
    "ampere_sgemm_128x64_tn": "dot",
    "sm80_xmma_fprop_implicit_gemm_indexed_f32f32_nhwckrsc_nchw":
        "convolution",
    "void cudnn::cnn::implicit_convolve_sgemm<float, float, 128, 5>":
        "convolution",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)":
        "all-reduce",
    "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)": "all-gather",
    "Memcpy HtoD (Pinned -> Device)": "infeed",
    "Memcpy DtoH (Device -> Pageable)": "infeed",
    "Memcpy DtoD (Device -> Device)": "",
    "Memset (Device)": "",
    "void at::native::vectorized_elementwise_kernel<8, GeluCUDAKernelImpl>":
        "",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>":
        "",
    "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, 512>": "",
    "void flash_attn_fwd_tc_kernel<64, false>(FwdParams)": "",
    "void flash_attn_bwd_dq_tc_kernel<64, false>(BwdParams)": "",
    "void flash_attn_bwd_dkv_tc_kernel<64, false>(BwdParams)": "",
}


# PyTorch's device-side copies (casts, layout copies): the JAX pattern
# ``copy[-._]`` reads them as infeed, the port as the elementwise work
# they are (the one deliberate difference in classification).
DEVICE_COPIES = [
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)>",
    "void at::native::vectorized_elementwise_kernel<8, at::native::"
    "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)>",
]


def _events(mod, rows):
    return [mod.TraceEvent(*row) for row in rows]


def _rows(names, line="/device:GPU:0 Stream #7"):
    rows, t = [], 1_000_000
    for i, name in enumerate(names):
        dur = 1000 * (i % 5 + 1)
        rows.append((name, t, dur, line, "/device:GPU:0"))
        t += dur + (0 if i % 3 else 700)  # a gap every third event
        if i % 4 == 1:  # an overlapping neighbour on another stream
            rows.append((name, t - dur // 2, dur, "Stream #8",
                         "/device:GPU:0"))
    return rows


def test_classify_xla_names_as_jax_does():
    assert pa.CATEGORIES == ja.CATEGORIES and pa.GAP == ja.GAP
    for name in XLA_NAMES:
        assert pa.classify(name) == ja.classify(name, None), name
        assert pa.classify(name, None) == ja.classify(name, None), name


def test_classify_cuda_names_as_jax_classifies_their_opcodes():
    for name, opcode in CUDA_NAMES.items():
        want = ja.classify(name, {name: (opcode, "")})
        assert pa.classify(name) == want, (name, want)
        scope = "train_step/optimizer_update"
        assert pa.classify(name, scope) == ja.classify(
            name, {name: (opcode, scope)}) == "optimizer_update"
    got = {pa.classify(n) for n in CUDA_NAMES}
    assert got == set(pa.CATEGORIES) - {"optimizer_update"}
    for name in DEVICE_COPIES:
        assert ja.classify(name, None) == "infeed"
        assert pa.classify(name) == "other_compute"
    assert pa.classify("copy_kernel.2") == ja.classify("copy_kernel.2",
                                                       None)


@pytest.mark.parametrize("names", [XLA_NAMES, XLA_NAMES[::-1] * 3])
def test_analyze_equals_jax_on_identical_events(names):
    rows = _rows(names)
    for top_n in (3, 15):
        got = pa.analyze(_events(pa, rows), top_n=top_n)
        want = ja.analyze(_events(ja, rows), None, top_n=top_n)
        assert got == want
    assert pa._union_ps([(0, 5), (3, 9), (12, 13)]) == ja._union_ps(
        [(0, 5), (3, 9), (12, 13)]) == 10
    assert pa.format_report(got) == ja.format_report(want)


def test_analyze_with_scopes_equals_jax_with_an_hlo_map():
    names = list(CUDA_NAMES) + ["multi_tensor_apply_kernel<AdamW>"]
    rows = _rows(names)
    scopes = {n: ("ProfilerStep#3/train_step/optimizer_update"
                  if "multi_tensor" in n or "Gelu" in n else
                  "ProfilerStep#3/train_step") for n in names}
    port = [pa.TraceEvent(*row, scope=scopes[row[0]]) for row in rows]
    hlo_map = {n: (CUDA_NAMES.get(n, ""), scopes[n]) for n in names}
    got = pa.analyze(port)
    want = ja.analyze(_events(ja, rows), hlo_map)
    assert got == want
    assert got["hlo_map_used"] is True
    assert got["breakdown"]["optimizer_update"]["summed_event_ps"] > 0


def _chrome_trace() -> dict:
    """A hand-written Kineto trace: one host thread with a step range
    and an optimizer_update range inside it, launches by the runtime and
    the driver, their kernels and a memcpy on stream 7, the profiler's
    own spans and flows (to be ignored)."""
    host = {"pid": 100, "tid": 100}
    dev = {"pid": 0, "tid": 7}

    def x(cat, name, ts, dur, where, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                **where, "args": args}

    return {"schemaVersion": 1, "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 100, "tid": 0,
         "args": {"name": "python3"}},
        x("Trace", "PyTorch Profiler (0)", 0, 2000, host),
        x("overhead", "Activity Buffer Request", 0, 50,
          {"pid": -1, "tid": 0}),
        x("user_annotation", "ProfilerStep#1", 10, 1000, host),
        x("user_annotation", "train_step", 20, 950, host),
        x("user_annotation", "optimizer_update", 600.5, 300, host),
        x("cpu_op", "aten::mm", 90, 30, host),
        x("cuda_runtime", "cudaMemcpyAsync", 5, 5, host, correlation=4),
        x("cuda_runtime", "cudaLaunchKernel", 100, 5, host, correlation=1),
        x("cuda_driver", "cuLaunchKernelEx", 200, 5, host, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 700.25, 5, host,
          correlation=2),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 60, 20, dev,
          stream=7, device=0, correlation=4),
        x("kernel", "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 150, 100,
          dev, stream=7, device=0, correlation=1),
        x("kernel", "void flash_attn_fwd_tc_kernel<64, false>(FwdParams)",
          260, 50.000001, dev, stream=7, device=0, correlation=3),
        x("gpu_user_annotation", "optimizer_update", 700, 100, dev),
        x("kernel", "void multi_tensor_apply_kernel<AdamW>", 720, 80, dev,
          stream=7, device=0, correlation=2),
        {"ph": "s", "id": 1, "pid": 100, "tid": 100, "ts": 100,
         "cat": "ac2g", "name": "ac2g"},
        {"ph": "i", "name": "Iteration Start", "pid": "Traces", "ts": 0},
    ]}


def test_kineto_reader_on_a_hand_written_trace(tmp_path):
    doc = _chrome_trace()
    plain = tmp_path / "h_1.1.pt.trace.json"
    plain.write_text(json.dumps(doc))
    zipped = tmp_path / "h_1.2.pt.trace.json.gz"
    with gzip.open(zipped, "wt") as fh:
        json.dump(doc, fh)
    assert pa.find_trace_files(str(tmp_path)) == [str(plain), str(zipped)]
    events = pa.parse_kineto(pa.load_kineto(str(plain)))
    assert events == pa.parse_kineto(pa.load_kineto(str(zipped)))
    device = {e.name: e for e in events if e.line == "Stream #7"}
    assert set(device) == {
        "Memcpy HtoD (Pinned -> Device)",
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT",
        "void flash_attn_fwd_tc_kernel<64, false>(FwdParams)",
        "void multi_tensor_apply_kernel<AdamW>"}
    adam = device["void multi_tensor_apply_kernel<AdamW>"]
    assert adam.scope == "ProfilerStep#1/train_step/optimizer_update"
    assert adam.plane == "/device:GPU:0"
    assert device["nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT"].scope == (
        "ProfilerStep#1/train_step")
    assert device["Memcpy HtoD (Pinned -> Device)"].scope == ""
    flash = device["void flash_attn_fwd_tc_kernel<64, false>(FwdParams)"]
    assert (flash.start_ps, flash.duration_ps) == (260_000_000, 50_000_001)
    host = [e for e in events if e.line == "host thread 100"]
    assert sorted(e.name for e in host) == sorted([
        "aten::mm", "cudaMemcpyAsync", "cudaLaunchKernel", "cuLaunchKernelEx",
        "cudaLaunchKernel"])
    report = pa.analyze_trace_file(str(plain))
    # The window is the device line alone: 60 us .. 800 us; busy is the
    # four device events; the host line stays out.
    assert report["num_events"] == 4
    assert report["window_ps"] == 740_000_000
    assert report["busy_ps"] == 250_000_001
    assert report["launch_gap_ps"] == 740_000_000 - 250_000_001
    b = report["breakdown"]
    assert b["optimizer_update"]["summed_event_ps"] == 80_000_000
    assert b["gemm_conv"]["summed_event_ps"] == 100_000_000
    assert b["infeed"]["summed_event_ps"] == 20_000_000
    assert b["other_compute"]["summed_event_ps"] == 50_000_001
    assert report["coverage"] == pytest.approx(1.0, abs=1e-8)
    assert report["hlo_map_used"] is True
    assert report["top_ops"][0]["name"].startswith("nvjet")
    assert report["trace_path"] == str(plain)
    out = str(tmp_path / "summary.jsonl")
    ev = pa.write_summary_event(report, out, run_id="r1")
    [read] = list(jt.read_events(out, kind=jt.KIND_TRACE_SUMMARY))
    assert read == ev and jt.validate_event(read) == []
    assert set(read["phases"]) == {*pa.CATEGORIES, pa.GAP}
    assert jt.summarize_events(out) == pt.summarize_events(out)
    assert "launch_gap" in pa.format_report(report)


def test_cpu_profiler_trace_covers_its_window(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.GELU(),
                                torch.nn.Linear(64, 8))
    opt = torch.optim.AdamW(model.parameters())
    x = torch.randn(16, 32)
    with profiling.trace(str(tmp_path / "traces")):
        for _ in range(2):
            with profiling.annotate("train_step"):
                model(x).square().mean().backward()
                with profiling.annotate("optimizer_update"):
                    opt.step()
                opt.zero_grad()
    [path] = pa.find_trace_files(str(tmp_path / "traces"))
    assert path.endswith(".pt.trace.json")
    report = pa.analyze_trace_file(path)
    assert report["coverage"] == pytest.approx(1.0, abs=1e-6)
    assert report["num_events"] > 0
    b = report["breakdown"]
    assert b["optimizer_update"]["summed_event_ps"] > 0
    assert b["gemm_conv"]["summed_event_ps"] > 0
    fracs = sum(v["fraction_of_window"] for v in b.values())
    assert fracs == pytest.approx(1.0, abs=1e-6)


def test_step_timer_phases():
    t = profiling.StepTimer()
    for name in ("a", "a", "b"):
        with t.phase(name):
            pass
    assert set(t.means()) == {"time_a_ms", "time_b_ms"}
    assert t.counts == {"a": 2, "b": 1}
    t.reset()
    assert t.means() == {}


class _Trainer:
    device = torch.device("cpu")


@pytest.mark.parametrize("start, stop, total, traced", [
    (2, 4, 6, [3, 4]),   # the window is steps (start, stop]
    (0, 2, 6, [2]),      # a start of 0 opens after the first step
    (4, 9, 6, [5, 6]),   # a run that ends inside the window: on_end
])
def test_profile_hook_window(tmp_path, monkeypatch, start, stop, total,
                             traced):
    """The JAX ProfileHook's window: the trace holds exactly the steps
    (start, stop] that ran."""
    ran, opened, closed = [], [], []
    monkeypatch.setattr(profiling, "start_trace",
                        lambda: opened.append(len(ran)) or "prof")
    monkeypatch.setattr(profiling, "stop_trace",
                        lambda prof, logdir: closed.append((len(ran), prof,
                                                            logdir)))
    hook = ProfileHook(str(tmp_path), start, stop)
    trainer = _Trainer()
    for step in range(1, total + 1):
        ran.append(step)
        hook.after_step(trainer, step, None)
    hook.on_end(trainer)
    hook.on_end(trainer)  # a closed window stays closed
    assert len(opened) == 1
    [(end, prof, logdir)] = closed
    assert (prof, logdir) == ("prof", str(tmp_path))
    assert ran[opened[0]:end] == traced
