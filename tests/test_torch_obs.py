"""The port's observatory (mgproto_tpu_torch/obs/{profiler,stall,opcount}.py,
cli/trace_report.py, the stall gates and `summarize`'s perf section of
cli/telemetry.py) against the JAX package's, on the CPU.

  * Profiler windows: `parse_step_range`, and the window's decisions (its
    captures, their reasons and steps, and which steps it is armed over)
    on seeded step-time, loader-wait and recompile sequences, equal to
    JAX's; the CPU capture's meta and counted cost report; `train_epoch`
    drives the window and the flight recorder; on CUDA there is no
    fallback (a window that cannot start the profiler, and a capture
    without device events, raise), and windows do not nest.
  * Stall attribution: `classify_op` on XLA names equal to JAX's; the CUDA
    name table checked first (the Memcpy trap, the four kernels by their
    bound; JAX files every custom-call as MXU work); `attribute_trace`,
    `top_byte_movers_from_trace`, `roofline_buckets` and `finish_report`
    equal to JAX's on the same inputs; a synthetic kineto trace with two
    streams and nested CPU events: the device lane, the shared overlap,
    step time = span + host wait, fractions summing to 1.
  * The cost counter: the tiny step's conv and matmul FLOPs equal the
    analytic count, the kernels' rows their analytic counts, the total
    FLOPs within 3.5 % of JAX's `step_costs(tiny)` (measured gap: 3.25 %),
    and bf16 moves fewer fused bytes than f32 (JAX's bound).
  * `cli.trace_report` in both modes, `stall_report_gates` and `check
    --stall-report / --stall-baseline`, `summarize`'s perf section, as
    JAX's; the profiler flags through `cli.train`; the overlap gauge.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from mgproto_tpu.cli import telemetry as jtelemetry
from mgproto_tpu.config import tiny_test_config as jax_tiny_config
from mgproto_tpu.obs import profiler as jprofiler
from mgproto_tpu.obs import stall as jstall
from mgproto_tpu_torch.cli import telemetry as ttelemetry
from mgproto_tpu_torch.cli import trace_report
from mgproto_tpu_torch.config import tiny_test_config
from mgproto_tpu_torch.engine.train import Trainer
from mgproto_tpu_torch.obs import flightrec
from mgproto_tpu_torch.obs import opcount
from mgproto_tpu_torch.obs import profiler as tprofiler
from mgproto_tpu_torch.obs import stall as tstall
from mgproto_tpu_torch.telemetry.monitor import StepMonitor
from mgproto_tpu_torch.telemetry.registry import MetricRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALL_REPORT = os.path.join(REPO, "evidence", "stall_report_b256_bf16.json")
# |port / JAX - 1| of the tiny step's total FLOPs: the port counts conv,
# matmul and the kernels' analytic FLOPs, XLA's cost analysis also counts
# elementwise work; measured 0.0325 at batch 4
FLOPS_REL_GAP = 0.035


def _jax_report():
    return json.loads(open(STALL_REPORT).read().strip())


# ------------------------------------------------------------ ProfilerWindow
@pytest.mark.parametrize("raw", ["", "  ", "120:130", "7", "3:", "0:1"])
def test_parse_step_range_equals_jax(raw):
    assert tprofiler.parse_step_range(raw) == jprofiler.parse_step_range(raw)


@pytest.mark.parametrize("raw", ["10:5", "4:4", "x"])
def test_parse_step_range_refuses_as_jax(raw):
    with pytest.raises(ValueError):
        jprofiler.parse_step_range(raw)
    with pytest.raises(ValueError):
        tprofiler.parse_step_range(raw)


class FakeMonitor:
    recompile_count = 0


def _sequence(seed, n=120):
    """Seeded step seconds (spikes), loader-wait shares and recompile
    counts, the same for both packages."""
    rng = np.random.default_rng(seed)
    secs = 0.01 * (1.0 + 0.1 * rng.standard_normal(n))
    secs[rng.choice(n, 6, replace=False)] *= rng.uniform(2.0, 8.0, 6)
    waits = rng.uniform(0.0, 0.7, n)
    recompiles = np.cumsum(rng.random(n) < 0.03)
    return secs, waits, recompiles


WINDOWS = {
    "range": dict(steps=(5, 9)),
    "bare_step": dict(steps=(3, 4), capture_steps=5),
    "anomaly": dict(on_anomaly=True, capture_steps=2, max_captures=4, cooldown_steps=10,
                    triggers=dict(spike_factor=3.0, min_steps=10)),
    "anomaly_tight": dict(on_anomaly=True, capture_steps=1, max_captures=9, cooldown_steps=0,
                          triggers=dict(spike_factor=2.0, min_steps=3, wait_fraction=0.6)),
    "range_and_anomaly": dict(steps=(40, 44), on_anomaly=True, capture_steps=3, max_captures=2,
                              cooldown_steps=5, triggers=dict(min_steps=5, recompile=False)),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_window_decisions_equal_jax(case, seed, tmp_path):
    """The same captures at the same steps for the same reasons, armed over
    the same steps."""
    kw = dict(WINDOWS[case])
    trig = kw.pop("triggers", None)
    secs, waits, recompiles = _sequence(seed)
    runs = {}
    for name, mod, extra in (("jax", jprofiler, {}), ("torch", tprofiler, {"device": "cpu"})):
        mon = FakeMonitor()
        w = mod.ProfilerWindow(str(tmp_path / name), monitor=mon,
                               triggers=mod.Triggers(**trig) if trig else None, **kw, **extra)
        armed = []
        for s, wf, rc in zip(secs, waits, recompiles):
            mon.recompile_count = int(rc)
            w.on_step(float(s), wait_fraction=float(wf))
            armed.append(w.armed)
        w.close()
        runs[name] = ([(c["reason"], c["step"], c["fallback"]) for c in w.captures], armed)
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][0], "the sequence opened no capture"


def test_cpu_capture_writes_meta_and_the_counted_cost(tmp_path):
    costs = {"flops": 123.0, "bytes_accessed": 456.0}
    w = tprofiler.ProfilerWindow(str(tmp_path), steps=(1, 2), capture_steps=1,
                                 cost_provider=lambda: costs, device="cpu")
    for _ in range(3):
        w.on_step(0.01)
    (cap,) = w.captures
    assert cap["reason"] == "steps" and cap["fallback"] is True and cap["steps"] == 1
    meta = json.load(open(os.path.join(cap["dir"], tprofiler.META_FILE)))
    assert meta["reason"] == "steps" and meta["fallback"] is True and meta["backend"] == "cpu"
    assert json.load(open(os.path.join(cap["dir"], tprofiler.COST_FILE))) == costs
    with tprofiler.profile_block(str(tmp_path / "warm"), reason="serve_warmup",
                                 device="cpu") as path:
        assert path.endswith("trace_serve_warmup_step000000")
    assert json.load(open(os.path.join(path, tprofiler.META_FILE)))["reason"] == "serve_warmup"
    with tprofiler.profile_block("", device="cpu") as none:
        assert none is None


def _tiny_batches(cfg, n, b=4, seed=0):
    rng = np.random.RandomState(seed)
    s = cfg.model.img_size
    return [(rng.rand(b, s, s, 3).astype(np.float32),
             rng.randint(0, cfg.model.num_classes, (b,)).astype(np.int64)) for _ in range(n)]


def test_train_epoch_drives_the_window_and_the_recorder(tmp_path):
    cfg = tiny_test_config()
    trainer = Trainer(cfg, steps_per_epoch=3, device="cpu")
    state = trainer.init_state(0)
    rec = flightrec.FlightRecorder()
    prev = flightrec.set_recorder(rec)
    try:
        w = tprofiler.ProfilerWindow(str(tmp_path), steps=(0, 1), device="cpu",
                                     cost_provider=lambda: {"ok": True})
        trainer.train_epoch(state, _tiny_batches(cfg, 3), 0, window=w)
    finally:
        flightrec.set_recorder(prev)
    assert [(c["reason"], c["step"], c["steps"]) for c in w.captures] == [("steps", 1, 1)]
    steps = [e for e in rec.events() if e["kind"] == "step"]
    assert [e["i"] for e in steps] == [0, 1, 2]
    kinds = [e["kind"] for e in rec.events()]
    assert kinds.count("profiler_arm") == 1 and kinds.count("profiler_disarm") == 1


def test_a_window_on_cuda_without_a_profiler_raises(tmp_path):
    """No fallback on the card: here the CUDA activity cannot start."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the profiler starts")
    w = tprofiler.ProfilerWindow(str(tmp_path), steps=(0, 1))  # device None: CUDA
    with pytest.raises(tprofiler.ProfilerError):
        w.on_step(0.01)
    assert not w.armed and not w.captures


def test_a_capture_without_device_events_raises_on_cuda(tmp_path, monkeypatch):
    class CpuOnly:
        def stop(self):
            pass

        def export_chrome_trace(self, path):
            json.dump({"traceEvents": [{"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                                        "pid": 1, "tid": 1, "ts": 0, "dur": 5}]}, open(path, "w"))

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    path = str(tmp_path / "t.trace.json")
    assert tprofiler.stop_profiler(CpuOnly(), path, "cpu")["device_events"] == 0
    with pytest.raises(tprofiler.ProfilerError, match="no device event"):
        tprofiler.stop_profiler(CpuOnly(), path, "cuda")


def test_windows_do_not_nest(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(tprofiler.ProfilerError, match="do not nest"):
            tprofiler.start_profiler("cpu")


def test_profiler_trace_writes_the_epoch_trace(tmp_path):
    from mgproto_tpu_torch.utils.log import profiler_trace

    cfg = tiny_test_config()
    trainer = Trainer(cfg, steps_per_epoch=2, device="cpu")
    state = trainer.init_state(0)
    with profiler_trace(str(tmp_path / "p"), device="cpu"):
        trainer.train_epoch(state, _tiny_batches(cfg, 2), 0)
    events = tstall.load_chrome_trace(str(tmp_path / "p"))
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    with pytest.raises(RuntimeError, match="boom"), profiler_trace(str(tmp_path / "q"), "cpu"):
        raise RuntimeError("boom")
    assert not os.path.exists(tmp_path / "q" / "epoch.trace.json")
    assert not torch.autograd._profiler_enabled()


# --------------------------------------------------------- op classification
XLA_NAMES = [
    "fusion.123.convolution_3x3", "dot_general.7", "fusion.42", "dynamic-update-slice",
    "InfeedDequeueTuple", "unknown_weird_op", "all-reduce.3", "all-gather-start.1",
    "reduce-scatter.2", "copy-start.4", "copy-done.4", "send.1", "recv-done.2",
    "custom-call.12", "convert.5", "broadcast.8", "transpose.2", "sort.9", "while.3",
    "select-and-scatter.1", "outfeed.7", "reduce-window.4", "concatenate.1", "iota.2",
    "pad.6", "bitcast.1", "compare.3", "slice.9", "gather.2", "scatter.4", "einsum",
    "cublas_gemm", "ppermute.1", "psum",
]


@pytest.mark.parametrize("name", XLA_NAMES)
def test_classify_op_on_xla_names_equals_jax(name):
    assert tstall.classify_op(name) == jstall.classify_op(name)


CUDA_NAMES = {
    "Memcpy HtoD (Pinned -> Device)": "host_infeed",
    "Memcpy DtoH (Device -> Pageable)": "host_infeed",
    "Memcpy DtoD (Device -> Device)": "hbm_bound",
    "Memset (Device)": "hbm_bound",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
        "collective_wait",
    "void (anonymous namespace)::score_pool_fwd_kernel<20>(float const*, float const*)":
        "mxu_busy",
    "(anonymous namespace)::score_pool_bwd_compact_kernel(float const*, int const*)": "hbm_bound",
    "void (anonymous namespace)::score_pool_bwd_accumulate_kernel<2>(int2 const*)": "hbm_bound",
    "void (anonymous namespace)::bn_epilogue_kernel<(anonymous namespace)::F32x4>()":
        "hbm_bound",
    "void (anonymous namespace)::em_estep_partial_kernel<10>(float const*)": "hbm_bound",
    "(anonymous namespace)::em_estep_combine_kernel(float const*, float*)": "hbm_bound",
    "sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize128x128x8": "mxu_busy",
    "void cudnn::winograd_nonfused::winogradForwardFilter4x4<float, float>()": "mxu_busy",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>()": "mxu_busy",
    "void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>()": "mxu_busy",
    "void dgrad2d_alg1_1<float, 0, 4, 6, 3, 2, 4, false, true>()": "mxu_busy",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>()":
        "hbm_bound",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>()": "hbm_bound",
}


@pytest.mark.parametrize("name", sorted(CUDA_NAMES))
def test_classify_op_cuda_names(name):
    assert tstall.classify_op(name) == CUDA_NAMES[name]


def test_the_memcpy_trap_and_the_kernels_buckets_differ_from_jax_by_design():
    """JAX's tables would file a host-to-device copy under HBM ("memcpy"
    holds neither "copy" nor "transfer") and every custom-call (its Pallas
    kernels) under MXU; the port files the copy as host traffic and its
    four kernels by their bound."""
    h2d = "Memcpy HtoD (Pinned -> Device)"
    assert jstall.classify_op(h2d) == "hbm_bound" and tstall.classify_op(h2d) == "host_infeed"
    assert jstall.classify_op("custom-call.7") == tstall.classify_op("custom-call.7") == "mxu_busy"
    port = {k: tstall.classify_op(f"{k}_kernel") for k in
            ("score_pool_fwd", "score_pool_bwd_compact", "bn_epilogue", "em_estep_partial")}
    assert port == {"score_pool_fwd": "mxu_busy", "score_pool_bwd_compact": "hbm_bound",
                    "bn_epilogue": "hbm_bound", "em_estep_partial": "hbm_bound"}


# ------------------------------------------------------------ trace attribution
def _event(name, ts_us, dur_us, pid=1, tid=1, **kw):
    return {"name": name, "ph": "X", "ts": ts_us, "dur": dur_us, "pid": pid, "tid": tid, **kw}


def _xla_trace(seed):
    """A seeded XLA-style trace: a busy device lane of XLA op names with
    gaps, and quieter lanes."""
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    for _ in range(40):
        t += float(rng.uniform(0, 30))
        d = float(rng.uniform(1, 200))
        events.append(_event(str(rng.choice(XLA_NAMES)), t, d, pid=2, tid=3))
        t += d
    for _ in range(10):
        events.append(_event("noise", float(rng.uniform(0, 500)), 5.0, pid=2, tid=9))
    events.append({"name": "marker", "ph": "i", "ts": 3.0, "pid": 2, "tid": 3})
    return events


@pytest.mark.parametrize("host_s", [0.0, 1e-3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribute_trace_on_xla_traces_equals_jax(seed, host_s):
    events = _xla_trace(seed)
    got = tstall.attribute_trace(events, host_infeed_s=host_s)
    want = jstall.attribute_trace(events, host_infeed_s=host_s)
    assert got["buckets"] == want["buckets"]
    for key in ("source", "span_s", "step_time_s"):
        assert got[key] == want[key], key
    assert {k: got["device_lane"][k] for k in want["device_lane"]} == want["device_lane"]
    assert got["device_lane"]["rule"] == "busiest_lane"


def test_attribute_trace_jax_case():
    events = [_event("convolution.1", 0, 400), _event("fusion.2", 400, 200),
              _event("infeed.3", 700, 100), _event("noise", 0, 10, tid=9)]
    b = tstall.attribute_trace(events)["buckets"]
    assert b == jstall.attribute_trace(events)["buckets"]
    assert b["bubble"]["seconds"] == pytest.approx(100e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_top_byte_movers_from_xla_traces_equal_jax(seed):
    events = _xla_trace(seed)
    for i, e in enumerate(events[:15]):
        e["args"] = {"bytes_accessed": float(100 * (i + 1))}
    assert tstall.top_byte_movers_from_trace(events) == jstall.top_byte_movers_from_trace(events)


def _kineto_trace():
    """Two CUDA streams of device 0 (the main stream 7 and a bank stream
    20, overlapping for 50 us), nested CPU ops whose durations add up past
    the wall time, runtime calls, flow events and a GPU annotation that
    spans everything (none of which is device work)."""
    cpu = dict(pid=4242, tid=4242)
    return [
        _event("aten::conv2d", 0, 1000, cat="cpu_op", **cpu),
        _event("aten::convolution", 5, 990, cat="cpu_op", **cpu),
        _event("aten::_convolution", 10, 980, cat="cpu_op", **cpu),
        _event("cudaLaunchKernel", 20, 5, cat="cuda_runtime", **cpu),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 4242, "tid": 4242, "ts": 20},
        _event("ProfilerStep#3", 0, 2000, cat="gpu_user_annotation", pid=0, tid=7),
        _event("sm90_xmma_fprop_implicit_gemm_f32f32", 100, 300, cat="kernel", pid=0, tid=7),
        _event("void bn_epilogue_kernel<F32x4>()", 400, 100, cat="kernel", pid=0, tid=7),
        _event("void em_estep_partial_kernel<10>()", 450, 100, cat="kernel", pid=0, tid=20),
        _event("Memcpy HtoD (Pinned -> Device)", 600, 50, cat="gpu_memcpy", pid=0, tid=17),
        _event("Memset (Device)", 650, 0, cat="gpu_memset", pid=0, tid=7),  # empty: dropped
    ]


def test_kineto_trace_merges_the_streams_and_counts_overlap_once():
    rep = tstall.finish_report(tstall.attribute_trace(_kineto_trace(), host_infeed_s=1e-3),
                               flops=6.7e6, peak_flops=tstall.H100_F32_FLOPS)
    lane = rep["device_lane"]
    assert lane["rule"] == "cuda_device_streams_merged" and lane["pid"] == 0
    assert lane["streams"] == [7, 17, 20] and lane["events"] == 4
    b = {k: v["seconds"] for k, v in rep["buckets"].items()}
    # the gemm alone 300 us; the epilogue 50 alone + 25 shared, the E-step
    # 25 shared + 50 alone; the 50 us gap before the copy is the bubble
    want = {"mxu_busy": 300e-6, "hbm_bound": 150e-6, "collective_wait": 0.0,
            "host_infeed": 50e-6 + 1e-3, "bubble": 50e-6}
    assert b == pytest.approx(want, abs=1e-12)
    assert rep["span_s"] == pytest.approx(550e-6) and rep["device_busy_s"] == pytest.approx(500e-6)
    assert rep["stream_overlap_s"] == pytest.approx(50e-6)
    assert rep["step_time_s"] == pytest.approx(rep["span_s"] + 1e-3)
    assert rep["fraction_sum"] == pytest.approx(1.0, abs=1e-12)
    assert rep["measured_mfu"] == pytest.approx(6.7e6 / (1550e-6 * 67e12))
    movers = tstall.top_byte_movers_from_trace(_kineto_trace())
    assert {r["name"] for r in movers["rows"]} == {e["name"] for e in _kineto_trace()[6:10]}


ROOFLINES = {
    "measured": dict(flops=1e12, bytes_accessed=1e9, step_time_s=0.02, host_infeed_s=0.001,
                     peak_flops=1e14, hbm_bytes_per_s=1e12),
    "clamped": dict(flops=1e12, bytes_accessed=1e12, step_time_s=0.02, peak_flops=1e14,
                    hbm_bytes_per_s=1e12),
    "modeled": dict(flops=1e12, bytes_accessed=1e9, peak_flops=1e14, hbm_bytes_per_s=1e12),
    "below_floor": dict(flops=1e13, bytes_accessed=1e9, step_time_s=0.01, collective_wait_s=0.002,
                        peak_flops=1e14, hbm_bytes_per_s=1e12),
}


@pytest.mark.parametrize("case", sorted(ROOFLINES))
def test_roofline_and_finish_report_equal_jax(case):
    kw = ROOFLINES[case]
    got, want = tstall.roofline_buckets(**kw), jstall.roofline_buckets(**kw)
    assert got == want
    extra = {"config": "x"}
    rep_t = tstall.finish_report(got, flops=kw["flops"], peak_flops=kw["peak_flops"],
                                 attainable_mfu=0.8, extra=extra)
    rep_j = jstall.finish_report(want, flops=kw["flops"], peak_flops=kw["peak_flops"],
                                 attainable_mfu=0.8, extra=extra)
    assert rep_t == rep_j
    assert rep_t["fraction_sum"] == pytest.approx(1.0)


def test_the_port_reads_no_tpu_figure():
    """The peaks are the H100's; the attainable MFU defaults to the
    roofline, where JAX reads its TPU evidence file."""
    assert tstall.DEFAULT_PEAK_FLOPS == 67e12 and tstall.DEFAULT_HBM_BYTES_PER_S == 3.35e12
    assert tstall.default_peak_flops("bfloat16") == 989e12
    rep = tstall.finish_report(tstall.roofline_buckets(1e12, 1e9, 0.1), flops=1e12)
    assert rep["attainable_mfu"] == 1.0
    src = open(os.path.join(REPO, "mgproto_tpu_torch", "obs", "stall.py")).read()
    assert "mfu_headroom" not in src and "197e12" not in src


# ---------------------------------------------------------------- the counter
@pytest.fixture(scope="module")
def tiny_costs():
    """The port's counted tiny step (batch 4) and JAX's cost analysis of
    it, each built once."""
    port = tstall.step_costs(tiny_test_config(), batch=4, device="cpu", top_n=100)
    cfg = jax_tiny_config()
    lowered = jstall.lower_step_programs(cfg, 4)
    jax_costs = jstall.step_costs(cfg, batch=4, lowered=lowered)
    return port, jax_costs


def _analytic_conv_and_matmul(batch=4):
    """Conv and matmul FLOPs of the tiny step from the model's shapes:
    each conv's forward (2 x its MACs), its backward the weight gradient
    and, where its input carries a gradient, the input gradient too; the
    embedding Linear and the aux loss's cosine product likewise."""
    cfg = tstall.card_program(tiny_test_config())
    state = Trainer(cfg, steps_per_epoch=1, device="cpu").init_state(0)
    convs = []

    def hook(mod, inp, out):
        macs = out.numel() * mod.weight.shape[1] * mod.weight[0, 0].numel()
        convs.append(2.0 * macs * (1 + (2 if inp[0].requires_grad else 1)))

    handles = [m.register_forward_hook(hook) for m in state.model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    x = torch.zeros(batch, cfg.model.img_size, cfg.model.img_size, 3)
    state.model(x)
    for h in handles:
        h.remove()
    e_in, e_out = state.model.embedding.in_features, state.model.embedding.out_features
    linear = 3 * 2.0 * batch * e_in * e_out  # forward, input and weight gradients
    aux = 3 * 2.0 * batch * e_out * state.proxies.shape[0]  # cos, its two gradients
    return sum(convs), linear + aux


def test_counter_conv_and_matmul_flops_equal_the_analytic_count(tiny_costs):
    port, _ = tiny_costs
    rows = {r["name"]: r for r in port["top_byte_movers"]["rows"]}
    conv_want, mm_want = _analytic_conv_and_matmul()
    conv = sum(port_rows_flops(port, n) for n in ("aten.convolution", "aten.convolution_backward"))
    mm = sum(port_rows_flops(port, n) for n in ("aten.mm", "aten.addmm", "aten.bmm"))
    assert conv == conv_want and mm == mm_want
    assert rows["aten.convolution"]["bucket"] == "mxu_busy"


def port_rows_flops(costs, name):
    return costs["rows"].get(name, {}).get("flops", 0.0)


def test_counter_kernel_rows_are_the_analytic_counts(tiny_costs):
    from mgproto_tpu_torch.ops.em_kernels import em_estep_cost
    from mgproto_tpu_torch.ops.fused_scoring import score_pool_bwd_cost, score_pool_cost

    port, _ = tiny_costs
    m = tiny_test_config().model
    hw = (m.img_size // 4) ** 2  # the tiny trunk's stride
    p = m.num_classes * m.prototypes_per_class
    want = {"score_pool": (1, *score_pool_cost(4, hw, p, m.proto_dim, m.mine_T)),
            "score_pool_bwd": (1, *score_pool_bwd_cost(4, hw, p, m.proto_dim, m.mine_T))}
    got = {k: (v["count"], v["flops"], v["bytes"]) for k, v in port["kernels"].items()
           if k in want}
    assert got == want
    n_em = tiny_test_config().em.num_em_loop
    em = port["kernels"]["em_estep"]
    assert em["count"] == n_em
    flops, nbytes = em_estep_cost(m.num_classes, m.mem_capacity, m.proto_dim,
                                  m.prototypes_per_class)
    assert em["flops"] == n_em * flops and em["bytes"] == n_em * nbytes


def test_counter_total_flops_near_jax_cost_analysis(tiny_costs):
    port, jax_costs = tiny_costs
    assert port["programs"].keys() == jax_costs["programs"].keys() == {"step"}
    assert abs(port["flops"] / jax_costs["flops"] - 1.0) <= FLOPS_REL_GAP
    assert port["raw_bytes"] > port["fused_bytes"] > 0


def test_counter_fused_bytes_fall_under_bf16():
    """JAX's bound on its byte model: the bf16 step moves fewer fused
    bytes than the f32 one."""
    cfg = tiny_test_config()
    f32 = tstall.step_costs(cfg, batch=4, device="cpu")
    bf16 = tstall.step_costs(
        cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16")),
        batch=4, device="cpu")
    assert bf16["fused_bytes"] < f32["fused_bytes"]
    assert bf16["flops"] == f32["flops"]


def test_counter_async_phases_and_epilogue_rows():
    """Under --async_bank the trunk and the bank phase report apart (JAX's
    {"trunk", "bank"}); on a resnet the epilogue is one kernel row a block
    tail, its backward counted as ops on either device."""
    cfg = tiny_test_config(arch="resnet18")
    cfg = cfg.replace(em=dataclasses.replace(cfg.em, async_bank=True))
    costs = tstall.step_costs(cfg, batch=2, device="cpu")
    assert set(costs["programs"]) == {"trunk", "bank"}
    assert costs["kernels"]["bn_epilogue"]["count"] == 8
    assert costs["kernels"]["em_estep"]["count"] == cfg.em.num_em_loop
    assert costs["programs"]["bank"]["flops"] > 0
    assert not opcount._ACTIVE


def test_counted_is_free_when_no_counter_is_active():
    assert opcount.counted("score_pool", 1.0, 2.0) is opcount.counted("em_estep", 3.0, 4.0)
    with opcount.OpCounter() as c:
        with pytest.raises(RuntimeError, match="already active"):
            opcount.OpCounter().__enter__()
        torch.ones(3) + 1
    assert c.totals()["raw_bytes"] > 0


# ---------------------------------------------------------------- trace_report
def test_trace_report_trace_mode(tmp_path, capsys):
    path = str(tmp_path / "t.json")
    json.dump({"traceEvents": _kineto_trace()}, open(path, "w"))
    out = str(tmp_path / "r.json")
    assert trace_report.main(["--trace", path, "--flops", "1e9", "--out", out]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep == json.loads(open(out).read())
    assert rep["source"] == "trace" and rep["fraction_sum"] == pytest.approx(1.0)
    assert rep["peak_flops"] == 67e12 and rep["measured_mfu"] > 0


def test_trace_report_cost_mode_tiny_cpu(tmp_path):
    rep = trace_report.cost_analysis_report(
        batch=4, step_time_s=0.05, host_infeed_s=0.0, peak_flops=None,
        hbm_bytes_per_s=3.35e12, attainable=None, tiny=True, byte_source="counted_fused",
        device="cpu")
    assert rep["stall_report"] and rep["source"] == "cost_analysis"
    assert set(rep["buckets"]) == set(tstall.BUCKETS)
    assert rep["fraction_sum"] == pytest.approx(1.0)
    assert rep["bytes_accessed"] == rep["counted_fused_bytes"] < rep["counted_raw_bytes"]
    assert rep["backend"] == "cpu" and rep["peak_flops"] == 67e12
    assert ttelemetry.stall_report_gates(rep)["ok"]


# ------------------------------------------------------------------ the gates
def _perturbed(kind):
    rep = _jax_report()
    if kind == "bytes":
        rep["bytes_accessed"] *= 1.2
    elif kind == "hbm":
        rep["buckets"]["hbm_bound"]["fraction"] += 0.1
    elif kind == "source":
        rep["byte_source"] = "cost_analysis"
    elif kind == "slower":
        rep["step_time_s"] *= 1.5
    elif kind == "fractions":
        rep["fraction_sum"] = 0.9
    elif kind == "no_movers":
        rep["top_byte_movers"] = {"rows": []}
    elif kind == "not_a_report":
        rep = {"not": "a report"}
    return rep


@pytest.mark.parametrize("baseline", [False, True])
@pytest.mark.parametrize("kind", ["same", "bytes", "hbm", "source", "slower", "fractions",
                                  "no_movers", "not_a_report"])
def test_stall_report_gates_equal_jax(kind, baseline):
    rec = _perturbed(kind)
    base = _jax_report() if baseline else None
    got = ttelemetry.stall_report_gates(rec, base)
    assert got == jtelemetry.stall_report_gates(rec, base)
    assert got["ok"] == (kind == "same" or (not baseline and kind in (
        "bytes", "hbm", "source", "slower")))


def test_check_stall_report_cli(tmp_path):
    assert ttelemetry.main(["check", "--stall-report", STALL_REPORT]) == 0
    assert ttelemetry.check_main(["--stall-report", STALL_REPORT,
                                  "--stall-baseline", STALL_REPORT]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(_perturbed("bytes")))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = ttelemetry.check_main(["--stall-report", str(bad), "--stall-baseline",
                                      STALL_REPORT])
    assert code == 1 and "stall.bytes_accessed" in out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttelemetry.check_main(["--stall-report", str(bad), "--json"])
    assert json.loads(out.getvalue()) == jtelemetry.stall_report_gates(_perturbed("bytes"))


def test_summarize_perf_section_equals_jax(tmp_path):
    from mgproto_tpu_torch.telemetry.session import TelemetrySession

    d = str(tmp_path / "telem")
    session = TelemetrySession(d, primary=True, registry=MetricRegistry())
    session.monitor.observe_step(4, 0.01, check_recompiles=False)
    session.close()
    shutil.copy(STALL_REPORT, os.path.join(d, "stall_report.json"))
    got = ttelemetry.summarize(d)["perf"]
    assert got == jtelemetry._perf_section(d)
    assert got["stall_report"] == "stall_report.json" and got["top_byte_movers"]
    table = ttelemetry.render_table(ttelemetry.summarize(d))
    assert "byte_mover_1" in table and "stall attribution" in table


# ------------------------------------------------------- the wiring, the gauge
def _cli_train(tmp_path, monkeypatch, *flags):
    """cli.train's main on a 4-class tree of 12 images at batch 4 (3 steps
    an epoch); returns the run's train.log."""
    from _torch_jax_states import write_jpeg_tree
    from test_torch_cli import TINY_FLAGS

    from mgproto_tpu_torch.cli import train as ttrain

    monkeypatch.setattr(ttrain.preemption, "install_handlers", lambda: None)
    train = write_jpeg_tree(str(tmp_path / "train"), 4, 3, seed=0)
    run = tmp_path / "run"
    ttrain.main(TINY_FLAGS + [
        "--img_size", "32", "--train_dir", train, "--test_dir", train, "--push_dir", train,
        "--model_dir", str(run), "--mine_start", "0", "--gmm_start", "0", "--push_start", "5",
        "--batch_size", "4", *flags])
    return (run / "train.log").read_text()


def test_the_profiler_flags_run_through_cli_train(tmp_path, monkeypatch):
    """--profile_steps and --profile_out open a window over the run's steps
    (on the CPU the capture's counted cost), --profile_dir traces the
    first epoch, through cli.train. The window is held while that trace is
    open: the range's steps in epoch 0 are skipped with one logged note,
    and the capture opens at the range's first step in epoch 1."""
    out, pdir = str(tmp_path / "captures"), str(tmp_path / "epoch_trace")
    log = _cli_train(tmp_path, monkeypatch, "--epochs", "2", "--profile_steps", "1:5",
                     "--profile_out", out, "--profile_dir", pdir)
    (cap,) = os.listdir(out)
    assert cap == "trace_steps_step000004"
    costs = json.load(open(os.path.join(out, cap, tprofiler.COST_FILE)))
    assert costs["cost_source"] == "counted" and costs["flops"] > 0
    assert os.path.getsize(os.path.join(pdir, "epoch.trace.json")) > 0
    assert log.count("steps capture at step 2 skipped while the --profile_dir trace") == 1
    assert "skipped" not in log.split("epoch: \t1", 1)[1]


def test_profile_dir_holds_an_anomaly_window_on_the_card(tmp_path, monkeypatch):
    """--profile_dir with --profile_on_anomaly, with the profiler behaving
    as on the card (a device trace, one profiler a process): the first
    step is a cold path, so the recompile trigger falls due inside the
    first epoch's trace. The window is held and skips it; it does not try
    to nest a second profiler (ProfilerError), and the run trains on."""
    opened = []

    def start(device=None):
        if opened and opened[-1]:
            raise tprofiler.ProfilerError("another profiler is active in this process; "
                                          "profiler windows do not nest")
        opened.append(True)
        return object()

    def stop(prof, path, device=None):
        opened[-1] = False
        with open(path, "w") as f:
            json.dump({"traceEvents": []}, f)
        return {"device_events": 1, "trace_bytes": os.path.getsize(path), "export_s": 0.0}

    monkeypatch.setattr(tprofiler, "trace_supported", lambda device=None: True)
    monkeypatch.setattr(tprofiler, "start_profiler", start)
    monkeypatch.setattr(tprofiler, "stop_profiler", stop)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
    out, pdir = str(tmp_path / "captures"), str(tmp_path / "epoch_trace")
    log = _cli_train(tmp_path, monkeypatch, "--epochs", "1", "--profile_on_anomaly",
                     "--profile_out", out, "--profile_dir", pdir)
    assert opened == [False]  # the epoch's trace alone, opened and closed
    assert os.path.exists(os.path.join(pdir, "epoch.trace.json"))
    assert "recompile capture at step 1 skipped while the --profile_dir trace" in log
    assert "training done" in log and not os.path.exists(out)


def test_a_held_window_skips_what_falls_due_and_resumes():
    """`ProfilerWindow.held`: a due capture inside the block is skipped and
    recorded (flight recorder, `skipped`), one log line per hold; after it
    the window arms as usual."""
    lines = []
    window = tprofiler.ProfilerWindow("unused", steps=(1, 3), log=lines.append, device="cpu")
    with window.held("another trace is open"):
        for _ in range(2):
            window.on_step(0.1)
    assert not window.armed and not window.captures
    assert window.skipped == [{"reason": "steps", "step": 2, "held": "another trace is open"}]
    assert lines == ["profiler: steps capture at step 2 skipped while another trace is open "
                     "(captures due in it are skipped)"]
    window.out_dir = None  # arming now would write: only the decision is checked
    assert window._due(window.steps_observed, 0.1, 0.0) == "steps"


@pytest.mark.parametrize("async_bank", [False, True])
def test_bank_dispatch_overlap_gauge(async_bank):
    """The StepMonitor's gauge from the async step's dispatch clock: in
    (0, 1] on async steps, 0 in sync mode."""
    cfg = tiny_test_config()
    cfg = cfg.replace(em=dataclasses.replace(cfg.em, async_bank=async_bank))
    trainer = Trainer(cfg, steps_per_epoch=4, device="cpu")
    reg = MetricRegistry()
    mon = StepMonitor(registry=reg)
    trainer.train_epoch(trainer.init_state(0), _tiny_batches(cfg, 4), 0, monitor=mon)
    frac = reg.gauge("bank_dispatch_overlap_fraction").value(phase="train")
    if async_bank:
        assert 0.0 < frac <= 1.0
    else:
        assert frac == 0.0
    assert trainer.bank_overlap_step_s == 0.0 or async_bank
