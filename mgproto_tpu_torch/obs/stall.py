"""Stall-budget attribution: where does the step time go (counterpart of
mgproto_tpu/obs/stall.py).

One report schema from either evidence source:

  * a CAPTURED DEVICE TRACE (Chrome trace-event JSON: the kineto trace a
    `ProfilerWindow` writes, or an XLA-style trace): device-op durations
    are classified by name into MXU / HBM / collective / host+infeed
    buckets, and the gaps of the device lane are the bubble.
  * the COUNTED COST of the production step (`step_costs`): one real step
    run under obs/opcount.py's dispatch counter, FLOPs and bytes apportioned
    by a roofline model over a measured or modeled step time.

Both give the step time split into five buckets whose fractions sum to 1:

    mxu_busy        the matrix and FLOP-bound work (cuDNN/cuBLAS convs and
                    GEMMs, the score_pool forward)
    hbm_bound       bandwidth-bound device work (elementwise, reductions,
                    device copies, the bytes-bound kernels)
    collective_wait collective time (NCCL kernels; XLA's all-reduce & co.)
    host_infeed     host-to-device copies plus a measured host wait
    bubble          the device lane's idle gaps

plus measured MFU against a peak and an attainable ceiling.

THE DEVICE LANE. JAX's rule takes the busiest pid/tid lane as the device.
A kineto trace breaks it: its CPU lanes hold nested `aten::` events whose
durations add up past the wall time, so the busiest lane is a CPU thread.
When a trace holds CUDA device events (kineto's `kernel`, `gpu_memcpy` and
`gpu_memset` categories), those are attributed instead: the device (pid)
with the most device time, all its streams merged into one lane (the
async bank runs on a second stream, `Trainer._bank_stream`). Where streams
overlap, the time is counted once: every instant covered by n device
events is shared equally among their n buckets, so the buckets' busy time
is the union of the events, `span = busy + bubble`, and
`step_time_s = span + host wait`. A trace with no such category (XLA-style
events, as the JAX package's tests write) keeps JAX's busiest-lane rule,
so the same inputs give JAX's numbers.

OP NAMES. JAX's token tables are kept, so XLA names classify as in JAX;
CUDA names are checked before them. `Memcpy HtoD/DtoH` is host traffic
(neither "copy" nor "transfer" is in "memcpy", so JAX's tables would file
it under HBM), `Memcpy DtoD` and `Memset` are HBM, NCCL kernels are
collectives, cuDNN/CUTLASS/xmma/GEMM/winograd/wgrad/dgrad kernels MXU.
The port's four kernels go by their bound (PERF.md §6): the score_pool
forward is operations-bound (mxu_busy); the epilogue, the score_pool
backward and the E-step are bytes-bound (hbm_bound). JAX files every
custom-call (its Pallas kernels) as MXU work.

PEAKS. The defaults are an NVIDIA H100 80GB HBM3's data-sheet figures
(SXM, dense, at its 700 W limit): 67 TFLOP/s in float32 outside the
tensor cores (the port keeps TF32 off, numerics.py), 989 TFLOP/s in
bf16, and 3.35 TB/s of HBM (`default_peak_flops` picks by compute dtype).
No TPU figure and no TPU evidence file is read: the attainable MFU is the
roofline's 1.0 unless a caller passes one (trace_report's --attainable).

Driven by `python -m mgproto_tpu_torch.cli.trace_report`; `step_costs` is
also the CPU cost provider of `ProfilerWindow`. The trace side imports no
torch.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

# NVIDIA H100 80GB HBM3 data sheet (SXM, dense, 700 W)
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
DEFAULT_PEAK_FLOPS = H100_F32_FLOPS
DEFAULT_HBM_BYTES_PER_S = H100_HBM_BYTES_PER_S
DEFAULT_ATTAINABLE_MFU = 1.0  # the roofline: no measured ceiling yet

BUCKETS = (
    "mxu_busy", "hbm_bound", "collective_wait", "host_infeed", "bubble"
)
# kineto's device-event categories: kernels, copies and fills on a stream
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def default_peak_flops(compute_dtype: str) -> float:
    """The H100's dense peak for a trunk in `compute_dtype`."""
    return H100_BF16_FLOPS if compute_dtype == "bfloat16" else H100_F32_FLOPS


# ---------------------------------------------------------------- trace side
# CUDA names, checked first: (tokens, bucket). The backward's name holds
# the forward's, so it comes first.
_CUDA_RULES = (
    (("memcpy htod", "memcpy dtoh", "memcpy htoh"), "host_infeed"),
    (("memcpy dtod", "memcpy ptop", "memset"), "hbm_bound"),
    (("nccl",), "collective_wait"),
    (("score_pool_bwd",), "hbm_bound"),
    (("score_pool",), "mxu_busy"),
    (("bn_epilogue", "em_estep"), "hbm_bound"),
    (("cudnn", "cutlass", "xmma", "gemm", "winograd", "wgrad", "dgrad"), "mxu_busy"),
)
# JAX's tables (mgproto_tpu/obs/stall.py), in its order: host before
# collectives before MXU before HBM
_HOST_TOKENS = (
    "infeed", "outfeed", "host", "transfer", "copy-start", "copy-done",
    "send", "recv",
)
_COLLECTIVE_TOKENS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective", "psum", "ppermute",
)
_MXU_TOKENS = (
    "convolution", "conv", "dot", "matmul", "gemm", "mxu", "einsum",
    "cublas", "custom-call",  # the JAX package's Pallas kernels
)
_HBM_TOKENS = (
    "copy", "scatter", "gather", "reduce", "broadcast", "transpose",
    "select", "concatenate", "slice", "pad", "iota", "sort", "fusion",
    "bitcast", "compare",
    "loop", "while", "dynamic-update",
)


def classify_op(name: str) -> str:
    """Bucket for one device-op (trace event) name."""
    n = name.lower()
    for tokens, bucket in _CUDA_RULES:
        if any(tok in n for tok in tokens):
            return bucket
    for tokens, bucket in ((_HOST_TOKENS, "host_infeed"),
                           (_COLLECTIVE_TOKENS, "collective_wait"),
                           (_MXU_TOKENS, "mxu_busy"), (_HBM_TOKENS, "hbm_bound")):
        if any(tok in n for tok in tokens):
            return bucket
    return "hbm_bound"  # unknown elementwise tails are bandwidth-bound


def load_chrome_trace(path: str) -> List[Dict[str, Any]]:
    """traceEvents from a Chrome trace file (.json / .json.gz) or from the
    newest *.trace.json(.gz) under a profiler output directory."""
    if os.path.isdir(path):
        candidates = sorted(
            glob.glob(os.path.join(path, "**", "*.trace.json*"), recursive=True),
            key=os.path.getmtime,
        )
        if not candidates:
            raise FileNotFoundError(
                f"no *.trace.json(.gz) under {path}: is this a profiler output directory?"
            )
        path = candidates[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", data) if isinstance(data, dict) else data
    if not isinstance(events, list):
        raise ValueError(f"{path} is not a Chrome trace")
    return events


def _complete(events: Iterable[Dict[str, Any]]):
    for e in events:
        if e.get("ph", "X") == "X" and float(e.get("dur", 0.0)) > 0:
            yield e


def device_events(events: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The complete CUDA device events (DEVICE_CATEGORIES) of a trace."""
    return [e for e in _complete(events) if e.get("cat") in DEVICE_CATEGORIES]


def _device_lane(events: List[Dict[str, Any]]) -> Tuple[List[Dict[str, Any]], Dict[str, Any]]:
    """The events of the lane to attribute and its description: the
    busiest device's streams merged when the trace has CUDA device events,
    else JAX's busiest pid/tid lane."""
    dev = device_events(events)
    if dev:
        busy: Dict[Any, float] = {}
        for e in dev:
            busy[e.get("pid")] = busy.get(e.get("pid"), 0.0) + float(e["dur"])
        pid = max(busy, key=busy.get)
        evs = [e for e in dev if e.get("pid") == pid]
        streams = sorted({e.get("tid") for e in evs},
                         key=lambda t: (not isinstance(t, int), t if isinstance(t, int) else str(t)))
        return evs, {"rule": "cuda_device_streams_merged", "pid": pid, "streams": streams,
                     "events": len(evs)}
    lanes: Dict[Tuple[Any, Any], float] = {}
    per_lane: Dict[Tuple[Any, Any], List] = {}
    for e in _complete(events):
        key = (e.get("pid"), e.get("tid"))
        lanes[key] = lanes.get(key, 0.0) + float(e["dur"]) / 1e6
        per_lane.setdefault(key, []).append(e)
    if not lanes:
        raise ValueError("trace has no complete events to attribute")
    key = max(lanes, key=lambda k: lanes[k])
    return per_lane[key], {"rule": "busiest_lane", "pid": key[0], "tid": key[1],
                           "events": len(per_lane[key])}


def _shared_busy(evs: List[Dict[str, Any]]) -> Tuple[Dict[str, float], float, float]:
    """(seconds by bucket, union busy seconds, span seconds) of a merged
    lane: each instant covered by n events is shared equally among their
    buckets (module docstring)."""
    edges = []
    for i, e in enumerate(evs):
        ts = float(e.get("ts", 0.0)) / 1e6
        edges.append((ts, 1, i))
        edges.append((ts + float(e["dur"]) / 1e6, 0, i))
    edges.sort()  # at one instant, ends (0) before starts (1)
    buckets = {b: 0.0 for b in BUCKETS}
    names = [classify_op(str(e.get("name", "?"))) for e in evs]
    active: Dict[int, str] = {}
    busy, prev = 0.0, edges[0][0]
    for t, kind, i in edges:
        if active and t > prev:
            share = (t - prev) / len(active)
            for bucket in active.values():
                buckets[bucket] += share
            busy += t - prev
        prev = t
        if kind:
            active[i] = names[i]
        else:
            active.pop(i, None)
    return buckets, busy, edges[-1][0] - edges[0][0]


def attribute_trace(
    events: Iterable[Dict[str, Any]],
    host_infeed_s: float = 0.0,
) -> Dict[str, Any]:
    """Bucket seconds from complete ('X') trace events: the device lane's
    busy time classified by op name, the unoccupied rest of its span the
    bubble (module docstring for which lane and the overlap rule).
    `host_infeed_s` adds externally measured host wait (e.g. telemetry's
    loader_wait_fraction x step time) on top of host-named ops."""
    events = list(events)
    evs, lane = _device_lane(events)
    if lane["rule"] == "busiest_lane":
        buckets = {b: 0.0 for b in BUCKETS}
        t_min, t_max = float("inf"), float("-inf")
        for e in evs:
            ts = float(e.get("ts", 0.0)) / 1e6
            dur = float(e.get("dur", 0.0)) / 1e6
            buckets[classify_op(str(e.get("name", "?")))] += dur
            t_min = min(t_min, ts)
            t_max = max(t_max, ts + dur)
        span = max(t_max - t_min, 0.0)
        busy = sum(buckets.values())
        overlap = 0.0
    else:
        buckets, busy, span = _shared_busy(evs)
        overlap = sum(float(e["dur"]) for e in evs) / 1e6 - busy
    buckets["bubble"] = max(span - busy, 0.0)
    buckets["host_infeed"] += max(float(host_infeed_s), 0.0)
    total = sum(buckets.values())
    out = {
        "source": "trace",
        "device_lane": lane,
        "span_s": span,
        "device_busy_s": busy,
        "step_time_s": total,
        "buckets": _fractions(buckets, total),
    }
    if lane["rule"] != "busiest_lane":
        out["stream_overlap_s"] = overlap
    return out


def top_byte_movers_from_trace(
    events: Iterable[Dict[str, Any]], top_n: int = 12
) -> Dict[str, Any]:
    """The ranked byte-movers table from a captured device trace: the
    device lane's events (as `attribute_trace` picks it) grouped by name,
    ranked by `bytes_accessed` from the event args when the profiler
    recorded it, by duration otherwise (bytes then stay null rather than
    invented)."""
    events = list(events)
    try:
        evs, _ = _device_lane(events)
    except ValueError:
        return {"source": "trace", "total_bytes": None, "rows": []}
    busy = sum(float(e["dur"]) / 1e6 for e in evs)  # JAX's sum, in its order
    groups: Dict[str, Dict[str, Any]] = {}
    for e in evs:
        name = str(e.get("name", "?"))
        args = e.get("args") or {}
        b = args.get("bytes_accessed", args.get("bytes accessed"))
        g = groups.setdefault(name, {"count": 0, "seconds": 0.0, "bytes": None})
        g["count"] += 1
        g["seconds"] += float(e.get("dur", 0.0)) / 1e6
        if b is not None:
            g["bytes"] = (g["bytes"] or 0.0) + float(b)
    known = [g["bytes"] for g in groups.values() if g["bytes"] is not None]
    total_bytes = sum(known) if known else None
    rows = []
    for name, g in sorted(
        groups.items(),
        key=lambda kv: (kv[1]["bytes"] if kv[1]["bytes"] is not None else -1.0,
                        kv[1]["seconds"]),
        reverse=True,
    )[: max(top_n, 0)]:
        rows.append({
            "name": name,
            "bucket": classify_op(name),
            "count": int(g["count"]),
            "bytes_accessed": g["bytes"],
            "bytes_fraction": (
                g["bytes"] / total_bytes if g["bytes"] is not None and total_bytes else None
            ),
            "seconds": g["seconds"],
            "time_fraction": g["seconds"] / busy if busy > 0 else 0.0,
        })
    return {"source": "trace", "total_bytes": total_bytes, "rows": rows}


# ----------------------------------------------------------- counted-cost side
def card_program(cfg):
    """`cfg` with the routes it would resolve to on the card: the kernels
    (`fused_*` None -> True; the epilogue for a resnet trunk only) and the
    device augmentation tail. The cost counter runs this program on either
    device, so the CPU and the card count the same ops (a route forced off
    stays off)."""
    from mgproto_tpu_torch.models.registry import family

    def on(v, available=True):
        return available if v is None else v

    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, fused_scoring=on(cfg.model.fused_scoring),
            fused_epilogue=on(cfg.model.fused_epilogue, family(cfg.model.arch) == "resnet")),
        em=dataclasses.replace(cfg.em, fused_estep=on(cfg.em.fused_estep)),
        data=dataclasses.replace(cfg.data, device_augment=on(cfg.data.device_augment)),
    )


def _seeded_step_inputs(cfg, trainer, batch: int, seed: int):
    """A full seeded memory bank (every queue full, marked updated, so EM
    runs) and one seeded host batch in the trainer's wire format."""
    import numpy as np
    import torch

    from mgproto_tpu_torch.core.memory import Memory

    m = cfg.model
    gen = torch.Generator().manual_seed(seed)
    c, cap, d = m.num_classes, m.mem_capacity, m.proto_dim
    memory = Memory(
        feats=torch.nn.functional.normalize(torch.randn(c, cap, d, generator=gen), dim=-1)
        .to(trainer.device),
        length=torch.full((c,), cap, dtype=torch.int32, device=trainer.device),
        cursor=torch.zeros(c, dtype=torch.int32, device=trainer.device),
        updated=torch.ones(c, dtype=torch.bool, device=trainer.device),
    )
    rng = np.random.default_rng(seed)
    shape = (batch, m.img_size, m.img_size, 3)
    if trainer.device_augment:
        images = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
        images = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, m.num_classes, size=batch).astype(np.int64)
    seeds = rng.integers(0, 2 ** 32, size=batch, dtype=np.uint32)
    return memory, (images, labels, None, seeds)


def _report(counter, phases: List[str], top_n: int) -> Dict[str, Any]:
    programs = {ph: counter.totals(ph) for ph in phases}
    merged = counter.merged_rows()
    totals = counter.totals()
    return {
        "programs": programs,
        "flops": totals["flops"],
        "raw_bytes": totals["raw_bytes"],
        "fused_bytes": totals["fused_bytes"],
        "kernels": counter.kernel_rows(),
        "rows": {name: merged[name] for name in sorted(merged)},
        "top_byte_movers": {
            "source": "counted",
            "total_bytes": totals["raw_bytes"],
            "rows": _mover_rows(merged, totals["raw_bytes"], top_n),
        },
    }


def step_costs(cfg, batch: Optional[int] = None, device=None, seed: int = 0,
               top_n: int = 12) -> Dict[str, Any]:
    """FLOPs and bytes of one real step of the production program for
    `cfg` at `batch` (default: the config's), counted by obs/opcount.py
    (module docstring there): the card's routes (`card_program`), a
    seeded state with a full bank and a seeded batch placed first (the
    host-to-device copy is not the step's), one step with mining and EM.
    Async-bank configs report the trunk (the pipeline's fill step) and the
    bank (its flush) apart, as JAX's {"trunk", "bank"}; sync configs
    {"step"}. The kernels' rows (`kernels`) and the totals are the same on
    the CPU and the card; `peak_bytes` is the card's allocator peak over
    the step (None on the CPU). `device`: CUDA unless the caller names
    another."""
    import torch

    from mgproto_tpu_torch.engine.train import Trainer
    from mgproto_tpu_torch.obs.opcount import OpCounter

    cfg = card_program(cfg)
    b = int(batch) if batch else int(cfg.data.train_batch_size)
    trainer = Trainer(cfg, steps_per_epoch=100, device=device)
    state = trainer.init_state(seed)
    state.memory, host = _seeded_step_inputs(cfg, trainer, b, seed)
    placed = trainer.put_batch(host)
    cuda = trainer.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(trainer.device)
        torch.cuda.reset_peak_memory_stats(trainer.device)
    flags = {"use_mine": True, "update_gmm": True, "warm": False}
    with OpCounter() as counter:
        if trainer.async_bank:
            counter.phase = "trunk"
            state, _ = trainer.train_step(state, placed, None, **flags)
            counter.phase = "bank"
            state, _ = trainer.flush_bank(state)
            phases = ["trunk", "bank"]
        else:
            trainer.train_step(state, placed, None, **flags)
            phases = ["step"]
    peak = None
    if cuda:
        torch.cuda.synchronize(trainer.device)
        peak = int(torch.cuda.max_memory_allocated(trainer.device))
    return {
        "cost_source": "counted",
        "batch": b,
        "device": trainer.device.type,
        "async_bank": trainer.async_bank,
        "compute_dtype": cfg.model.compute_dtype,
        "peak_bytes": peak,
        **_report(counter, phases, top_n),
    }


# counted rows that are matrix work whatever classify_op makes of "aten.mm"
_COUNTED_MXU = frozenset(f"aten.{n}" for n in (
    "convolution", "convolution_backward", "mm", "addmm", "bmm", "baddbmm", "addbmm",
    "matmul", "dot", "mv", "addmv"))


def _counted_bucket(name: str) -> str:
    """The bucket of a counted row: `kernel:<name>` by the kernel's name,
    conv and matmul ops MXU, the rest by `classify_op`."""
    if name in _COUNTED_MXU:
        return "mxu_busy"
    return classify_op(name.split(":", 1)[-1])


def _mover_rows(rows: Dict[str, Dict[str, Any]], total: float,
                top_n: int) -> List[Dict[str, Any]]:
    out = []
    for name, row in sorted(rows.items(), key=lambda kv: kv[1]["bytes"],
                            reverse=True)[: max(top_n, 0)]:
        out.append({
            "name": name,
            "bucket": _counted_bucket(name),
            "count": int(row["count"]),
            "bytes_accessed": float(row["bytes"]),
            "bytes_fraction": float(row["bytes"]) / total if total > 0 else 0.0,
            "seconds": None,
            "time_fraction": None,
        })
    return out


def roofline_buckets(
    flops: float,
    bytes_accessed: float,
    step_time_s: Optional[float] = None,
    host_infeed_s: float = 0.0,
    collective_wait_s: float = 0.0,
    peak_flops: float = DEFAULT_PEAK_FLOPS,
    hbm_bytes_per_s: float = DEFAULT_HBM_BYTES_PER_S,
) -> Dict[str, Any]:
    """Apportion a step via the roofline: compute time is flops/peak, the
    HBM bucket the bandwidth time compute cannot hide, host and collective
    time whatever the caller measured (one card passes none, and the line
    item reports zero, keeping the schema of a fleet).

    A MEASURED `step_time_s` is ground truth: the buckets partition it
    exactly; the HBM bucket is clamped into the residual after compute,
    host and collective time (`hbm_model_clamped` says when the byte count
    wanted more), and what the model cannot claim is the bubble. Without a
    measurement the modeled sum stands in (bubble 0) and the report says
    so. Fractions always sum to 1 of the reported step time."""
    mxu_s = flops / peak_flops if peak_flops > 0 else 0.0
    hbm_total_s = bytes_accessed / hbm_bytes_per_s if hbm_bytes_per_s else 0.0
    hbm_raw_s = max(hbm_total_s - mxu_s, 0.0)
    host_s = max(float(host_infeed_s), 0.0)
    coll_s = max(float(collective_wait_s), 0.0)
    measured = step_time_s is not None
    floor = mxu_s + host_s + coll_s
    if measured:
        # a step cannot be shorter than its compute + host + collective
        # floor; a measurement below it means the peaks are mis-set, and
        # the floor wins so the partition stays consistent
        total = max(float(step_time_s), floor)
        hbm_s = min(hbm_raw_s, max(total - floor, 0.0))
    else:
        total = floor + hbm_raw_s
        hbm_s = hbm_raw_s
    buckets = {
        "mxu_busy": mxu_s,
        "hbm_bound": hbm_s,
        "collective_wait": coll_s,
        "host_infeed": host_s,
        "bubble": max(total - mxu_s - hbm_s - host_s - coll_s, 0.0),
    }
    return {
        "source": "cost_analysis",
        "step_time_s": total,
        "step_time_measured": measured,
        "modeled_step_time_s": floor + hbm_raw_s,
        "hbm_total_s": hbm_total_s,
        "hbm_model_clamped": measured and hbm_raw_s > hbm_s,
        "buckets": _fractions(buckets, total),
    }


# ------------------------------------------------------------------- report
def _fractions(buckets: Dict[str, float], total: float) -> Dict[str, Any]:
    return {
        name: {
            "seconds": buckets[name],
            "fraction": buckets[name] / total if total > 0 else 0.0,
        }
        for name in BUCKETS
    }


def finish_report(
    attribution: Dict[str, Any],
    flops: Optional[float] = None,
    peak_flops: float = DEFAULT_PEAK_FLOPS,
    attainable_mfu: Optional[float] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Wrap a bucket attribution into the one stall-report schema: the
    fraction-sum self-check and measured vs attainable MFU (measured =
    flops / (step x peak); attainable defaults to the roofline's 1.0)."""
    report: Dict[str, Any] = {"stall_report": True, **attribution}
    report["fraction_sum"] = sum(b["fraction"] for b in attribution["buckets"].values())
    att = float(attainable_mfu) if attainable_mfu is not None else DEFAULT_ATTAINABLE_MFU
    report["attainable_mfu"] = att
    step = attribution.get("step_time_s") or 0.0
    if flops and step > 0 and peak_flops > 0:
        measured = flops / (step * peak_flops)
        report["flops"] = flops
        report["peak_flops"] = peak_flops
        report["measured_mfu"] = measured
        report["mfu_ratio_measured_over_attainable"] = measured / att if att > 0 else None
    if extra:
        report.update(extra)
    return report
