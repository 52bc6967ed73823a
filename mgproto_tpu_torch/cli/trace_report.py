"""Stall-budget attribution report (counterpart of scripts/trace_report.py).

Apportions a train step's time into MXU-busy / HBM-bound / collective-wait
/ host+infeed / bubble buckets and reports measured MFU against a peak.
Two evidence sources, one output schema (mgproto_tpu_torch/obs/stall.py):

  * --trace PATH      a captured trace (a Chrome trace JSON / .json.gz
                      file, or a ProfilerWindow capture directory): device
                      events classified by name, the device lane's gaps the
                      bubble; a kineto trace's CUDA streams are merged into
                      one lane (obs/stall.py).
  * (default)         the COUNTED COST of one real step of the production
                      program (obs/stall.py `step_costs`) on the port's
                      flagship config (or `--tiny`), on --device (CUDA
                      unless named), attributed by the roofline model.
                      `--step-time-s` injects a measured step time so the
                      bubble is the real residual; without it the modeled
                      time stands in and the report says so.

Every report carries a ranked `top_byte_movers` table: per-kernel
durations (and bytes, where the trace has them) in trace mode, the counted
per-op bytes in cost mode.

    # the flagship step on the card, its counted cost beside a measured step:
    python -m mgproto_tpu_torch.cli.trace_report --step-time-s 0.25 --out stall_report.json

    # attribute a captured window:
    python -m mgproto_tpu_torch.cli.trace_report --trace evidence/trace_run/trace_steps_step000003

    # a smoke run on the CPU:
    python -m mgproto_tpu_torch.cli.trace_report --tiny --batch 4 --device cpu

One JSON line to stdout (and --out FILE).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

from mgproto_tpu_torch.obs import stall

# --byte-source: the port's counted totals in place of JAX's XLA sources
BYTE_SOURCES = {
    "counted_raw": "raw_bytes",  # JAX's cost_analysis (every op charged)
    "counted_fused": "fused_bytes",  # JAX's hlo_model (the ideal-fusion floor)
}


def cost_analysis_report(
    batch: int,
    step_time_s: Optional[float],
    host_infeed_s: float,
    peak_flops: Optional[float],
    hbm_bytes_per_s: float,
    attainable: Optional[float],
    tiny: bool = False,
    collective_wait_s: float = 0.0,
    dtype: str = "",
    byte_source: str = "counted_raw",
    top_n: int = 12,
    device=None,
) -> dict:
    """The counted-cost report: the flagship (or tiny) config's step
    counted once on `device`, roofline-attributed. `dtype` overrides the
    config's compute dtype; `byte_source` picks the roofline's byte input
    (BYTE_SOURCES); `peak_flops` None is the H100's peak for the dtype."""
    from mgproto_tpu_torch.config import Config, tiny_test_config

    cfg = tiny_test_config() if tiny else Config()
    if dtype:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    if peak_flops is None:
        peak_flops = stall.default_peak_flops(cfg.model.compute_dtype)
    costs = stall.step_costs(cfg, batch=batch, device=device, top_n=top_n)
    roofline_bytes = costs[BYTE_SOURCES[byte_source]]
    attribution = stall.roofline_buckets(
        costs["flops"], roofline_bytes, step_time_s=step_time_s,
        host_infeed_s=host_infeed_s, collective_wait_s=collective_wait_s,
        peak_flops=peak_flops, hbm_bytes_per_s=hbm_bytes_per_s,
    )
    return stall.finish_report(
        attribution, flops=costs["flops"], peak_flops=peak_flops, attainable_mfu=attainable,
        extra={
            "config": "tiny" if tiny else "flagship",
            "batch": costs["batch"],
            "backend": costs["device"],
            "async_bank": costs["async_bank"],
            "compute_dtype": cfg.model.compute_dtype,
            "byte_source": byte_source,
            "bytes_accessed": roofline_bytes,
            "counted_raw_bytes": costs["raw_bytes"],
            "counted_fused_bytes": costs["fused_bytes"],
            "programs": costs["programs"],
            "kernels": costs["kernels"],
            "peak_bytes": costs["peak_bytes"],
            "top_byte_movers": costs["top_byte_movers"],
            "hbm_bytes_per_s": hbm_bytes_per_s,
        },
    )


def trace_mode_report(
    trace_path: str,
    host_infeed_s: float,
    peak_flops: float,
    flops: Optional[float],
    attainable: Optional[float],
    top_n: int = 12,
) -> dict:
    events = stall.load_chrome_trace(trace_path)
    attribution = stall.attribute_trace(events, host_infeed_s=host_infeed_s)
    return stall.finish_report(
        attribution, flops=flops, peak_flops=peak_flops, attainable_mfu=attainable,
        extra={
            "trace": os.path.abspath(trace_path),
            "top_byte_movers": stall.top_byte_movers_from_trace(events, top_n=top_n),
        },
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mgproto_tpu_torch.cli.trace_report",
        description="Stall-budget attribution: step time -> MXU/HBM/collective/host/bubble "
                    "buckets + measured MFU")
    p.add_argument("--trace", default="",
                   help="Chrome trace file (.json/.json.gz) or profiler capture dir; omit for "
                        "the counted-cost report")
    p.add_argument("--batch", type=int, default=80,
                   help="cost mode: the batch to count the step at")
    p.add_argument("--tiny", action="store_true",
                   help="cost mode: the tiny test config instead of the flagship")
    p.add_argument("--device", default="cuda",
                   help="cost mode: the device the step is counted on (cpu runs the kernels' "
                        "plain versions; the counts are the same)")
    p.add_argument("--step-time-s", type=float, default=None,
                   help="MEASURED step seconds; enables the bubble residual")
    p.add_argument("--host-infeed-s", type=float, default=0.0,
                   help="measured host+input wait per step (e.g. loader_wait_fraction x step "
                        "time from telemetry)")
    p.add_argument("--collective-wait-s", type=float, default=0.0,
                   help="measured per-step collective wait; one card reports the line item "
                        "as zero")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="peak TFLOP/s (default: NVIDIA H100 80GB HBM3's data sheet, 67 in "
                        "float32 outside the tensor cores, 989 in bf16, by the compute dtype)")
    p.add_argument("--hbm-gbps", type=float, default=stall.H100_HBM_BYTES_PER_S / 1e9,
                   help="HBM GB/s (default: NVIDIA H100 80GB HBM3, 3350)")
    p.add_argument("--attainable", type=float, default=None,
                   help="attainable MFU ceiling (default: the roofline, 1.0)")
    p.add_argument("--dtype", default="", choices=("", "float32", "bfloat16"),
                   help="cost mode: override the config's compute dtype")
    p.add_argument("--byte-source", default="counted_raw", choices=tuple(BYTE_SOURCES),
                   help="cost mode: the roofline's byte input. counted_raw (every aten op's "
                        "operands and results; in place of the JAX script's cost_analysis) "
                        "or counted_fused (only the ops that survive ideal fusion; in place "
                        "of its hlo_model)")
    p.add_argument("--top-movers", type=int, default=12,
                   help="rows in the ranked top-byte-movers table")
    p.add_argument("--flops", type=float, default=None,
                   help="trace mode: the FLOPs of the traced steps for the MFU line (cost "
                        "mode counts them)")
    p.add_argument("--out", default="", help="also write the JSON line here")
    args = p.parse_args(argv)

    peak_flops = args.peak_tflops * 1e12 if args.peak_tflops is not None else None
    if args.trace:
        report = trace_mode_report(
            args.trace, args.host_infeed_s,
            peak_flops if peak_flops is not None else stall.DEFAULT_PEAK_FLOPS,
            args.flops, args.attainable, top_n=args.top_movers)
    else:
        report = cost_analysis_report(
            args.batch, args.step_time_s, args.host_infeed_s, peak_flops, args.hbm_gbps * 1e9,
            args.attainable, tiny=args.tiny, collective_wait_s=args.collective_wait_s,
            dtype=args.dtype, byte_source=args.byte_source, top_n=args.top_movers,
            device=args.device)
    line = json.dumps(report, sort_keys=True)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
