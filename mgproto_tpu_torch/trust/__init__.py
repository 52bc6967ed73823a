"""The trust verification plane (counterpart of mgproto_tpu/trust/).

The paper's trust claims, generative-p(x) OoD abstention and graceful
degradation under distribution shift, as re-derivable gates that run
against the production serving path:

  matrix.py  — the robustness matrix: ID x OoD dataset pairs and a seeded
               corruption ladder (ops/corrupt.py, on the engine's device)
               driven through a warmed, calibrated ServingEngine; one
               trust report with per-cell AUROC, per-severity
               risk-coverage and the calibration-drift reading, gated by
               `python -m mgproto_tpu_torch.cli.telemetry check --trust`.
  auroc.py   — the midrank AUROC, numpy only, so the check re-derives
               every per-pair verdict from the report's raw scores.
  metrics.py — the trust_* metric family.

The sharded interpretability evaluator (the JAX package's
trust/interp_sharded.py) needs multi-GPU and is not ported (ROADMAP A
item 5); `cli.trust interp` refuses it by name.
"""
