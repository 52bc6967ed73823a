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
  interp_sharded.py — consistency, stability and purity with the device
               half sharded over the (data, model) rank mesh (each rank
               its rows, each class slab its prototypes), equal to the
               one-process metrics; `cli.trust interp` and
               `cli.interpret --distributed` run it.
  auroc.py   — the midrank AUROC, numpy only, so the check re-derives
               every per-pair verdict from the report's raw scores.
  metrics.py — the trust_* metric family.
"""
