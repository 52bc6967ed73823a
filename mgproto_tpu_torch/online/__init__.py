"""The online plane: continual learning from served traffic (counterpart
of mgproto_tpu/online/).

  capture.py     — trusted capture: the serving engine's post-`record()` tap
                   stages high-p(x) predictions into bounded per-class
                   reservoirs (one module-global None-check when off).
  consolidate.py — the candidate state (its own GMM, bank and mean-optimizer
                   moments): staged samples through the eval trunk, the
                   head's enqueue, `memory_push` and compact dirty-class EM,
                   at one batch width; on the card through the score_pool,
                   epilogue and E-step kernels.
  classes.py     — padded class slots (`ModelConfig.class_bucket`): a new
                   class claims a slot without a new input shape.
  drift.py       — the p(x) quantile-sketch divergence and the per-class bank
                   mean and variance shift against the calibration.
  republish.py   — recalibrate the candidate and promote it through the
                   blue/green swap, fail-closed.
  drill.py       — the seeded virtual-clock drift drill.
  metrics.py     — the online_* / drift_* registration.

This package __init__ imports nothing, so the engine's tap (`from
mgproto_tpu_torch.online import capture`) stays light.
"""
