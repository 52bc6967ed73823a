"""Fault tolerance of the training run (counterpart of mgproto_tpu/resilience,
single process): `preemption` (the SIGTERM/SIGINT flag and the
PREEMPTED.json marker), `chaos` (the training drills' NaN batch and
simulated preemption) and `guard` (`EpochGuard`, `DivergenceError`)."""
