"""Observability of the port: only the flight recorder so far (the rest of
the JAX package's obs/ is ROADMAP A item 7)."""
