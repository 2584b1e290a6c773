"""Unit-axis mapping and host worker pools (the JAX package's
``repro.parallel.sharding`` for tile units)."""
