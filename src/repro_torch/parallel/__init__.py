"""Sharding rules, unit-axis mapping and host worker pools (the JAX
package's ``repro.parallel.sharding``)."""
