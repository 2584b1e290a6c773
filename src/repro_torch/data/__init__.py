"""Synthetic field generators (numpy; shared shapes with the JAX package)."""
