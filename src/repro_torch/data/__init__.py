"""Synthetic field generators and the synthetic LM token pipeline (numpy;
shared shapes and values with the JAX package)."""
