"""Single-device LM training (the port of ``repro.train``): AdamW, int8
gradient compression with error feedback, the micro-batched train step
and checkpoints in the JAX package's on-disk format."""
