"""Core library of the PyTorch port (monolithic fused main path)."""
