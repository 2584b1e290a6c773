"""PyTorch/CUDA port of the critical-point-trajectory-preserving compressor.

    blob, stats = repro_torch.compress(u, v, CompressionConfig(eb=...))
    u_rec, v_rec = repro_torch.decompress(blob)
    blob, stats = repro_torch.compress_tiled(u, v, cfg, TileGrid(...))
    blob, stats = repro_torch.compress_stream(frames, cfg, TileGrid(...),
                                              value_range=(lo, hi))
    u_reg, v_reg = repro_torch.decompress_region(blob, region)

The entry points run on the CUDA device unless the caller passes
``device="cpu"``.  On a CUDA tensor the three hot ops launch the
hand-written Hopper kernels under ``csrc/`` (built with nvcc at first
use); on a CPU tensor they run their plain PyTorch versions.  The
container format is the JAX package's: blobs cross between the two
packages in both directions.
"""
from .core.compressor import CompressionConfig, compress, decompress  # noqa: F401
from .core.ebpolicy import DegenerateRangeError  # noqa: F401
from .core.tiling import (  # noqa: F401
    TileGrid,
    compress_stream,
    compress_tiled,
    decompress_region,
    decompress_tiled,
    read_plan,
)
