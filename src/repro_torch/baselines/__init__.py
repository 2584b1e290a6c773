"""Comparison compressors of the paper's Tables II-V (the JAX package's
``repro.baselines``): lossless gzip / zstd / fpzip-like (host only) and
lossy zfp-like (host numpy), sz3-like and cpsz-like (on ``device``, the
CUDA device unless ``device="cpu"``).  Each returns a dict with the
ratio, the compressed size, the seconds and the reconstruction."""
from .lossless import fpzip_like, gzip_compress, zstd_compress  # noqa: F401
from .lossy import cpsz_like, sz3_like, zfp_like  # noqa: F401

REGISTRY = {
    "gzip": gzip_compress,
    "zstd": zstd_compress,
    "fpzip-like": fpzip_like,
    "zfp-like": zfp_like,
    "sz3-like": sz3_like,
    "cpsz-like": cpsz_like,
}
