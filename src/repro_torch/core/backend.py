"""Dispatch of the hot ops of the pipeline.

The tensor's device picks the implementation: on a CUDA tensor each op
launches its hand-written Hopper kernel (``repro_torch/kernels``), on a
CPU tensor it runs the kernel's plain PyTorch version.  There is no
fallback between the two.

Determinism contract:

* the integer ops (Lorenzo residual, SoS predicate and the verify round
  built on it, symbol histogram, Huffman decode) are exact and equal on
  every device;
* the SL stepper is one of the JAX package's three, named by the
  container header's ``sl_backend`` (``SL_BACKENDS``; core/predictors.py
  has their arithmetic): "numpy" (f64, every operation rounded once, in
  the op order of its numpy stepper; what this package writes unless
  told otherwise), "xla" (f64 with XLA:CPU's fused multiply-adds; what
  the JAX package writes off the TPU) and "pallas" (f32, the Pallas
  kernel's body under interpret mode; what it writes on a TPU, and its
  f64 "xla" path where the plane's rows are not a multiple of the
  kernel's 8-row tile).  Kernel and plain version of each are bitwise
  equal to the JAX package's stepper as it runs on the CPU, so a
  container decodes to the same integers in both packages whichever
  wrote it.  The decode (K3) and batched (K4) kernels share one device
  function, so decoding a field in one launch and predicting the
  encoder's T-1 frames in one batched call change no integer.

A container written by a real TPU used the TPU's compiled arithmetic
for "pallas", which no machine without a TPU reproduces (the JAX
package's own consistency there is structural: one executable encodes
and decodes); what the port holds is the JAX package as it runs on the
CPU, where the tests run.

The ``*_units`` ops take a stack of same-signature tile units (the
tiled pipeline, core/tiling.py) and launch one kernel for the whole
stack; each unit's result equals the single-field op on that unit.
``connected_labels`` (the track index's stitching) is exact torch ops:
the JAX package has no kernel for it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import predictors
from .. import perfflags
from ..kernels.cptest import ops as _cp_ops
from ..kernels.entropy import ops as _ent_ops
from ..kernels.lorenzo import ops as _lz_ops
from ..kernels.semilagrange import ops as _sl_ops

# the SL steppers (header tags) this package writes and decodes
SL_BACKENDS = predictors.SL_VARIANTS
# the tag a compress writes when neither CompressionConfig.backend nor
# REPRO_BACKEND names one
SL_BACKEND = "numpy"
# the Pallas kernel's row tile: the JAX package's "pallas" stepper runs
# its f64 "xla" path on planes whose rows are not a multiple of it
# (src/repro/core/backend.py::sl_stepper)
PALLAS_TILE_H = 8


def resolve(name=None) -> str:
    """A compress's SL stepper and header tag: ``name``
    (``CompressionConfig.backend``), else ``REPRO_BACKEND``, else
    ``SL_BACKEND``.  Raises ValueError for a name not in
    ``SL_BACKENDS``."""
    name = name or perfflags.backend_override() or SL_BACKEND
    if name not in SL_BACKENDS:
        raise ValueError(f"unknown backend {name!r}; expected one of "
                         f"{SL_BACKENDS} (the SL stepper and its header "
                         "tag) or None")
    return name


def sl_variant(tag: str, H: int) -> str:
    """The stepper that replays header tag ``tag`` on planes of H rows
    (module doc): the tag itself, but "xla" for "pallas" where H is not
    a multiple of ``PALLAS_TILE_H``."""
    if tag not in SL_BACKENDS:
        raise ValueError(f"unknown SL stepper {tag!r}; expected one of "
                         f"{SL_BACKENDS}")
    return "xla" if tag == "pallas" and H % PALLAS_TILE_H else tag


def lorenzo_residual(ufp, vfp, k, lossless, xi_unit: int, block: int,
                     want_x: bool = False):
    """Fused dual-quantize + 3D-Lorenzo residual of both components (one
    K1 launch on CUDA).

    ufp, vfp (T, H, W) int64; k int32 (-1 lossless); lossless bool.
    Returns int64 (res_u, res_v), and with ``want_x`` also the quantized
    fields (xu, xv) that ``quantize.dual_quantize`` gives."""
    return _lz_ops.lorenzo_residual(ufp.contiguous(), vfp.contiguous(),
                                    k.to(torch.int32).contiguous(),
                                    lossless.contiguous(), xi_unit, block,
                                    want_x)


def sl_decode(res_u, res_v, blockmap, block: int, g2f: float, cfl_x: float,
              cfl_y: float, d_max: float, n_max: int, tag: str = SL_BACKEND):
    """Parallel-in-time decode of the verify simulation and of
    decompress: (T, H, W) int64 residuals and the HOST bool blockmap
    (T, nbi, nbj) -> the base-grid integers (xu, xv), the SL blocks
    stepped with the stepper of header tag ``tag``.  A field with no SL
    block past frame 0 is one prefix sum over time; any other goes to one
    ``sl_decode`` call (one kernel launch on CUDA), with the blockmap and
    the per-frame flags copied to the device once."""
    bm = np.asarray(blockmap)
    T = res_u.shape[0]
    c2u = predictors.c2_block(res_u, block)
    c2v = predictors.c2_block(res_v, block)
    flags = bm.reshape(T, -1).any(axis=1)
    flags[0] = False                           # frame 0 is spatial-only
    if not flags.any():
        return torch.cumsum(c2u, dim=0), torch.cumsum(c2v, dim=0)
    dev = res_u.device
    return _sl_ops.sl_decode(
        c2u.contiguous(), c2v.contiguous(), res_u.contiguous(),
        res_v.contiguous(),
        torch.as_tensor(bm.astype(np.uint8), device=dev).contiguous(),
        torch.as_tensor(flags.astype(np.uint8), device=dev), block, g2f,
        cfl_x, cfl_y, d_max, n_max, sl_variant(tag, res_u.shape[-2]))


def sl_predictions(xu, xv, g2f: float, cfl_x: float, cfl_y: float,
                   d_max: float, n_max: int, tag: str = SL_BACKEND):
    """Encoder-side predictions of frames 1..T-1 from frames 0..T-2 of the
    known (T, H, W) fields, in one batched call of the stepper of header
    tag ``tag``.  Returns (T-1, H, W) int64 stacks."""
    return _sl_ops.sl_step_batched(xu[:-1].contiguous(),
                                   xv[:-1].contiguous(), g2f, cfl_x, cfl_y,
                                   d_max, n_max,
                                   sl_variant(tag, xu.shape[-2]))


def verify_faces(ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab, slice0,
                 slab0, forced):
    """Face re-verification of one verify round (one K2 launch on CUDA):
    ``delta is None`` selects the faces the sign-stability screen cannot
    clear (first round), else the faces with a vertex in ``delta`` (the
    newly forced vertices).  A selected face whose SoS predicate on the
    (T, H, W) reconstructions (ur_fp, vr_fp) differs from its original
    predicate (slice0 (T, Fs), slab0 (T-1, Fb)) gets its three vertices
    set in ``forced`` (updated in place, so it must be contiguous).
    Returns the bad-face count as a 0-d int64 tensor on the device."""
    def c(t):
        return None if t is None else t.contiguous()
    return _cp_ops.verify_faces(c(ur_fp), c(vr_fp), c(ufp), c(vfp), c(delta),
                                c(slice_tab), c(slab_tab), c(slice0),
                                c(slab0), forced)


def symbol_histogram(sym):
    """Per-row 256-bin histogram of a (B, n) uint8 symbol stack.  Returns
    (B, 256) int32 exact counts."""
    return _ent_ops.symbol_histogram(sym.contiguous())


def huffman_decode(ln, codes, data: bytes, n: int, device):
    """Canonical Huffman decode of one section's bytes on ``device`` (K6
    on CUDA), with the checked length table ``ln`` and its canonical
    ``codes``.  Returns (n uint8 symbols on ``device``, the symbols
    before the stream's end, the bits past the end where the chain
    stopped or None where it got stuck)."""
    return _ent_ops.huffman_decode_section(ln, codes, data, n, device)


# ----------------------------------------------------------------------
# unit-batched ops (tile units stacked on a leading axis)
# ----------------------------------------------------------------------

def lorenzo_residual_units(ufp, vfp, k, lossless, xi_unit: int, block: int,
                           owned):
    """K1 over B same-signature units (one launch on CUDA): ufp, vfp
    (B, Te, He, We) int64 extensions, k int32, lossless bool; owned =
    (ot, oi, oj, To, Ho, Wo).  Returns (res_u, res_v) (B, To, Ho, Wo)
    over the owned boxes and (xu, xv) (B, Te, He, We) over the
    extensions."""
    return _lz_ops.lorenzo_residual_units(
        ufp.contiguous(), vfp.contiguous(), k.to(torch.int32).contiguous(),
        lossless.contiguous(), xi_unit, block, owned)


def sl_predictions_units(xu, xv, g2f: float, cfl_x: float, cfl_y: float,
                         d_max: float, n_max: int, tag: str = SL_BACKEND):
    """Encoder-side predictions of frames 1..T-1 of B (B, T, H, W) units,
    all B (T-1) frames in one stepper call (K4).  Returns (B, T-1, H, W)
    int64 stacks."""
    B, T, H, W = xu.shape
    pu, pv = _sl_ops.sl_step_batched(
        xu[:, :-1].reshape(B * (T - 1), H, W).contiguous(),
        xv[:, :-1].reshape(B * (T - 1), H, W).contiguous(), g2f, cfl_x,
        cfl_y, d_max, n_max, sl_variant(tag, H))
    return pu.reshape(B, T - 1, H, W), pv.reshape(B, T - 1, H, W)


def sl_decode_units(res_u, res_v, blockmaps, block: int, g2f: float,
                    cfl_x: float, cfl_y: float, d_max: float, n_max: int,
                    tag: str = SL_BACKEND):
    """``sl_decode`` of B (B, T, H, W) units with their HOST blockmaps
    (B, T, nbi, nbj): one prefix sum over time when no unit has an SL
    block past its frame 0, else one ``sl_decode_units`` call (one
    cooperative launch on CUDA) with per-unit frame flags."""
    bm = np.asarray(blockmaps)
    B, T, H, W = res_u.shape
    c2u = predictors.c2_block(res_u, block)
    c2v = predictors.c2_block(res_v, block)
    flags = bm.reshape(B, T, -1).any(axis=2)
    flags[:, 0] = False                        # frame 0 is spatial-only
    if not flags.any():
        return torch.cumsum(c2u, dim=1), torch.cumsum(c2v, dim=1)
    dev = res_u.device
    return _sl_ops.sl_decode_units(
        c2u.contiguous(), c2v.contiguous(), res_u.contiguous(),
        res_v.contiguous(),
        torch.as_tensor(bm.astype(np.uint8), device=dev).contiguous(),
        torch.as_tensor(flags.astype(np.uint8), device=dev).contiguous(),
        block, g2f, cfl_x, cfl_y, d_max, n_max, sl_variant(tag, H))


def verify_faces_units(ur_fp, vr_fp, ufp, vfp, delta, slice_tab, slab_tab,
                       slice0, slab0, forced):
    """``verify_faces`` of B same-shape units (one K2 launch on CUDA):
    (B, T, H, W) fields, delta and forced (updated in place), (B, T, Fs)
    / (B, T-1, Fb) original predicates.  Returns the bad faces of all
    units as a 0-d int64 tensor on the device."""
    def c(t):
        return None if t is None else t.contiguous()
    return _cp_ops.verify_faces_units(c(ur_fp), c(vr_fp), c(ufp), c(vfp),
                                      c(delta), c(slice_tab), c(slab_tab),
                                      c(slice0), c(slab0), forced)


def face_crossed(u_flat, v_flat, verts):
    """SoS predicate of the faces ``verts`` (N, 3) int64 ids into the
    flat int64 values (one K2 ``face_crossed`` launch on CUDA).  Returns
    (N,) bool."""
    return _cp_ops.face_crossed(u_flat.contiguous(), v_flat.contiguous(),
                                verts.contiguous())


# ----------------------------------------------------------------------
# connected-component labeling (track stitching)
# ----------------------------------------------------------------------

_CCL_MAX_ROUNDS = 64


def connected_labels(n: int, edges):
    """Connected components of an undirected graph on nodes [0, n):
    edges (E, 2) int64 tensor.  Returns int64 labels on the edges'
    device with label[i] = the minimum node id of i's component, by
    iterated min-hooking (a scatter-min of each edge's smaller parent
    into its larger) and pointer jumping to a fixpoint -- exact, so equal
    to the JAX package's labels for any edge order."""
    dev = edges.device
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    parent = torch.arange(n, dtype=torch.int64, device=dev)
    if edges.numel() == 0:
        return parent
    ea = edges[:, 0].to(torch.int64)
    eb = edges[:, 1].to(torch.int64)
    for _ in range(_CCL_MAX_ROUNDS):
        pa, pb = parent[ea], parent[eb]
        nxt = parent.scatter_reduce(0, torch.maximum(pa, pb),
                                    torch.minimum(pa, pb), reduce="amin")
        while True:
            jumped = nxt[nxt]
            if torch.equal(jumped, nxt):
                break
            nxt = jumped
        if torch.equal(nxt, parent):
            return parent
        parent = nxt
    raise RuntimeError("connected_labels did not converge "
                       f"in {_CCL_MAX_ROUNDS} rounds")
