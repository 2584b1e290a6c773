"""Lossy baselines (paper Tables II-V comparison rows).

zfp-like   -- fixed-accuracy 4x4 orthonormal block transform (DCT-II)
              per frame, coefficient quantization, container codec
              (host numpy).  A stand-in for ZFP's decorrelating
              transform, labelled "-like" everywhere.
sz3-like   -- the dual-quantized block-local 3D-Lorenzo pipeline with a
              *uniform* error bound and NO critical-point constraints:
              what a generic SZ-style compressor does.  K1 encodes, the
              all-Lorenzo decode is ``backend.sl_decode``'s prefix sum.
cpsz-like  -- per-time-slice CP preservation only: the slice faces
              bound the error, the cross-time slab faces are ignored, so
              FC_t = 0 while trajectories may still break inside slabs
              (the paper's characterization of cpSZ(SoS)).  Up to 8
              rounds of K1, the decode and the face predicates (K2).

sz3-like and cpsz-like run on ``device`` (the CUDA device unless
``device="cpu"``); their bytes and reconstructions equal the JAX
package's.  Their clocks stop once the reconstruction is on the host.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import (backend, compressor, ebound, encode, fixedpoint, pipeline,
                    quantize)

_DCT4 = None


def _dct4():
    global _DCT4
    if _DCT4 is None:
        k = np.arange(4)[:, None]
        n = np.arange(4)[None, :]
        m = np.cos(np.pi * (2 * n + 1) * k / 8.0) * np.sqrt(2.0 / 4.0)
        m[0] /= np.sqrt(2.0)
        _DCT4 = m
    return _DCT4


def _eb_abs(u, v, eb, mode):
    rng = float(max(u.max(), v.max()) - min(u.min(), v.min()))
    return eb * rng if mode == "rel" else eb


def zfp_like(u, v, eb=1e-2, mode="rel", level=12, **kw):
    t0 = time.perf_counter()
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    eb_abs = _eb_abs(u, v, eb, mode)
    T, H, W = u.shape
    Hp, Wp = -(-H // 4) * 4, -(-W // 4) * 4
    m = _dct4()

    def fwd(x):
        xp = np.zeros((T, Hp, Wp), np.float32)
        xp[:, :H, :W] = x
        xp[:, H:, :W] = xp[:, H - 1: H, :W]
        xp[:, :, W:] = xp[:, :, W - 1: W]
        b = xp.reshape(T, Hp // 4, 4, Wp // 4, 4).transpose(0, 1, 3, 2, 4)
        c = np.einsum("ij,tbkjl,ml->tbkim", m, b.astype(np.float64), m)
        return np.round(c / eb_abs).astype(np.int32)

    def inv(q):
        c = q.astype(np.float64) * eb_abs
        b = np.einsum("ji,tbkjl,lm->tbkim", m, c, m)
        xp = b.transpose(0, 1, 3, 2, 4).reshape(T, Hp, Wp)
        return xp[:, :H, :W].astype(np.float32)

    qu, qv = fwd(u), fwd(v)
    payload = qu.astype(np.int16).tobytes() + qv.astype(np.int16).tobytes()
    over = np.concatenate([qu[np.abs(qu) > 32000], qv[np.abs(qv) > 32000]])
    blob = encode.codec_compress(payload, level)
    tc = time.perf_counter() - t0
    t0 = time.perf_counter()
    ur, vr = inv(np.clip(qu, -32000, 32000)), inv(np.clip(qv, -32000, 32000))
    td = time.perf_counter() - t0
    n = u.nbytes + v.nbytes
    return {
        "name": "zfp-like", "lossless": False, "eb_abs": eb_abs,
        "orig_bytes": n, "comp_bytes": len(blob) + over.nbytes,
        "ratio": n / (len(blob) + over.nbytes),
        "t_compress": tc, "t_decompress": td,
        "u_rec": ur, "v_rec": vr,
    }


def _pack_like_ours(res_u, res_v, lossless, u_ll, v_ll, bm_shape, level):
    sym_u, esc_u = encode.to_symbols(res_u)
    sym_v, esc_v = encode.to_symbols(res_v)
    sections = {
        "sym_u": sym_u, "sym_v": sym_v, "esc_u": esc_u, "esc_v": esc_v,
        "lossless": np.packbits(lossless),
        "u_ll": u_ll, "v_ll": v_ll,
        "blockmap": np.packbits(np.zeros(bm_shape, bool)),
        "bm_shape": np.asarray(bm_shape, np.int32),
    }
    return encode.pack({"v": 1}, sections, level)


def _decode(res_u, res_v, bm_shape, scale, xi_unit, block, lossless, u_t,
            v_t):
    """All-Lorenzo decode (``backend.sl_decode`` with an all-False
    blockmap) and the reconstruction, on the residuals' device."""
    xu, xv = backend.sl_decode(res_u, res_v, np.zeros(bm_shape, bool), block,
                               (2.0 * xi_unit) / scale, 1.0, 1.0, 2.0, 32)
    return pipeline._reconstruct(xu, xv, scale, xi_unit, lossless, u_t, v_t)


def _fields(u, v, dev):
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    scale, ufp, vfp = fixedpoint.to_fixed(u, v)
    return (u, v, scale, torch.as_tensor(ufp, device=dev),
            torch.as_tensor(vfp, device=dev), torch.as_tensor(u, device=dev),
            torch.as_tensor(v, device=dev))


def sz3_like(u, v, eb=1e-2, mode="rel", level=12, block=16, device=None,
             **kw):
    """Uniform-eb Lorenzo pipeline, no CP constraints, no verify."""
    dev = compressor.resolve_device(device)
    t0 = time.perf_counter()
    u, v, scale, ufp, vfp, u_t, v_t = _fields(u, v, dev)
    T, H, W = u.shape
    eb_abs = _eb_abs(u, v, eb, mode)
    tau = max(int(np.floor(eb_abs * scale)), 1)
    xi_unit = max(tau, 1)  # SZ semantics: quantum 2*eb, max err <= eb
    k = torch.zeros((T, H, W), dtype=torch.int32, device=dev)
    ll = torch.zeros((T, H, W), dtype=torch.bool, device=dev)
    res_u, res_v = backend.lorenzo_residual(ufp, vfp, k, ll, xi_unit, block)
    bm_shape = (T, -(-H // block), -(-W // block))
    blob = _pack_like_ours(res_u.cpu().numpy(), res_v.cpu().numpy(),
                           np.zeros((T, H, W), bool),
                           np.zeros(0, np.float32), np.zeros(0, np.float32),
                           bm_shape, level)
    tc = time.perf_counter() - t0

    t0 = time.perf_counter()
    ur, vr = _decode(res_u, res_v, bm_shape, scale, xi_unit, block, ll, u_t,
                     v_t)
    ur, vr = ur.cpu().numpy(), vr.cpu().numpy()
    td = time.perf_counter() - t0
    n = u.nbytes + v.nbytes
    return {
        "name": "sz3-like", "lossless": False, "eb_abs": eb_abs,
        "orig_bytes": n, "comp_bytes": len(blob), "ratio": n / len(blob),
        "t_compress": tc, "t_decompress": td,
        "u_rec": ur, "v_rec": vr,
    }


def cpsz_like(u, v, eb=1e-2, mode="rel", level=12, block=16, device=None,
              **kw):
    """Per-slice CP preservation only (no slab faces, no slab verify)."""
    dev = compressor.resolve_device(device)
    t0 = time.perf_counter()
    u, v, scale, ufp, vfp, u_t, v_t = _fields(u, v, dev)
    T, H, W = u.shape
    eb_abs = _eb_abs(u, v, eb, mode)
    tau = max(int(np.floor(eb_abs * scale)), 1)
    xi_unit, n_levels = quantize.ladder(tau)
    eb_slice = ebound.derive_slice_eb(ufp, vfp, tau)
    s0, _ = ebound.all_face_predicates(ufp, vfp)
    bm_shape = (T, -(-H // block), -(-W // block))
    no_slab = np.zeros((T - 1, 1), bool)

    lossless_extra = torch.zeros((T, H, W), dtype=torch.bool, device=dev)
    for _ in range(8):
        k, lossless = quantize.quantize_eb(eb_slice, xi_unit, n_levels)
        lossless = lossless | lossless_extra
        res_u, res_v = backend.lorenzo_residual(ufp, vfp, k, lossless,
                                                xi_unit, block)
        ur, vr = _decode(res_u, res_v, bm_shape, scale, xi_unit, block,
                         lossless, u_t, v_t)
        # verify the SLICE predicates only (the cpSZ guarantee)
        ur_fp = torch.round(ur.to(torch.float64) * scale).to(torch.int64)
        vr_fp = torch.round(vr.to(torch.float64) * scale).to(torch.int64)
        s1, _ = ebound.all_face_predicates(ur_fp, vr_fp)
        bad = s0 ^ s1
        err = torch.maximum(
            torch.abs(ur.to(torch.float64) - u_t.to(torch.float64)),
            torch.abs(vr.to(torch.float64) - v_t.to(torch.float64)))
        bad_pt = err > eb_abs
        if not bool(bad.any()) and not bool(bad_pt.any()):
            break
        extra = lossless_extra | bad_pt
        extra |= torch.as_tensor(pipeline._faces_to_vertex_mask(
            bad.cpu().numpy(), no_slab, T, H, W), device=dev)
        lossless_extra = extra

    lossless_np = lossless.cpu().numpy()
    ur, vr = ur.cpu().numpy(), vr.cpu().numpy()
    blob = _pack_like_ours(res_u.cpu().numpy(), res_v.cpu().numpy(),
                           lossless_np, u[lossless_np], v[lossless_np],
                           bm_shape, level)
    tc = time.perf_counter() - t0
    n = u.nbytes + v.nbytes
    return {
        "name": "cpsz-like", "lossless": False, "eb_abs": eb_abs,
        "orig_bytes": n, "comp_bytes": len(blob), "ratio": n / len(blob),
        "t_compress": tc, "t_decompress": 0.0,
        "u_rec": ur, "v_rec": vr,
    }
