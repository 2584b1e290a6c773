"""The monolithic fused pipeline: plan, encode stages, verify fixpoint,
decode.

    fixedpoint -> eb-derive -> quantize -> predict -> verify-fixpoint
               -> symbolize -> pack

Every stage runs on the device of the tensors it is given (the caller's
``device``): on CUDA the hot ops launch their kernels through
core/backend.py, on the CPU they run the plain versions.  Integer stages
are exact int64, the reconstruction and pointwise checks are elementwise
IEEE f64, the SL decode and stepper are the plan's (``sl_backend``, the
JAX package's stepper of that name: backend.py) and the MoP rate model
runs on the host (mop.py), so the container bytes do not depend on the
device and equal the JAX package's for the same plan and backend.

The plan's ``codec`` picks the symbolize + pack stage: ``"host"``
fetches the residuals and writes a CPTZ1 / CPTL1 container
(encode.field_sections), ``"device"`` entropy-codes them where they are
and writes a CPTH1 container (entropy.field_sections_device).  Decode
reads either, on the host.

The tiled pipeline (core/tiling.py) runs the same stages per tile unit
through ``PlanExecutor``'s unit entries: a unit quantizes its halo
extension and stores residual streams of its owned box only, the
temporal predictor restarting at the unit's first frame.
``encode_unit`` / ``decode_fields`` run one unit through the
whole-field kernel entries; ``encode_units`` / ``decode_units`` run a
stack of same-signature units (``unit_signature``) through the
unit-batched ones, one launch per stage for the stack.  Every stage is
exact integer work or elementwise f64, the MoP rate model takes each
tile's histogram alone, and the SL stepper is one device function, so
a unit's streams are the same bytes either way and for any batch size.

The legacy (seed) plan (``fused=False`` or ``REPRO_FUSED=0``: the JAX
package's ``LEGACY_BINDINGS``) unfuses the quantize and predict stages
(``quantize.dual_quantize`` and ``predictors.lorenzo_encode`` as torch
ops, no K1), re-evaluates every face's predicate in each verify round
(``ebound.all_face_predicates``, K2 ``face_crossed`` on CUDA) and steps
SL with the "xla" stepper on every plane height; its container is
tagged ``"pipeline": "legacy"`` with no ``sl_backend``.  The JAX
package decodes it with a sequential scan over frames, which the
parallel decode with the "xla" stepper reproduces bitwise.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import obs
from . import (backend, ebound, ebpolicy, encode, entropy, grid, mop,
               predictors, quantize)

FORMAT_VERSION = 2
# the adaptive (per-tile policy) monolithic container; its decode path
# is the uniform one
FORMAT_VERSION_ADAPTIVE = 3

# stage bindings, the JAX package's (stage, variant) pairs; a plan's
# ``bindings`` pick the encode, decode and verify implementations below
FUSED_BINDINGS = (("encode", "fused"), ("decode", "parallel"),
                  ("verify", "screened"))
LEGACY_BINDINGS = (("encode", "legacy"), ("decode", "scan"),
                   ("verify", "full"))
# the SL stepper of the legacy plan, on every plane height
LEGACY_SL_BACKEND = "xla"


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """One pipeline configuration: global stream parameters."""

    name: str
    predictor: str
    block: int
    n_levels: int
    scale: float
    eb_abs: float
    tau: int
    xi_unit: int
    n_usable: int
    cfl_x: float
    cfl_y: float
    d_max: float
    n_max: int
    zstd_level: int = 12
    verify: bool = True
    max_rounds: int = 12
    sl_backend: str = backend.SL_BACKEND
    codec: str = "host"              # symbolize + pack: host | device
    # canonical spec of an adaptive eb policy (ebpolicy.TilePolicy.spec),
    # None for the uniform bound; it moves the container to version 3
    eb_policy: object = None
    batch_units: bool = True         # tiled: stack same-signature units
    bindings: tuple = FUSED_BINDINGS

    @property
    def g2f(self) -> float:
        return (2.0 * self.xi_unit) / self.scale

    def binding(self, stage: str) -> str:
        return dict(self.bindings)[stage]


def plan_from_cfg(cfg, scale: float, eb_abs: float,
                  name: str = "fused") -> PipelinePlan:
    """Plan from a CompressionConfig + the field-derived stream params;
    ``name`` is the container's pipeline tag ("fused" | "tiled" |
    "legacy"), the SL stepper the config's backend (``backend.resolve``),
    "xla" whatever it says for "legacy"."""
    tau = max(int(np.floor(eb_abs * scale)), 0)
    xi_unit, n_usable = quantize.ladder(tau, cfg.n_levels)
    legacy = name == "legacy"
    return PipelinePlan(
        name=name,
        predictor=cfg.predictor,
        block=cfg.block,
        n_levels=cfg.n_levels,
        scale=scale,
        eb_abs=eb_abs,
        tau=tau,
        xi_unit=xi_unit,
        n_usable=n_usable,
        cfl_x=cfg.dt / cfg.dx,
        cfl_y=cfg.dt / cfg.dy,
        d_max=cfg.d_max,
        n_max=cfg.n_max,
        zstd_level=cfg.zstd_level,
        verify=cfg.verify,
        max_rounds=cfg.max_rounds,
        sl_backend=LEGACY_SL_BACKEND if legacy
        else backend.resolve(cfg.backend),
        codec=cfg.codec,
        eb_policy=ebpolicy.policy_spec(ebpolicy.normalize(cfg.eb_policy)),
        batch_units=bool(cfg.batch_units),
        bindings=LEGACY_BINDINGS if legacy else FUSED_BINDINGS,
    )


def plan_from_header(header: dict, sl_backend=None) -> PipelinePlan:
    """Decode-side plan of a monolithic container or of a tiled footer
    (whose unit frames carry their own codec).  The SL stepper the
    decode replays is ``sl_backend`` (a decode entry's ``backend=``)
    when given, else the header's ``sl_backend``: "numpy", "xla" or
    "pallas" (``backend.SL_BACKENDS``), each bitwise equal to the JAX
    package's stepper of that name as it runs on the CPU; any other name
    is refused.  A "legacy" container (or one with no ``pipeline`` tag)
    decodes with the "xla" stepper whatever either says, as the JAX
    package does.  A "pallas" container written on a TPU holds that
    TPU's f32 arithmetic, which no other machine reproduces
    (core/backend.py)."""
    name = header.get("pipeline", "legacy")
    if name not in ("fused", "tiled", "legacy"):
        raise encode.ContainerError(
            f"unknown pipeline {name!r}; expected 'fused', 'tiled' or "
            "'legacy'")
    if sl_backend is not None:
        backend.resolve(sl_backend)          # an unknown name raises
    if name == "legacy":
        tag = LEGACY_SL_BACKEND
    else:
        tag = sl_backend or header.get("sl_backend")
    if tag not in backend.SL_BACKENDS:
        raise ValueError(
            f"container SL stepper {tag!r} cannot be replayed by "
            f"repro_torch (decodes {backend.SL_BACKENDS})")
    codec = header.get("codec")
    if name != "tiled" and codec not in ("zstd", "zlib", "huffman"):
        raise encode.ContainerError(
            f"unknown container codec {codec!r}; expected 'zstd', 'zlib' "
            "or 'huffman'")
    try:
        plan = PipelinePlan(
            name=name,
            predictor=header.get("predictor", "mop"),
            block=int(header["block"]),
            n_levels=1,
            scale=float(header["scale"]),
            eb_abs=float(header.get("eb_abs", 0.0)),
            tau=0,
            xi_unit=int(header["xi_unit"]),
            n_usable=1,
            cfl_x=float(header["cfl_x"]),
            cfl_y=float(header["cfl_y"]),
            d_max=float(header["d_max"]),
            n_max=int(header["n_max"]),
            sl_backend=tag,
            codec="device" if codec == "huffman" else "host",
            bindings=LEGACY_BINDINGS if name == "legacy"
            else FUSED_BINDINGS,
        )
    except (KeyError, TypeError, ValueError) as e:
        raise encode.ContainerError(f"malformed container header: {e}") \
            from e
    if plan.block < 1 or plan.xi_unit < 1 or plan.n_max < 1:
        raise encode.ContainerError(
            f"malformed container header: block {plan.block}, xi_unit "
            f"{plan.xi_unit}, n_max {plan.n_max}")
    return plan


def unit_signature(ext_shape, owned_shape, owned_offset):
    """Batching signature: tile units sharing it stack through one
    launch per stage (``PlanExecutor.encode_units``)."""
    return (tuple(ext_shape), tuple(owned_shape), tuple(owned_offset))


def owned_slices(owned):
    """(ot, oi, oj, To, Ho, Wo) -> the owned box's slices in the
    extension."""
    ot, oi, oj, To, Ho, Wo = owned
    return (slice(ot, ot + To), slice(oi, oi + Ho), slice(oj, oj + Wo))


class PlanExecutor:
    """A plan bound to a device: the full-field stages below and the
    tile-unit entries of the tiled pipeline."""

    def __init__(self, plan: PipelinePlan, device: torch.device):
        self.plan = plan
        self.device = device

    @property
    def g2f(self) -> float:
        return self.plan.g2f

    @property
    def codec(self) -> str:
        return self.plan.codec

    def tables(self, H: int, W: int) -> dict:
        return grid.device_tables(H, W, str(self.device))

    def _sl_args(self):
        p = self.plan
        return (p.g2f, p.cfl_x, p.cfl_y, p.d_max, p.n_max, p.sl_backend)

    # ---- one tile unit (the whole-field kernel entries) ----------------

    def encode_unit(self, ufp_e, vfp_e, eb_e, extra_e, owned):
        """Quantize one unit's (Te, He, We) extension and build its owned
        box's residual streams (owned = (ot, oi, oj, To, Ho, Wo)):
        ``lorenzo_residual`` over the extension gives X, the owned
        streams come from ``_unit_streams``.  Returns (xu_e, xv_e, ll_e,
        res_u, res_v, bm (host))."""
        p = self.plan
        k, ll = _levels(eb_e, extra_e, p.xi_unit, p.n_levels)
        _, _, xu_e, xv_e = backend.lorenzo_residual(
            ufp_e, vfp_e, k, ll, p.xi_unit, p.block, want_x=True)
        o = owned_slices(owned)
        res_u, res_v, bm = self._unit_streams(
            ufp_e[o], vfp_e[o], k[o], ll[o], xu_e[o], xv_e[o])
        return xu_e, xv_e, ll, res_u, res_v, bm

    def _unit_streams(self, ufp_o, vfp_o, k_o, ll_o, xu_o, xv_o):
        """The stored streams of one unit: Lorenzo blocks from the owned
        origin, the temporal predictor restarting at its first frame,
        the SL stepper on the unit's own planes."""
        p = self.plan
        To, Ho, Wo = xu_o.shape
        nb = (To, -(-Ho // p.block), -(-Wo // p.block))
        if p.predictor == "lorenzo":
            res_u, res_v = backend.lorenzo_residual(ufp_o, vfp_o, k_o, ll_o,
                                                    p.xi_unit, p.block)
            return res_u, res_v, np.zeros(nb, dtype=bool)
        if To > 1:
            pu, pv = backend.sl_predictions(xu_o, xv_o, *self._sl_args())
        else:
            pu = pv = torch.zeros((0, Ho, Wo), dtype=torch.int64,
                                  device=xu_o.device)
        if p.predictor == "sl":
            bm = np.ones(nb, dtype=bool)
            bm[0] = False
            return (torch.cat([predictors.d2_block(xu_o[:1], p.block),
                               xu_o[1:] - pu]),
                    torch.cat([predictors.d2_block(xv_o[:1], p.block),
                               xv_o[1:] - pv]), bm)
        res3_u, res3_v = backend.lorenzo_residual(ufp_o, vfp_o, k_o, ll_o,
                                                  p.xi_unit, p.block)
        zero = torch.zeros_like(xu_o[:1])
        ressl_u = torch.cat([zero, xu_o[1:] - pu])
        ressl_v = torch.cat([zero, xv_o[1:] - pv])
        bm = mop.select(res3_u, res3_v, ressl_u, ressl_v, p.block)
        return (mop.assemble(res3_u, ressl_u, bm, p.block),
                mop.assemble(res3_v, ressl_v, bm, p.block), bm.numpy())

    def decode_fields(self, res_u, res_v, bm):
        """One unit's (or field's) base-grid integers from its streams.
        The legacy plan's "scan" decode is this one with the "xla"
        stepper: frame by frame, the JAX package's scan computes the
        same integers."""
        return backend.sl_decode(res_u, res_v, bm, self.plan.block,
                                 *self._sl_args())

    # ---- a stack of same-signature units (the unit-batched entries) ----

    def encode_units(self, owned, ufp_es, vfp_es, eb_es, extra_es):
        """``encode_unit`` of B same-signature units stacked on axis 0,
        one launch per kernel for the stack: K1 (X over the extensions,
        residuals over the owned boxes), K4 over all B (To-1) frames,
        one MoP selection pass.  Returns (xu_e, xv_e, ll_e, res_u, res_v,
        bms (host (B, To, nbi, nbj)))."""
        p = self.plan
        k, ll = _levels(eb_es, extra_es, p.xi_unit, p.n_levels)
        res3_u, res3_v, xu_e, xv_e = backend.lorenzo_residual_units(
            ufp_es, vfp_es, k, ll, p.xi_unit, p.block, owned)
        B = xu_e.shape[0]
        To, Ho, Wo = owned[3:]
        nb = (B, To, -(-Ho // p.block), -(-Wo // p.block))
        if p.predictor == "lorenzo":
            return xu_e, xv_e, ll, res3_u, res3_v, np.zeros(nb, dtype=bool)
        o = (slice(None),) + owned_slices(owned)
        xu_o, xv_o = xu_e[o], xv_e[o]
        if To > 1:
            pu, pv = backend.sl_predictions_units(xu_o, xv_o,
                                                  *self._sl_args())
        else:
            pu = pv = torch.zeros((B, 0, Ho, Wo), dtype=torch.int64,
                                  device=xu_o.device)
        if p.predictor == "sl":
            bms = np.ones(nb, dtype=bool)
            bms[:, 0] = False
            return (xu_e, xv_e, ll,
                    torch.cat([predictors.d2_block(xu_o[:, :1], p.block),
                               xu_o[:, 1:] - pu], dim=1),
                    torch.cat([predictors.d2_block(xv_o[:, :1], p.block),
                               xv_o[:, 1:] - pv], dim=1), bms)
        zero = torch.zeros_like(xu_o[:, :1])
        ressl_u = torch.cat([zero, xu_o[:, 1:] - pu], dim=1)
        ressl_v = torch.cat([zero, xv_o[:, 1:] - pv], dim=1)
        bms = mop.select_units(res3_u, res3_v, ressl_u, ressl_v, p.block)
        flat_bm = bms.reshape(B * To, *nb[2:])

        def assemble(r3, rsl):
            return mop.assemble(r3.reshape(B * To, Ho, Wo),
                                rsl.reshape(B * To, Ho, Wo), flat_bm,
                                p.block).reshape(B, To, Ho, Wo)

        return (xu_e, xv_e, ll, assemble(res3_u, ressl_u),
                assemble(res3_v, ressl_v), bms.numpy())

    def decode_units(self, res_u, res_v, bms):
        """Decode simulation of a stack of units: one prefix sum, or one
        ``sl_decode_units`` launch when a unit has SL blocks."""
        return backend.sl_decode_units(res_u, res_v, bms, self.plan.block,
                                       *self._sl_args())

    # ---- decode and device codec of tiled containers --------------------

    def decode_unit(self, unit_header: dict, sections: dict):
        """A tiled container's unit frame -> (u, v) float32 numpy of its
        owned box."""
        try:
            t0, t1, i0, i1, j0, j1 = (int(b) for b in unit_header["box"])
        except (KeyError, TypeError, ValueError) as e:
            raise encode.ContainerError(f"malformed unit box: {e}") from e
        return decode_payload(self, (t1 - t0, i1 - i0, j1 - j0), sections)

    def entropy_fragments(self, res_u_stack, res_v_stack) -> list:
        """Device entropy coding of stacked same-shape residual streams
        (device codec): one section fragment per unit."""
        return entropy.encode_streams(res_u_stack, res_v_stack)


def executor_from_header(header: dict, device, sl_backend=None
                         ) -> PlanExecutor:
    return PlanExecutor(plan_from_header(header, sl_backend), device)


# ----------------------------------------------------------------------
# shared stage pieces
# ----------------------------------------------------------------------

def _reconstruct(xu, xv, scale, xi_unit, lossless, u_raw, v_raw):
    g = 2.0 * xi_unit
    u_rec = (xu.to(torch.float64) * (g / scale)).to(torch.float32)
    v_rec = (xv.to(torch.float64) * (g / scale)).to(torch.float32)
    return (torch.where(lossless, u_raw, u_rec),
            torch.where(lossless, v_raw, v_rec))


def _levels(eb_vertex, lossless_extra, xi_unit, n_levels):
    """eb -> (k, lossless), with the forced vertices lossless."""
    k, lossless = quantize.quantize_eb(eb_vertex, xi_unit, n_levels)
    lossless = lossless | lossless_extra
    k = torch.where(lossless_extra, torch.full_like(k, -1), k)
    return k, lossless


def _check_pt_core(xu_d, xv_d, lossless, lossless_extra, u_raw, v_raw,
                   scale, xi_unit, bound):
    """Reconstruct, re-fix, flag pointwise-bound violations.  ``bound``
    is the plan's scalar ``eb_abs`` or an adaptive policy's (T, H, W)
    float64 per-vertex bounds.  Returns (forced set, n violations as a
    0-d device tensor, ur_fp, vr_fp)."""
    u_rec, v_rec = _reconstruct(xu_d, xv_d, scale, xi_unit, lossless,
                                u_raw, v_raw)
    ur_fp = torch.round(u_rec.to(torch.float64) * scale).to(torch.int64)
    vr_fp = torch.round(v_rec.to(torch.float64) * scale).to(torch.int64)
    err = torch.maximum(
        torch.abs(u_rec.to(torch.float64) - u_raw.to(torch.float64)),
        torch.abs(v_rec.to(torch.float64) - v_raw.to(torch.float64)))
    bad_pt = err > bound
    return lossless_extra | bad_pt, bad_pt.sum(), ur_fp, vr_fp


def _faces_to_vertex_mask(bad_slice, bad_slab, T, H, W):
    """(T, H, W) host bool mask of every vertex of the violated faces
    (bad_slice (T, Fs), bad_slab (T-1, Fb) host bools)."""
    HW = H * W
    mask = np.zeros(T * HW, dtype=bool)
    for bad, tab in ((bad_slice, grid.slab_faces(H, W)["slice0"]),
                     (bad_slab, grid.slab_face_table(H, W))):
        t_ids, f_ids = np.nonzero(np.asarray(bad))
        if len(t_ids):
            ids = tab[f_ids].astype(np.int64) + t_ids[:, None] * HW
            mask[ids.reshape(-1)] = True
    return mask.reshape(T, H, W)


# ----------------------------------------------------------------------
# decode (backend.sl_decode, shared with the verify simulation)
# ----------------------------------------------------------------------

def decode_payload(ex: PlanExecutor, shape, sections):
    """sections -> reconstructed (u, v) float32 numpy arrays."""
    p = ex.plan
    dev = ex.device
    with obs.span("decode.parse"):
        res_u, res_v, bm, ll = encode.parse_field_sections(sections, shape)
        T, H, W = shape
        if bm.shape != (T, -(-H // p.block), -(-W // p.block)):
            raise encode.ContainerError(
                f"blockmap shape {list(bm.shape)} does not match the field "
                f"{list(shape)} in {p.block}-blocks")
    with obs.span("decode.sl", blocks=int(np.count_nonzero(bm))):
        xu, xv = backend.sl_decode(
            torch.as_tensor(res_u, device=dev),
            torch.as_tensor(res_v, device=dev), bm, p.block, *ex._sl_args())
        obs.device_sync(xu)
    with obs.span("decode.reconstruct"):
        n_ll = int(ll.sum())
        u_raw = np.zeros(shape, dtype=np.float32)
        v_raw = np.zeros(shape, dtype=np.float32)
        for raw, name in ((u_raw, "u_ll"), (v_raw, "v_ll")):
            vals = sections.get(name)
            if vals is None or vals.shape != (n_ll,):
                raise encode.ContainerError(
                    f"section {name!r} does not hold the {n_ll} lossless "
                    "values")
            raw[ll] = vals
        u_rec, v_rec = _reconstruct(
            xu, xv, p.scale, p.xi_unit, torch.as_tensor(ll, device=dev),
            torch.as_tensor(u_raw, device=dev),
            torch.as_tensor(v_raw, device=dev))
        return u_rec.cpu().numpy(), v_rec.cpu().numpy()


def decode_field_blob(ex: PlanExecutor, header: dict, sections: dict):
    try:
        T, H, W = (int(s) for s in header["shape"])
    except (KeyError, TypeError, ValueError) as e:
        raise encode.ContainerError(f"malformed container shape: {e}") from e
    return decode_payload(ex, (T, H, W), sections)


# ----------------------------------------------------------------------
# full-field encode (quantize -> predict -> verify-fixpoint)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class FieldEncode:
    """compress_field result: streams + masks + verify accounting."""

    res_u: torch.Tensor
    res_v: torch.Tensor
    bm: np.ndarray
    lossless: torch.Tensor
    rounds: int
    bad_counts: list


def _lorenzo_stage(ex, ufp, vfp, k, lossless, want_x=False):
    """Both components' Lorenzo residuals (with ``want_x`` also the
    quantized fields): one K1 launch on the fused binding; on the legacy
    one the JAX package's unfused stages as torch ops,
    ``quantize.dual_quantize`` then ``predictors.lorenzo_encode`` (the
    same integers)."""
    p = ex.plan
    if p.binding("encode") == "fused":
        return backend.lorenzo_residual(ufp, vfp, k, lossless, p.xi_unit,
                                        p.block, want_x=want_x)
    xu = quantize.dual_quantize(ufp, k, lossless, p.xi_unit)
    xv = quantize.dual_quantize(vfp, k, lossless, p.xi_unit)
    res = (predictors.lorenzo_encode(xu, p.block),
           predictors.lorenzo_encode(xv, p.block))
    return res + (xu, xv) if want_x else res


def _encode_field(ex: PlanExecutor, ufp, vfp, eb_vertex, lossless_extra,
                  shape):
    """Quantize + predict on the full field -> (res_u, res_v, bm (host),
    lossless), through the plan's encode binding (``_lorenzo_stage``)."""
    p = ex.plan
    T, H, W = shape
    nb = (T, -(-H // p.block), -(-W // p.block))
    k, lossless = _levels(eb_vertex, lossless_extra, p.xi_unit, p.n_levels)
    if p.predictor == "lorenzo":
        res_u, res_v = _lorenzo_stage(ex, ufp, vfp, k, lossless)
        return res_u, res_v, np.zeros(nb, dtype=bool), lossless
    if p.predictor == "sl":
        xu = quantize.dual_quantize(ufp, k, lossless, p.xi_unit)
        xv = quantize.dual_quantize(vfp, k, lossless, p.xi_unit)
        pu, pv = backend.sl_predictions(xu, xv, *ex._sl_args())
        res_u = torch.cat([predictors.d2_block(xu[:1], p.block), xu[1:] - pu])
        res_v = torch.cat([predictors.d2_block(xv[:1], p.block), xv[1:] - pv])
        bm = np.ones(nb, dtype=bool)
        bm[0] = False
        return res_u, res_v, bm, lossless
    # MoP: the Lorenzo residuals and the quantized fields the SL
    # predictions start from (one K1 launch on the fused binding)
    res3_u, res3_v, xu, xv = _lorenzo_stage(ex, ufp, vfp, k, lossless,
                                            want_x=True)
    pu, pv = backend.sl_predictions(xu, xv, *ex._sl_args())
    zero = torch.zeros_like(xu[:1])
    ressl_u = torch.cat([zero, xu[1:] - pu])
    ressl_v = torch.cat([zero, xv[1:] - pv])
    bm = mop.select(res3_u, res3_v, ressl_u, ressl_v, p.block)
    res_u = mop.assemble(res3_u, ressl_u, bm, p.block)
    res_v = mop.assemble(res3_v, ressl_v, bm, p.block)
    return res_u, res_v, bm.numpy(), lossless


def _verify_round(ex, shape, tabs, preds, prev_extra, ufp, vfp, u, v,
                  xu_d, xv_d, lossless, lossless_extra, bound):
    """One verify round: pointwise check + face re-verification (the
    sign-stability screen in the first round, the faces touched by the
    newly forced vertices after it), one ``backend.verify_faces`` call.
    ``bound`` as in ``_check_pt_core``.  Returns (new forced set,
    n_bad); reading n_bad is the round's one host sync."""
    p = ex.plan
    forced, n_pt, ur_fp, vr_fp = _check_pt_core(
        xu_d, xv_d, lossless, lossless_extra, u, v, p.scale, p.xi_unit,
        bound)
    delta = None if prev_extra is None else lossless_extra ^ prev_extra
    n_face = backend.verify_faces(ur_fp, vr_fp, ufp, vfp, delta,
                                  tabs["slice"], tabs["slab"], *preds, forced)
    return forced, int(n_pt + n_face)


def _verify_full(ex, shape, preds, u, v, xu_d, xv_d, lossless,
                 lossless_extra, bound):
    """The legacy verify round (the JAX package's ``_verify_full``): the
    pointwise check, and every face's predicate re-evaluated on the
    re-fixed reconstruction (``ebound.all_face_predicates``, K2
    ``face_crossed`` on CUDA) against the original ``preds``; the
    vertices of every changed face join the forced set on the host.
    Returns (new forced set, n_bad = bad vertices + bad faces)."""
    T, H, W = shape
    p = ex.plan
    forced, n_pt, ur_fp, vr_fp = _check_pt_core(
        xu_d, xv_d, lossless, lossless_extra, u, v, p.scale, p.xi_unit,
        bound)
    slice1, slab1 = ebound.all_face_predicates(ur_fp, vr_fp)
    bad_slice = (preds[0] ^ slice1).cpu().numpy()
    bad_slab = (preds[1] ^ slab1).cpu().numpy()
    forced |= torch.as_tensor(
        _faces_to_vertex_mask(bad_slice, bad_slab, T, H, W),
        device=forced.device)
    return forced, int(n_pt) + int(bad_slice.sum()) + int(bad_slab.sum())


def compress_field(ex: PlanExecutor, u, v, ufp, vfp, eb_cap=None,
                   eb_bound=None) -> FieldEncode:
    """Full-field quantize -> predict -> verify-fixpoint driver.

    u, v: (T, H, W) float32 numpy; ufp, vfp: int64 numpy fixed point.
    The loop forces the vertices of every violated face (and every
    vertex breaking the pointwise bound) lossless and repeats; it only
    grows the lossless set, so it terminates, and on exit FC_t = FC_s =
    0 by construction.

    ``eb_cap`` / ``eb_bound``: an adaptive policy's (T, H, W) int64 caps
    and float64 absolute bounds (numpy); both None on the uniform path,
    which then compares with the plan's scalar bound."""
    p = ex.plan
    dev = ex.device
    T, H, W = u.shape
    shape = (T, H, W)
    with obs.span("pipeline.upload", bytes=ufp.nbytes + vfp.nbytes
                  + u.nbytes + v.nbytes):
        tabs = ex.tables(H, W)
        ufp_d = torch.as_tensor(ufp, device=dev)
        vfp_d = torch.as_tensor(vfp, device=dev)
        u_d = torch.as_tensor(u, device=dev)
        v_d = torch.as_tensor(v, device=dev)
        obs.device_sync(v_d)
    with obs.span("pipeline.derive_eb", shape=list(shape)):
        eb_vertex, slice0, slab0 = ebound.derive_vertex_eb(
            ufp_d, vfp_d, int(max(p.tau, 1)))
        if eb_cap is not None:
            # adaptive policy: clamp the derived bounds DOWN to the
            # per-vertex caps (min composes with the derivation's own tau
            # clamp); the device copy of the caps dies with the clamp
            eb_vertex = torch.minimum(eb_vertex,
                                      torch.as_tensor(eb_cap, device=dev))
        obs.device_sync(eb_vertex)
    bound = p.eb_abs if eb_bound is None \
        else torch.as_tensor(eb_bound, device=dev)
    lossless_extra = torch.zeros(shape, dtype=torch.bool, device=dev)
    if p.tau < 1 or p.n_usable < 1:
        lossless_extra = torch.ones(shape, dtype=torch.bool, device=dev)

    prev_extra = None
    rounds = 0
    bad_counts = []
    while True:
        with obs.span("pipeline.quantize_predict", round=rounds):
            res_u, res_v, bm, lossless = _encode_field(
                ex, ufp_d, vfp_d, eb_vertex, lossless_extra, shape)
            obs.device_sync(res_u)
        if not p.verify:
            break
        with obs.span("pipeline.verify_round", round=rounds) as vs:
            xu_d, xv_d = ex.decode_fields(res_u, res_v, bm)
            if p.binding("verify") == "full":
                new_extra, n_bad = _verify_full(
                    ex, shape, (slice0, slab0), u_d, v_d, xu_d, xv_d,
                    lossless, lossless_extra, bound)
            else:
                new_extra, n_bad = _verify_round(
                    ex, shape, tabs, (slice0, slab0), prev_extra, ufp_d,
                    vfp_d, u_d, v_d, xu_d, xv_d, lossless, lossless_extra,
                    bound)
            vs.set(n_bad=n_bad)
        bad_counts.append(n_bad)
        if n_bad == 0 or rounds >= p.max_rounds:
            break
        prev_extra = lossless_extra
        lossless_extra = new_extra
        rounds += 1
    obs.count("pipeline.verify_rounds", rounds)
    return FieldEncode(res_u, res_v, bm, lossless, rounds, bad_counts)


# ----------------------------------------------------------------------
# symbolize + pack + stats
# ----------------------------------------------------------------------

def field_header(plan: PipelinePlan, shape) -> dict:
    """The JAX package's ``pipeline.field_header``: the plan's SL stepper
    tag, but none for the legacy plan.  The key order fixes the
    bytes."""
    T, H, W = shape
    header = {
        # the version moves only with a policy: uniform containers stay
        # byte-identical to the pre-policy ones
        "version": (FORMAT_VERSION_ADAPTIVE if plan.eb_policy
                    else FORMAT_VERSION),
        "pipeline": plan.name,
        "predictor": plan.predictor,
    }
    if plan.eb_policy:
        header["eb_policy"] = plan.eb_policy
    if plan.name != "legacy":
        header["sl_backend"] = plan.sl_backend
    header.update({
        "shape": [int(T), int(H), int(W)],
        "scale": float(plan.scale),
        "xi_unit": int(plan.xi_unit),
        "block": int(plan.block),
        "cfl_x": float(plan.cfl_x),
        "cfl_y": float(plan.cfl_y),
        "d_max": float(plan.d_max),
        "n_max": int(plan.n_max),
        "eb_abs": float(plan.eb_abs),
    })
    return header


def pack_field(ex: PlanExecutor, u, v, enc: FieldEncode, t0: float):
    """Symbolize + pack + stats for a full-field encode."""
    p = ex.plan
    with obs.span("pipeline.download", bytes=enc.lossless.numel()):
        lossless_np = enc.lossless.cpu().numpy()
    with obs.span("pipeline.symbolize", codec=p.codec):
        if p.codec == "device":
            sections = entropy.field_sections_device(
                enc.res_u, enc.res_v, lossless_np, u[lossless_np],
                v[lossless_np], enc.bm)
        else:
            sections = encode.field_sections(
                enc.res_u.cpu().numpy(), enc.res_v.cpu().numpy(),
                lossless_np, u[lossless_np], v[lossless_np], enc.bm)
    with obs.span("pipeline.pack") as ps:
        blob = encode.pack(field_header(p, u.shape), sections, p.zstd_level)
        ps.set(bytes=len(blob))
    t1 = time.perf_counter()
    orig_bytes = u.nbytes + v.nbytes
    stats = {
        "orig_bytes": orig_bytes,
        "comp_bytes": len(blob),
        "ratio": orig_bytes / max(len(blob), 1),
        "lossless_frac": float(lossless_np.mean()),
        "sl_block_frac": float(enc.bm.mean()),
        "verify_rounds": enc.rounds,
        "verify_bad_counts": enc.bad_counts,
        "eb_abs": p.eb_abs,
        "scale": p.scale,
        "tau": p.tau,
        "xi_unit": p.xi_unit,
        "seconds": t1 - t0,
        "device": str(ex.device),
        "pipeline": p.name,
    }
    return blob, stats
