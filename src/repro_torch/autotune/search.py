"""Plan search: enumerate + cost-prune candidate pipeline plans (the JAX
package's ``autotune/search.py``).

The discrete space is the cross product of

    tile geometry (divisor/halving heuristics over H, W) x
    window length x batch chunk (batch_cap) x backend x codec x
    async on/off x queue bounds,

plus the monolithic (untiled) candidate when the input is in memory.
The backend arm is the SL stepper and its header tag (core/backend.py):
``available_backends`` gives the tags worth searching on a device, and
``apply`` writes the chosen tag into ``cfg.backend``, overriding the
caller's, as the JAX package does; the tag ``backend.SL_BACKEND``
("numpy") becomes ``backend=None``, the one spelling of that stepper
that runs its kernel on CUDA (``backend="numpy"`` keeps to the plain
versions on the CPU).  A tuned container's header ``sl_backend`` is the
chosen candidate's ``backend`` on every device.  Every candidate is
ranked by
the analytic cost model (costmodel.py, optionally calibrated from obs
spans); ``search`` can then measure-verify the top-k on the actual
field so a mispriced model never silently picks a slow plan.  Ties on
predicted/measured cost break on the candidate's knob tuple, so a fixed
calibration table always yields the same chosen plan.

Backend, codec and tiling select the plan itself (different plans,
different containers, by design); batch_cap, the queue bounds and async
are pure scheduling and never change the bytes of a chosen plan.  The eb
policy is BYTE-CHANGING, so the search never enumerates it: every candidate
carries the caller's policy spec unchanged (in its key and the report,
so tunes under different policies are never conflated) and ``apply``
leaves ``cfg.eb_policy`` untouched.  Per-unit bounds for a target ratio
are a separate, rate-distortion search: rate.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from .. import perfflags
from ..core import backend as sl_backend, compressor, tiling
from . import costmodel


@dataclasses.dataclass(frozen=True, order=True)
class PlanCandidate:
    """One point of the search space.  ``grid`` is (tile_h, tile_w,
    window_t) or None for the monolithic pipeline."""

    grid: Optional[tuple] = None
    backend: str = "xla"
    codec: str = "host"
    batch_units: bool = True
    batch_cap: int = 8
    async_engine: bool = False
    q_in_frames: Optional[int] = None
    q_out_units: Optional[int] = None
    # byte-changing plan knob carried through, never searched (module
    # doc): the canonical ebpolicy spec, () for uniform
    eb_policy: tuple = ()

    @property
    def key(self):
        """Deterministic tie-break / identity tuple."""
        return (self.grid or (0, 0, 0), self.backend, self.codec,
                self.batch_units, self.batch_cap, self.async_engine,
                self.q_in_frames or 0, self.q_out_units or 0,
                self.eb_policy)

    def describe(self) -> str:
        g = "mono" if self.grid is None else \
            f"{self.grid[0]}x{self.grid[1]}x{self.grid[2]}"
        bits = [g, self.backend, self.codec,
                f"cap{self.batch_cap}" if self.grid else "",
                "async" if self.async_engine else "",
                "eb-adaptive" if self.eb_policy else ""]
        return "/".join(b for b in bits if b)


def available_backends(device=None) -> tuple:
    """Backends (SL stepper tags) worth searching on ``device`` (the CUDA
    device unless ``device="cpu"``).  On CUDA every tag has its kernels;
    on the CPU the JAX package's off-TPU tuple, whose "pallas" runs its
    "xla" path there.  The "numpy" arm is left out while
    ``REPRO_BACKEND`` names another stepper: ``apply`` spells it
    ``backend=None``, which would resolve to that stepper and duplicate
    its arm."""
    if compressor.resolve_device(device).type == "cuda":
        arms = ("pallas", "xla", "numpy")
    else:
        arms = ("xla", "numpy")
    if perfflags.backend_override() not in (None, sl_backend.SL_BACKEND):
        arms = tuple(a for a in arms if a != sl_backend.SL_BACKEND)
    return arms


def _axis_tiles(n: int) -> tuple:
    """Candidate tile sizes along one spatial axis: the full extent
    plus halvings down to 8, preferring exact divisors (no ragged last
    tile -> fewer signature groups)."""
    out = [n]
    t = n
    while t > 8:
        t = max(t // 2, 8)
        out.append(t)
    # snap each halving to the nearest divisor within 25% if one exists
    divs = [d for d in range(8, n + 1) if n % d == 0]
    snapped = []
    for t in out:
        best = min(divs, key=lambda d: abs(d - t), default=t)
        snapped.append(best if abs(best - t) <= max(t // 4, 1) else t)
    return tuple(dict.fromkeys(snapped))[:3]


def _window_lengths(T: int) -> tuple:
    out, w = [T], T
    while w > 4:
        w = max(w // 2, 4)
        out.append(w)
    return tuple(dict.fromkeys(out))[:3]


def enumerate_candidates(shape, stream: bool = False,
                         backends: Optional[Sequence[str]] = None,
                         codecs: Sequence[str] = ("host", "device"),
                         batch_caps: Sequence[int] = (4, 8, 16),
                         eb_policy: tuple = (), device=None) -> list:
    """The full (pre-pruning) candidate list for one field shape.

    ``backends`` defaults to ``available_backends(device)``.
    ``stream=True`` drops the monolithic candidate (a stream cannot be
    monolithic) and adds async-engine / queue-bound variants.
    ``eb_policy`` (a canonical spec, () for uniform) is stamped on
    every candidate unchanged -- carried, never enumerated.
    """
    T, H, W = shape
    backends = tuple(backends or available_backends(device))
    eb_policy = tuple(eb_policy or ())
    cands = []
    if not stream:
        for be in backends:
            cands.append(PlanCandidate(grid=None, backend=be,
                                       eb_policy=eb_policy))
    grids = [(th, tw, wt)
             for th in _axis_tiles(H)
             for tw in _axis_tiles(W)
             for wt in _window_lengths(T)]
    # a 1x1-tile "grid" covering everything in one window duplicates the
    # monolithic plan's work at tiled overhead; keep it only for streams
    if not stream:
        grids = [g for g in grids
                 if not (g[0] >= H and g[1] >= W and g[2] >= T)]
    for g in grids:
        nti = -(-H // g[0])
        ntj = -(-W // g[1])
        for be in backends:
            for codec in codecs:
                for cap in batch_caps:
                    if cap > nti * ntj and cap != batch_caps[0]:
                        continue  # caps beyond the unit count duplicate
                    base = PlanCandidate(grid=g, backend=be, codec=codec,
                                         batch_cap=cap,
                                         eb_policy=eb_policy)
                    cands.append(base)
                    if stream:
                        tpw = nti * ntj
                        cands.append(dataclasses.replace(
                            base, async_engine=True,
                            q_in_frames=max(g[2], 2),
                            q_out_units=max(2 * tpw, 2)))
                        cands.append(dataclasses.replace(
                            base, async_engine=True,
                            q_in_frames=2,
                            q_out_units=max(tpw // 2, 2)))
    # dedupe (divisor snapping can collide), first occurrence kept
    seen, out = set(), []
    for c in cands:
        if c.key not in seen:
            seen.add(c.key)
            out.append(c)
    return out


@dataclasses.dataclass
class Ranked:
    cand: PlanCandidate
    predicted: dict                  # costmodel.predict output
    measured_s: Optional[float] = None


def search(shape, model: Optional[costmodel.CostModel] = None,
           stream: bool = False, verify_rounds: float = 2.0,
           backends: Optional[Sequence[str]] = None,
           top_k: int = 0,
           measure: Optional[Callable[[PlanCandidate], float]] = None,
           candidates: Optional[Sequence[PlanCandidate]] = None,
           ingest_s: float = 0.0, eb_policy: tuple = (),
           device=None) -> list:
    """Rank the candidate space by predicted cost; optionally measure
    the ``top_k`` cheapest with ``measure(cand) -> seconds`` and re-rank
    those by measured time.  Returns [Ranked] sorted best-first --
    measured candidates (if any) always sort ahead of unmeasured ones.
    ``backends`` defaults to ``available_backends(device)``.
    """
    model = model or costmodel.CostModel()
    T, H, W = shape
    wl = costmodel.Workload(T=T, H=H, W=W, verify_rounds=verify_rounds,
                            stream=stream, ingest_s=ingest_s)
    cands = list(candidates) if candidates is not None else \
        enumerate_candidates(shape, stream=stream, backends=backends,
                             eb_policy=eb_policy, device=device)
    ranked = [Ranked(c, model.predict(c, wl)) for c in cands]
    ranked.sort(key=lambda r: (r.predicted["total"], r.cand.key))
    if top_k and measure is not None:
        head = ranked[:top_k]
        for r in head:
            r.measured_s = measure(r.cand)
        head.sort(key=lambda r: (r.measured_s, r.cand.key))
        ranked = head + ranked[top_k:]
    return ranked


def config_backend(tag: str) -> Optional[str]:
    """The ``CompressionConfig.backend`` that runs arm ``tag`` on every
    device: the tag, ``None`` for ``backend.SL_BACKEND`` (module doc).
    ValueError for that arm while ``REPRO_BACKEND`` names another
    stepper, which ``None`` would run."""
    tag = sl_backend.resolve(tag)
    if tag != sl_backend.SL_BACKEND:
        return tag
    if sl_backend.resolve() != tag:
        raise ValueError(
            f"the {tag!r} arm cannot run while REPRO_BACKEND="
            f"{perfflags.backend_override()} names another SL stepper; "
            "leave it out of the backends searched")
    return None


def apply(cfg, cand: PlanCandidate):
    """A new CompressionConfig realizing ``cand`` (cfg untouched).
    ``cfg.backend`` becomes ``config_backend(cand.backend)``, whatever
    the caller's was.  ``cfg.eb_policy`` passes through: the candidate's
    ``eb_policy`` records the policy the tune ran under, not a knob the
    search may move."""
    grid = None
    if cand.grid is not None:
        grid = tiling.TileGrid(tile_h=cand.grid[0], tile_w=cand.grid[1],
                               window_t=cand.grid[2])
    return dataclasses.replace(
        cfg, backend=config_backend(cand.backend), codec=cand.codec,
        batch_units=cand.batch_units, batch_cap=cand.batch_cap,
        q_in_frames=cand.q_in_frames, q_out_units=cand.q_out_units,
        tiling=grid)
