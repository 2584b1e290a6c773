"""Deterministic fault injection for the streaming/query stack (the JAX
package's ``core/faults.py``, host only).

Robustness code is only as good as the failures it has actually seen.
This module gives tests (and the recovery benchmark) a seeded, replayable
way to make the I/O and threading layers misbehave at exact, chosen
points:

* ``FaultPlan`` -- an ordered set of fault rules keyed by ``(site, op)``.
  A *site* is a short string naming an instrumented location
  (``"source.read"``, ``"engine.compute"``, ``"writer.write"``, ...);
  the plan decides, per call, whether that call fails and how.
* ``FaultPoint`` -- the hook object handed to instrumented code.  Code
  under test calls ``faults.check("site")`` (a no-op when no plan is
  armed) and the plan raises the scheduled exception on the scheduled
  call number.

Fault kinds
-----------
``io_error``      raise ``InjectedFault`` (an ``OSError``) on the Nth
                  call at a site.  ``transient=k`` makes the first *k*
                  raises transient: retry layers that re-invoke the
                  same site eventually succeed, which is how the
                  bounded-retry path in ``ContainerSource`` is tested.
``thread_death``  raise ``InjectedThreadDeath`` (a ``BaseException``
                  subclass) -- deliberately *not* an ``Exception`` so
                  that naive ``except Exception`` recovery code does
                  not swallow it; only the engine's shutdown path may
                  handle it.
``stall``         sleep for ``seconds`` on the Nth call, to trip
                  watchdog timeouts.

Everything is deterministic: the plan is driven by explicit call
counters, and the optional ``seed`` only feeds ``spread()`` helpers
that *derive* call numbers (e.g. "some call in the first 40") so a
matrix test can vary placement across cases while each case stays
exactly reproducible.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


class InjectedFault(OSError):
    """A scheduled I/O failure from a :class:`FaultPlan`."""


class InjectedThreadDeath(BaseException):
    """A scheduled hard thread death (not an ``Exception`` on purpose:
    generic recovery code must not be able to swallow it)."""


@dataclass
class _Rule:
    kind: str                   # "io_error" | "thread_death" | "stall"
    nth: int                    # 1-based call number at the site
    transient: int = 0          # io_error: first k raises are transient
    seconds: float = 0.0        # stall duration
    message: str = ""
    fired: int = 0              # how many times this rule has raised


class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    Instances are thread-safe: the streaming engine probes the same
    plan from three threads.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._rules: Dict[str, List[_Rule]] = {}
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.log: List[Tuple[str, str, int]] = []   # (site, kind, call#)

    # -- plan construction -------------------------------------------------
    def io_error(self, site: str, nth: int = 1, *, transient: int = 0,
                 message: str = "") -> "FaultPlan":
        """Raise :class:`InjectedFault` on the ``nth`` call at ``site``.

        ``transient=k``: the rule re-arms for the next *k* calls too
        (calls nth..nth+k raise), after which the site succeeds -- a
        retry loop that re-executes the site k+1 times gets through.
        """
        self._add(site, _Rule("io_error", nth, transient=transient,
                              message=message or f"injected io error @ {site}"))
        return self

    def thread_death(self, site: str, nth: int = 1) -> "FaultPlan":
        self._add(site, _Rule("thread_death", nth,
                              message=f"injected thread death @ {site}"))
        return self

    def stall(self, site: str, seconds: float, nth: int = 1) -> "FaultPlan":
        self._add(site, _Rule("stall", nth, seconds=float(seconds)))
        return self

    def spread(self, lo: int, hi: int) -> int:
        """A seed-derived call number in ``[lo, hi]`` (inclusive) --
        lets matrix tests place a fault "somewhere early" while staying
        replayable from the plan's seed."""
        return self._rng.randint(int(lo), int(hi))

    def _add(self, site: str, rule: _Rule) -> None:
        if rule.nth < 1:
            raise ValueError(f"fault nth must be >= 1, got {rule.nth}")
        with self._lock:
            self._rules.setdefault(site, []).append(rule)

    # -- probing -----------------------------------------------------------
    def check(self, site: str) -> None:
        """Account one call at ``site``; raise/stall if a rule matches."""
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            todo = None
            for rule in self._rules.get(site, ()):
                if rule.kind == "io_error":
                    if rule.nth <= n <= rule.nth + rule.transient:
                        rule.fired += 1
                        todo = rule
                        break
                elif rule.nth == n:
                    rule.fired += 1
                    todo = rule
                    break
            if todo is not None:
                self.log.append((site, todo.kind, n))
        if todo is None:
            return
        if todo.kind == "stall":
            time.sleep(todo.seconds)
            return
        if todo.kind == "thread_death":
            raise InjectedThreadDeath(todo.message)
        raise InjectedFault(todo.message)

    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)

    def fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for s, _, _ in self.log
                       if site is None or s == site)


class FaultPoint:
    """Nullable handle instrumented code keeps: ``FaultPoint(None)`` is
    a zero-cost no-op, ``FaultPoint(plan)`` defers to the plan."""

    __slots__ = ("plan",)

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan

    def check(self, site: str) -> None:
        if self.plan is not None:
            self.plan.check(site)

    def __bool__(self) -> bool:
        return self.plan is not None


# ----------------------------------------------------------------------
# bounded retry with per-site visibility
# ----------------------------------------------------------------------
#
# A retry that succeeds used to be invisible: only the final failure
# surfaced, so a flaky disk retrying on every read looked identical to
# a healthy one.  Every retry_transient site now records its attempt
# accounting here (and into the obs registry), and debugging surfaces
# (stream_engine.resume_info, tiling.DecodeReport) report it.

_RETRY_LOCK = threading.Lock()
_RETRY_STATS: Dict[str, Dict[str, object]] = {}


def _record_retry(site: str, attempts: int, retried: int, ok: bool,
                  error: Optional[BaseException]) -> None:
    from .. import obs

    with _RETRY_LOCK:
        st = _RETRY_STATS.setdefault(site, {
            "calls": 0, "attempts": 0, "retries": 0,
            "failures": 0, "last_outcome": None, "last_error": None,
        })
        st["calls"] += 1
        st["attempts"] += attempts
        st["retries"] += retried
        if ok:
            st["last_outcome"] = "ok"
        else:
            st["failures"] += 1
            st["last_outcome"] = "failed"
            st["last_error"] = repr(error)
    obs.counter(f"faults.retry.{site}.attempts").add(attempts)
    if retried:
        obs.counter(f"faults.retry.{site}.retries").add(retried)
        obs.instant_event("faults.retry", site=site, retried=retried,
                          outcome="ok" if ok else "failed")
    if not ok:
        obs.counter(f"faults.retry.{site}.failures").add(1)


def retry_stats(site: Optional[str] = None):
    """Per-site retry accounting since process start (or last reset):
    ``{site: {calls, attempts, retries, failures, last_outcome,
    last_error}}`` -- or one site's dict (empty if never seen)."""
    with _RETRY_LOCK:
        if site is not None:
            return dict(_RETRY_STATS.get(site, {}))
        return {s: dict(st) for s, st in _RETRY_STATS.items()}


def reset_retry_stats() -> None:
    with _RETRY_LOCK:
        _RETRY_STATS.clear()


def retry_transient(fn: Callable[[], object], *, retries: int = 3,
                    backoff: float = 0.01,
                    retry_on: tuple = (OSError,),
                    on_retry: Optional[Callable[[int, BaseException], None]]
                    = None, site: Optional[str] = None):
    """Run ``fn`` with bounded retry + exponential backoff on transient
    errors.  ``InjectedThreadDeath`` (BaseException) always escapes.

    ``retries`` is the number of *re*-attempts: the function runs at
    most ``retries + 1`` times.  The final failure is re-raised as-is
    so callers keep the typed error.  ``site`` names the call site for
    ``retry_stats`` / obs accounting, so retries that eventually
    SUCCEED are still visible afterwards.
    """
    attempt = 0
    while True:
        try:
            out = fn()
        except retry_on as e:
            attempt += 1
            if attempt > retries:
                if site is not None:
                    _record_retry(site, attempt, attempt - 1, False, e)
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff > 0:
                time.sleep(backoff * (2.0 ** (attempt - 1)))
        else:
            if site is not None:
                _record_retry(site, attempt + 1, attempt, True, None)
            return out
