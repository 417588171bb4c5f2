"""Seeded, deterministic fault injection for the opportunistic engine.

The paper's value proposition is that background speculation is *free* — which
only holds if a background failure can never cost the user anything.  This
module is the chaos harness that lets tests, benchmarks, and CI prove it: a
:class:`FaultPlan` describes *where* faults fire (named injection sites),
*how* (failure modes), and *how often* (a seeded Bernoulli rate), and the
engine threads the plan through every layer that can fail at run time.

Injection sites
---------------

==============  =============================================================
``kernel``      inside the frame backend's guarded kernel dispatch
                (``frame/backend.py``), i.e. "an XLA executable blew up at
                run time".  Fires on foreground *and* background dispatches —
                the runtime numpy fallback + circuit breaker must absorb both.
``exec.unit``   around one background partition unit / batch in the executor
                ("a poisoned partition").  Background-only by default: a
                foreground unit failure is a genuine user-facing error.
``cache.put``   :meth:`MaterializedCache.put` (background-only by default).
``cache.get``   :meth:`MaterializedCache.get` (background-only by default).
==============  =============================================================

Failure modes
-------------

==============  =============================================================
``raise``       raise :class:`InjectedFault` (a generic runtime error)
``oom``         raise :class:`InjectedResourceExhausted` (XLA
                ``RESOURCE_EXHAUSTED``-style resource error)
``hang``        sleep ``latency_s`` wall seconds, then proceed normally —
                exercises the worker stall watchdog, never corrupts results
``corrupt``     replace the produced value with a :class:`Corrupted` wrapper;
                every consumption boundary (executor combine, worker cache
                put, interactive ``_ensure``) checks :func:`is_corrupt` and
                treats a wrapped value as a detected integrity failure
==============  =============================================================

Activation: ``Engine(fault_plan=FaultPlan(...))`` for tests/benchmarks, or the
``REPRO_FAULTS`` environment variable for CI chaos runs, e.g.::

    REPRO_FAULTS="kernel:raise:0.1,exec.unit:corrupt:0.02" \
    REPRO_FAULTS_SEED=7 python benchmarks/bench_faults.py --smoke

Determinism: every prospective injection point draws exactly once from one
seeded RNG, so a single-threaded (simulation-mode) run fires the identical
fault sequence on every execution with the same seed.
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from random import Random
from typing import Any, Dict, List, Optional, Sequence, Tuple

ENV_VAR = "REPRO_FAULTS"
ENV_SEED_VAR = "REPRO_FAULTS_SEED"

SITES = ("kernel", "exec.unit", "cache.put", "cache.get")
MODES = ("raise", "oom", "hang", "corrupt")

# sites that may fire on the foreground (interactive) path: only the kernel
# dispatch site, whose failures are absorbed by the runtime numpy fallback.
# Everything else defaults to background-only — an injected foreground fault
# there would *manufacture* the user-facing failure the harness exists to
# rule out.
_FOREGROUND_SAFE_SITES = frozenset({"kernel"})


class InjectedFault(RuntimeError):
    """A fault raised by the injection harness (generic runtime failure)."""


class InjectedResourceExhausted(InjectedFault):
    """OOM-style resource error (models XLA ``RESOURCE_EXHAUSTED``)."""


class CorruptResult(RuntimeError):
    """An integrity boundary detected a :class:`Corrupted` value."""


class Corrupted:
    """Detectably-corrupted stand-in for a real value.

    Real silent corruption is undetectable by construction; the harness models
    the *detected* kind (a validation/checksum layer catching garbage) by
    wrapping the value.  Integrity boundaries call :func:`is_corrupt` and
    must never let a wrapped value reach the user.
    """

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Corrupted({self.value!r})"


def corrupt(value: Any) -> Corrupted:
    return value if isinstance(value, Corrupted) else Corrupted(value)


def is_corrupt(value: Any) -> bool:
    return isinstance(value, Corrupted)


@dataclass(frozen=True)
class FaultSpec:
    """One injection rule: fire ``mode`` at ``site`` with probability ``rate``.

    ``ops`` restricts the rule to specific operator names (``None`` = all);
    ``max_fires`` bounds total activations (``None`` = unbounded);
    ``background_only`` defaults per site (see module docstring) and may be
    forced either way.
    """

    site: str
    mode: str = "raise"
    rate: float = 1.0
    ops: Optional[Tuple[str, ...]] = None
    latency_s: float = 0.05  # "hang" mode sleep
    max_fires: Optional[int] = None
    background_only: Optional[bool] = None

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; expected one of {SITES}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; expected one of {MODES}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")

    @property
    def effective_background_only(self) -> bool:
        if self.background_only is not None:
            return self.background_only
        return self.site not in _FOREGROUND_SAFE_SITES


class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules plus firing bookkeeping.

    Thread-safe: the engine's real-mode worker and the interactive thread
    both consult the plan concurrently.  ``fired`` / ``checked`` counters are
    the observability surface the fault benchmark and tests assert on.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self._rng = Random(seed)
        self._lock = threading.Lock()
        self.checked: Dict[str, int] = {}
        self.fired: Dict[Tuple[str, str], int] = {}
        self._fires_per_spec: Dict[int, int] = {}

    # -- construction helpers --------------------------------------------------
    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """``"site:mode:rate[,site:mode:rate...]"`` → plan (CI chaos syntax)."""
        specs = []
        for chunk in text.split(","):
            chunk = chunk.strip()
            if not chunk:
                continue
            parts = chunk.split(":")
            if len(parts) != 3:
                raise ValueError(
                    f"bad fault spec {chunk!r}; expected 'site:mode:rate'"
                )
            specs.append(FaultSpec(parts[0], parts[1], float(parts[2])))
        return cls(specs, seed=seed)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """Build a plan from ``REPRO_FAULTS`` (None when unset/empty)."""
        text = os.environ.get(ENV_VAR, "").strip()
        if not text:
            return None
        return cls.parse(text, seed=int(os.environ.get(ENV_SEED_VAR, "0")))

    # -- firing ----------------------------------------------------------------
    def fire(self, site: str, op: Optional[str] = None) -> Optional[str]:
        """One prospective injection point.

        Draws once per matching spec (deterministic under a fixed call order),
        executes the fault's side effect, and returns the fired mode — or
        raises, for the ``raise``/``oom`` modes.  ``"corrupt"`` is returned to
        the caller, which is responsible for wrapping its value;
        ``"hang"`` sleeps here and returns (latency only, results intact).
        """
        in_background = _STATE.__dict__.get("background", False)
        hit: Optional[FaultSpec] = None
        with self._lock:
            self.checked[site] = self.checked.get(site, 0) + 1
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.ops is not None and op not in spec.ops:
                    continue
                if spec.effective_background_only and not in_background:
                    continue
                if (
                    spec.max_fires is not None
                    and self._fires_per_spec.get(i, 0) >= spec.max_fires
                ):
                    continue
                if self._rng.random() >= spec.rate:
                    continue
                self._fires_per_spec[i] = self._fires_per_spec.get(i, 0) + 1
                key = (site, spec.mode)
                self.fired[key] = self.fired.get(key, 0) + 1
                hit = spec
                break
        if hit is None:
            return None
        if hit.mode == "raise":
            raise InjectedFault(f"injected fault at {site} (op={op})")
        if hit.mode == "oom":
            raise InjectedResourceExhausted(
                f"injected RESOURCE_EXHAUSTED at {site} (op={op})"
            )
        if hit.mode == "hang":
            time.sleep(hit.latency_s)
            return "hang"
        return "corrupt"

    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())

    def summary(self) -> dict:
        with self._lock:
            return {
                "seed": self.seed,
                "checked": dict(self.checked),
                "fired": {f"{s}:{m}": n for (s, m), n in sorted(self.fired.items())},
            }


# --------------------------------------------------------------------------- #
# thread-local plumbing                                                        #
#                                                                              #
# The active plan travels with the executing thread: the engine scopes its     #
# plan around unit execution, and the frame backend (module-level functions,   #
# several call layers down) retrieves it via current() at the kernel dispatch  #
# site.  A second flag marks "this thread is doing background work", gating    #
# the background-only sites.                                                   #
# --------------------------------------------------------------------------- #

_STATE = threading.local()


@contextmanager
def scope(plan: Optional["FaultPlan"]):
    """Make ``plan`` the thread's active plan for the duration (None = clear)."""
    prev = _STATE.__dict__.get("plan")
    _STATE.plan = plan
    try:
        yield
    finally:
        _STATE.plan = prev


def current() -> Optional[FaultPlan]:
    return _STATE.__dict__.get("plan")


@contextmanager
def background():
    """Mark the current thread as executing background (non-critical) work."""
    prev = _STATE.__dict__.get("background", False)
    _STATE.background = True
    try:
        yield
    finally:
        _STATE.background = prev


def in_background() -> bool:
    return _STATE.__dict__.get("background", False)


def fire(site: str, op: Optional[str] = None) -> Optional[str]:
    """Fire against the thread's active plan (no-op without one)."""
    plan = current()
    if plan is None:
        return None
    return plan.fire(site, op=op)
