"""Clock abstraction: real wall time vs. deterministic virtual time.

Simulation mode executes operators *for real* (results are exact) but accounts
latency on a virtual clock whose increments come from the cost model — this is
what makes the paper-figure benchmarks reproducible on any machine, like the
paper's own think-time-injection methodology (§6: "think time was injected
into the notebook from the distribution presented in Figure 3").
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def advance(self, dt: float) -> None:
        raise NotImplementedError

    @property
    def virtual(self) -> bool:
        raise NotImplementedError


@dataclass
class RealClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def advance(self, dt: float) -> None:  # real time cannot be advanced
        pass

    @property
    def virtual(self) -> bool:
        return False


@dataclass
class VirtualClock(Clock):
    _t: float = 0.0

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError("time moves forward")
        self._t += dt

    @property
    def virtual(self) -> bool:
        return True
