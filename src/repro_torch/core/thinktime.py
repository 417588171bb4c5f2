"""Think-time model (paper §3.1, §5.3).

Prior: a lognormal fit to the paper's Data 100 statistics (many fast cell
re-executions, heavy tail; 75th-percentile think time = 23 s).  With median
6 s and P75 = 23 s the lognormal parameters are mu = ln 6, sigma =
(ln 23 − ln 6) / z_{0.75}.  As the system observes the specific user, the
model updates by conjugate-style blending of the prior with the empirical
log-sample moments (the paper: "this distribution can be updated to better
capture the behavior of the specific user").
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_Z75 = 0.6744897501960817  # Phi^{-1}(0.75)

PRIOR_MEDIAN_S = 6.0
PRIOR_P75_S = 23.0


@dataclass
class ThinkTimeModel:
    """Lognormal think-time model with online updates."""

    prior_mu: float = math.log(PRIOR_MEDIAN_S)
    prior_sigma: float = (math.log(PRIOR_P75_S) - math.log(PRIOR_MEDIAN_S)) / _Z75
    prior_weight: float = 8.0  # pseudo-observations behind the prior
    _samples: List[float] = field(default_factory=list)

    # -- posterior parameters ---------------------------------------------------
    def _params(self) -> tuple[float, float]:
        if not self._samples:
            return self.prior_mu, self.prior_sigma
        logs = np.log(np.maximum(self._samples, 1e-3))
        n = len(logs)
        w = self.prior_weight
        mu = (w * self.prior_mu + logs.sum()) / (w + n)
        if n > 1:
            var_emp = float(np.var(logs, ddof=1))
        else:
            var_emp = self.prior_sigma**2
        var = (w * self.prior_sigma**2 + n * var_emp) / (w + n)
        return float(mu), math.sqrt(max(var, 1e-6))

    # -- API ---------------------------------------------------------------------
    def update(self, think_seconds: float) -> None:
        if think_seconds > 0:
            self._samples.append(float(think_seconds))

    def median(self) -> float:
        mu, _ = self._params()
        return math.exp(mu)

    def mean(self) -> float:
        mu, sigma = self._params()
        return math.exp(mu + 0.5 * sigma**2)

    def quantile(self, q: float) -> float:
        from math import erf, sqrt

        mu, sigma = self._params()
        # inverse CDF via scipy-free rational approximation (Acklam)
        z = _norm_ppf(q)
        return math.exp(mu + sigma * z)

    def predict(self) -> float:
        """Point prediction used by the optimizer (median = robust)."""
        return self.median()

    def sample(self, rng: np.random.Generator, n: Optional[int] = None):
        mu, sigma = self._params()
        return rng.lognormal(mu, sigma, size=n)

    def cdf(self, t: float) -> float:
        mu, sigma = self._params()
        if t <= 0:
            return 0.0
        return 0.5 * (1 + math.erf((math.log(t) - mu) / (sigma * math.sqrt(2))))

    def hazard_after(self, t: float) -> float:
        """P(interaction arrives in the next instant | none yet at t) — used by
        the think-time-aware partitioner (paper §5.1)."""
        mu, sigma = self._params()
        if t <= 0:
            return 0.0
        z = (math.log(t) - mu) / sigma
        pdf = math.exp(-0.5 * z * z) / (t * sigma * math.sqrt(2 * math.pi))
        sf = 1.0 - self.cdf(t)
        return pdf / max(sf, 1e-12)


def _norm_ppf(p: float) -> float:
    """Acklam's inverse normal CDF approximation (|eps| < 1.15e-9)."""
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0,1)")
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
            (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        )
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
        ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
    )
