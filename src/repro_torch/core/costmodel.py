"""Operator cost model with online calibration (paper §4.1, §5.2).

The paper augments the operator DAG with runtime statistics as cells execute;
we keep per-op-class throughputs (seconds/row) updated by an EWMA of observed
executions, plus row-count estimation rules so unexecuted operators get cost
estimates (needed by the scheduler's delivery costs and the cache's
recomputation costs).

Costs are *simulated-seconds* in simulation mode (driven by synthetic
``io_seconds``-style annotations) and wall-seconds in real mode — the model is
agnostic, it just learns from whatever ``observe`` feeds it.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .dag import DAG, Node

# Default per-row costs (seconds/row) before any calibration.  These only
# matter until the first observation of each op class; magnitudes are from
# single-core columnar throughputs (~1e8 rows/s scans, slower UDF/sorts).
DEFAULT_UNIT_COST: Dict[str, float] = {
    "read_table": 2e-7,
    "apply": 1e-6,
    "sort_values": 5e-7,
    "groupby_agg": 4e-7,
    "join": 5e-7,
    "describe": 2e-7,
    "value_counts": 2e-7,
}
FALLBACK_UNIT_COST = 1e-7
MIN_COST = 1e-6  # floor so zero-row ops still cost something to schedule

# Row estimators: est rows of node given parent rows.
_SELECTIVITY_DEFAULT = 0.5
_GROUP_FRACTION_DEFAULT = 0.01


def _est_rows(node: Node) -> float:
    if node.est_rows is not None:
        return float(node.est_rows)
    parent_rows = [(_est_rows(p)) for p in node.parents] or [0.0]
    top = max(parent_rows)
    op = node.op
    if op in ("filter", "filter_cmp", "isin", "between", "dropna"):
        return top * _SELECTIVITY_DEFAULT
    if op in ("head", "tail"):
        k = node.literals[0] if node.literals else 5
        return float(min(top, k))
    if op in ("groupby_agg", "value_counts", "unique"):
        return max(1.0, top * _GROUP_FRACTION_DEFAULT)
    if op in ("describe", "mean", "sum", "count", "min", "max", "std", "columns"):
        return 1.0
    return top


@dataclass
class _OpStats:
    unit_cost: float
    n_obs: int = 0


@dataclass
class CostModel:
    """Per-op-class EWMA throughput model.

    On top of the EWMA there is an explicit *calibration* path for the kernel
    backends: the frame layer records measured ``(op, backend, rows, seconds)``
    samples as units execute (:meth:`add_sample`), and :meth:`calibrate` fits
    per-``(op, backend)`` unit costs by least squares through the origin.
    Setting :attr:`active_backend` makes estimation consult the fitted costs
    for that backend, so virtual-clock benchmarks stay faithful to whichever
    backend actually runs the partials.
    """

    ewma_alpha: float = 0.3
    active_backend: Optional[str] = None
    # real-mode auto-recalibration: refit after every N new measured samples
    # (0 = only explicit calibrate() calls)
    auto_calibrate_every: int = 0
    # sliding per-key sample window: bounds calibrate() work and memory in
    # long-lived sessions, and makes the fit track throughput drift
    max_samples_per_key: int = 1024
    # monotone estimate version: bumped whenever anything that can change
    # cost()/unit_cost() output changes (EWMA observation, recalibration,
    # persisted-cost load) — consumers memoising cost-derived values key
    # their invalidation on it (see Scheduler._sync_caches)
    version: int = 0
    _stats: Dict[str, _OpStats] = field(default_factory=dict)
    # raw measured samples: (op, backend) -> [(rows, seconds), ...]
    _samples: Dict[Tuple[str, str], List[Tuple[float, float]]] = field(
        default_factory=dict
    )
    # fitted per-backend unit costs (seconds/row), set by calibrate()
    _backend_unit_cost: Dict[Tuple[str, str], float] = field(default_factory=dict)
    # fitted per-backend fixed dispatch overhead (seconds/call): the affine
    # intercept of calibrate()'s fit — what makes small partitions stop
    # looking free on jit backends (the planner's "dispatch tax" term)
    _backend_overhead: Dict[Tuple[str, str], float] = field(default_factory=dict)
    # planner decision counters: "op|backend|reason" -> count.  Persisted with
    # the fitted costs so mis-planning is visible across sessions and in the
    # bench drift gate.
    planner_decisions: Dict[str, int] = field(default_factory=dict)
    _samples_since_calibrate: int = 0

    # -- estimation ------------------------------------------------------------
    def unit_cost(self, op: str, backend: Optional[str] = None) -> float:
        bk = backend or self.active_backend
        if bk is not None:
            fitted = self._backend_unit_cost.get((op, bk))
            if fitted is not None:
                return fitted
        st = self._stats.get(op)
        if st is not None:
            return st.unit_cost
        return DEFAULT_UNIT_COST.get(op, FALLBACK_UNIT_COST)

    def est_rows(self, node: Node) -> float:
        return _est_rows(node)

    # -- size-aware estimation (the planner's estimate/perform split) ------------
    def estimate(self, op: str, backend: str, rows: float) -> Optional[float]:
        """Predicted wall seconds for one dispatch of ``op`` on ``backend``
        at ``rows`` rows: ``unit_cost * rows + overhead`` from the affine
        calibration fit.  Returns ``None`` when the key has never been
        calibrated (callers fall back to priors or the precedence chain) —
        a missing key must never silently estimate as free."""
        a = self._backend_unit_cost.get((op, backend))
        if a is None:
            return None
        b = self._backend_overhead.get((op, backend), 0.0)
        return a * max(float(rows), 0.0) + b

    def estimate_dispatches(
        self, op: str, backend: str, rows_per_dispatch: float, n_dispatches: int
    ) -> Optional[float]:
        """``n_dispatches`` × the affine per-dispatch estimate: the cost of
        running one partial per partition, each paying the overhead intercept
        — the term a single collective (sharded) dispatch amortises away.
        None when the key has never been calibrated, like :meth:`estimate`."""
        per = self.estimate(op, backend, rows_per_dispatch)
        if per is None:
            return None
        return per * max(int(n_dispatches), 1)

    def has_calibration(self, op: str, backend: str) -> bool:
        return (op, backend) in self._backend_unit_cost

    def overhead(self, op: str, backend: str) -> float:
        return self._backend_overhead.get((op, backend), 0.0)

    def install_prior(
        self, op: str, backend: str, unit_cost: float, overhead: float = 0.0
    ) -> None:
        """Seed a (unit_cost, overhead) pair for a key with no measured
        samples yet — cold-start priors (e.g. the committed bench verdicts).
        Measured calibration overwrites the prior at the next refit."""
        if (op, backend) not in self._backend_unit_cost:
            self._backend_unit_cost[(op, backend)] = max(float(unit_cost), 1e-12)
            self._backend_overhead[(op, backend)] = max(float(overhead), 0.0)
            self.version += 1

    def note_planner_decision(self, op: str, backend: str, reason: str) -> None:
        key = f"{op}|{backend}|{reason}"
        self.planner_decisions[key] = self.planner_decisions.get(key, 0) + 1

    def planner_report(self) -> Dict[str, int]:
        return dict(sorted(self.planner_decisions.items()))

    def cost(self, node: Node) -> float:
        """Estimated cost (seconds) of executing ``node`` alone, inputs ready.

        Explicit per-node cost annotations (synthetic workloads, simulated IO)
        take precedence: ``node.kwargs['cost_s']``.
        """
        explicit = node.kwargs.get("cost_s")
        if explicit is not None:
            return float(explicit)
        # work is driven by the larger of input/output rows
        rows = max([_est_rows(node)] + [_est_rows(p) for p in node.parents])
        return max(MIN_COST, rows * self.unit_cost(node.op))

    # -- delivery cost (paper §5.2) --------------------------------------------
    def delivery_cost(self, node: Node, executed: Iterable[int]) -> float:
        """Cost of executing ``node`` along with all unexecuted predecessors;
        zero if already executed (paper's c_j)."""
        done = set(executed)
        if node.nid in done:
            return 0.0
        total = 0.0
        seen: set[int] = set()
        stack = [node]
        while stack:
            n = stack.pop()
            if n.nid in seen or n.nid in done:
                continue
            seen.add(n.nid)
            total += self.cost(n)
            stack.extend(n.parents)
        return total

    def recompute_cost(self, node: Node, cached: Iterable[int]) -> float:
        """Paper's k_i: recomputation cost of a materialised result, reusing
        other materialised results (never recompute from scratch if ancestors
        are cached)."""
        cached_set = set(cached) - {node.nid}
        return self.delivery_cost(node, cached_set)

    # -- calibration -----------------------------------------------------------
    def observe(self, node: Node, seconds: float, rows: Optional[float] = None) -> None:
        rows = rows if rows is not None else max(
            [_est_rows(node)] + [_est_rows(p) for p in node.parents]
        )
        rows = max(rows, 1.0)
        per_row = seconds / rows
        st = self._stats.get(node.op)
        if st is None:
            self._stats[node.op] = _OpStats(unit_cost=per_row, n_obs=1)
        else:
            st.unit_cost = (1 - self.ewma_alpha) * st.unit_cost + self.ewma_alpha * per_row
            st.n_obs += 1
        self.version += 1

    # -- per-backend calibration (measured wall-time samples) -------------------
    def add_sample(self, op: str, backend: str, rows: float, seconds: float) -> None:
        """Record one measured unit execution for later calibration.

        With :attr:`auto_calibrate_every` set (real mode), the fit refreshes
        itself every N samples, so long sessions track throughput drift
        (thermal throttling, contended machines) without an explicit
        :meth:`calibrate` call.  Per-key history is a sliding window
        (:attr:`max_samples_per_key`), so the refit stays O(keys × window)
        and memory stays bounded over arbitrarily long sessions."""
        bucket = self._samples.setdefault((op, backend), [])
        bucket.append((max(float(rows), 1.0), max(float(seconds), 0.0)))
        if len(bucket) > self.max_samples_per_key:
            del bucket[: len(bucket) - self.max_samples_per_key]
        self._samples_since_calibrate += 1
        if (
            self.auto_calibrate_every > 0
            and self._samples_since_calibrate >= self.auto_calibrate_every
        ):
            self.calibrate()

    def calibrate(self) -> Dict[Tuple[str, str], float]:
        """Fit per-(op, backend) unit costs from the recorded samples.

        Affine least squares: ``seconds ≈ unit_cost * rows + overhead`` —
        the intercept is the fixed per-dispatch cost (jit launch, host↔device
        round-trip) that dominates small partitions, and is what lets the
        planner's :meth:`estimate` stop routing tiny dispatches to a backend
        whose per-row throughput only wins at scale.  When the sample set has
        no row-count spread (a single partition size) the affine system is
        degenerate; the fit falls back to least squares through the origin
        (Σ r·s / Σ r²), with zero overhead.  Negative intercepts (noise) are
        clamped by refitting through the origin.  Returns the fitted
        unit-cost map (also installed for :meth:`unit_cost`).
        """
        for key, samples in self._samples.items():
            n = len(samples)
            sr = sum(r for r, _ in samples)
            sr2 = sum(r * r for r, _ in samples)
            if sr2 <= 0:
                continue
            srs = sum(r * s for r, s in samples)
            ss = sum(s for _, s in samples)
            det = n * sr2 - sr * sr
            a = b = None
            if n >= 2 and det > 1e-9 * n * sr2:  # genuine row-count spread
                a = (n * srs - sr * ss) / det
                b = (sr2 * ss - sr * srs) / det
            if a is None or a <= 0 or b < 0:
                a, b = srs / sr2, 0.0
            self._backend_unit_cost[key] = max(a, 1e-12)
            self._backend_overhead[key] = max(b, 0.0)
        self._samples_since_calibrate = 0
        self.version += 1
        return dict(self._backend_unit_cost)

    def samples(self) -> Dict[Tuple[str, str], List[Tuple[float, float]]]:
        return {k: list(v) for k, v in self._samples.items()}

    def drift_report(
        self,
        baseline: Dict[str, float],
        rel_tol: float = 3.0,
    ) -> Dict[str, dict]:
        """Compare freshly fitted unit costs against a persisted baseline
        (``{"op|backend": unit_cost}``, the :meth:`save` schema) and flag
        keys whose cost moved by more than ``rel_tol``× in either direction.

        This is the CI drift alert: a calibration regression — a kernel
        suddenly 3× slower, or a fit collapsing to the 1e-12 floor — fails
        the bench-smoke job loudly instead of silently skewing every
        scheduling and eviction decision downstream.  Keys present on only
        one side are reported as ``missing_current`` / ``missing_baseline``
        (informational; new ops are expected as the repo grows).
        """
        report: Dict[str, dict] = {}
        current = {
            f"{op}|{bk}": cost
            for (op, bk), cost in self._backend_unit_cost.items()
        }
        for key in sorted(set(baseline) | set(current)):
            base, cur = baseline.get(key), current.get(key)
            if base is None:
                report[key] = {"status": "missing_baseline", "current": cur}
            elif cur is None:
                report[key] = {"status": "missing_current", "baseline": base}
            else:
                ratio = cur / base if base > 0 else float("inf")
                status = (
                    "drift" if ratio > rel_tol or ratio < 1.0 / rel_tol else "ok"
                )
                report[key] = {
                    "status": status,
                    "baseline": base,
                    "current": cur,
                    "ratio": round(ratio, 4),
                }
        return report

    # -- persistence (fitted costs survive across sessions) ----------------------
    def state_fingerprint(self) -> str:
        """Content hash of everything that can change cost()/unit_cost()
        output: fitted per-backend costs and overheads, the per-op EWMA
        state, and the active backend.  Floats are hashed via repr (shortest
        round-trip), so two models agree iff their estimates are bit-equal —
        the validity token for persisting cost-derived memos (see
        Scheduler.save_memos/load_memos)."""
        h = hashlib.blake2b(digest_size=16)
        for (op, bk), cost in sorted(self._backend_unit_cost.items()):
            h.update(f"u:{op}|{bk}={cost!r};".encode())
        for (op, bk), ovh in sorted(self._backend_overhead.items()):
            h.update(f"o:{op}|{bk}={ovh!r};".encode())
        for op, st in sorted(self._stats.items()):
            h.update(f"e:{op}={st.unit_cost!r},{st.n_obs};".encode())
        h.update(f"b:{self.active_backend};a:{self.ewma_alpha!r}".encode())
        return h.hexdigest()

    def save(self, path: str) -> None:
        """Dump the fitted per-(op, backend) unit costs (plus the per-op EWMA
        state) as JSON, so a fresh session starts from calibrated estimates
        instead of the static defaults."""
        payload = {
            "version": 2,
            "unit_costs": {
                f"{op}|{bk}": cost
                for (op, bk), cost in sorted(self._backend_unit_cost.items())
            },
            "overheads": {
                f"{op}|{bk}": ovh
                for (op, bk), ovh in sorted(self._backend_overhead.items())
                if ovh > 0.0
            },
            "planner_decisions": dict(sorted(self.planner_decisions.items())),
            "op_ewma": {
                op: {"unit_cost": st.unit_cost, "n_obs": st.n_obs}
                for op, st in sorted(self._stats.items())
            },
        }
        # crash-safe write: unique temp name (two sessions saving to the same
        # path must not clobber each other's half-written temp), fsync before
        # the atomic rename (a crash after replace() must not leave a torn
        # file), and temp cleanup on any failure
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load(self, path: str) -> bool:
        """Install previously fitted costs; returns False if the file is
        missing, unreadable, or malformed (the model keeps its defaults —
        a corrupted persisted file must never prevent a session starting).
        Installation is all-or-nothing: the payload is validated into
        staging dicts before anything is applied."""
        try:
            with open(path) as f:
                payload = json.load(f)
            # rpartition: the backend never contains "|" but fused op keys do
            # (e.g. "fused:filter|describe|xla" → op "fused:filter|describe")
            unit_costs = {}
            for key, cost in payload.get("unit_costs", {}).items():
                op, _, bk = key.rpartition("|")
                if op and bk:
                    unit_costs[(op, bk)] = float(cost)
            overheads = {}
            for key, ovh in payload.get("overheads", {}).items():
                op, _, bk = key.rpartition("|")
                if op and bk:
                    overheads[(op, bk)] = max(float(ovh), 0.0)
            decisions = {
                str(k): int(v)
                for k, v in payload.get("planner_decisions", {}).items()
            }
            op_ewma = {
                op: _OpStats(
                    unit_cost=float(st["unit_cost"]), n_obs=int(st.get("n_obs", 1))
                )
                for op, st in payload.get("op_ewma", {}).items()
            }
        except (OSError, ValueError, TypeError, AttributeError, KeyError):
            return False
        self._backend_unit_cost.update(unit_costs)
        self._backend_overhead.update(overheads)
        for k, v in decisions.items():
            self.planner_decisions[k] = self.planner_decisions.get(k, 0) + v
        self._stats.update(op_ewma)
        self.version += 1
        return True
