"""Progressive interaction path: bounded estimates that upgrade in place.

A blocking interaction on a partially-executed node normally waits for 100%
of the partitions.  But every blocking operator here is a monoid (partial
units + associative combine), so the completed subset of partitions already
determines a statistically meaningful estimate of the final answer — the
"Progressive Analytics" observation layered on the paper's partial/combine
decomposition.  :class:`ProgressiveResult` is the channel that carries it:

* construction replays any checkpointed partials into the op's *running
  combine* (see ``frame/blocking.py``) and registers a streaming listener
  with the executor, so every partition completed afterwards — foreground
  refinement, think-time background execution, the real-mode worker — folds
  into the estimate the moment it lands;
* :meth:`estimate` returns a :class:`BoundedEstimate` — the current value in
  the exact result's shape, per-statistic confidence intervals, and the
  partition-coverage fraction;
* :meth:`refine` executes the next sample-first slice of missing partitions;
  :meth:`upgrade` runs to completion; iteration yields successive estimates
  until exact.

Exactness-on-completion guarantee: the estimate channel NEVER produces the
final value.  When coverage reaches 100% the node is finalised through the
executor's ordinary ``execute`` → ``combine(prog.ordered())`` path — unit
results combined in index order, identical to the non-progressive path — so
the completed progressive result is bit-for-bit equal to the exact one.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from . import faults
from .scheduler import sample_first_order


@dataclass
class BoundedEstimate:
    """One snapshot of a progressive result.

    ``intervals`` maps statistic labels (e.g. column names for describe/mean,
    ``"count[value]"`` for value_counts, ``"agg[key]"`` for groupby) to 95%
    confidence bounds; empty when exact or when the op has no estimator.
    ``value`` is ``None`` for coverage-only ops (no running combine) until
    the node completes."""

    value: Any
    coverage: float
    intervals: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    exact: bool = False
    n_units: int = 0
    total_units: int = 0


class ProgressiveResult:
    """Handle to an in-flight interaction: bounded estimate + upgrade path.

    Thread-safety: the executor may stream unit results from the real-mode
    worker thread while the owning thread polls :meth:`estimate`; all
    listener/combine state is guarded by an internal mutex (never held while
    calling into the engine)."""

    def __init__(
        self,
        engine,
        node,
        inputs: Sequence[Any],
        combine: Optional[Any],
        total_units: int,
        tenant: Optional[str] = None,
    ):
        self._engine = engine
        self.node = node
        # strong refs: cache eviction of the parents must not break refinement
        self._inputs = list(inputs)
        self._combine = combine
        self.total_units = total_units
        self.tenant = tenant
        self._units = None  # prebuilt Unit list, reused across refinements
        self._seen: set = set()
        self._mutex = threading.Lock()

    # -- streaming (called by Executor._store_unit, any thread) ---------------
    def _on_unit(self, index: int, result: Any) -> None:
        if faults.is_corrupt(result):
            return  # poisoned units never reach the estimate channel
        with self._mutex:
            if index in self._seen:
                return
            self._seen.add(index)
            if self._combine is not None:
                self._combine.update(index, result)

    # -- inspection -----------------------------------------------------------
    @property
    def n_units(self) -> int:
        with self._mutex:
            return len(self._seen)

    @property
    def coverage(self) -> float:
        if self.total_units <= 0:
            return 1.0
        return min(len(self._seen) / self.total_units, 1.0)

    def estimate(self) -> BoundedEstimate:
        """Current bounded estimate; the exact cached value once complete."""
        eng = self._engine
        with eng._lock:
            value = eng.cache.peek(self.node.nid)
        if value is not None and not faults.is_corrupt(value):
            return BoundedEstimate(
                value=value,
                coverage=1.0,
                intervals={},
                exact=True,
                n_units=self.total_units,
                total_units=self.total_units,
            )
        with self._mutex:
            k = len(self._seen)
            cov = min(k / self.total_units, 1.0) if self.total_units > 0 else 0.0
            if self._combine is None:
                return BoundedEstimate(
                    value=None, coverage=cov, intervals={},
                    exact=False, n_units=k, total_units=self.total_units,
                )
            value, intervals = self._combine.snapshot(cov)
        return BoundedEstimate(
            value=value, coverage=cov, intervals=intervals,
            exact=False, n_units=k, total_units=self.total_units,
        )

    # -- refinement ordering --------------------------------------------------
    def refinement_order(self, missing: Sequence[int]) -> List[int]:
        """Scheduler-aware refinement: ask the running combine which missing
        partitions would shrink the *widest live confidence interval* fastest
        (``unit_priority`` — see frame/blocking.py), falling back to the
        sample-first bit-reversal lattice for combines without one.  The
        ordering is advisory: any estimator failure, or a permutation that
        doesn't cover ``missing`` exactly, degrades to the lattice — exact
        completion semantics never depend on it."""
        total = self.total_units or len(missing)
        with self._mutex:
            combine = self._combine
        prio = getattr(combine, "unit_priority", None)
        if prio is not None:
            try:
                order = prio(list(missing), total)
            except Exception:  # pragma: no cover - defensive
                order = None
            if order is not None and sorted(order) == sorted(missing):
                return list(order)
        return sample_first_order(missing, total)

    # -- upgrading ------------------------------------------------------------
    def refine(self, units: int = 1) -> BoundedEstimate:
        """Execute up to ``units`` more partitions (sample-first order) and
        return the tightened estimate.  Completing the last partition
        finalises through the exact combine path."""
        eng = self._engine
        eng._pause_worker()
        try:
            with eng._lock:
                eng._progressive_step(self, units)
        finally:
            eng._resume_worker()
        return self.estimate()

    def upgrade(self) -> Any:
        """Run the node to completion and return the exact value (bit-for-bit
        equal to the non-progressive interaction)."""
        eng = self._engine
        eng._pause_worker()
        try:
            with eng._lock:
                if self.node.nid not in eng.cache:
                    eng._progressive_step(self, self.total_units or 1)
                value = eng.cache.peek(self.node.nid)
                if value is None or faults.is_corrupt(value):
                    value = eng._ensure(self.node)
                return value
        finally:
            eng._resume_worker()

    def __iter__(self) -> Iterator[BoundedEstimate]:
        """Yield successively tighter estimates until the exact result.

        The final yielded estimate has ``exact=True`` and carries the
        bit-for-bit exact value."""
        step = max(1, self.total_units // 8)
        while True:
            est = self.estimate()
            yield est
            if est.exact:
                return
            self.refine(step)
