"""Opportunistic evaluation engine (paper §4, §5) — the framework's core.

Ties together the operator DAG, critical-path slicing, the think-time
scheduler, the materialised-result cache, speculation, and preemptible
partition-granular execution:

* ``add``        — extend the DAG (hash-consed; specification only, no work)
* ``display``    — an *interaction*: preempt background work, execute only the
                   interaction critical path (with the head/tail partial-result
                   fast path), record latency
* ``think``      — (simulation) let virtual think time elapse; the scheduler
                   opportunistically executes non-critical operators until the
                   budget is exhausted (mid-partition progress is lost, completed
                   partitions are kept)
* ``start_background`` / ``stop_background`` — (real mode) a daemon worker doing
                   the same against wall time, preempted by ``display``

Two engines per process are fine; state is fully instance-local.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import faults
from .cache import EvictionPolicy, MaterializedCache
from .clock import Clock, RealClock, VirtualClock
from .costmodel import CostModel
from .dag import DAG, Node
from .executor import (
    Executor,
    OpRuntime,
    PartialProgress,
    Preempted,
    Registry,
)
from .faults import FaultPlan

logger = logging.getLogger("repro.engine")
from .predictor import InteractionPredictor
from .progressive import ProgressiveResult
from .scheduler import Policy, Scheduler, sample_first_order
from .slicing import critical_path, unexecuted_critical
from .speculation import SpeculationManager
from .thinktime import ThinkTimeModel


@dataclass
class InteractionRecord:
    label: str
    latency_s: float
    ops_executed: int
    partial: bool  # served via the head/tail partial-result path
    at: float
    tenant: Optional[str] = None  # multi-tenant serving attribution
    # served as a progressive bounded estimate (latency_s is then the
    # time-to-first-bounded-estimate, not time-to-exact)
    progressive: bool = False


@dataclass
class BackgroundFault:
    """One absorbed background failure (the worker survived it)."""

    nid: int
    op: str
    kind: str  # exception class name
    detail: str
    at: float


MAX_FAULT_RECORDS = 256  # bounded: a 100%-fault chaos run must not leak memory


@dataclass
class Metrics:
    interactions: List[InteractionRecord] = field(default_factory=list)
    sync_wait_s: float = 0.0
    think_s: float = 0.0
    background_busy_s: float = 0.0
    # fault-domain observability (chaos runs assert on these)
    background_faults: List[BackgroundFault] = field(default_factory=list)
    n_background_faults: int = 0
    worker_stalls: int = 0
    corrupt_results_dropped: int = 0
    quarantines: int = 0

    def record_background_fault(
        self, node: Node, exc: BaseException, at: float
    ) -> None:
        self.n_background_faults += 1
        self.background_faults.append(
            BackgroundFault(
                nid=node.nid,
                op=node.op,
                kind=type(exc).__name__,
                detail=str(exc)[:200],
                at=at,
            )
        )
        if len(self.background_faults) > MAX_FAULT_RECORDS:
            del self.background_faults[: len(self.background_faults) - MAX_FAULT_RECORDS]

    def summary(self) -> dict:
        return {
            "n_interactions": len(self.interactions),
            "sync_wait_s": round(self.sync_wait_s, 6),
            "think_s": round(self.think_s, 6),
            "background_busy_s": round(self.background_busy_s, 6),
            "mean_latency_s": round(
                sum(r.latency_s for r in self.interactions)
                / max(1, len(self.interactions)),
                6,
            ),
            "n_background_faults": self.n_background_faults,
            "worker_stalls": self.worker_stalls,
            "corrupt_results_dropped": self.corrupt_results_dropped,
            "quarantines": self.quarantines,
        }


class Engine:
    def __init__(
        self,
        budget_bytes: int = 2 << 30,
        mode: str = "sim",  # "sim" (virtual clock) | "real"
        policy: Policy = "utility",
        cache_policy: EvictionPolicy = "corrected",
        opportunistic: bool = True,  # False = eager baseline (paper's status quo)
        partial_results: bool = True,  # head/tail partial-result fast path
        speculation: bool = True,
        predictor: Optional[InteractionPredictor] = None,
        seed: int = 0,
        kernel_backend: Optional[str] = None,  # frame-layer columnar backend
        batching: bool = True,  # fused multi-partition background dispatches
        batch_loss_frac: float = 0.1,  # batch duration ≤ this × predicted think
        cost_model_path: Optional[str] = None,  # persist fitted unit costs
        recalibrate_every: int = 64,  # real mode: refit costs every N samples
        planner: bool = True,  # cost-based backend planning + chain fusion
        fault_plan: Optional[FaultPlan] = None,  # chaos harness (None: env)
        worker_ack_timeout_s: float = 60.0,  # pause-ack stall watchdog bound
        scheduler_memo_path: Optional[str] = None,  # persist scheduler memos
    ):
        self.dag = DAG()
        self.cost_model = CostModel()
        self.faults = fault_plan if fault_plan is not None else FaultPlan.from_env()
        self.worker_ack_timeout_s = worker_ack_timeout_s
        self.batching = batching
        self.batch_loss_frac = batch_loss_frac
        self.cost_model_path = cost_model_path
        # scheduler descendant/delivery-cost memos ride alongside the cost
        # model file by default; loading is explicit (load_scheduler_memos)
        # because the DAG fingerprint only matches once the program is rebuilt
        self.scheduler_memo_path = scheduler_memo_path or (
            f"{cost_model_path}.sched.json" if cost_model_path else None
        )
        if cost_model_path:
            self.cost_model.load(cost_model_path)
        if mode == "real":
            self.cost_model.auto_calibrate_every = recalibrate_every
        self.clock: Clock = VirtualClock() if mode == "sim" else RealClock()
        self.mode = mode
        self.kernel_backend = kernel_backend
        # cost-based backend planning (frame/planner.py): demote dispatches
        # to the cheaper backend by fitted estimate, fuse eligible linear
        # chains.  The frame runtime reads this at install time.
        self.planner_enabled = planner
        self.opportunistic = opportunistic
        self.partial_results = partial_results
        self.registry = Registry()
        self.cache = MaterializedCache(
            budget_bytes=budget_bytes,
            cost_model=self.cost_model,
            policy=cache_policy,
            fault_plan=self.faults,
        )
        self.think_time = ThinkTimeModel()
        self.predictor = predictor
        self.speculation = SpeculationManager(
            dag=self.dag,
            cache=self.cache,
            cost_model=self.cost_model,
            think_time=self.think_time,
            enabled=speculation,
        )
        self.scheduler = Scheduler(
            dag=self.dag,
            cost_model=self.cost_model,
            predictor=predictor,
            policy=policy,
            seed=seed,
            extra_utility=self.speculation.boost_for,
        )
        self.executor = Executor(
            self.registry, self.clock, self.cost_model, fault_plan=self.faults
        )
        # progressive refinement executes a spread of partitions before the
        # rest; applied only to nodes with a progress listener, so the exact
        # path's unit order is untouched
        self.executor.unit_order = sample_first_order
        self.partials: Dict[int, PartialProgress] = {}
        self.speculation.partials = self.partials
        self.cache.on_evict = lambda node: self.scheduler.evicted_once.add(node.nid)
        self.metrics = Metrics()
        # multi-tenant serving: when set (a list), every successful background
        # pick appends its nid here — together with the interaction hit/miss
        # sequence this is the replayable schedule log the determinism tests
        # compare byte-for-byte.  Worker-thread picks are NOT logged (real
        # mode is wall-clock nondeterministic by nature).
        self.pick_log: Optional[List[int]] = None
        self._lock = threading.RLock()
        self._last_op: Optional[str] = None
        self._last_output_at: Optional[float] = None
        # real-mode background worker
        self._worker: Optional[_BackgroundWorker] = None

    # ------------------------------------------------------------------ DAG --
    def add(
        self,
        op: str,
        parents: Sequence[Node] = (),
        literals: Sequence[Any] = (),
        kwargs: Optional[dict] = None,
        interaction: bool = False,
        est_rows: Optional[float] = None,
    ) -> Node:
        with self._lock:
            before = len(self.dag)
            node = self.dag.add(
                op, parents, literals, kwargs, interaction=interaction,
                est_rows=est_rows,
            )
            if len(self.dag) > before:  # genuinely new (not CSE-merged)
                if self.predictor is not None and self._last_op is not None:
                    self.predictor.observe_transition(self._last_op, op)
                self._last_op = op
                self.speculation.on_node_submitted(node)
            return node

    def register_op(self, op: str, impl: OpRuntime) -> None:
        self.registry.register(op, impl)

    def observe_interned_node(self, node: Node, is_new: bool) -> None:
        """Observation hook for nodes interned via ``cse.intern_program``.

        Interning bypasses :meth:`add`, so without this hook the interaction
        predictor's transition counts and the speculation manager never see
        multi-tenant submissions — the speculation blind spot.  Callers pass
        this as ``intern_program(..., observer=engine.observe_interned_node)``;
        it mirrors exactly the new-node block of :meth:`add`."""
        if not is_new:
            return
        with self._lock:
            if self.predictor is not None and self._last_op is not None:
                self.predictor.observe_transition(self._last_op, node.op)
            self._last_op = node.op
            self.speculation.on_node_submitted(node)

    # ----------------------------------------------------------- materialise --
    def value_of(self, node: Node) -> Any:
        """Materialise a node synchronously (no preemption)."""
        with self._lock:
            return self._ensure(node)

    def _ensure(self, node: Node, budget_s: Optional[float] = None) -> Any:
        if node.nid in self.cache:
            value = self.cache.get(node)
            if not faults.is_corrupt(value):
                return value
            # graceful degradation: a poisoned background result must never
            # reach the user — drop it and recompute on the foreground path
            # (where no background-only faults are injected)
            self.cache.drop(node.nid)
            self.partials.pop(node.nid, None)
            self.metrics.corrupt_results_dropped += 1
            logger.warning(
                "dropped corrupted cached result for %s; recomputing", node.label
            )
        impl = self.registry[node.op]
        if impl.try_fused is not None and budget_s is None:
            # planner fusion hook: lower filter→reduce chains as one dispatch
            # (foreground only — background think-time execution keeps the
            # per-unit preemption granularity)
            value = impl.try_fused(node, self._ensure)
            if value is not None:
                self.cache.put(node, value)
                self._record_rows(node, value)
                return value
        inputs = []
        pinned = []
        try:
            if impl.needs_inputs:
                for p in node.parents:
                    inputs.append(self._ensure(p))
                    self.cache.pin(p.nid)
                    pinned.append(p.nid)
            value = self.executor.execute(
                node, inputs, self.partials, budget_s=budget_s
            )
            self.cache.put(node, value)
            self._record_rows(node, value)
            return value
        finally:
            for nid in pinned:
                self.cache.unpin(nid)

    @staticmethod
    def _record_rows(node: Node, value: Any) -> None:
        nrows = getattr(value, "nrows", None)
        if nrows is not None:
            node.est_rows = float(nrows)

    # ------------------------------------------------------------ interaction --
    def display(self, node: Node, tenant: Optional[str] = None) -> Any:
        """Execute an interaction: critical path only, everything else deferred."""
        node.is_interaction = True
        self._pause_worker()
        try:
            with self._lock:
                # record think time since previous output
                now = self.clock.now()
                if self._last_output_at is not None:
                    dt = now - self._last_output_at
                    if dt > 0:
                        self.think_time.update(dt)
                        self.metrics.think_s += dt

                t0 = self.clock.now()
                n_exec_before = self.executor.stats.nodes_completed
                partial = False
                if not self.opportunistic:
                    # eager baseline: execute *everything specified so far*
                    # (the paper's status-quo semantics)
                    for n in self.dag.topological():
                        if n.nid <= node.nid and n.nid not in self.cache:
                            self._ensure(n)
                    value = self.cache.get(node)
                else:
                    value = None
                    if self.partial_results:
                        impl = (
                            self.registry[node.op]
                            if node.op in self.registry
                            else None
                        )
                        if impl is not None and impl.fast_interaction is not None:
                            value = impl.fast_interaction(node)
                            if value is not None:
                                self.cache.put(node, value)
                        if value is None:
                            value = self._try_partial_headtail(node)
                        partial = value is not None
                    if value is None:
                        value = self._ensure(node)
                latency = self.clock.now() - t0
                self.metrics.sync_wait_s += latency
                self.metrics.interactions.append(
                    InteractionRecord(
                        label=node.label,
                        latency_s=latency,
                        ops_executed=self.executor.stats.nodes_completed
                        - n_exec_before,
                        partial=partial,
                        at=self.clock.now(),
                        tenant=tenant,
                    )
                )
                self.speculation.on_critical_path_executed(
                    critical_path(self.dag, node)
                )
                self._last_output_at = self.clock.now()
                return value
        finally:
            self._resume_worker()

    # ---- progressive interactions (bounded estimates, upgrade in place) ------
    def interact(
        self,
        node: Node,
        tenant: Optional[str] = None,
        progressive: bool = False,
        seed_units: Optional[int] = None,
    ) -> Any:
        """The interaction entry point.  ``progressive=False`` is exactly
        :meth:`display` (blocking, exact).  ``progressive=True`` returns a
        :class:`~repro.core.progressive.ProgressiveResult` immediately: a
        bounded estimate over the partitions completed so far (seeding a
        sample-first slice when none are) that upgrades in place as
        background execution / explicit refinement completes partitions."""
        if not progressive:
            return self.display(node, tenant=tenant)
        return self.display_progressive(node, tenant=tenant, seed_units=seed_units)

    def display_progressive(
        self,
        node: Node,
        tenant: Optional[str] = None,
        seed_units: Optional[int] = None,
    ) -> ProgressiveResult:
        """Progressive interaction: return a bounded estimate immediately.

        Mirrors :meth:`display`'s bookkeeping — think-time update, an
        :class:`InteractionRecord` whose latency is the
        time-to-first-bounded-estimate, speculation hooks — but instead of
        materialising the node it wires a running combine into the executor's
        streaming path and executes only a small sample-first seed of
        partitions (``seed_units``, default total/16) when no partials exist
        yet.  Parents ARE materialised (they're on the critical path of any
        estimate); only the node's own partitions are progressive."""
        node.is_interaction = True
        self._pause_worker()
        try:
            with self._lock:
                now = self.clock.now()
                if self._last_output_at is not None:
                    dt = now - self._last_output_at
                    if dt > 0:
                        self.think_time.update(dt)
                        self.metrics.think_s += dt
                t0 = self.clock.now()
                n_exec_before = self.executor.stats.nodes_completed
                impl = self.registry[node.op]
                cached = self.cache.peek(node.nid)
                if cached is not None and not faults.is_corrupt(cached):
                    pr = ProgressiveResult(
                        self, node, inputs=[], combine=None, total_units=0,
                        tenant=tenant,
                    )
                else:
                    inputs = (
                        [self._ensure(p) for p in node.parents]
                        if impl.needs_inputs
                        else []
                    )
                    units = impl.units(node, inputs)
                    prog = self.partials.get(node.nid)
                    if prog is None or prog.total_units != len(units):
                        prog = PartialProgress(total_units=len(units))
                        self.partials[node.nid] = prog
                    combine = (
                        impl.running_combine(node, inputs)
                        if impl.running_combine is not None
                        else None
                    )
                    pr = ProgressiveResult(
                        self, node, inputs=inputs, combine=combine,
                        total_units=len(units), tenant=tenant,
                    )
                    pr._units = units
                    # replay checkpointed partials, then stream the rest
                    for i in sorted(prog.results):
                        pr._on_unit(i, prog.results[i])
                    self.executor.progress_listeners[node.nid] = pr._on_unit
                    if pr.n_units == 0 and len(units) > 0:
                        k = (
                            seed_units
                            if seed_units is not None
                            else max(1, len(units) // 16)
                        )
                        self._progressive_step(pr, k)
                latency = self.clock.now() - t0
                self.metrics.sync_wait_s += latency
                self.metrics.interactions.append(
                    InteractionRecord(
                        label=node.label,
                        latency_s=latency,
                        ops_executed=self.executor.stats.nodes_completed
                        - n_exec_before,
                        partial=True,
                        at=self.clock.now(),
                        tenant=tenant,
                        progressive=True,
                    )
                )
                self.speculation.on_critical_path_executed(
                    critical_path(self.dag, node)
                )
                self._last_output_at = self.clock.now()
                return pr
        finally:
            self._resume_worker()

    def _progressive_step(self, pr: ProgressiveResult, max_units: int) -> None:
        """Execute up to ``max_units`` missing partitions of ``pr.node`` in
        sample-first order; finalise through the exact combine when the last
        one lands.  Caller holds the engine lock (worker paused)."""
        node = pr.node
        if node.nid in self.cache:
            return
        prog = self.partials.get(node.nid)
        if prog is None or prog.total_units != pr.total_units:
            prog = PartialProgress(total_units=pr.total_units)
            self.partials[node.nid] = prog
        missing = prog.missing()
        if missing:
            order = pr.refinement_order(missing)
            self.executor.run_units(
                node, pr._inputs, self.partials,
                order[: max(int(max_units), 1)], tenant=pr.tenant,
                units=pr._units,
            )
        if prog.done:
            self._progressive_finalize(pr)

    def _progressive_finalize(self, pr: ProgressiveResult) -> None:
        """All partitions done: combine through the executor's ordinary path
        (unit results in index order — identical to the non-progressive
        path, so the completed result is bit-for-bit exact) and cache it."""
        node = pr.node
        if node.nid in self.cache:
            return
        value = self.executor.execute(node, pr._inputs, self.partials)
        self.cache.put(node, value)
        self._record_rows(node, value)

    # ---- head/tail partial results (paper §2.2.2, §5.1) ----------------------
    def _try_partial_headtail(self, node: Node) -> Optional[Any]:
        if node.op not in ("head", "tail") or not node.parents:
            return None
        k = int(node.literals[0]) if node.literals else 5
        from_back = node.op == "tail"

        # walk up through partition-wise ops to a materialised (or source) base
        chain: List[Node] = []
        cur = node.parents[0]
        base_parts: Optional[List[Any]] = None
        nparts: Optional[int] = None
        source: Optional[Node] = None
        while True:
            if cur.nid in self.cache:
                base_value = self.cache.get(cur)
                parts = getattr(base_value, "partitions", None)
                if parts is None:
                    return None
                base_parts = list(parts)
                nparts = len(base_parts)
                break
            impl = self.registry[cur.op] if cur.op in self.registry else None
            if impl is None:
                return None
            if impl.partitionwise and cur.parents and impl.apply_partition:
                # non-frame parents (scalar subexpressions) must already be
                # materialised for the partial path to proceed
                if any(p.nid not in self.cache for p in cur.parents[1:]):
                    return None
                chain.append(cur)
                cur = cur.parents[0]
                continue
            if impl.source_partitioned and impl.gen_partition and impl.n_partitions:
                source = cur
                nparts = impl.n_partitions(cur)
                break
            return None  # blocking operator in the way → full materialisation
        chain.reverse()  # base-first application order

        order = range(nparts - 1, -1, -1) if from_back else range(nparts)
        gathered: List[Any] = []
        rows = 0
        for j in order:
            part = self._chain_partition(source, base_parts, chain, j)
            gathered.append(part)
            rows += int(getattr(part, "nrows", 0))
            if rows >= k:
                break
        if from_back:
            gathered.reverse()
        combiner = self.registry[node.op]
        value = combiner.combine(node, [_FakeParts(gathered)], [])
        self.cache.put(node, value)
        return value

    def _chain_partition(
        self,
        source: Optional[Node],
        base_parts: Optional[List[Any]],
        chain: List[Node],
        j: int,
    ) -> Any:
        """Partition j pushed through the partition-wise chain, memoised in
        ``self.partials`` so background completion resumes without recompute."""
        if base_parts is not None:
            part = base_parts[j]
        else:
            impl = self.registry[source.op]
            prog = self.partials.setdefault(
                source.nid, PartialProgress(total_units=impl.n_partitions(source))
            )
            if j in prog.results:
                part = prog.results[j]
            else:
                part = impl.gen_partition(source, j)
                cost = (
                    impl.partition_cost(source, j) if impl.partition_cost else 0.0
                )
                self.clock.advance(cost)
                prog.results[j] = part
                self.executor.stats.units_run += 1
        for op_node in chain:
            impl = self.registry[op_node.op]
            prog = self.partials.setdefault(
                op_node.nid,
                PartialProgress(
                    total_units=len(base_parts)
                    if base_parts is not None
                    else self.partials[source.nid].total_units
                ),
            )
            if j in prog.results:
                part = prog.results[j]
            else:
                cost = (
                    impl.partition_cost(op_node, j) if impl.partition_cost else 0.0
                )
                extras = [self.cache.get(p) for p in op_node.parents[1:]]
                part = impl.apply_partition(op_node, part, extras)
                self.clock.advance(cost)
                prog.results[j] = part
                self.executor.stats.units_run += 1
        return part

    # --------------------------------------------------------------- think time --
    def _batch_budget_s(self, remaining: Optional[float] = None) -> Optional[float]:
        """Max duration one fused background batch may span, sized so an
        arriving interaction loses (or waits on) at most one batch: a fraction
        of the think-time model's current prediction, clamped to the remaining
        window when one is known.  ``None`` disables batching entirely."""
        if not self.batching:
            return None
        t = self.batch_loss_frac * self.think_time.predict()
        if remaining is not None:
            t = min(t, remaining)
        return max(t, 1e-6)

    def think(self, seconds: float, tenant: Optional[str] = None) -> dict:
        """Simulation: user thinks for ``seconds`` of virtual time while the
        scheduler opportunistically executes non-critical operators.

        ``tenant`` is the session whose think window this is; the scheduler
        allocates it *across all tenants'* demand (cross-tenant Eq-1), and
        quarantine decisions are scoped to the faulting tenant."""
        assert self.clock.virtual, "think() is for simulation mode; use start_background() in real mode"
        with self._lock, faults.background():
            t_start = self.clock.now()
            deadline = t_start + seconds
            executed_any = True
            while self.opportunistic and executed_any:
                remaining = deadline - self.clock.now()
                if remaining <= 0:
                    break
                node = self.scheduler.pick(
                    self.cache.executed_ids(), now=self.clock.now(), tenant=tenant
                )
                if node is None:
                    break
                try:
                    impl = self.registry[node.op]
                    inputs = (
                        self._background_inputs(node) if impl.needs_inputs else []
                    )
                    value = self.executor.execute(
                        node, inputs, self.partials, budget_s=remaining,
                        batch_budget_s=self._batch_budget_s(remaining),
                        tenant=tenant,
                    )
                    if faults.is_corrupt(value):
                        raise faults.CorruptResult(node.label)
                    self.cache.put(node, value)
                    self._record_rows(node, value)
                    self.scheduler.clear_quarantine(node.nid)
                    if self.pick_log is not None:
                        self.pick_log.append(node.nid)
                except Preempted:
                    break  # budget exhausted mid-unit; progress checkpointed
                except Exception as exc:  # crash isolation (fault domain)
                    self._absorb_background_fault(node, exc, tenant)
            busy = self.clock.now() - t_start
            self.metrics.background_busy_s += busy
            if self.clock.now() < deadline:  # idle remainder of think time
                self.clock.advance(deadline - self.clock.now())
            return {"busy_s": busy, "idle_s": seconds - busy}

    def drain_background(self, tenant: Optional[str] = None) -> int:
        """Run all remaining non-critical work to completion (no budget).

        Nodes in active quarantine are skipped — the drain completes with
        them unexecuted rather than spinning on a failing fault domain."""
        n = 0
        with self._lock, faults.background():
            while True:
                node = self.scheduler.pick(
                    self.cache.executed_ids(), now=self.clock.now(), tenant=tenant
                )
                if node is None:
                    return n
                try:
                    impl = self.registry[node.op]
                    inputs = (
                        self._background_inputs(node) if impl.needs_inputs else []
                    )
                    value = self.executor.execute(
                        node, inputs, self.partials,
                        batch_budget_s=self._batch_budget_s(),
                        tenant=tenant,
                    )
                    if faults.is_corrupt(value):
                        raise faults.CorruptResult(node.label)
                    self.cache.put(node, value)
                    self._record_rows(node, value)
                    self.scheduler.clear_quarantine(node.nid)
                    if self.pick_log is not None:
                        self.pick_log.append(node.nid)
                    n += 1
                except Exception as exc:  # crash isolation (fault domain)
                    self._absorb_background_fault(node, exc, tenant)

    def _background_inputs(self, node: Node) -> List[Any]:
        """Fetch materialised parents for background execution, refusing to
        compute on a corrupted input (the parent is dropped for recompute)."""
        inputs = []
        for p in node.parents:
            value = self.cache.get(p)
            if faults.is_corrupt(value):
                self.cache.drop(p.nid)
                self.partials.pop(p.nid, None)
                self.metrics.corrupt_results_dropped += 1
                raise faults.CorruptResult(f"corrupted input {p.label}")
            inputs.append(value)
        return inputs

    def _absorb_background_fault(
        self, node: Node, exc: BaseException, tenant: Optional[str] = None
    ) -> None:
        """The crash-isolation boundary: record, quarantine, carry on.

        Background failures must never kill the loop (the pre-fix behaviour
        silently disabled all think-time optimisation forever) and must never
        corrupt interactive results — the node re-enters scheduling after an
        exponential backoff, and the interactive path recomputes it on the
        foreground (numpy-fallback) path if demanded sooner.  With shared
        DAGs the quarantine is keyed (tenant, node): one tenant's faulting
        window must not block a deduped node for every other tenant."""
        now = self.clock.now()
        self.metrics.record_background_fault(node, exc, now)
        self.metrics.quarantines += 1
        entry = self.scheduler.quarantine(
            node.nid, now, error=f"{type(exc).__name__}: {exc}", tenant=tenant
        )
        logger.warning(
            "background execution of %s failed (%s: %s); quarantined "
            "(failures=%d, backoff until %.3f)",
            node.label, type(exc).__name__, exc, entry.failures, entry.until,
        )

    # ------------------------------------------------------- real-mode worker --
    def start_background(self) -> None:
        assert self.mode == "real"
        if self._worker is None:
            self._worker = _BackgroundWorker(self)
            self._worker.start()

    def stop_background(self) -> None:
        if self._worker is not None:
            self._worker.stop()
            self._worker = None
        self.save_cost_model()

    def save_cost_model(self) -> None:
        """Persist fitted unit costs (no-op without ``cost_model_path``),
        plus the scheduler's descendant/delivery-cost memos alongside."""
        if self.cost_model_path:
            self.cost_model.calibrate()
            self.cost_model.save(self.cost_model_path)
        self.save_scheduler_memos()

    def save_scheduler_memos(self) -> None:
        """Persist the scheduler's memo caches (no-op without a path)."""
        if self.scheduler_memo_path:
            with self._lock:
                self.scheduler.save_memos(self.scheduler_memo_path)

    def load_scheduler_memos(self) -> bool:
        """Install persisted scheduler memos.  Call AFTER the session's DAG
        is rebuilt — validity is keyed on a content fingerprint of the DAG
        (and the cost-model state for the cost-derived memos), so loading
        against a different program is rejected wholesale."""
        if not self.scheduler_memo_path:
            return False
        with self._lock:
            return self.scheduler.load_memos(self.scheduler_memo_path)

    def _pause_worker(self) -> None:
        if self._worker is not None:
            self._worker.pause()

    def _resume_worker(self) -> None:
        if self._worker is not None:
            self._worker.resume()

    def nudge_background(self) -> None:
        if self._worker is not None:
            self._worker.nudge()


class _FakeParts:
    """Minimal parent stand-in for head/tail combine over gathered partitions."""

    def __init__(self, partitions):
        self.partitions = partitions


class _BackgroundWorker:
    """Real-mode daemon thread running the think-time scheduler loop,
    preempted between partition units (paper §4.3).

    The loop is a *fault domain*: any failure of one node's background
    execution — a runtime kernel error, an injected chaos fault, a corrupted
    value — is absorbed at the iteration boundary (recorded + the node
    quarantined with exponential backoff) and the loop continues.  Before
    this boundary existed, the first such exception silently killed the
    daemon thread and all think-time optimisation stopped forever, which is
    strictly worse than never speculating."""

    STOP_JOIN_TIMEOUT_S = 10.0

    def __init__(self, engine: Engine):
        self.engine = engine
        self._pause_req = threading.Event()
        self._paused = threading.Event()
        self._stop = threading.Event()
        self._work = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._work.set()
        self._thread.start()

    def stop(self) -> bool:
        """Stop the worker; returns False (and records a stall) if the thread
        failed to exit within the join timeout — a wedged kernel dispatch."""
        self._stop.set()
        self._pause_req.set()
        self._work.set()
        self._thread.join(timeout=self.STOP_JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            self.engine.metrics.worker_stalls += 1
            logger.warning(
                "background worker failed to stop within %.0fs (stalled unit?)",
                self.STOP_JOIN_TIMEOUT_S,
            )
            return False
        return True

    def pause(self) -> bool:
        """Request pause and wait for the ack (bounded: ~one unit duration).
        A missed ack means a stalled unit is still holding the device; the
        interaction proceeds anyway, but the stall is surfaced instead of
        silently swallowed."""
        self._pause_req.set()
        acked = self._paused.wait(timeout=self.engine.worker_ack_timeout_s)
        if not acked:
            self.engine.metrics.worker_stalls += 1
            logger.warning(
                "background worker missed pause ack within %.0fs "
                "(stalled unit still running)",
                self.engine.worker_ack_timeout_s,
            )
        return acked

    def resume(self) -> None:
        self._pause_req.clear()
        self._paused.clear()
        self._work.set()

    def nudge(self) -> None:
        self._work.set()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def _run(self) -> None:
        with faults.background():
            self._run_loop()

    def _run_loop(self) -> None:
        eng = self.engine
        while not self._stop.is_set():
            if self._pause_req.is_set():
                self._paused.set()
                self._work.clear()
                self._work.wait(timeout=0.5)
                continue
            node = None
            try:
                with eng._lock:
                    node = eng.scheduler.pick(
                        eng.cache.executed_ids(), now=eng.clock.now()
                    )
                if node is None:
                    self._paused.set()
                    self._work.clear()
                    self._work.wait(timeout=0.05)
                    self._paused.clear()
                    continue
                with eng._lock:
                    inputs = eng._background_inputs(node)
                t0 = time.monotonic()
                value = eng.executor.execute(
                    node,
                    inputs,
                    eng.partials,
                    preempt_check=self._pause_req.is_set,
                    batch_budget_s=eng._batch_budget_s(),
                )
                if faults.is_corrupt(value):
                    raise faults.CorruptResult(node.label)
                with eng._lock:
                    eng.cache.put(node, value)
                    eng.scheduler.clear_quarantine(node.nid)
                    eng.metrics.background_busy_s += time.monotonic() - t0
            except Preempted:
                continue
            except KeyError:
                continue  # input evicted between pick and fetch; re-pick
            except Exception as exc:  # crash isolation: record, quarantine, go on
                if node is None:
                    # a scheduler/cache failure outside any node's fault
                    # domain: log and keep serving (pick again next round)
                    logger.exception("background scheduling failed; continuing")
                    time.sleep(0.01)
                    continue
                with eng._lock:
                    eng._absorb_background_fault(node, exc)
