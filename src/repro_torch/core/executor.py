"""Preemptible operator execution at partition granularity (paper §5.1).

pandas' lower-level BLAS calls cannot be interrupted; neither can an XLA
executable once dispatched.  The paper's answer is *dataframe partitioning*:
background work is decomposed into per-partition work units so that preemption
loses at most the current partition's progress.  Completed units are
checkpointed in :class:`PartialProgress` (a sparse ``{unit_index: result}``
map — the head/tail partial-result path fills units from the front/back) and
execution resumes from the first missing unit during the next think-time
window — preemption never wastes completed-partition work.

Batched execution: running one kernel dispatch per partition leaves the device
idle between host round-trips (the dispatch-bound regime).  Operators that
support it expose :class:`UnitBatch` construction via ``OpRuntime.make_batches``
— k partition units fused into one dispatch, with preemption granularity
widened from one unit to one batch.  The batch size is chosen from a time
budget (``batch_budget_s``) so an arriving interaction loses at most one
batch; a completed batch fills all k of its :class:`PartialProgress` slots at
once.  In real mode batches are *pipelined*: the next batch's kernel is
dispatched before the previous batch's results are pulled back to host (JAX
async dispatch), so device compute overlaps host-side finalisation.

Operator semantics are supplied by an :class:`OpRuntime` registry (the frame
layer registers dataframe operators; the serving layer registers decode /
prefill steps).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import faults
from .faults import CorruptResult

_log = logging.getLogger(__name__)


class Preempted(Exception):
    """Raised when background execution yields to an interaction."""


@dataclass
class Unit:
    """One preemption quantum (usually: one partition of one operator)."""

    fn: Callable[[], Any]
    cost_s: float = 0.0  # simulated duration; real mode measures instead
    tag: str = ""


@dataclass
class UnitBatch:
    """k fused units: one device dispatch covering ``indices`` unit slots.

    ``dispatch()`` launches the kernel and returns a handle without waiting
    for the result (JAX async dispatch keeps the arrays device-side);
    ``finalize(handle)`` blocks, pulls results to host, and returns one value
    per index in ``indices`` order.  A singleton batch wrapping a host-path
    unit simply runs it inside ``dispatch`` and passes the value through.
    """

    indices: List[int]
    dispatch: Callable[[], Any]
    finalize: Callable[[Any], List[Any]]
    cost_s: float = 0.0  # simulated duration of the whole batch
    tag: str = ""
    # >1 marks a *sharded* batch: one collective dispatch over a device mesh
    # covering k partitions × `devices` devices (frame/dist.py), instead of a
    # single-device fused kernel.  Purely accounting — the executor treats
    # both flavours identically.
    devices: int = 1

    def __len__(self) -> int:
        return len(self.indices)


@dataclass
class OpRuntime:
    """Executable semantics of one operator class."""

    # build the full unit list given materialised parent values
    units: Callable[["Node", Sequence[Any]], List[Unit]]
    # combine(node, inputs, ordered_unit_results) -> final value
    combine: Callable[["Node", Sequence[Any], List[Any]], Any]
    # True if unit i consumes exactly partition i of the (single, first) frame
    # parent and emits partition i of the output — enables head/tail partial
    # results (paper §2.2.2).  Such ops must also provide apply_partition.
    partitionwise: bool = False
    # partitionwise fast path: apply_partition(node, partition, extras) where
    # extras are the materialised values of node.parents[1:]
    apply_partition: Optional[Callable[["Node", Any, Sequence[Any]], Any]] = None
    # source ops (no frame parents) generating independent partitions:
    # gen_partition(node, i) -> partition ; n_partitions(node) -> int
    source_partitioned: bool = False
    gen_partition: Optional[Callable[["Node", int], Any]] = None
    n_partitions: Optional[Callable[["Node"], int]] = None
    # per-partition simulated cost (for the partial path)
    partition_cost: Optional[Callable[["Node", int], float]] = None
    # cost (sim-seconds) of the combine phase, charged before combine runs
    combine_cost: Optional[Callable[["Node", Sequence[Any]], float]] = None
    # False for metadata-only ops (e.g. ``columns``) that must not force
    # materialisation of their parents
    needs_inputs: bool = True
    # optional interaction fast path (physical rewrites like the paper's
    # Fig. 2b group-head pushdown); returns None to fall through
    fast_interaction: Optional[Callable[["Node"], Optional[Any]]] = None
    # optional batched execution: make_batches(node, inputs, units, indices,
    # max_batch) -> List[UnitBatch] covering every index in ``indices`` (ops
    # may wrap unsupported partitions as singleton host batches), or None to
    # decline batching for this node and run unit-at-a-time
    make_batches: Optional[
        Callable[["Node", Sequence[Any], List[Unit], List[int], int],
                 Optional[List["UnitBatch"]]]
    ] = None
    # optional fused lowering: try_fused(node, ensure) -> final value, or None
    # to run the normal unit path.  ``ensure`` materialises a DAG node (the
    # engine passes its own _ensure).  The frame layer uses this to lower
    # planner-detected linear chains (filter→stats, filter→groupby,
    # filter→topk) as one kernel dispatch (see frame/planner.py).
    try_fused: Optional[
        Callable[["Node", Callable[["Node"], Any]], Optional[Any]]
    ] = None
    # optional progressive path: running_combine(node, inputs) -> a running
    # combine state object (update(index, partial) / snapshot(coverage)) that
    # folds completed unit results in as they stream out of the executor and
    # can produce a bounded estimate at any coverage.  Ops without one still
    # get a coverage-only ProgressiveResult (value None until complete).
    running_combine: Optional[Callable[["Node", Sequence[Any]], Any]] = None


@dataclass
class PartialProgress:
    """Per-node resumable progress: sparse map of completed unit results."""

    results: Dict[int, Any] = field(default_factory=dict)
    total_units: Optional[int] = None

    def missing(self) -> List[int]:
        if self.total_units is None:
            return []
        return [i for i in range(self.total_units) if i not in self.results]

    @property
    def done(self) -> bool:
        return self.total_units is not None and len(self.results) == self.total_units

    def ordered(self) -> List[Any]:
        assert self.done
        return [self.results[i] for i in range(self.total_units)]


class Registry:
    def __init__(self) -> None:
        self._impls: Dict[str, OpRuntime] = {}

    def register(self, op: str, impl: OpRuntime) -> None:
        self._impls[op] = impl

    def __getitem__(self, op: str) -> OpRuntime:
        try:
            return self._impls[op]
        except KeyError:
            raise KeyError(
                f"no runtime registered for operator {op!r}; "
                "did the frame/serve layer initialise its registry?"
            ) from None

    def __contains__(self, op: str) -> bool:
        return op in self._impls


@dataclass
class ExecStats:
    units_run: int = 0
    units_preempted_lost: int = 0
    nodes_completed: int = 0
    seconds: float = 0.0
    batches_run: int = 0  # fused dispatches (a batch of k counts k units_run)
    units_batched: int = 0  # units that rode a multi-unit batch
    sharded_batches: int = 0  # collective (multi-device) dispatches
    units_sharded: int = 0  # units that rode a sharded batch
    # multi-tenant serving: units attributed to the think window they ran in,
    # keyed by tenant ("" = untenanted).  Units a tenant's window executes for
    # *another* tenant's demand still land here — the attribution is "whose
    # idle capacity paid", which is what cross-tenant harvest reporting needs.
    units_by_tenant: Dict[str, int] = field(default_factory=dict)


class Executor:
    """Runs one node's units with preemption + resume.

    The clock decides accounting: virtual clocks advance by ``unit.cost_s``;
    real clocks measure wall time.  Either way the cost model is calibrated
    with the observed duration.
    """

    def __init__(self, registry: Registry, clock, cost_model, fault_plan=None):
        self.registry = registry
        self.clock = clock
        self.cost_model = cost_model
        self.fault_plan = fault_plan
        self.stats = ExecStats()
        # progressive streaming: nid -> callback(unit_index, result), fired at
        # every unit-result write site (unit loop, batch fill, run_units) so a
        # ProgressiveResult sees partitions as they complete, not at 100%
        self.progress_listeners: Dict[int, Callable[[int, Any], None]] = {}
        # intra-node unit ordering hook (sample-first); applied ONLY to nodes
        # with a registered progress listener so the exact path's execution
        # order — and therefore its observable behaviour — is untouched
        self.unit_order: Optional[Callable[[List[int], int], List[int]]] = None

    def execute(
        self,
        node,
        inputs: Sequence[Any],
        partials: Dict[int, PartialProgress],
        preempt_check: Optional[Callable[[], bool]] = None,
        budget_s: Optional[float] = None,
        batch_budget_s: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> Any:
        """Execute ``node``; raises :class:`Preempted` if interrupted.

        ``tenant``: attribute the units this call completes (including a
        preempted prefix) to that tenant's think window in
        :attr:`ExecStats.units_by_tenant`.

        ``budget_s`` (virtual clocks only): stop when the simulated duration of
        the *next* unit would exceed the remaining budget — models an
        interaction arriving during that unit, whose progress would be lost.

        ``batch_budget_s``: enable batched execution when the operator supports
        it — fuse up to k units per dispatch, sized so one batch's estimated
        duration stays within the budget (an arriving interaction loses at
        most one batch).  ``None`` disables batching (unit-at-a-time).

        The engine's fault plan (if any) is scoped around execution so the
        frame backend's kernel-dispatch site sees it; the ``exec.unit`` site
        fires here, around each unit/batch.  May raise
        :class:`~repro.core.faults.InjectedFault` or
        :class:`~repro.core.faults.CorruptResult` — the background boundaries
        quarantine on those; the foreground path never has them injected.
        """
        before = self.stats.units_run
        try:
            with faults.scope(self.fault_plan):
                return self._execute(
                    node, inputs, partials, preempt_check, budget_s, batch_budget_s
                )
        finally:
            if tenant is not None:
                delta = self.stats.units_run - before
                if delta:
                    self.stats.units_by_tenant[tenant] = (
                        self.stats.units_by_tenant.get(tenant, 0) + delta
                    )

    def _execute(
        self,
        node,
        inputs: Sequence[Any],
        partials: Dict[int, PartialProgress],
        preempt_check: Optional[Callable[[], bool]],
        budget_s: Optional[float],
        batch_budget_s: Optional[float],
    ) -> Any:
        impl = self.registry[node.op]
        units = impl.units(node, inputs)
        prog = partials.get(node.nid)
        if prog is None or prog.total_units != len(units):
            prog = PartialProgress(total_units=len(units))
            partials[node.nid] = prog

        started = self.clock.now()
        spent = 0.0
        missing = [i for i in range(len(units)) if i not in prog.results]
        if self.unit_order is not None and node.nid in self.progress_listeners:
            missing = self.unit_order(missing, len(units))
        if batch_budget_s is not None and impl.make_batches is not None and missing:
            k = self._batch_size(units, missing, batch_budget_s)
            batches = (
                impl.make_batches(node, inputs, units, missing, k)
                if k > 1
                else None
            )
            if batches:
                spent += self._run_batches(
                    node, batches, prog, preempt_check, budget_s, spent
                )
                missing = [i for i in missing if i not in prog.results]
        for i in missing:
            unit = units[i]
            if preempt_check is not None and preempt_check():
                raise Preempted(node.label)
            if budget_s is not None and self.clock.virtual:
                if spent + unit.cost_s > budget_s + 1e-12:
                    # unit would straddle the interaction arrival: its progress
                    # is lost (paper's worst case = one partition)
                    self.stats.units_preempted_lost += 1
                    raise Preempted(node.label)
            t0 = time.monotonic()
            mode = faults.fire("exec.unit", op=node.op)  # may raise / sleep
            result = unit.fn()
            if mode == "corrupt":
                result = faults.corrupt(result)
            wall = time.monotonic() - t0
            dur = unit.cost_s if self.clock.virtual else wall
            self.clock.advance(unit.cost_s)
            spent += dur
            self._store_unit(node, prog, i, result)

        self._purge_corrupt(node, prog)
        if impl.combine_cost is not None:
            c = impl.combine_cost(node, inputs)
            self.clock.advance(c)
            spent += c if self.clock.virtual else 0.0
        value = impl.combine(node, inputs, prog.ordered())
        total = (self.clock.now() - started) if self.clock.virtual else spent
        self.cost_model.observe(node, max(total, 1e-9))
        self.stats.seconds += total
        self.stats.nodes_completed += 1
        partials.pop(node.nid, None)
        self.progress_listeners.pop(node.nid, None)
        return value

    def _store_unit(self, node, prog: PartialProgress, i: int, result: Any) -> None:
        """Single write site for completed unit results: fills the progress
        slot, counts the unit, and streams the result to any progressive
        listener.  Listener failures must never poison execution — the exact
        path owes nothing to the estimate channel."""
        prog.results[i] = result
        self.stats.units_run += 1
        cb = self.progress_listeners.get(node.nid)
        if cb is not None:
            try:
                cb(i, result)
            except Exception:  # pragma: no cover - defensive
                _log.exception("progress listener for %s failed", node.label)

    def run_units(
        self,
        node,
        inputs: Sequence[Any],
        partials: Dict[int, PartialProgress],
        indices: Sequence[int],
        tenant: Optional[str] = None,
        units: Optional[List[Unit]] = None,
    ) -> int:
        """Execute exactly the given unit indices of ``node`` — no combine, no
        completion bookkeeping.  This is the progressive-refinement quantum:
        the caller picks a sample-first slice of the missing units, results
        stream into :class:`PartialProgress` (and any progress listener) and
        remain resumable by a later ``execute``.  Returns units completed.

        ``units`` lets the caller reuse an already-built unit list (building
        one closure per partition is O(partitions) even to run a single
        unit, which would dominate small refinement quanta)."""
        impl = self.registry[node.op]
        if units is None:
            units = impl.units(node, inputs)
        prog = partials.get(node.nid)
        if prog is None or prog.total_units != len(units):
            prog = PartialProgress(total_units=len(units))
            partials[node.nid] = prog
        before = self.stats.units_run
        with faults.scope(self.fault_plan):
            for i in indices:
                if i in prog.results:
                    continue
                mode = faults.fire("exec.unit", op=node.op)  # may raise / sleep
                result = units[i].fn()
                if mode == "corrupt":
                    result = faults.corrupt(result)
                self.clock.advance(units[i].cost_s)
                self._store_unit(node, prog, i, result)
        delta = self.stats.units_run - before
        if tenant is not None and delta:
            self.stats.units_by_tenant[tenant] = (
                self.stats.units_by_tenant.get(tenant, 0) + delta
            )
        return delta

    @staticmethod
    def _purge_corrupt(node, prog: PartialProgress) -> None:
        """Integrity boundary before combine: a corrupted unit result must
        never flow into a combined value.  Corrupt slots are dropped (so a
        retry — background after backoff, or the interactive foreground path —
        recomputes exactly the poisoned units) and the failure surfaces as
        :class:`CorruptResult` for the fault boundaries to quarantine on."""
        bad = [i for i, r in prog.results.items() if faults.is_corrupt(r)]
        if bad:
            for i in bad:
                prog.results.pop(i, None)
            raise CorruptResult(
                f"{node.label}: {len(bad)} corrupted unit result(s) detected"
            )

    # hard batch-size ceiling: cost estimates can be stale by orders of
    # magnitude before calibration, and one mis-sized mega-batch both blows
    # the preemption-loss bound and starves the async pipeline of overlap
    MAX_BATCH_UNITS = 32

    @staticmethod
    def _batch_size(
        units: List[Unit], missing: List[int], batch_budget_s: float
    ) -> int:
        """Units per batch such that one batch's estimated duration fits the
        budget: k = budget / mean-unit-cost, clamped to
        [1, min(len(missing), MAX_BATCH_UNITS)] and rounded DOWN to a power
        of two — fused kernels jit-specialise on the stacked batch shape, so
        quantising k keeps the compiled-executable universe tiny (≤ 6 sizes)
        instead of recompiling whenever calibration drifts the estimate."""
        cap = min(len(missing), Executor.MAX_BATCH_UNITS)
        est = sum(units[i].cost_s for i in missing) / max(len(missing), 1)
        k = cap if est <= 0 else max(1, min(cap, int(batch_budget_s / est)))
        return 1 << (k.bit_length() - 1)

    def _run_batches(
        self,
        node,
        batches: List[UnitBatch],
        prog: PartialProgress,
        preempt_check: Optional[Callable[[], bool]],
        budget_s: Optional[float],
        spent0: float,
    ) -> float:
        """Run fused batches; fills ``prog`` k slots per completed batch.

        Virtual clock: synchronous, budget checked at batch granularity — a
        batch that would straddle the interaction arrival is lost whole (the
        batched analogue of the paper's one-partition worst case).

        Real clock: pipelined — batch i+1 is dispatched before batch i's
        results are finalised, so the device never waits on the host between
        batches.  Preemption is polled between dispatches; an in-flight batch
        is *harvested* (its kernel already runs on the device — blocking for
        its result wastes nothing and its slots never recompute) before the
        Preempted signal propagates.
        """
        spent = 0.0

        def fill(batch: UnitBatch, results: List[Any]) -> None:
            for idx, res in zip(batch.indices, results):
                self._store_unit(node, prog, idx, res)
            self.stats.batches_run += 1
            if len(batch) > 1:
                self.stats.units_batched += len(batch)
            if batch.devices > 1:
                self.stats.sharded_batches += 1
                self.stats.units_sharded += len(batch)

        def finish(batch: UnitBatch, handle: Any, mode: Optional[str]) -> None:
            results = batch.finalize(handle)
            if mode == "corrupt":
                results = [faults.corrupt(r) for r in results]
            fill(batch, results)

        if self.clock.virtual:
            for batch in batches:
                if any(i in prog.results for i in batch.indices):
                    continue  # defensive: slots already filled elsewhere
                if preempt_check is not None and preempt_check():
                    raise Preempted(node.label)
                if budget_s is not None and spent0 + spent + batch.cost_s > (
                    budget_s + 1e-12
                ):
                    # the whole batch straddles the arrival: one batch lost
                    self.stats.units_preempted_lost += len(batch)
                    raise Preempted(node.label)
                mode = faults.fire("exec.unit", op=node.op)  # may raise / sleep
                finish(batch, batch.dispatch(), mode)
                self.clock.advance(batch.cost_s)
                spent += batch.cost_s
            return spent

        # wall time of the whole pipelined loop — NOT the sum of per-batch
        # dispatch→finalize spans, which overlap under pipelining and would
        # double-count device compute (inflating observe() ~2x)
        t_loop = time.monotonic()
        inflight: Optional[tuple] = None  # (batch, handle, fault_mode)
        try:
            for batch in batches:
                if preempt_check is not None and preempt_check():
                    raise Preempted(node.label)
                mode = faults.fire("exec.unit", op=node.op)  # may raise / sleep
                handle = batch.dispatch()
                if inflight is not None:
                    finish(*inflight)
                inflight = (batch, handle, mode)
            if inflight is not None:
                finish(*inflight)
                inflight = None
            return time.monotonic() - t_loop
        except Preempted:
            if inflight is not None:  # harvest the dispatched batch
                finish(*inflight)
            raise
