"""Frame operator runtimes: binds dataframe semantics into the core engine.

Every operator is decomposed into per-partition :class:`~repro_torch.core.executor.Unit`
quanta (preemptible, resumable — paper §5.1) plus a combine step.  Simulated
unit costs come from the engine's cost model so virtual-clock benchmarks are
reproducible; real mode measures wall time and calibrates the same model.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ..core.costmodel import CostModel
from ..core.dag import Node
from ..core.engine import Engine
from ..core.executor import OpRuntime, Unit, UnitBatch
from . import backend as BK
from . import blocking as B
from .backend import BackendPolicy
from .exprs import eval_expr, predicate_mask
from .io import Catalog
from .planner import Planner, planner_key
from .schema import SchemaUnknown, infer_schema
from .table import Column, Partition, PTable

# filter-family ops whose output a fused chain can consume (they all reduce
# to a host keep-mask + row compaction, so the compaction can move into the
# downstream kernel); filters with a value_ref extra parent are excluded by
# the single-parent chain gate in _try_fused
_FUSABLE_FILTER_OPS = ("filter", "filter_cmp", "isin", "between", "dropna")


class ColumnsResult(list):
    """Displayable result of ``df.columns``."""

    @property
    def nbytes(self) -> int:
        return sum(len(c) for c in self)


class FrameRuntime:
    def __init__(self, engine: Engine, catalog: Catalog, device=None):
        self.engine = engine
        self.catalog = catalog
        self.cost_model: CostModel = engine.cost_model
        self.backend_policy = BackendPolicy(
            engine_default=getattr(engine, "kernel_backend", None)
        )
        # runs on the card unless the caller asked for the CPU: raises here
        # rather than computing on the CPU quietly.  The device is this
        # runtime's own and goes with every dispatch.
        self.device = BK.require_device(self.backend_policy.resolve(), device)
        self.planner = Planner(
            self.cost_model,
            board=BK.breaker_board(),
            enabled=getattr(engine, "planner_enabled", True),
        )
        self._register_all()

    # ------------------------------------------------------------- helpers --
    def _node_cost(self, node: Node) -> float:
        return self.cost_model.cost(node)

    def backend(self) -> str:
        """The columnar kernel backend for this runtime's blocking partials."""
        return self.backend_policy.resolve()

    def _planned_backend(self, key: str, rows: int) -> str:
        """Precedence resolution with the cost-based planner layered under
        it: an explicit per-call / global / env override is absolute, but at
        the ``engine`` / ``default`` tiers the planner may demote this
        dispatch to numpy when the fitted (or cold-start) estimates say the
        kernel loses at this row count (see ``frame/planner.py``)."""
        bk, tier = self.backend_policy.resolve_tier()
        if tier in ("engine", "default"):
            bk = self.planner.choose(key, rows, bk)
        return bk

    def _timed(self, node: Node, rows: int, fn: Callable[[str], Any]) -> Callable[[], Any]:
        """Wrap a partial-unit body: resolve the backend (planner included)
        at execution time, measure wall time, and feed the sample to
        cost-model calibration under the node's *planning key* — so the
        samples keep refining exactly the estimates the planner consults.
        The sample is labelled with the backend that actually *served* the
        dispatch — when the runtime guard falls back to numpy (an injected
        fault, a contained error on the CPU, an open breaker) the time must
        calibrate the numpy path, or a single kernel failure would
        permanently skew the kernel's fitted cost."""
        key = planner_key(node)

        def run():
            bk = self._planned_backend(key, rows)
            BK.note_reset()
            t0 = time.perf_counter()
            out = fn(bk)
            dt = time.perf_counter() - t0
            served, _reason = BK.served_backend(bk)
            self.cost_model.add_sample(key, served, rows, dt)
            return out

        return run

    def _unit_costs_by_rows(self, node: Node, parts: Sequence[Partition]) -> List[float]:
        total_rows = max(sum(p.nrows for p in parts), 1)
        c = self._node_cost(node)
        return [c * p.nrows / total_rows for p in parts]

    def _batch_maker(
        self,
        planner: Callable[[Node, Sequence[Any], List[Partition], str], Any],
        sharded_planner: Optional[Callable[[Node, Any, List[int]], Any]] = None,
    ):
        """Build an ``OpRuntime.make_batches`` hook from a per-group planner.

        ``planner(node, inputs, group, bk)`` returns the backend's
        ``(dispatch, finalize)`` pair for a group of partitions or ``None``
        when the group falls outside the kernel envelope — those indices are
        left uncovered and the executor runs them unit-at-a-time.  Missing
        indices are chunked into runs of ≤ ``max_batch`` partitions sharing
        one shape bucket, so each batch is a single fused dispatch.
        Calibration moves to the batch block points: one
        ``(op, backend, rows, seconds)`` sample per batch.  Under the async
        pipeline the raw dispatch→finalize spans of consecutive batches
        overlap (batch i+1 launches before batch i's results land), so each
        sample clips its start to the previous batch's block point — the
        clipped spans tile wall time exactly and the fitted unit costs
        reflect achieved *batched throughput*, not double-counted latency.
        """

        def make_batches(node, inputs, units, indices, max_batch):
            parent = inputs[0]
            bk, tier = self.backend_policy.resolve_tier()
            if sharded_planner is not None and tier in ("engine", "default"):
                # The sharded attempt precedes the numpy early-out below: one
                # call over the data mesh is a *whole-node* alternative
                # costed against the host plan (numpy included) by
                # choose_sharded, so the default-numpy resolution must not
                # veto it.  Covers the raw missing set — per-partition backend
                # demotions are irrelevant once a single call serves all.
                sh = self._sharded_batch(node, parent, units, indices, sharded_planner)
                if sh is not None:
                    return sh
            if bk == "numpy" or max_batch < 2:
                return None
            parts = parent.partitions
            if tier in ("engine", "default"):
                # planner consistency: batch only the partitions the unit
                # path would dispatch to this kernel backend — demoted
                # partitions stay uncovered and run unit-at-a-time, where
                # _timed re-derives the identical numpy decision
                key = planner_key(node)
                indices = [
                    i for i in indices
                    if self.planner.choose(key, parts[i].nrows, bk) == bk
                ]
                if not indices:
                    return None
            batches: List[UnitBatch] = []
            last_block_end: List[float] = [float("-inf")]  # shared across node's batches

            def flush(run: List[int]) -> None:
                # emit power-of-two-sized batches only (the executor's k is
                # already a power of two; this quantises the tail remainder
                # too), so each (op, bucket) pair compiles a handful of fused
                # executables that the warmup / first window fully covers
                while len(run) >= 2:
                    take = 1 << (len(run).bit_length() - 1)
                    _flush_exact(run[:take])
                    run = run[take:]
                # a trailing singleton gains nothing over the unit path

            def _flush_exact(chunk: List[int]) -> None:
                group = [parts[i] for i in chunk]
                plan = planner(node, inputs, group, bk)
                if plan is None:
                    return
                dispatch, finalize = plan
                rows = sum(p.nrows for p in group)
                t_disp: List[float] = []

                def disp(_d=dispatch, _t=t_disp):
                    _t.append(time.perf_counter())
                    return _d()

                def fin(handle, _f=finalize, _t=t_disp, _rows=rows, _bk=bk):
                    out = _f(handle)
                    now = time.perf_counter()
                    start = max(_t[0], last_block_end[0])
                    last_block_end[0] = now
                    self.cost_model.add_sample(
                        planner_key(node), _bk, _rows, now - start
                    )
                    return out

                batches.append(
                    UnitBatch(
                        indices=list(chunk),
                        dispatch=disp,
                        finalize=fin,
                        cost_s=sum(units[i].cost_s for i in chunk),
                        tag=f"{node.op}[batch x{len(chunk)}]",
                    )
                )

            # group by shape bucket *non-contiguously*: the think-time-aware
            # partitioner sizes partitions by interaction hazard, so adjacent
            # partitions often land in different buckets while e.g. the head
            # and tail (or all mid partitions of an evenly-split table) share
            # one.  Stable within a bucket, so batch contents are deterministic.
            chunk: List[int] = []
            bucket = None
            for i in sorted(indices, key=lambda i: (BK.shape_bucket(parts[i]), i)):
                b = BK.shape_bucket(parts[i])
                if chunk and (b != bucket or len(chunk) >= max_batch):
                    flush(chunk)
                    chunk = []
                bucket = b
                chunk.append(i)
            flush(chunk)
            return batches or None

        return make_batches

    def _sharded_batch(
        self,
        node: Node,
        parent: Any,
        units: List[Unit],
        indices: List[int],
        sharded_planner: Callable[[Node, Any, List[int]], Any],
    ) -> Optional[List[UnitBatch]]:
        """One sharded :class:`UnitBatch` covering every missing partition of
        ``node`` — a single call over the data mesh replaces k per-partition
        kernel dispatches (frame/dist.py).  Chosen by the planner's
        per-(op, sharded|host) estimates, or forced under dist mode "on";
        None declines back to the per-backend batching path."""
        from . import dist

        if not BK.sharded_available(self.device) or len(indices) < 2:
            return None
        key = planner_key(node)
        parts = parent.partitions
        rows = sum(parts[i].nrows for i in indices)
        if dist.mode() != "on" and not self.planner.choose_sharded(
            key, self.backend_policy.resolve(), rows, len(indices)
        ):
            return None
        plan = sharded_planner(node, parent, list(indices))
        if plan is None:
            return None
        dispatch, finalize, n_dev = plan
        t_disp: List[float] = []

        def disp():
            t_disp.append(time.perf_counter())
            return dispatch()

        def fin(handle):
            out = finalize(handle)
            self.cost_model.add_sample(
                key, "sharded", rows, time.perf_counter() - t_disp[0]
            )
            return out

        return [
            UnitBatch(
                indices=list(indices),
                dispatch=disp,
                finalize=fin,
                cost_s=sum(units[i].cost_s for i in indices),
                tag=f"{node.op}[sharded x{len(indices)}@{n_dev}]",
                devices=n_dev,
            )
        ]

    def _read_bounds(self, node: Node):
        return node.kwargs["partition_bounds"]

    def _base_read(self, node: Node) -> Optional[Node]:
        cur = node
        while cur.parents:
            cur = cur.parents[0]
        return cur if cur.op == "read_table" else None

    def _partition_cost(self, node: Node, j: int) -> float:
        """Best-effort per-partition cost for the head/tail partial path."""
        base = self._base_read(node)
        c = self._node_cost(node)
        if base is not None:
            bounds = base.kwargs.get("partition_bounds")
            if bounds:
                total = bounds[-1][1] - bounds[0][0]
                a, b = bounds[min(j, len(bounds) - 1)]
                return c * (b - a) / max(total, 1)
        return c / 16.0

    # --------------------------------------------------------- registration --
    def _register_all(self) -> None:
        eng = self.engine

        # ---- read_table (source-partitioned) --------------------------------
        def read_units(node: Node, inputs) -> List[Unit]:
            name = node.literals[0]
            bounds = self._read_bounds(node)
            spec = self.catalog.spec(name)
            total = max(spec.nrows, 1)
            return [
                Unit(
                    fn=(lambda a=a, b=b: self.catalog.generate(name, a, b)),
                    cost_s=spec.io_seconds * (b - a) / total,
                    tag=f"read[{a}:{b}]",
                )
                for a, b in bounds
            ]

        def read_combine(node, inputs, results):
            return PTable(list(results))

        eng.register_op(
            "read_table",
            OpRuntime(
                units=read_units,
                combine=read_combine,
                source_partitioned=True,
                gen_partition=lambda node, j: self.catalog.generate(
                    node.literals[0], *self._read_bounds(node)[j]
                ),
                n_partitions=lambda node: len(self._read_bounds(node)),
                partition_cost=lambda node, j: (
                    self.catalog.spec(node.literals[0]).io_seconds
                    * (self._read_bounds(node)[j][1] - self._read_bounds(node)[j][0])
                    / max(self.catalog.spec(node.literals[0]).nrows, 1)
                ),
            ),
        )

        # ---- partition-wise ops ---------------------------------------------
        def make_pw(apply_fn, batch_planner=None):
            def units(node: Node, inputs) -> List[Unit]:
                parent: PTable = inputs[0]
                extras = list(inputs[1:])
                costs = self._unit_costs_by_rows(node, parent.partitions)
                return [
                    Unit(
                        fn=(lambda p=p: apply_fn(node, p, extras)),
                        cost_s=c,
                        tag=f"{node.op}[{i}]",
                    )
                    for i, (p, c) in enumerate(zip(parent.partitions, costs))
                ]

            def combine(node, inputs, results):
                return PTable(list(results))

            return OpRuntime(
                units=units,
                combine=combine,
                partitionwise=True,
                apply_partition=apply_fn,
                partition_cost=self._partition_cost,
                make_batches=(
                    self._batch_maker(batch_planner) if batch_planner else None
                ),
            )

        def filter_expr(node: Node):
            if node.op == "filter_cmp":
                rhs = (
                    ("ref", 0)
                    if node.kwargs.get("value_ref")
                    else ("lit", node.literals[0])
                )
                return (node.kwargs["cmp"], ("col", node.kwargs["col"]), rhs)
            if node.op == "isin":
                return ("isin", ("col", node.kwargs["col"]), list(node.literals[0]))
            if node.op == "between":
                return (
                    "between",
                    ("col", node.kwargs["col"]),
                    node.literals[0],
                    node.literals[1],
                )
            return node.kwargs["expr"]

        def filter_apply(node: Node, part: Partition, extras) -> Partition:
            keep = predicate_mask(filter_expr(node), part, extras)
            return self._timed(
                node, part.nrows, lambda bk: BK.select_rows(
                    part, keep, backend=bk, device=self.device
                )
            )()

        def project_apply(node: Node, part: Partition, extras) -> Partition:
            return part.project(node.kwargs["cols"])

        def assign_apply(node: Node, part: Partition, extras) -> Partition:
            col = eval_expr(node.kwargs["expr"], part, extras)
            return part.with_column(node.kwargs["col"], col)

        def fillna_apply(node: Node, part: Partition, extras) -> Partition:
            target_cols = node.kwargs.get("cols")  # None = all
            if node.kwargs.get("value_ref", False):
                from .exprs import _as_scalar

                value = _as_scalar(extras[0])
            else:
                value = node.kwargs["value"]
            new = dict(part.columns)
            for name in target_cols or part.order:
                c = part.columns[name]
                if c.mask is None or c.is_string:
                    continue
                data = np.where(c.mask, c.data, np.asarray(value, c.data.dtype))
                new[name] = Column(data=data, mask=None, dictionary=c.dictionary)
            return Partition(new, list(part.order))

        def dropna_keep(node: Node, part: Partition) -> np.ndarray:
            """Row-validity mask for dropna — shared by the unbatched apply
            and the batch planner so the two paths cannot diverge."""
            subset = node.kwargs.get("subset") or part.order
            keep = None
            for name in subset:
                v = part.columns[name].valid_mask()
                keep = v if keep is None else (keep & v)
            return keep

        def dropna_apply(node: Node, part: Partition, extras) -> Partition:
            keep = dropna_keep(node, part)
            return self._timed(
                node, part.nrows, lambda bk: BK.select_rows(
                    part, keep, backend=bk, device=self.device
                )
            )()

        def join_apply(node: Node, part: Partition, extras) -> Partition:
            right: PTable = extras[0]
            return self._timed(
                node,
                part.nrows,
                lambda bk: BK.join_partition(
                    part, right, node.kwargs["on"],
                    node.kwargs.get("how", "inner"), backend=bk, device=self.device,
                ),
            )()

        def filter_batch_planner(node, inputs, group, bk):
            extras = list(inputs[1:])
            return BK.plan_select_rows_batch(
                group,
                lambda: [
                    predicate_mask(filter_expr(node), p, extras) for p in group
                ],
                backend=bk, device=self.device,
            )

        def dropna_batch_planner(node, inputs, group, bk):
            return BK.plan_select_rows_batch(
                group, lambda: [dropna_keep(node, p) for p in group], backend=bk,
                device=self.device
            )

        # exposed for the fusion driver (_try_fused): fused chains re-derive
        # the filter's keep mask from the filter node against the *parent*
        # partitions, so mask semantics must be shared, not duplicated
        self._filter_expr = filter_expr
        self._dropna_keep = dropna_keep

        eng.register_op("filter", make_pw(filter_apply, filter_batch_planner))
        eng.register_op("filter_cmp", make_pw(filter_apply, filter_batch_planner))
        eng.register_op("isin", make_pw(filter_apply, filter_batch_planner))
        eng.register_op("between", make_pw(filter_apply, filter_batch_planner))
        eng.register_op("project", make_pw(project_apply))
        eng.register_op("assign", make_pw(assign_apply))
        eng.register_op("fillna", make_pw(fillna_apply))
        eng.register_op("dropna", make_pw(dropna_apply, dropna_batch_planner))
        eng.register_op("join", make_pw(join_apply))

        # ---- head / tail -----------------------------------------------------
        def ht_units(node, inputs):
            return [Unit(fn=lambda: None, cost_s=1e-6, tag=node.op)]

        def head_combine(node, inputs, results):
            k = int(node.literals[0]) if node.literals else 5
            table = PTable(list(inputs[0].partitions))
            return table.head(k) if node.op == "head" else table.tail(k)

        eng.register_op(
            "head",
            OpRuntime(
                units=ht_units,
                combine=head_combine,
                fast_interaction=self._fast_head,
            ),
        )
        eng.register_op(
            "tail",
            OpRuntime(
                units=ht_units,
                combine=head_combine,
                fast_interaction=self._fast_head,
            ),
        )

        # ---- columns (metadata-only) ------------------------------------------
        def columns_units(node, inputs):
            return [Unit(fn=lambda: None, cost_s=1e-6, tag="columns")]

        def columns_combine(node, inputs, results):
            parent = node.parents[0]
            try:
                return ColumnsResult(infer_schema(parent, self.catalog))
            except (SchemaUnknown, KeyError):
                value = self.engine.value_of(parent)
                return ColumnsResult(value.column_names)

        eng.register_op(
            "columns",
            OpRuntime(units=columns_units, combine=columns_combine, needs_inputs=False),
        )

        # ---- blocking: describe / mean / mean_scalar ---------------------------
        def stats_units(node, inputs):
            parent: PTable = inputs[0]
            costs = self._unit_costs_by_rows(node, parent.partitions)
            return [
                Unit(
                    fn=self._timed(
                        node, p.nrows, lambda bk, p=p: BK.partial_stats(
                            p, backend=bk, device=self.device
                        )
                    ),
                    cost_s=c,
                    tag=f"stats[{i}]",
                )
                for i, (p, c) in enumerate(zip(parent.partitions, costs))
            ]

        stats_batches = self._batch_maker(
            lambda node, inputs, group, bk: BK.plan_stats_batch(
                group, backend=bk, device=self.device
            ),
            sharded_planner=lambda node, parent, idx: BK.plan_stats_sharded_batch(
                parent, idx, backend=self.backend(), device=self.device
            ),
        )

        def stats_running(kind):
            # progressive channel: per-partition ColStats partials stream into
            # a Chan-merged running state with CLT intervals (frame/blocking)
            def make(node, inputs):
                return B.RunningStats(
                    total_units=len(inputs[0].partitions), kind=kind
                )

            return make

        eng.register_op(
            "describe",
            OpRuntime(
                units=stats_units,
                combine=lambda n, i, r: B.stats_to_table(B.merge_stats(r)),
                make_batches=stats_batches,
                try_fused=self._try_sharded_or_fused,
                running_combine=stats_running("describe"),
            ),
        )
        eng.register_op(
            "mean",
            OpRuntime(
                units=stats_units,
                combine=lambda n, i, r: B.means_to_table(B.merge_stats(r)),
                make_batches=stats_batches,
                try_fused=self._try_sharded_or_fused,
                running_combine=stats_running("mean"),
            ),
        )

        def mean_scalar_combine(node, inputs, results):
            merged = B.merge_stats(results)
            vals = [s.mean for s in merged.values() if s.n > 0]
            return float(np.mean(vals)) if vals else float("nan")

        eng.register_op(
            "mean_scalar",
            OpRuntime(
                units=stats_units,
                combine=mean_scalar_combine,
                make_batches=stats_batches,
                try_fused=self._try_sharded_or_fused,
                running_combine=stats_running("mean_scalar"),
            ),
        )

        # ---- value_counts -------------------------------------------------------
        def vc_units(node, inputs):
            parent: PTable = inputs[0]
            col = node.kwargs["col"]
            costs = self._unit_costs_by_rows(node, parent.partitions)
            return [
                Unit(
                    fn=self._timed(
                        node,
                        p.nrows,
                        lambda bk, p=p: BK.partial_value_counts(
                            p, col, backend=bk, device=self.device
                        ),
                    ),
                    cost_s=c,
                    tag=f"vc[{i}]",
                )
                for i, (p, c) in enumerate(zip(parent.partitions, costs))
            ]

        def vc_combine(node, inputs, results):
            col = node.kwargs["col"]
            dictionary = inputs[0].partitions[0].columns[col].dictionary
            return B.merge_value_counts(results, dictionary, col)

        def vc_running(node, inputs):
            col = node.kwargs["col"]
            dictionary = inputs[0].partitions[0].columns[col].dictionary
            return B.RunningValueCounts(len(inputs[0].partitions), col, dictionary)

        eng.register_op(
            "value_counts",
            OpRuntime(
                units=vc_units,
                combine=vc_combine,
                make_batches=self._batch_maker(
                    lambda node, inputs, group, bk: BK.plan_value_counts_batch(
                        group, node.kwargs["col"], backend=bk, device=self.device
                    )
                ),
                try_fused=self._try_sharded,  # no filter-fusion lowering exists
                running_combine=vc_running,
            ),
        )

        # ---- groupby_agg ----------------------------------------------------------
        def gb_units(node, inputs):
            parent: PTable = inputs[0]
            by = node.kwargs["by"]
            aggs = node.kwargs["aggs"]
            topk = node.kwargs.get("topk")
            costs = self._unit_costs_by_rows(node, parent.partitions)
            return [
                Unit(
                    fn=self._timed(
                        node,
                        p.nrows,
                        lambda bk, p=p: BK.partial_groupby(
                            p, by, aggs, topk, backend=bk, device=self.device
                        ),
                    ),
                    cost_s=c,
                    tag=f"gb[{i}]",
                )
                for i, (p, c) in enumerate(zip(parent.partitions, costs))
            ]

        def gb_combine(node, inputs, results):
            by = node.kwargs["by"]
            dictionary = inputs[0].partitions[0].columns[by].dictionary
            return B.merge_groupby(
                results, by, node.kwargs["aggs"], dictionary, node.kwargs.get("topk")
            )

        def gb_running(node, inputs):
            by = node.kwargs["by"]
            dictionary = inputs[0].partitions[0].columns[by].dictionary
            return B.RunningGroupby(
                len(inputs[0].partitions),
                by,
                node.kwargs["aggs"],
                dictionary,
                node.kwargs.get("topk"),
            )

        eng.register_op(
            "groupby_agg",
            OpRuntime(
                units=gb_units,
                combine=gb_combine,
                combine_cost=lambda n, i: 0.05 * self._node_cost(n),
                make_batches=self._batch_maker(
                    lambda node, inputs, group, bk: BK.plan_groupby_batch(
                        group,
                        node.kwargs["by"],
                        node.kwargs["aggs"],
                        node.kwargs.get("topk"),
                        backend=bk, device=self.device,
                    )
                ),
                try_fused=self._try_sharded_or_fused,
                running_combine=gb_running,
            ),
        )

        # ---- sort_values -------------------------------------------------------------
        def sort_units(node, inputs):
            parent: PTable = inputs[0]
            by = node.kwargs["by"]
            asc = node.kwargs.get("ascending", True)
            limit = node.kwargs.get("limit")
            costs = self._unit_costs_by_rows(node, parent.partitions)
            return [
                Unit(
                    fn=self._timed(
                        node,
                        p.nrows,
                        lambda bk, p=p: BK.partial_sort(
                            p, by, asc, limit, backend=bk, device=self.device
                        ),
                    ),
                    cost_s=c,
                    tag=f"sort[{i}]",
                )
                for i, (p, c) in enumerate(zip(parent.partitions, costs))
            ]

        def sort_combine(node, inputs, results):
            return BK.merge_sort(
                results,
                node.kwargs["by"],
                node.kwargs.get("ascending", True),
                node.kwargs.get("limit"),
                backend=self.backend_policy.resolve(), device=self.device,
            )

        eng.register_op(
            "sort_values",
            OpRuntime(
                units=sort_units,
                combine=sort_combine,
                combine_cost=lambda n, i: 0.25 * self._node_cost(n),
                make_batches=self._batch_maker(
                    lambda node, inputs, group, bk: BK.plan_sort_batch(
                        group,
                        node.kwargs["by"],
                        node.kwargs.get("ascending", True),
                        node.kwargs.get("limit"),
                        backend=bk, device=self.device,
                    )
                ),
                try_fused=self._try_sharded_or_fused,
            ),
        )

        # ---- drop_sparse_cols (case study §6) --------------------------------------
        def dsc_units(node, inputs):
            parent: PTable = inputs[0]
            costs = self._unit_costs_by_rows(node, parent.partitions)
            return [
                Unit(
                    fn=(lambda p=p: B.partial_null_counts(p)),
                    cost_s=c,
                    tag=f"nulls[{i}]",
                )
                for i, (p, c) in enumerate(zip(parent.partitions, costs))
            ]

        def dsc_combine(node, inputs, results):
            return B.combine_drop_sparse(
                inputs[0], results, node.kwargs["thresh"]
            )

        eng.register_op(
            "drop_sparse_cols", OpRuntime(units=dsc_units, combine=dsc_combine)
        )

        # ---- generic synthetic op (benchmark DAGs without frames) -------------------
        def synth_units(node, inputs):
            n_units = int(node.kwargs.get("n_units", 1))
            c = self._node_cost(node) / n_units
            return [
                Unit(fn=(lambda i=i: i), cost_s=c, tag=f"synth[{i}]")
                for i in range(n_units)
            ]

        eng.register_op(
            "synthetic",
            OpRuntime(units=synth_units, combine=lambda n, i, r: len(r)),
        )

    # ---- sharded whole-node lowering: one call over the data mesh -----------
    def _sharded_whole_value(self, node: Node, key: str, table: PTable, bk: str):
        """``node``'s final value through ONE sharded call under the kernel
        backend ``bk``, or None outside the sharded envelope.  The sharded
        partials feed the op's registered combine, so results are bit-for-bit
        identical to the per-partition path (the sharded combines replay the
        host merges exactly — see frame/dist.py; merging one merged ColStats
        returns it as it is)."""
        if key == "describe":  # describe / mean / mean_scalar share the unit
            merged = BK.sharded_stats(table, backend=bk)
            partials = None if merged is None else [merged]
        elif key == "value_counts":
            partial = BK.sharded_value_counts(table, node.kwargs["col"], backend=bk)
            partials = None if partial is None else [partial]
        elif key == "groupby_agg" and node.kwargs.get("topk") is None:
            partial = BK.sharded_groupby(table, node.kwargs["by"], node.kwargs["aggs"],
                                         backend=bk)
            partials = None if partial is None else [partial]
        elif key == "sort_values:topk":
            partials = BK.sharded_topk(table, node.kwargs["by"],
                                       node.kwargs.get("ascending", True),
                                       node.kwargs["limit"], backend=bk)
        else:
            return None
        if partials is None:
            return None
        return self.engine.registry[node.op].combine(node, [table], partials)

    def _try_sharded(self, node: Node, ensure) -> Optional[Any]:
        """Engine ``try_fused`` hook: run the whole node as one sharded call
        when a data mesh on this session's kind of device exists and the
        planner's per-(op, sharded|host) estimates favour it over
        per-partition dispatches (dist mode "on" skips the cost check —
        forced, for tests and benches).  Returns the combined value, or None
        for the normal path."""
        from . import dist

        if not BK.sharded_available(self.device) or len(node.parents) != 1:
            return None
        bk, tier = self.backend_policy.resolve_tier()
        if tier not in ("engine", "default"):
            return None  # an explicit backend override pins the host path
        eng = self.engine
        fnode = node.parents[0]
        if fnode.op in _FUSABLE_FILTER_OPS and fnode.nid not in eng.cache:
            return None  # leave uncached filter chains to the fusion lowering
        table = ensure(fnode)
        if not isinstance(table, PTable) or len(table.partitions) < 2:
            return None
        key = planner_key(node)
        rows = sum(p.nrows for p in table.partitions)
        if dist.mode() != "on" and not self.planner.choose_sharded(
            key, bk, rows, len(table.partitions)
        ):
            return None
        t0 = time.perf_counter()
        value = self._sharded_whole_value(node, key, table, bk)
        if value is None:
            return None
        self.cost_model.add_sample(key, "sharded", rows, time.perf_counter() - t0)
        est = self.planner.estimate(key, "sharded", rows)
        if est is not None:
            eng.clock.advance(est)
        return value

    def _try_sharded_or_fused(self, node: Node, ensure) -> Optional[Any]:
        """Composite ``try_fused`` slot: the sharded whole-node lowering
        first (it covers every partition in one call), then the
        filter-fusion lowering."""
        out = self._try_sharded(node, ensure)
        if out is not None:
            return out
        return self._try_fused(node, ensure)

    # ---- planner fusion: filter→reduce chains as one dispatch ----------------
    def _fuse_keep(self, fnode: Node, part: Partition) -> np.ndarray:
        """The filter node's keep mask on one *parent* partition — the same
        mask the unfused filter dispatch would compute (shared helpers, so
        the two paths cannot diverge)."""
        if fnode.op == "dropna":
            return np.asarray(self._dropna_keep(fnode, part), bool)
        return np.asarray(
            predicate_mask(self._filter_expr(fnode), part, []), bool
        )

    def _fused_partial_fns(self, node: Node, key: str):
        """``(fused_fn, unfused_fn)`` for ops with a fused lowering, else
        None.  ``fused_fn(part, keep, bk)`` runs the one-dispatch composite
        on the unfiltered partition (None = partition outside the fused
        envelope); ``unfused_fn(filtered, bk)`` is the per-partition unfused
        second stage used as the in-chain fallback."""
        if key == "describe":  # describe / mean / mean_scalar share the unit
            return (
                lambda p, keep, bk: BK.fused_stats_partition(
                    p, keep, backend=bk, device=self.device
                ),
                lambda p, bk: BK.partial_stats(p, backend=bk, device=self.device),
            )
        if key == "groupby_agg" and node.kwargs.get("topk") is None:
            by, aggs = node.kwargs["by"], node.kwargs["aggs"]
            return (
                lambda p, keep, bk: BK.fused_groupby_partition(
                    p, keep, by, aggs, backend=bk, device=self.device
                ),
                lambda p, bk: BK.partial_groupby(
                    p, by, aggs, None, backend=bk, device=self.device
                ),
            )
        if key == "sort_values:topk":
            by = node.kwargs["by"]
            asc = node.kwargs.get("ascending", True)
            limit = node.kwargs.get("limit")
            return (
                lambda p, keep, bk: BK.fused_topk_partition(
                    p, keep, by, asc, limit, backend=bk, device=self.device
                ),
                lambda p, bk: BK.partial_sort(
                    p, by, asc, limit, backend=bk, device=self.device
                ),
            )
        return None

    def _try_fused(self, node: Node, ensure) -> Optional[Any]:
        """Engine ``try_fused`` hook: lower filter→``node`` as one fused
        dispatch chain when the planner's estimates favour it.

        Eligibility (the linear-chain rule): ``node``'s single parent is an
        uncached filter-family node with a single parent of its own, whose
        output feeds ONLY this node; the backend resolves at a
        planner-governed tier; and the fused estimate beats the summed
        unfused estimates.  Returns the combined value, or None to run the
        normal unfused path."""
        eng = self.engine
        planner = self.planner
        if not (planner.enabled and planner.fusion):
            return None
        if len(node.parents) != 1:
            return None
        fnode = node.parents[0]
        if fnode.op not in _FUSABLE_FILTER_OPS or len(fnode.parents) != 1:
            return None
        if fnode.nid in eng.cache or fnode.nid in eng.partials:
            return None  # the filter already (partially) ran: fusing wastes it
        if len(eng.dag.children(fnode)) != 1:
            return None  # shared filter output: materialising it pays off
        bk, tier = self.backend_policy.resolve_tier()
        if bk == "numpy" or tier not in ("engine", "default"):
            return None
        key = planner_key(node)
        fns = self._fused_partial_fns(node, key)
        if fns is None:
            return None
        fused_key = f"fused:filter|{key}"
        parent_table = ensure(fnode.parents[0])
        if not isinstance(parent_table, PTable):
            return None
        rows = sum(p.nrows for p in parent_table.partitions)
        if not planner.choose_fusion(fused_key, bk, rows, ["filter", key]):
            return None
        fused_fn, unfused_fn = fns
        results: List[Any] = []
        t0 = time.perf_counter()
        for part in parent_table.partitions:
            keep = self._fuse_keep(fnode, part)
            out = fused_fn(part, keep, bk)
            if out is None:
                # this partition sits outside the fused envelope (empty keep,
                # unsupported column, runtime kernel failure): run the plain
                # two-step sequence for it — identical result by definition
                filtered = BK.select_rows(
                    part, keep,
                    backend=self._planned_backend("filter", part.nrows),
                    device=self.device,
                )
                out = unfused_fn(filtered, bk)
            results.append(out)
        # the fused samples calibrate the fused key itself, so the
        # fuse/don't-fuse decision keeps tracking measured reality
        self.cost_model.add_sample(fused_key, bk, rows, time.perf_counter() - t0)
        est = planner.estimate(fused_key, bk, rows)
        if est is not None:
            eng.clock.advance(est)
        return eng.registry[node.op].combine(node, [parent_table], results)

    # ---- interaction fast paths (paper Fig. 2b, §5.1) -----------------------------
    def _sharded_topk_value(self, frame, by, asc, k, bk):
        """Top-k over the data mesh for the head-of-sort pushdown: one call
        yields every partition's local winners, merged by the same
        ``B.merge_sort`` the host path uses.  Partial-sort row selection is
        bit-exact across backends, so the result is bit-for-bit the host
        answer.  None declines to the per-partition host loop."""
        from . import dist

        if not BK.sharded_available(self.device):
            return None
        if not isinstance(frame, PTable) or len(frame.partitions) < 2:
            return None
        rows = sum(p.nrows for p in frame.partitions)
        if dist.mode() != "on" and not self.planner.choose_sharded(
            "sort_values:topk", bk, rows, len(frame.partitions)
        ):
            return None
        t0 = time.perf_counter()
        partials = BK.sharded_topk(frame, by, asc, k, backend=bk)
        if partials is None:
            return None
        value = B.merge_sort(partials, by, asc, limit=k)
        self.cost_model.add_sample(
            "sort_values:topk", "sharded", rows, time.perf_counter() - t0
        )
        return value

    def _fast_head(self, node: Node) -> Optional[Any]:
        """head/tail over an unexecuted groupby or sort: compute only the
        top-k groups / rows (predicate pushdown through blocking ops)."""
        if not node.parents:
            return None
        k = int(node.literals[0]) if node.literals else 5
        parent = node.parents[0]
        eng = self.engine
        if parent.nid in eng.cache:
            return None  # cheap anyway; let the normal path run
        if parent.op == "groupby_agg" and node.op == "head":
            frame_node = parent.parents[0]
            frame = eng.value_of(frame_node)
            by = parent.kwargs["by"]
            aggs = parent.kwargs["aggs"]
            bk = self.backend()
            partials = [
                BK.partial_groupby(
                    p, by, aggs, topk_keys=k, backend=bk, device=self.device
                )
                for p in frame.partitions
            ]
            dictionary = frame.partitions[0].columns[by].dictionary
            value = B.merge_groupby(partials, by, aggs, dictionary, topk_keys=k)
            # charge a cost proportional to the group fraction computed
            est_groups = max(self.cost_model.est_rows(parent), 1.0)
            frac = min(1.0, k / est_groups)
            eng.clock.advance(self._node_cost(parent) * frac)
            return PTable(list(value.partitions)).head(k)
        if parent.op == "sort_values":
            frame_node = parent.parents[0]
            frame = eng.value_of(frame_node)
            by = parent.kwargs["by"]
            asc = parent.kwargs.get("ascending", True)
            if node.op == "tail":
                asc = not asc
            bk = self.backend()
            value = self._sharded_topk_value(frame, by, asc, k, bk)
            if value is None:
                partials = [
                    BK.partial_sort(p, by, asc, limit=k, backend=bk, device=self.device)
                    for p in frame.partitions
                ]
                value = B.merge_sort(partials, by, asc, limit=k)
            # local top-k selection avoids the global merge: charge ~60 %
            eng.clock.advance(self._node_cost(parent) * 0.6)
            out = PTable(list(value.partitions)).head(k)
            if node.op == "tail":
                merged = out.concat()
                out = PTable([merged.take(np.arange(merged.nrows - 1, -1, -1))])
            return out
        return None


def install(engine: Engine, catalog: Catalog, device=None) -> FrameRuntime:
    return FrameRuntime(engine, catalog, device=device)
