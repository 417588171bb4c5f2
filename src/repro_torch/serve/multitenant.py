"""Multi-tenant opportunistic serving: many sessions, one Engine.

The paper's claim — think time is idle capacity opportunistic evaluation can
harvest — generalises from one analyst to a fleet: with many concurrent
sessions, *one user's think window is another user's compute*.  This module
scales the single-session serving layer to N tenants sharing one
:class:`~repro.core.engine.Engine`:

* **Cross-tenant Eq-1** — every tenant's predicted think window is allocated
  across *all* tenants' background queues.  Each tenant declares the set of
  shared-DAG nodes its program demands (:meth:`MultiTenantServer.submit`);
  the scheduler's utility for a candidate becomes the weighted sum of every
  demanding tenant's Eq-1 term, memoised per (node, tenant) so the
  incremental ``pick()`` machinery carries over unchanged.

* **Cross-DAG dedup** — tenants author programs in *private* DAGs (their own
  authoring :class:`~repro.frame.api.Session`, or any DAG built by hand);
  :func:`~repro.core.cse.intern_program` hash-conses the program into the
  shared engine DAG, so structurally identical queries from different tenants
  resolve to one node and hence one materialisation.  Identity is the node
  fingerprint: (op, literals, kwargs, interned parents) — the same rule
  single-DAG CSE uses, applied across tenant boundaries.

* **Fair-share caching** — every interned node is subscribed to its tenant in
  the shared :class:`~repro.core.cache.MaterializedCache`; per-tenant byte
  accounting plus the fair-share GC rule keep one tenant's working set from
  evicting another's below its equal slice of the budget.

* **Tenant-scoped quarantine** — a node that faults inside tenant A's think
  window is quarantined under the (A, node) key only; the same deduped node
  keeps executing for everyone else (see ``Scheduler.quarantine``).

The optional *schedule log* records every background pick and every
interaction's cache hit/miss in order; two replays of the same seeded trace
must produce byte-identical logs (``tests/test_multitenant.py`` pins this).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..core.cse import intern_program
from ..core.dag import DAG, Node
from ..core.engine import Engine
from ..core.executor import OpRuntime, Unit


def register_synthetic_op(engine: Engine) -> None:
    """Register the generic ``synthetic`` operator on a bare engine (the same
    semantics the frame runtime registers): ``n_units`` preemption quanta of
    ``cost_s / n_units`` simulated seconds each, combine returning the unit
    count.  Lets trace-replay benchmarks and multi-tenant tests drive the
    full engine without the frame or model layers."""

    def units(node: Node, inputs) -> List[Unit]:
        n_units = int(node.kwargs.get("n_units", 1))
        c = float(node.kwargs.get("cost_s", 0.0)) / max(n_units, 1)
        return [
            Unit(fn=(lambda i=i: i), cost_s=c, tag=f"synth[{i}]")
            for i in range(n_units)
        ]

    engine.register_op(
        "synthetic", OpRuntime(units=units, combine=lambda n, i, r: len(r))
    )


def synthetic_trace_program(
    template: int, param: int, n_stages: int = 3
) -> Tuple[DAG, Node]:
    """The canonical private program for trace event ``(template, param)``:
    a chain of synthetic operators over a source shared by every template.

    Deterministic by construction (costs are a pure function of the
    template), so two sessions issuing the same (template, param) author
    *structurally identical* programs — the cross-tenant dedup case — while
    a different param perturbs the chain kwargs and defeats dedup honestly.
    Returns ``(private_dag, root)``; submit the root via
    :meth:`MultiTenantServer.submit`."""
    d = DAG()
    cur = d.add(
        "synthetic", kwargs={"tag": "trace_src", "cost_s": 0.4, "n_units": 4}
    )
    for stage in range(n_stages):
        cost = round(0.15 + 0.05 * (template % 4) + 0.04 * stage, 6)
        cur = d.add(
            "synthetic",
            parents=[cur],
            kwargs={
                "tag": f"tpl{template}.s{stage}",
                "param": int(param),
                "cost_s": cost,
                "n_units": 2,
            },
        )
    return d, cur


@dataclass
class TenantProgram:
    """One submitted program: the tenant's private roots mapped to shared nodes."""

    tenant: str
    roots: List[Node]  # shared-DAG nodes, in the order the private roots came
    n_nodes: int  # nodes in the private program's closure
    n_new: int  # how many the shared DAG actually gained (rest were deduped)

    @property
    def n_deduped(self) -> int:
        return self.n_nodes - self.n_new


class MultiTenantServer:
    """N interactive sessions multiplexed onto one opportunistic engine.

    The server owns the tenant bookkeeping — demand sets for the cross-tenant
    scheduler, cache subscriptions for fair-share accounting, dedup counters —
    while all execution stays in the shared engine.  Typical driver loop::

        srv = MultiTenantServer(engine)
        prog = srv.submit("alice", private_roots)     # intern + subscribe
        value = srv.interact("alice", prog.roots[0])  # display, tenant-tagged
        srv.think("alice", gap_s)                     # alice's window, shared
    """

    def __init__(self, engine: Engine, record_schedule: bool = False):
        self.engine = engine
        self._demand: Dict[str, Set[int]] = {}
        self._programs: List[TenantProgram] = []
        self.n_nodes_submitted = 0
        self.n_nodes_new = 0
        # ordered schedule log: the engine appends bare nids for background
        # picks; interact() appends ["interact", tenant, nid, "hit"|"miss"].
        # One flat list so relative order (pick vs interaction) is captured.
        self.schedule_log: Optional[List[Any]] = None
        if record_schedule:
            self.schedule_log = []
            engine.pick_log = self.schedule_log

    # ------------------------------------------------------------- tenants --
    def register(self, tenant: str, weight: float = 1.0) -> None:
        """Admit a tenant: counts towards the cache fair-share denominator
        immediately (even before it submits anything) and sets its Eq-1
        weight for cross-tenant utility."""
        self.engine.cache.register_tenant(tenant)
        self.engine.scheduler.tenant_weight[tenant] = float(weight)
        self._demand.setdefault(tenant, set())

    def tenants(self) -> List[str]:
        return sorted(self._demand)

    # ------------------------------------------------------------ programs --
    def submit(self, tenant: str, roots: Sequence[Node]) -> TenantProgram:
        """Intern a tenant's private program into the shared DAG.

        Every node of the program's closure is hash-consed against the shared
        DAG (cross-tenant CSE), subscribed to the tenant in the cache, and
        added to the tenant's scheduler demand set."""
        if tenant not in self._demand:
            self.register(tenant)
        mapping, n_new = intern_program(
            self.engine.dag, list(roots),
            observer=self.engine.observe_interned_node,
        )
        demand = self._demand.setdefault(tenant, set())
        for shared in mapping.values():
            self.engine.cache.subscribe(shared.nid, tenant)
            demand.add(shared.nid)
        self.engine.scheduler.set_tenant_demand(tenant, demand)
        prog = TenantProgram(
            tenant=tenant,
            roots=[mapping[r.nid] for r in roots],
            n_nodes=len(mapping),
            n_new=n_new,
        )
        self._programs.append(prog)
        self.n_nodes_submitted += prog.n_nodes
        self.n_nodes_new += prog.n_new
        return prog

    # --------------------------------------------------------- interaction --
    def interact(self, tenant: str, node: Node, progressive: bool = False) -> Any:
        """A tenant's interaction on a shared node (from a submitted program's
        ``roots``).  Cache hit/miss is logged *before* display so the schedule
        log captures whether think-time harvest got there first.

        ``progressive=True`` returns a ProgressiveResult (bounded estimate +
        upgrade path); its refinement units are attributed to ``tenant`` in
        the executor's per-tenant counters.  Non-progressive log entries keep
        their historical shape; progressive calls log a distinct tag."""
        if self.schedule_log is not None:
            hit = "hit" if node.nid in self.engine.cache else "miss"
            tag = "interact_progressive" if progressive else "interact"
            self.schedule_log.append([tag, tenant, node.nid, hit])
        if progressive:
            return self.engine.display_progressive(node, tenant=tenant)
        return self.engine.display(node, tenant=tenant)

    def think(self, tenant: str, seconds: float) -> dict:
        """``tenant``'s think window, harvested for *all* tenants' demand."""
        return self.engine.think(seconds, tenant=tenant)

    # --------------------------------------------------------------- stats --
    def dedup_rate(self) -> float:
        """Fraction of submitted program nodes resolved to existing shared
        nodes (0.0 with a single tenant and no repeated queries)."""
        if self.n_nodes_submitted == 0:
            return 0.0
        return 1.0 - self.n_nodes_new / self.n_nodes_submitted

    def schedule_fingerprint(self) -> str:
        """Canonical serialisation of the schedule log — two replays of the
        same seeded trace must match byte-for-byte."""
        assert self.schedule_log is not None, "record_schedule=False"
        return json.dumps(self.schedule_log, separators=(",", ":"))

    def stats(self) -> dict:
        per_tenant: Dict[str, dict] = {}
        for rec in self.engine.metrics.interactions:
            t = rec.tenant or ""
            d = per_tenant.setdefault(
                t, {"n_interactions": 0, "latency_s_sum": 0.0}
            )
            d["n_interactions"] += 1
            d["latency_s_sum"] += rec.latency_s
        return {
            "tenants": self.tenants(),
            "n_programs": len(self._programs),
            "n_nodes_submitted": self.n_nodes_submitted,
            "n_nodes_new": self.n_nodes_new,
            "dedup_rate": round(self.dedup_rate(), 4),
            "per_tenant_interactions": per_tenant,
            "units_by_tenant": dict(
                sorted(self.engine.executor.stats.units_by_tenant.items())
            ),
            "cache": self.engine.cache.tenant_stats(),
            "quarantines": self.engine.scheduler.quarantine_summary(),
        }
