"""Materialised-result cache with utility-based eviction (paper §4.3, §5.2).

Eq 2:  p_i = 1 / (T + 1 - t_i)          (recency proxy for reuse probability)
Eq 3:  O(r_i) = p_i * m_i / k_i         (paper: discard the lowest O)

The paper's Eq 3 as written discards *small, expensive-to-recompute* results
first, which is internally inconsistent with its own prose; we implement it
verbatim as policy ``"paper_eq3"`` and additionally ship the corrected
GreedyDual-Size-style policy ``"corrected"`` that discards the result with the
lowest  p_i * k_i / m_i  (low reuse probability, cheap to recompute, large).
``benchmarks/bench_cache.py`` ablates both against LRU and size-only.

GC triggers when memory consumption exceeds ``gc_threshold`` (paper: 80%) of
the budget; eviction continues until back under the threshold.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional

from . import faults as _faults
from .costmodel import CostModel
from .dag import Node

EvictionPolicy = str  # "paper_eq3" | "corrected" | "lru" | "size"


def result_nbytes(value: Any) -> int:
    """Best-effort memory footprint of a materialised result."""
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(value, (int, float, bool)):
        return 8
    if isinstance(value, str):
        return len(value)
    if isinstance(value, (list, tuple)):
        return sum(result_nbytes(v) for v in value) + 8 * len(value)
    if isinstance(value, dict):
        return sum(result_nbytes(v) + len(str(k)) for k, v in value.items())
    return 64


@dataclass
class CacheEntry:
    node: Node
    value: Any
    m_bytes: int
    t_last_use: int
    pinned: int = 0
    speculative: bool = False
    # multi-tenant serving: the tenants whose programs reference this node.
    # A shared (deduped) entry charges its full size against *each*
    # subscriber's share — conservative, and it keeps the per-tenant byte
    # accounting integral.  Empty = untenanted (single-tenant engine).
    tenants: set = field(default_factory=set)


@dataclass
class MaterializedCache:
    budget_bytes: int
    cost_model: CostModel
    policy: EvictionPolicy = "corrected"
    gc_threshold: float = 0.8  # paper §4.3
    on_evict: Optional[Callable[[Node], None]] = None
    # chaos harness: the cache.put / cache.get injection sites (background-only
    # by default — see core.faults).  None disables injection entirely.
    fault_plan: Optional[Any] = None

    _entries: Dict[int, CacheEntry] = field(default_factory=dict)
    _T: int = 0  # paper's global reuse counter
    used_bytes: int = 0
    n_evictions: int = 0
    n_hits: int = 0
    n_misses: int = 0
    # -- multi-tenant fairness state -------------------------------------------
    # node id -> subscribing tenants, maintained by the serving layer as
    # programs are interned; consulted at put() time so entries are charged
    # without threading a tenant through every execution path.
    node_tenants: Dict[int, set] = field(default_factory=dict)
    # tenant -> charged bytes (full entry size per subscriber, see CacheEntry)
    _tenant_bytes: Dict[str, int] = field(default_factory=dict)
    n_fairness_evictions: int = 0  # victims chosen by the fair-share rule

    # -- basic ops -----------------------------------------------------------------
    def __contains__(self, nid: int) -> bool:
        return nid in self._entries

    def executed_ids(self) -> set[int]:
        return set(self._entries)

    def get(self, node: Node) -> Any:
        mode = (
            self.fault_plan.fire("cache.get", op=node.op)  # may raise / sleep
            if self.fault_plan is not None
            else None
        )
        entry = self._entries.get(node.nid)
        if entry is None:
            self.n_misses += 1
            raise KeyError(node.nid)
        self.n_hits += 1
        self._T += 1  # paper: increment T on each reuse
        entry.t_last_use = self._T
        if mode == "corrupt":
            # transient read corruption: the stored entry stays intact, the
            # reader gets a detectably-poisoned value
            return _faults.corrupt(entry.value)
        return entry.value

    def peek(self, nid: int) -> Optional[Any]:
        e = self._entries.get(nid)
        return None if e is None else e.value

    def put(self, node: Node, value: Any, speculative: bool = False) -> None:
        if self.fault_plan is not None:
            mode = self.fault_plan.fire("cache.put", op=node.op)  # may raise
            if mode == "corrupt":
                # the stored copy is poisoned; every consumer boundary
                # (foreground _ensure, background input fetch) detects it
                value = _faults.corrupt(value)
        m = result_nbytes(value)
        old = self._entries.pop(node.nid, None)
        subscribers = set(self.node_tenants.get(node.nid, ()))
        if old is not None:
            self.used_bytes -= old.m_bytes
            self._uncharge(old)
            subscribers |= old.tenants  # a refresh must not shed subscribers
        entry = CacheEntry(
            node=node, value=value, m_bytes=m, t_last_use=self._T,
            speculative=speculative, tenants=subscribers,
        )
        self._entries[node.nid] = entry
        self.used_bytes += m
        self._charge(entry)
        self.maybe_gc()

    def drop(self, nid: int) -> None:
        e = self._entries.pop(nid, None)
        if e is not None:
            self.used_bytes -= e.m_bytes
            self._uncharge(e)
            if self.on_evict is not None:
                self.on_evict(e.node)

    # -- multi-tenant fairness ---------------------------------------------------
    def _charge(self, entry: CacheEntry) -> None:
        for t in entry.tenants:
            self._tenant_bytes[t] = self._tenant_bytes.get(t, 0) + entry.m_bytes

    def _uncharge(self, entry: CacheEntry) -> None:
        for t in entry.tenants:
            self._tenant_bytes[t] = self._tenant_bytes.get(t, 0) - entry.m_bytes

    def register_tenant(self, tenant: str) -> None:
        """Make ``tenant`` count towards the fair-share denominator (idempotent)."""
        self._tenant_bytes.setdefault(tenant, 0)

    def subscribe(self, nid: int, tenant: str) -> None:
        """Subscribe ``tenant`` to node ``nid`` (dedup: a second tenant's
        identical query points at the same materialisation).  Charges the
        tenant for an already-cached entry immediately; future put()s pick the
        subscription up from :attr:`node_tenants`."""
        self.register_tenant(tenant)
        self.node_tenants.setdefault(nid, set()).add(tenant)
        e = self._entries.get(nid)
        if e is not None and tenant not in e.tenants:
            e.tenants.add(tenant)
            self._tenant_bytes[tenant] += e.m_bytes

    def tenant_bytes(self, tenant: str) -> int:
        return self._tenant_bytes.get(tenant, 0)

    def fair_share(self) -> float:
        """Per-tenant slice of the memory budget (equal split)."""
        return self.budget_bytes / max(1, len(self._tenant_bytes))

    def over_share(self) -> set:
        share = self.fair_share()
        return {t for t, b in self._tenant_bytes.items() if b > share}

    def tenant_stats(self) -> dict:
        return {
            "fair_share_bytes": self.fair_share(),
            "tenant_bytes": dict(sorted(self._tenant_bytes.items())),
            "fairness_evictions": self.n_fairness_evictions,
        }

    def pin(self, nid: int) -> None:
        if nid in self._entries:
            self._entries[nid].pinned += 1

    def unpin(self, nid: int) -> None:
        if nid in self._entries and self._entries[nid].pinned > 0:
            self._entries[nid].pinned -= 1

    # -- eviction ---------------------------------------------------------------------
    def _p(self, entry: CacheEntry) -> float:
        return 1.0 / (self._T + 1 - entry.t_last_use)  # Eq 2

    def _score(self, entry: CacheEntry) -> float:
        """Lower score = evicted first."""
        p = self._p(entry)
        m = max(entry.m_bytes, 1)
        k = max(
            self.cost_model.recompute_cost(entry.node, self.executed_ids()), 1e-9
        )
        if self.policy == "paper_eq3":
            return p * m / k  # Eq 3 verbatim: discard lowest O
        if self.policy == "corrected":
            return p * k / m  # GreedyDual-Size: keep high-p, costly, small
        if self.policy == "lru":
            return float(entry.t_last_use)
        if self.policy == "size":
            return -float(m)  # discard largest
        raise ValueError(f"unknown eviction policy {self.policy!r}")

    def maybe_gc(self) -> int:
        """Evict until under gc_threshold * budget. Returns #evictions.

        With tenants registered, eviction is *fair-share constrained*: while
        any tenant is over its equal slice of the budget, victims must be
        entries all of whose subscribers are over-share — Eq-2/3 scoring then
        runs *within* that over-share pool, so a tenant below its fair share
        is never evicted to make room for one above it.  If no such victim
        exists (the over-share bytes are all pinned or shared with under-share
        tenants), GC falls back to the global score so it always makes
        progress — fairness must never wedge the allocator (starvation-free,
        including under the fault-quarantine recompute paths)."""
        limit = self.gc_threshold * self.budget_bytes
        if self.used_bytes <= limit:
            return 0
        evicted = 0
        # speculative results go before user-program results at equal score
        while self.used_bytes > limit:
            candidates = [e for e in self._entries.values() if e.pinned == 0]
            if not candidates:
                break
            victim = None
            if self._tenant_bytes:
                over = self.over_share()
                if over:
                    eligible = [
                        e for e in candidates if e.tenants and e.tenants <= over
                    ]
                    if eligible:
                        victim = min(
                            eligible,
                            key=lambda e: (not e.speculative, self._score(e)),
                        )
                        self.n_fairness_evictions += 1
            if victim is None:
                victim = min(
                    candidates, key=lambda e: (not e.speculative, self._score(e))
                )
            self.drop(victim.node.nid)
            evicted += 1
            self.n_evictions += 1
        return evicted

    # -- stats ---------------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "used_bytes": self.used_bytes,
            "budget_bytes": self.budget_bytes,
            "hits": self.n_hits,
            "misses": self.n_misses,
            "evictions": self.n_evictions,
        }
