"""Non-critical operator scheduling (paper §5.2, Eqs. 1 and 4).

The scheduler chooses which *source operator* (unexecuted, all predecessors
executed) to run next during think time.  Paper policy: maximize

    U(s_i)   = sum_{j in D_i} c_j                 (Eq 1)
    U_p(s_i) = sum_{j in D_i} c_j * p_j           (Eq 4)

where D_i is the source operator plus all of its successors, c_j is the
delivery cost (cost of j plus all unexecuted predecessors; 0 if executed) and
p_j the predicted probability of j's children being an interaction.

FIFO / LIFO / random / cheapest-first baselines are included for the
ablation benchmark (EXPERIMENTS.md §Ablations).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import random as _random
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .costmodel import CostModel
from .dag import DAG, Node
from .predictor import InteractionPredictor
from .slicing import source_operators

Policy = str  # "utility" | "utility_p" | "fifo" | "lifo" | "random" | "cheapest"


def sample_first_order(missing: Sequence[int], total: int) -> List[int]:
    """Intra-node unit ordering for progressive execution: a bit-reversal
    (van der Corput base-2) permutation over partition indices.

    Executing partitions in index order samples the table front-to-back —
    terrible for a bounded estimate when the data has any positional drift
    (time-ordered facts, clustered categories), because the covered prefix is
    a *biased* sample until late.  Bit-reversal order visits an evenly-spread,
    recursively-refining lattice (0, m/2, m/4, 3m/4, …): after k units the
    covered set is close to a uniform systematic sample of the partitions, so
    CLT variance estimates tighten at the fastest rate the coverage allows.

    Deterministic, and a pure permutation of ``missing`` — resumed execution
    (the exact path's ``execute``) still completes every unit, so completion
    semantics are untouched.  This orders units *within* one node; node-level
    ``pick()`` is a different axis and keeps its `reference_pick` parity.
    """
    if total <= 1 or len(missing) <= 1:
        return list(missing)
    bits = max((total - 1).bit_length(), 1)

    def rev(i: int) -> int:
        r = 0
        for _ in range(bits):
            r = (r << 1) | (i & 1)
            i >>= 1
        return r

    return sorted(missing, key=lambda i: (rev(i), i))


@dataclass
class QuarantineEntry:
    """Fault-domain state for one node whose background execution failed.

    Each failure doubles the backoff; after ``Scheduler.quarantine_max_failures``
    the node is quarantined permanently (``until = inf``) and only the
    interactive foreground path will ever compute it again."""

    failures: int = 0
    until: float = -math.inf
    last_error: str = ""


@dataclass
class Scheduler:
    dag: DAG
    cost_model: CostModel
    predictor: Optional[InteractionPredictor] = None
    policy: Policy = "utility"
    seed: int = 0
    # extra additive utility (speculative-materialisation boosts, paper §5.2)
    extra_utility: Optional[Callable[[Node], float]] = None
    # anti-thrash: nodes whose results were GC'd are not recomputed without
    # demand (an unexecuted descendant) — otherwise the background loop would
    # recompute-evict-recompute for the whole think window
    evicted_once: Set[int] = field(default_factory=set)
    # fault domains: background execution of these nodes failed; they are
    # skipped by pick() until their exponential backoff expires (permanently
    # after quarantine_max_failures).  Quarantine is a *post-filter* over the
    # enumerated sources — it never touches the delta-maintained memos, so
    # plans over non-quarantined state stay byte-identical to the brute-force
    # oracle (the PR-3 invariant).
    quarantine_base_s: float = 0.5
    quarantine_max_failures: int = 5
    # keyed (tenant, nid): once DAGs are shared across tenants, one tenant's
    # faulting execution of a deduped node must not quarantine it for every
    # tenant — another tenant's think window may still attempt it (and a
    # success clears every tenant's history for the node).  The single-tenant
    # engine passes tenant=None everywhere, which degrades to the old
    # one-key-per-node behaviour exactly.  A (None, nid) entry — a fault with
    # no tenant attribution, e.g. the real-mode worker — conservatively
    # blocks all tenants.
    quarantined: Dict[Tuple[Optional[str], int], QuarantineEntry] = field(
        default_factory=dict
    )
    _rng: _random.Random = field(init=False)

    def __post_init__(self) -> None:
        self._rng = _random.Random(self.seed)
        # hot-path memoisation: the think loop calls pick() once per executed
        # node, and each pick() walks descendants of every source and the
        # ancestor cone of every descendant.  Descendant sets depend only on
        # DAG structure (invalidated via dag.version); delivery costs and the
        # Eq-1 utility sums depend on structure + the executed set, and are
        # *delta-maintained*: when the executed set changes by a node x (one
        # completes, or an eviction removes one), only entries whose ancestor
        # cone contains x — i.e. the descendant cone of x — are dropped.
        # Everything outside that cone keeps its exact memoised float, so a
        # full recompute and the delta path produce byte-identical plans.
        self._dag_version: int = -1
        self._cost_version: int = -1
        self._desc_cache: dict[int, list[Node]] = {}
        self._desc_ids: dict[int, frozenset] = {}
        self._delivery_memo: dict[int, float] = {}
        self._utility_memo: dict[int, float] = {}  # Eq-1 base sums per source
        self._demand_memo: dict[int, bool] = {}  # evicted source -> has demand
        self._memo_done: Optional[frozenset] = None
        self._node_by_id: dict[int, Node] = {}
        # -- cross-tenant dimension (multi-tenant serving) ------------------
        # tenant -> the node ids of that tenant's program cone.  When any
        # demand set is registered, Eq-1 becomes cross-tenant:
        #     U(s) = sum_t w_t * sum_{j in D_s ∩ demand_t} c_j
        # with untenanted descendants (in no tenant's cone) kept at weight 1
        # under the pseudo-tenant key None, so directly-added nodes still
        # schedule.  The per-(source, tenant) partial sums are memoised in
        # _tenant_utility_memo and delta-invalidated by the same descendant-
        # cone rule as the single-tenant sums; the weights (think-time
        # urgency, set by the serving layer) are applied at read time so
        # think-model drift never touches the memos.
        self._tenant_demand: dict[str, frozenset] = {}
        self.tenant_weight: dict[str, float] = {}
        self._tenant_utility_memo: dict[tuple[int, Optional[str]], float] = {}

    # -- memoised graph walks ---------------------------------------------------
    def _drop_all_done_memos(self) -> None:
        self._delivery_memo.clear()
        self._utility_memo.clear()
        self._demand_memo.clear()
        self._tenant_utility_memo.clear()

    def _sync_caches(self, done: frozenset) -> None:
        v = self.dag.version
        if v != self._dag_version:
            self._dag_version = v
            self._desc_cache.clear()
            self._desc_ids.clear()
            self._drop_all_done_memos()
            self._memo_done = None
            self._node_by_id = {n.nid: n for n in self.dag.nodes}
        cv = getattr(self.cost_model, "version", 0)
        if cv != self._cost_version:
            # cost estimates drifted (EWMA observation / recalibration /
            # persisted-cost load): every memoised delivery cost and utility
            # sum is stale.  Demand verdicts are cost-free and survive.  The
            # delta path below still carries plan()'s greedy loop and eviction
            # churn, where costs don't move between picks.
            self._cost_version = cv
            self._delivery_memo.clear()
            self._utility_memo.clear()
            self._tenant_utility_memo.clear()
        if done != self._memo_done:
            prev = self._memo_done
            if prev is None:
                self._drop_all_done_memos()
            else:
                self._invalidate_cones(done ^ prev)
            self._memo_done = done

    def _invalidate_cones(self, changed: Iterable[int]) -> None:
        """Delta maintenance: completing or evicting node x only changes the
        delivery cost of nodes whose ancestor cone contains x — exactly the
        descendant cone of x — and the utility/demand of sources whose
        descendant set meets that cone."""
        affected: set = set()
        for nid in changed:
            node = self._node_by_id.get(nid)
            if node is None:  # executed id unknown to this DAG: full reset
                self._drop_all_done_memos()
                return
            affected |= self._desc_id_set(node)
        for nid in affected:
            self._delivery_memo.pop(nid, None)
        for memo in (self._utility_memo, self._demand_memo):
            stale = [
                s for s in memo if not affected.isdisjoint(self._desc_id_set_of(s))
            ]
            for s in stale:
                memo.pop(s, None)
        if self._tenant_utility_memo:
            stale_t = [
                key
                for key in self._tenant_utility_memo
                if not affected.isdisjoint(self._desc_id_set_of(key[0]))
            ]
            for key in stale_t:
                self._tenant_utility_memo.pop(key, None)

    def _descendants(self, node: Node) -> list[Node]:
        d = self._desc_cache.get(node.nid)
        if d is None:
            d = self.dag.descendants(node, include_self=True)
            self._desc_cache[node.nid] = d
        return d

    def _desc_id_set(self, node: Node) -> frozenset:
        s = self._desc_ids.get(node.nid)
        if s is None:
            s = frozenset(d.nid for d in self._descendants(node))
            self._desc_ids[node.nid] = s
        return s

    def _desc_id_set_of(self, nid: int) -> frozenset:
        node = self._node_by_id.get(nid)
        if node is None:
            return frozenset((nid,))
        return self._desc_id_set(node)

    def _delivery_cost(self, j: Node, done: frozenset) -> float:
        c = self._delivery_memo.get(j.nid)
        if c is None:
            c = self.cost_model.delivery_cost(j, done)
            self._delivery_memo[j.nid] = c
        return c

    # -- cross-tenant demand (multi-tenant serving) -----------------------------
    def set_tenant_demand(self, tenant: str, nids: Iterable[int]) -> None:
        """Register (or extend to) the node-id cone tenant's program demands.

        Any registered demand switches :meth:`utility` to the cross-tenant
        Eq-1 sum; the tenant's memoised partial sums are dropped (its demand
        set changed), everything else survives."""
        self._tenant_demand[tenant] = frozenset(nids)
        self.tenant_weight.setdefault(tenant, 1.0)
        stale = [k for k in self._tenant_utility_memo if k[1] == tenant]
        for k in stale:
            self._tenant_utility_memo.pop(k, None)
        # the untenanted remainder sums also shift when a demand set changes
        stale_none = [k for k in self._tenant_utility_memo if k[1] is None]
        for k in stale_none:
            self._tenant_utility_memo.pop(k, None)

    def tenant_demand(self, tenant: str) -> frozenset:
        return self._tenant_demand.get(tenant, frozenset())

    def _tenant_utility(
        self, source: Node, done: frozenset, tenant: Optional[str]
    ) -> float:
        """Memoised Eq-1 partial sum of ``source`` restricted to one tenant's
        demand cone (``None``: descendants in no tenant's cone)."""
        key = (source.nid, tenant)
        total = self._tenant_utility_memo.get(key)
        if total is None:
            total = 0.0
            if tenant is None:
                all_demand: set = set()
                for d in self._tenant_demand.values():
                    all_demand |= d
                for j in self._descendants(source):
                    if j.nid not in all_demand:
                        total += self._delivery_cost(j, done)
            else:
                demand = self._tenant_demand.get(tenant, frozenset())
                if not demand.isdisjoint(self._desc_id_set(source)):
                    for j in self._descendants(source):
                        if j.nid in demand:
                            total += self._delivery_cost(j, done)
            self._tenant_utility_memo[key] = total
        return total

    # -- utilities ---------------------------------------------------------------
    def utility(self, source: Node, executed: Iterable[int]) -> float:
        """Eq 1 (or Eq 4 when a predictor is used under policy='utility_p').

        With tenant demand registered the sum is cross-tenant: each
        descendant's delivery cost is weighted by the total urgency weight of
        the tenants demanding it, so one tenant's think window is allocated
        across *all* tenants' background queues."""
        done = executed if isinstance(executed, frozenset) else frozenset(executed)
        self._sync_caches(done)
        use_p = self.policy == "utility_p" and self.predictor is not None
        if use_p:
            # the predictor's p_j drifts with observed transitions, so Eq-4
            # products are recomputed per call (from memoised delivery costs)
            total = 0.0
            for j in self._descendants(source):
                total += self._delivery_cost(j, done) * self.predictor.p_interaction(j)
        elif self._tenant_demand:
            total = self._tenant_utility(source, done, None)
            for t in self._tenant_demand:
                part = self._tenant_utility(source, done, t)
                if part:
                    total += self.tenant_weight.get(t, 1.0) * part
        else:
            total = self._utility_memo.get(source.nid)
            if total is None:
                total = 0.0
                for j in self._descendants(source):
                    total += self._delivery_cost(j, done)
                self._utility_memo[source.nid] = total
        if self.extra_utility is not None:
            total += self.extra_utility(source)
        return total

    # -- selection ----------------------------------------------------------------
    def sources(self, executed: Iterable[int]) -> list[Node]:
        done = executed if isinstance(executed, frozenset) else frozenset(executed)
        self._sync_caches(done)
        out = []
        for n in source_operators(self.dag, done):
            if n.nid in self.evicted_once:
                # anti-thrash: a GC'd result is only recomputed on demand (an
                # unexecuted descendant).  The verdict is memoised alongside
                # the delivery memo — delta-invalidated by the same cone rule —
                # instead of rescanning the full descendant list every call.
                demand = self._demand_memo.get(n.nid)
                if demand is None:
                    demand = any(
                        d.nid not in done
                        for d in self._descendants(n)
                        if d.nid != n.nid
                    )
                    self._demand_memo[n.nid] = demand
                if not demand:
                    continue  # no demand: don't churn on a GC'd result
            out.append(n)
        return out

    # -- quarantine (fault domains) ------------------------------------------------
    def quarantine(
        self, nid: int, now: float, error: str = "", tenant: Optional[str] = None
    ) -> QuarantineEntry:
        """Record a background failure of ``nid``: exponential backoff, then
        permanent quarantine after ``quarantine_max_failures`` failures.

        The entry is scoped to ``tenant`` (the tenant whose think window was
        executing when the fault fired) — a shared, deduped node stays
        schedulable from every other tenant's window."""
        key = (tenant, nid)
        entry = self.quarantined.get(key)
        if entry is None:
            entry = self.quarantined[key] = QuarantineEntry()
        entry.failures += 1
        entry.last_error = error
        if entry.failures >= self.quarantine_max_failures:
            entry.until = math.inf
        else:
            entry.until = now + self.quarantine_base_s * (2 ** (entry.failures - 1))
        return entry

    def clear_quarantine(self, nid: int) -> None:
        """A successful execution ends the node's quarantine history — for
        every tenant: the node demonstrably works, whoever ran it."""
        for key in [k for k in self.quarantined if k[1] == nid]:
            self.quarantined.pop(key, None)

    def is_quarantined(
        self, nid: int, now: Optional[float] = None, tenant: Optional[str] = None
    ) -> bool:
        """Active quarantine verdict for one tenant's window.  With
        ``now=None`` (legacy call sites) only permanent quarantines hold;
        timed backoffs need the caller's clock to expire against.  A
        tenant-attributed check also honours untenanted ``(None, nid)``
        entries — a fault with no attribution blocks everyone."""
        for key in ((tenant, nid), (None, nid)) if tenant is not None else ((None, nid),):
            entry = self.quarantined.get(key)
            if entry is None:
                continue
            if math.isinf(entry.until):
                return True
            if now is not None and now < entry.until:
                return True
        return False

    def quarantine_summary(self) -> dict:
        return {
            (nid if tenant is None else f"{tenant}:{nid}"): {
                "failures": e.failures, "until": e.until, "error": e.last_error
            }
            for (tenant, nid), e in sorted(
                self.quarantined.items(), key=lambda kv: (kv[0][0] or "", kv[0][1])
            )
        }

    def pick(
        self,
        executed: Iterable[int],
        now: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> Optional[Node]:
        done = frozenset(executed)
        srcs = self.sources(done)
        if self.quarantined:
            srcs = [n for n in srcs if not self.is_quarantined(n.nid, now, tenant)]
        if not srcs:
            return None
        if self.policy == "fifo":
            return min(srcs, key=lambda n: n.nid)
        if self.policy == "lifo":
            return max(srcs, key=lambda n: n.nid)
        if self.policy == "random":
            return self._rng.choice(srcs)
        if self.policy == "cheapest":
            return min(srcs, key=lambda n: (self.cost_model.cost(n), n.nid))
        # "utility" / "utility_p": break ties by earliest specification order
        return max(srcs, key=lambda n: (self.utility(n, done), -n.nid))

    def plan(
        self,
        executed: Iterable[int],
        limit: Optional[int] = None,
        tenant: Optional[str] = None,
    ) -> list[Node]:
        """Greedy full ordering (simulation convenience): repeatedly pick."""
        done = set(executed)
        order: list[Node] = []
        while True:
            nxt = self.pick(done, tenant=tenant)
            if nxt is None or (limit is not None and len(order) >= limit):
                return order
            order.append(nxt)
            done.add(nxt.nid)

    # -- self-check oracle ---------------------------------------------------------
    def reference_pick(
        self,
        executed: Iterable[int],
        now: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> Optional[Node]:
        """Brute-force, memo-free re-derivation of ``pick()`` under the
        "utility" policy: walks the DAG and the cost model directly on every
        call (including the cross-tenant weighting when tenant demand is
        registered).  This is the oracle the delta-maintained memos are
        verified against (the scheduler fuzz tests and ``bench_background``'s
        ``plan_order_unchanged`` invariant) — keep it dumb."""
        done = frozenset(executed)
        srcs = []
        for n in source_operators(self.dag, done):
            if n.nid in self.evicted_once and all(
                d.nid in done
                for d in self.dag.descendants(n, include_self=True)
                if d.nid != n.nid
            ):
                continue
            if self.is_quarantined(n.nid, now, tenant):
                continue
            srcs.append(n)
        if not srcs:
            return None

        def weight_of(j: Node) -> float:
            if not self._tenant_demand:
                return 1.0
            w = 0.0
            demanded = False
            for t, demand in self._tenant_demand.items():
                if j.nid in demand:
                    demanded = True
                    w += self.tenant_weight.get(t, 1.0)
            return w if demanded else 1.0

        def util(s: Node) -> float:
            total = 0.0
            for j in self.dag.descendants(s, include_self=True):
                total += self.cost_model.delivery_cost(j, done) * weight_of(j)
            if self.extra_utility is not None:
                total += self.extra_utility(s)
            return total

        return max(srcs, key=lambda n: (util(n), -n.nid))

    # -- cross-session memo persistence ---------------------------------------------
    # The descendant sets are pure DAG structure (the expensive O(V·E) walks a
    # large notebook pays on its first pick) and the delivery/utility memos
    # are floats valid for one exact (DAG, cost-model state, executed set)
    # triple.  Both are persisted alongside CostModel.save/load, keyed by
    # content fingerprints: a mismatched DAG rejects the whole file, a
    # mismatched cost state installs structure only.  The in-session
    # ``dag.version`` counter cannot identify a DAG across processes — the
    # fingerprint below hashes the content (nid + node fingerprint) instead,
    # which is what "invalidation on DAG-version mismatch" has to mean
    # cross-session.

    MEMO_FORMAT_VERSION = 1

    def dag_fingerprint(self) -> str:
        """Content identity of the scheduler's DAG: ordered (nid, node
        fingerprint) pairs — stable across processes for identically-rebuilt
        programs, unlike the in-memory ``dag.version`` counter."""
        h = hashlib.blake2b(digest_size=16)
        for n in self.dag.nodes:
            h.update(f"{n.nid}:{n.fingerprint};".encode())
        return h.hexdigest()

    def save_memos(self, path: str) -> None:
        """Persist the memo caches (crash-safe tmp+rename, like
        CostModel.save).  Memos are synced to the current versions first so
        the file never pairs stale floats with a fresh fingerprint."""
        if self._memo_done is not None:
            self._sync_caches(self._memo_done)
        payload = {
            "format_version": self.MEMO_FORMAT_VERSION,
            "dag_fingerprint": self.dag_fingerprint(),
            "cost_fingerprint": self.cost_model.state_fingerprint(),
            "done": sorted(self._memo_done) if self._memo_done is not None else None,
            "desc_ids": {str(k): sorted(v) for k, v in self._desc_ids.items()},
            "delivery": {str(k): v for k, v in self._delivery_memo.items()},
            "utility": {str(k): v for k, v in self._utility_memo.items()},
            "demand": {str(k): bool(v) for k, v in self._demand_memo.items()},
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load_memos(self, path: str) -> bool:
        """Install persisted memos; all-or-nothing per layer.

        DAG fingerprint mismatch → reject the whole file (False).  On a match
        the structure memos (descendant id sets) always install; the cost
        memos additionally require the cost-model state fingerprint to match
        and are installed together with the executed set they were computed
        at — any done-set difference at the next pick() flows through the
        normal ``_invalidate_cones`` delta, so surviving floats are
        byte-identical to a from-scratch recompute (oracle parity holds by
        construction)."""
        try:
            with open(path) as f:
                payload = json.load(f)
            if payload.get("format_version") != self.MEMO_FORMAT_VERSION:
                return False
            if payload.get("dag_fingerprint") != self.dag_fingerprint():
                return False
            known = {n.nid for n in self.dag.nodes}
            desc_ids = {
                int(k): frozenset(v)
                for k, v in payload.get("desc_ids", {}).items()
                if int(k) in known and set(v) <= known
            }
            cost_ok = (
                payload.get("cost_fingerprint") == self.cost_model.state_fingerprint()
                and payload.get("done") is not None
            )
            if cost_ok:
                done = frozenset(int(i) for i in payload["done"])
                delivery = {int(k): float(v) for k, v in payload.get("delivery", {}).items()}
                utility = {int(k): float(v) for k, v in payload.get("utility", {}).items()}
                demand = {int(k): bool(v) for k, v in payload.get("demand", {}).items()}
        except (OSError, ValueError, TypeError, AttributeError, KeyError):
            return False
        self._node_by_id = {n.nid: n for n in self.dag.nodes}
        self._desc_ids.update(desc_ids)
        self._dag_version = self.dag.version
        if cost_ok:
            self._delivery_memo = delivery
            self._utility_memo = utility
            self._demand_memo = demand
            self._memo_done = done
            self._cost_version = getattr(self.cost_model, "version", 0)
        return True
