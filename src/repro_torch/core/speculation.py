"""Speculative materialisation (paper §5.2).

Observed pattern: users "explore the data by changing the value of a filter
repeatedly".  The system therefore

1. detects *parametric* operators (filters with literal constants) on executed
   interaction critical paths,
2. ensures their **pre-filter inputs** are materialised and retained (pinned
   against eviction) so that resubmitting the query with a different literal
   reuses the saved intermediate instead of recomputing from scratch, and
3. gates the extra background materialisation on the predicted think time
   exceeding the materialisation cost (the paper's enabling condition), so
   speculation never delays an imminent interaction.

Because the DAG hash-conses, a re-submitted filter with a new literal becomes
a *sibling* node sharing the same parent; `param_fingerprint` equality is how
we recognise the pattern and count speculation hits.

The parametric family is wider than filters: ``sort_values`` treats the sort
column, direction and top-k limit as tunable parameters too (see
``dag.PARAMETRIC_KWARGS``), so "re-sort the same frame by another column" or
"widen the top-k" resubmissions keep the pre-sort input pinned and count as
hits exactly like filter-constant tweaks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set

from .cache import MaterializedCache
from .costmodel import CostModel
from .dag import DAG, Node, PARAMETRIC_OPS
from .thinktime import ThinkTimeModel


@dataclass
class SpeculationManager:
    dag: DAG
    cache: MaterializedCache
    cost_model: CostModel
    think_time: ThinkTimeModel
    enabled: bool = True
    max_pins: int = 8

    # parent nid -> scheduling boost (consumed by the engine's scheduler hook)
    boosts: Dict[int, float] = field(default_factory=dict)
    _pinned: Set[int] = field(default_factory=set)
    hits: int = 0
    activations: int = 0
    # set by the engine: partial progress also counts as speculation capital
    partials: Optional[dict] = None

    # -- signals --------------------------------------------------------------------
    def on_critical_path_executed(self, path: list[Node]) -> None:
        """Inspect an executed critical path for parametric ops; protect their
        inputs for future literal-tweaking resubmissions."""
        if not self.enabled:
            return
        for node in path:
            if node.op not in PARAMETRIC_OPS or not node.parents:
                continue
            parent = node.parents[0]
            predicted_think = self.think_time.predict()
            mat_cost = self.cost_model.cost(parent)
            if parent.nid in self.cache:
                self._pin(parent.nid)
                self.activations += 1
            elif predicted_think > mat_cost:
                # paper's gate: speculate only when think time affords it
                self.boosts[parent.nid] = max(
                    self.boosts.get(parent.nid, 0.0), mat_cost
                )
                self.activations += 1

    def on_node_submitted(self, node: Node) -> None:
        """Count a speculation *hit*: a parametric resubmission whose pre-filter
        input is already materialised."""
        if node.op not in PARAMETRIC_OPS or not node.parents:
            return
        siblings = self.dag.find_by_param_fingerprint(node)
        pnid = node.parents[0].nid
        saved = pnid in self.cache or (
            self.partials is not None and pnid in self.partials
        )
        if siblings and saved:
            self.hits += 1

    # -- scheduler integration ---------------------------------------------------------
    def boost_for(self, node: Node) -> float:
        return self.boosts.get(node.nid, 0.0)

    def _pin(self, nid: int) -> None:
        if nid in self._pinned:
            return
        if len(self._pinned) >= self.max_pins:
            oldest = next(iter(self._pinned))
            self._pinned.discard(oldest)
            self.cache.unpin(oldest)
        self.cache.pin(nid)
        self._pinned.add(nid)

    def release_all(self) -> None:
        for nid in self._pinned:
            self.cache.unpin(nid)
        self._pinned.clear()
