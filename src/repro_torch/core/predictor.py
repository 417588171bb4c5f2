"""Future-interaction prediction (paper §5.3).

The paper defers to Yan & He's Auto-Suggest models (trained on a large private
notebook corpus).  That model is not public, so we ship the same *interface*
backed by a bigram model over operator classes learned from (synthetic or
replayed) notebook traces: ``p_j`` = probability that the children of operator
``j`` include an interaction — exactly the quantity Eq. 4 consumes.

The paper's default assumption ("equal probability of users selecting any
operator in the DAG to extend with an interaction") is the uniform fallback.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, Sequence

from .dag import DEFAULT_INTERACTION_OPS, Node


@dataclass
class InteractionPredictor:
    """Bigram P(next-op-is-interaction | current op class)."""

    laplace: float = 1.0
    uniform_p: float = 0.5
    _next_counts: Dict[str, Counter] = field(
        default_factory=lambda: defaultdict(Counter)
    )

    # -- training ---------------------------------------------------------------
    def train_on_sequences(self, sequences: Iterable[Sequence[str]]) -> None:
        """``sequences`` are per-notebook op-name streams in submission order."""
        for seq in sequences:
            for cur, nxt in zip(seq, seq[1:]):
                bucket = "interaction" if nxt in DEFAULT_INTERACTION_OPS else "other"
                self._next_counts[cur][bucket] += 1

    def observe_transition(self, cur_op: str, next_op: str) -> None:
        bucket = (
            "interaction" if next_op in DEFAULT_INTERACTION_OPS else "other"
        )
        self._next_counts[cur_op][bucket] += 1

    # -- inference ----------------------------------------------------------------
    def p_interaction(self, node: Node) -> float:
        """p_j: probability the children of ``node`` include an interaction."""
        if node.is_interaction:
            return 1.0
        counts = self._next_counts.get(node.op)
        if not counts:
            return self.uniform_p
        hits = counts["interaction"] + self.laplace
        total = sum(counts.values()) + 2 * self.laplace
        return hits / total


UNIFORM = InteractionPredictor()
