"""Program slicing: interaction critical paths (paper §2.1, §4.2).

The *interaction critical path* of an interaction node is its backward slice
— every operator whose output (transitively) feeds the interaction.  All other
operators specified so far are *non-critical* and may be deferred to think
time (paper's opportunistic evaluation).
"""
from __future__ import annotations

from typing import Iterable, Sequence

from .dag import DAG, Node


def critical_path(dag: DAG, interaction: Node) -> list[Node]:
    """All dependencies of ``interaction`` (including itself), topologically."""
    return dag.ancestors(interaction, include_self=True)


def non_critical(dag: DAG, interactions: Sequence[Node]) -> list[Node]:
    """Operators not on any of the given interactions' critical paths."""
    crit: set[int] = set()
    for it in interactions:
        crit.update(n.nid for n in dag.ancestors(it))
    return [n for n in dag.topological() if n.nid not in crit]


def unexecuted_critical(
    dag: DAG, interaction: Node, executed: Iterable[int]
) -> list[Node]:
    """The part of the critical path that still needs to run, topologically.

    ``executed`` is the set of node ids whose results are materialised
    (cached); their ancestors need not run either.
    """
    done = set(executed)
    out: list[Node] = []
    seen: set[int] = set()
    stack = [interaction]
    while stack:
        n = stack.pop()
        if n.nid in seen or n.nid in done:
            continue
        seen.add(n.nid)
        stack.extend(n.parents)
    return sorted((dag._nodes[i] for i in seen), key=lambda n: n.nid)


def count_non_critical_before(dag: DAG, interaction: Node) -> int:
    """Paper §3.2 metric: # of non-critical operators *specified before* an
    interaction (Fig 4).  "Before" = smaller SSA id; interactions themselves
    and the interaction's own dependencies are excluded."""
    crit = {n.nid for n in dag.ancestors(interaction)}
    return sum(
        1
        for n in dag.topological()
        if n.nid < interaction.nid and n.nid not in crit and not n.is_interaction
    )


def source_operators(dag: DAG, executed: Iterable[int]) -> list[Node]:
    """Paper §5.2: source operators are unexecuted nodes whose predecessors
    'do not exist or are already executed'."""
    done = set(executed)
    return [
        n
        for n in dag.topological()
        if n.nid not in done and all(p.nid in done for p in n.parents)
    ]
