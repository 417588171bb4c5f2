"""Common-subexpression elimination over the operator DAG (paper §4.2).

The paper's procedure: start at root nodes, traverse breadth-first, merging
any descendants with identical code; proceed level by level until the leaves.
Operators are assumed idempotent, so nodes with identical (op, literals,
merged-parents) compute identical results.

``DAG.add`` already hash-conses, so graphs built through the fluent API are
CSE'd incrementally; this explicit pass exists for externally constructed
graphs and as the paper-faithful reference implementation (tested equivalent
to hash consing in ``tests/test_core_dag.py``).

Multi-tenant serving generalises CSE *across* DAGs: every tenant authors its
program in a private DAG, and :func:`intern_program` hash-conses that program
into the shared engine DAG — two tenants issuing structurally identical
queries resolve to the same shared node, hence one materialisation
(idempotence makes sharing safe for exactly the reason single-DAG merging
is safe).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

from .dag import DAG, Node


def merge_common_subexpressions(dag: DAG) -> Dict[int, int]:
    """BFS merge of structurally identical nodes.

    Returns a mapping ``{merged_away_nid: surviving_nid}``.
    """
    merged: Dict[int, int] = {}
    frontier = deque(dag.roots())
    visited: set[int] = set()
    canonical: Dict[str, Node] = {}

    while frontier:
        node = frontier.popleft()
        if node.nid in visited or node.nid in merged:
            continue
        visited.add(node.nid)
        fp = node.fingerprint
        survivor = canonical.get(fp)
        if survivor is None or survivor.nid == node.nid:
            canonical[fp] = node
            survivor = node
        else:
            dag.replace_node(node, survivor)
            merged[node.nid] = survivor.nid
            node = survivor
        for child in dag.children(node):
            frontier.append(child)
    return merged


def resolve(merged: Dict[int, int], nid: int) -> int:
    """Follow merge chains to the surviving node id."""
    while nid in merged:
        nid = merged[nid]
    return nid


def intern_program(
    dst: DAG, roots: Sequence[Node],
    observer: Optional[Callable[[Node, bool], None]] = None,
) -> Tuple[Dict[int, Node], int]:
    """Hash-cons a foreign program (the ancestor closure of ``roots``, from
    another DAG) into ``dst`` — cross-DAG CSE.

    Nodes are re-added bottom-up through ``dst.add``, whose hash consing
    resolves any node structurally identical to an existing ``dst`` node
    (same op, literals, kwargs, and *interned* parents) to that node.

    ``observer(dst_node, is_new)`` fires once per interned source node.
    Interning bypasses ``Engine.add``, so without an observer the engine's
    interaction-predictor / speculation hooks would never see multi-tenant
    submissions — callers that care pass
    ``Engine.observe_interned_node`` here.

    Returns ``(mapping, n_new)``: ``mapping[src_nid]`` is the corresponding
    ``dst`` node, and ``n_new`` is how many genuinely new nodes ``dst``
    gained — ``len(mapping) - n_new`` interned nodes were deduplicated
    against existing shared state.
    """
    closure: Dict[int, Node] = {}
    stack = list(roots)
    while stack:
        n = stack.pop()
        if n.nid in closure:
            continue
        closure[n.nid] = n
        stack.extend(n.parents)
    mapping: Dict[int, Node] = {}
    before = len(dst)
    # source nid order is topological by construction (DAG._insert)
    for n in sorted(closure.values(), key=lambda n: n.nid):
        size_before = len(dst)
        mapping[n.nid] = dst.add(
            n.op,
            parents=[mapping[p.nid] for p in n.parents],
            literals=n.literals,
            kwargs=n.kwargs,
            interaction=n.is_interaction,
            est_rows=n.est_rows,
        )
        if observer is not None:
            observer(mapping[n.nid], len(dst) > size_before)
    return mapping, len(dst) - before
