"""Operator DAG intermediate representation (paper §4.2).

Nodes are SSA-named operator invocations.  The DAG is built either by the
fluent deferred :class:`repro.frame.api.DataFrame` API or by the notebook cell
parser (:mod:`repro.frame.parser`), mirroring the paper's custom-kernel
interception of code cells.

Common-subexpression elimination happens in two (equivalent) ways:

* **hash consing** at construction: ``DAG.add`` returns an existing node when
  an identical (op, literals, parents) triple already exists — operators are
  assumed idempotent (paper §4.2);
* an explicit BFS merge pass (:func:`repro.core.cse.merge_common_subexpressions`)
  for externally constructed graphs, faithful to the paper's description.

Each node also carries a *parametric* fingerprint that ignores literal filter
constants; speculation (paper §5.2) uses it to recognise "same query, different
filter literal" resubmissions.
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

# Ops whose literal arguments are considered *tunable parameters* for
# speculative materialisation (paper §5.2: "users ... changing the value of a
# filter repeatedly").
PARAMETRIC_OPS = frozenset(
    {"filter_cmp", "isin", "head", "tail", "between", "sort_values"}
)

# Parametric *kwargs* per op: tunable parameters that live in kwargs rather
# than literals.  For sort_values that's the sort column, direction and top-k
# limit — "same pipeline, re-sorted by another column / different k" is the
# same exploratory pattern as filter-constant tweaking, and its pre-sort
# input is equally worth keeping warm.  param_fingerprint drops exactly
# these keys; every other kwarg (and the whole set for non-parametric ops)
# still distinguishes nodes.
PARAMETRIC_KWARGS: Mapping[str, frozenset] = {
    "sort_values": frozenset({"by", "ascending", "limit"}),
}

# Ops that inspect results (paper §2.1 "interactions").  The parser marks the
# trailing expression of a cell as an interaction; these ops are *always*
# interactions even mid-cell when displayed.
DEFAULT_INTERACTION_OPS = frozenset(
    {"head", "tail", "describe", "columns", "value_counts", "show"}
)


def _lit_repr(v: Any) -> str:
    """Stable literal representation for fingerprints."""
    if isinstance(v, float):
        return f"f:{v!r}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_lit_repr(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k}:{_lit_repr(v[k])}" for k in sorted(v)) + "}"
    if callable(v):  # UDFs: identity by qualified name (idempotence assumption)
        return f"udf:{getattr(v, '__module__', '?')}.{getattr(v, '__qualname__', repr(v))}"
    return f"{type(v).__name__}:{v!r}"


@dataclass(eq=False)
class Node:
    """A single SSA operator invocation."""

    op: str
    parents: tuple["Node", ...]
    literals: tuple[Any, ...] = ()
    kwargs: Mapping[str, Any] = field(default_factory=dict)
    is_interaction: bool = False
    # --- metadata filled by the planner / cost model -----------------------
    est_rows: Optional[float] = None  # estimated output rows
    # --- identity ----------------------------------------------------------
    nid: int = field(default=-1)
    label: str = ""

    def __post_init__(self) -> None:
        self.parents = tuple(self.parents)
        self.literals = tuple(self.literals)
        self.kwargs = dict(self.kwargs)

    # -- fingerprints --------------------------------------------------------
    def _fp(self, parametric: bool) -> str:
        h = hashlib.blake2b(digest_size=16)
        h.update(self.op.encode())
        for p in self.parents:
            key = p.param_fingerprint if parametric else p.fingerprint
            h.update(key.encode())
        # Parametric fingerprints ignore the *literals* (the tunable filter
        # constants, paper §5.2) but keep kwargs (column names, comparison
        # ops) so only genuine "same query, new constant" pairs match.
        if not (parametric and self.op in PARAMETRIC_OPS):
            for a in self.literals:
                h.update(_lit_repr(a).encode())
        skip = PARAMETRIC_KWARGS.get(self.op, frozenset()) if parametric else frozenset()
        for k in sorted(self.kwargs):
            if k in skip:
                continue
            h.update(k.encode())
            h.update(_lit_repr(self.kwargs[k]).encode())
        return h.hexdigest()

    @property
    def fingerprint(self) -> str:
        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            fp = self._fp(parametric=False)
            self._fingerprint = fp
        return fp

    @property
    def param_fingerprint(self) -> str:
        fp = getattr(self, "_param_fingerprint", None)
        if fp is None:
            fp = self._fp(parametric=True)
            self._param_fingerprint = fp
        return fp

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        tag = "!" if self.is_interaction else ""
        return f"<{self.label or self.op}#{self.nid}{tag}>"


class DAG:
    """The operator DAG with hash-consing construction and graph queries."""

    def __init__(self, cse: bool = True):
        self._nodes: list[Node] = []
        self._by_fp: dict[str, Node] = {}
        self._children: dict[int, list[Node]] = {}
        self._ssa_counter: dict[str, itertools.count] = {}
        self.cse_enabled = cse
        self._version = 0  # bumped on any structural change (insert/rewire)

    @property
    def version(self) -> int:
        """Monotone structural version — cache-invalidation token for
        consumers that memoise graph walks (e.g. the scheduler)."""
        return self._version

    # -- construction --------------------------------------------------------
    def add(
        self,
        op: str,
        parents: Sequence[Node] = (),
        literals: Sequence[Any] = (),
        kwargs: Optional[Mapping[str, Any]] = None,
        interaction: bool = False,
        est_rows: Optional[float] = None,
    ) -> Node:
        node = Node(
            op=op,
            parents=tuple(parents),
            literals=tuple(literals),
            kwargs=dict(kwargs or {}),
            is_interaction=interaction,
            est_rows=est_rows,
        )
        if self.cse_enabled:
            existing = self._by_fp.get(node.fingerprint)
            if existing is not None:
                # idempotence: same op on same inputs == same result
                if interaction:
                    existing.is_interaction = True
                if est_rows is not None and existing.est_rows is None:
                    existing.est_rows = est_rows
                return existing
        return self._insert(node)

    def _insert(self, node: Node) -> Node:
        self._version += 1
        node.nid = len(self._nodes)
        counter = self._ssa_counter.setdefault(node.op, itertools.count())
        node.label = f"{node.op}_{next(counter)}"
        self._nodes.append(node)
        self._by_fp.setdefault(node.fingerprint, node)
        self._children[node.nid] = []
        for p in node.parents:
            self._children[p.nid].append(node)
        return node

    # -- queries --------------------------------------------------------------
    @property
    def nodes(self) -> list[Node]:
        return list(self._nodes)

    def children(self, node: Node) -> list[Node]:
        return list(self._children.get(node.nid, ()))

    def ancestors(self, node: Node, include_self: bool = True) -> list[Node]:
        """Backward slice — the paper's *interaction critical path*."""
        seen: dict[int, Node] = {}
        stack = [node]
        while stack:
            n = stack.pop()
            if n.nid in seen:
                continue
            seen[n.nid] = n
            stack.extend(n.parents)
        if not include_self:
            seen.pop(node.nid, None)
        return sorted(seen.values(), key=lambda n: n.nid)

    def descendants(self, node: Node, include_self: bool = True) -> list[Node]:
        seen: dict[int, Node] = {}
        stack = [node]
        while stack:
            n = stack.pop()
            if n.nid in seen:
                continue
            seen[n.nid] = n
            stack.extend(self._children.get(n.nid, ()))
        if not include_self:
            seen.pop(node.nid, None)
        return sorted(seen.values(), key=lambda n: n.nid)

    def topological(self, nodes: Optional[Iterable[Node]] = None) -> list[Node]:
        """Topological order; nid order is already topological by construction."""
        pool = self._nodes if nodes is None else list(nodes)
        return sorted(pool, key=lambda n: n.nid)

    def interactions(self) -> list[Node]:
        return [n for n in self._nodes if n.is_interaction]

    def find_by_param_fingerprint(self, node: Node) -> list[Node]:
        """Nodes equal to ``node`` up to parametric literals (and not identical)."""
        return [
            n
            for n in self._nodes
            if n.param_fingerprint == node.param_fingerprint and n.nid != node.nid
        ]

    def roots(self) -> list[Node]:
        return [n for n in self._nodes if not n.parents]

    def __len__(self) -> int:
        return len(self._nodes)

    # -- mutation (used by the explicit CSE pass) ------------------------------
    def replace_node(self, old: Node, new: Node) -> None:
        """Redirect all children of ``old`` to consume ``new`` instead."""
        if old.nid == new.nid:
            return
        self._version += 1
        for child in list(self._children.get(old.nid, ())):
            child.parents = tuple(new if p.nid == old.nid else p for p in child.parents)
            # fingerprints of descendants change; invalidate caches
            for d in self.descendants(child):
                d.__dict__.pop("_fingerprint", None)
                d.__dict__.pop("_param_fingerprint", None)
            self._children.setdefault(new.nid, []).append(child)
        self._children[old.nid] = []
        if new.est_rows is None and old.est_rows is not None:
            new.est_rows = old.est_rows
        new.is_interaction = new.is_interaction or old.is_interaction
