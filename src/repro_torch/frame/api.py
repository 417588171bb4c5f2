"""Fluent deferred DataFrame API (specification ≠ execution, paper §1).

Every method call *specifies* an operator (extends the DAG, hash-consed CSE);
nothing executes until an *interaction* — ``session.show(x)`` or the trailing
expression of a parsed notebook cell — at which point only the interaction
critical path runs; everything else is deferred to think time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.dag import Node
from ..core.engine import Engine
from .io import Catalog, TableSpec, default_catalog
from .partitioner import plan_partitions
from .runtime import FrameRuntime, install
from .table import PTable

_CMP = {"gt": "gt", "ge": "ge", "lt": "lt", "le": "le", "eq": "eq", "ne": "ne"}


class Session:
    """An interactive analysis session backed by the opportunistic engine.

    Runs on the CUDA device with the hand-written kernels by default
    (``kernel_backend="cuda"``).  ``kernel_backend="numpy"`` runs the host
    reference; ``kernel_backend="torch"`` runs the plain PyTorch versions on
    ``device`` (default ``"cuda"``).  Asking for the card where there is none
    raises instead of falling back to the CPU."""

    def __init__(
        self,
        catalog: Optional[Catalog] = None,
        engine: Optional[Engine] = None,
        device=None,
        **engine_kwargs,
    ):
        self.engine = engine or Engine(**engine_kwargs)
        self.catalog = catalog or default_catalog()
        self.runtime: FrameRuntime = install(self.engine, self.catalog, device=device)

    # -- sources -------------------------------------------------------------
    def read_table(self, name: str) -> "DataFrame":
        spec = self.catalog.spec(name)
        est_cost = spec.io_seconds or spec.nrows * 2e-7
        bounds = plan_partitions(spec.nrows, est_cost, self.engine.think_time)
        node = self.engine.add(
            "read_table",
            literals=[name],
            kwargs={"partition_bounds": tuple(tuple(b) for b in bounds)},
            est_rows=spec.nrows,
        )
        return DataFrame(self, node)

    read_csv = read_table  # pandas-flavoured alias

    # -- interaction -----------------------------------------------------------
    def show(self, x: Any) -> Any:
        node = _node_of(x)
        if node is None:
            return x  # plain python value: nothing to execute
        return self.engine.display(node)

    def interact(self, x: Any, progressive: bool = False, seed_units: Optional[int] = None) -> Any:
        """Blocking interaction.  With ``progressive=True`` returns a
        :class:`~repro_torch.core.progressive.ProgressiveResult` immediately — a
        bounded estimate over the completed partitions that upgrades in
        place — instead of waiting for exact completion."""
        node = _node_of(x)
        if node is None:
            return x
        return self.engine.interact(
            node, progressive=progressive, seed_units=seed_units
        )

    def think(self, seconds: float) -> dict:
        return self.engine.think(seconds)

    def drain(self) -> int:
        return self.engine.drain_background()

    # -- notebook frontend -------------------------------------------------------
    def cell(self, code: str, env: Optional[Dict[str, Any]] = None) -> Any:
        from .parser import CellRunner

        runner = getattr(self, "_runner", None)
        if runner is None:
            runner = CellRunner(self)
            self._runner = runner
        if env:
            runner.env.update(env)
        return runner.run_cell(code)

    def replay(
        self,
        cells: Sequence[str],
        think_times: Sequence[float],
        env: Optional[Dict[str, Any]] = None,
    ) -> List[Any]:
        """Replay a notebook with injected think times (paper §6 methodology)."""
        out = []
        for i, code in enumerate(cells):
            out.append(self.cell(code, env=env))
            if i < len(think_times):
                self.think(think_times[i])
        return out


def _node_of(x: Any) -> Optional[Node]:
    if isinstance(x, Node):
        return x
    return getattr(x, "node", None)


@dataclass
class ScalarHandle:
    """A deferred scalar (e.g. ``df.mean().mean()``) usable inside expressions."""

    session: Session
    node: Node

    def __float__(self) -> float:
        v = self.session.engine.value_of(self.node)
        return float(v)


class SeriesLike:
    """Result of ``df.mean()`` — a one-row table with Series-flavoured mean()."""

    def __init__(self, session: Session, node: Node):
        self.session = session
        self.node = node

    def mean(self) -> ScalarHandle:
        n = self.session.engine.add("mean_scalar", parents=[self.node], est_rows=1)
        return ScalarHandle(self.session, n)


@dataclass
class ColExpr:
    """A column-valued expression tree (pre-assignment)."""

    session: Session
    frame_node: Node
    expr: tuple
    scalar_parents: tuple = ()

    def _bin(self, other, op):
        expr2, parents2 = _rhs(other, len(self.scalar_parents))
        return ColExpr(
            self.session,
            self.frame_node,
            (op, self.expr, expr2),
            self.scalar_parents + parents2,
        )

    def __add__(self, o):
        return self._bin(o, "add")

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __rmul__(self, o):
        return self._bin(o, "mul")

    def __truediv__(self, o):
        return self._bin(o, "div")

    def _cmp(self, other, op) -> "Predicate":
        expr2, parents2 = _rhs(other, len(self.scalar_parents))
        return Predicate(
            self.session,
            self.frame_node,
            (op, self.expr, expr2),
            self.scalar_parents + parents2,
        )

    def __gt__(self, o):
        return self._cmp(o, "gt")

    def __ge__(self, o):
        return self._cmp(o, "ge")

    def __lt__(self, o):
        return self._cmp(o, "lt")

    def __le__(self, o):
        return self._cmp(o, "le")

    def __eq__(self, o):  # type: ignore[override]
        return self._cmp(o, "eq")

    def __ne__(self, o):  # type: ignore[override]
        return self._cmp(o, "ne")

    def fillna(self, value) -> "ColExpr":
        expr2, parents2 = _rhs(value, len(self.scalar_parents))
        return ColExpr(
            self.session,
            self.frame_node,
            ("fillna", self.expr, expr2),
            self.scalar_parents + parents2,
        )

    def apply(self, fn: Callable) -> "ColExpr":
        return ColExpr(
            self.session, self.frame_node, ("udf", fn, self.expr), self.scalar_parents
        )


def _rhs(other: Any, offset: int):
    """Right-hand side of an expression: literal, scalar handle, or column."""
    if isinstance(other, ScalarHandle):
        return ("ref", offset), (other.node,)
    if isinstance(other, (ColumnRef, ColExpr)):
        return other.expr if isinstance(other, ColExpr) else ("col", other.name), ()
    return ("lit", other), ()


@dataclass
class Predicate:
    session: Session
    frame_node: Node
    expr: tuple
    scalar_parents: tuple = ()

    def __and__(self, o: "Predicate") -> "Predicate":
        return self._combine(o, "and")

    def __or__(self, o: "Predicate") -> "Predicate":
        return self._combine(o, "or")

    def __invert__(self) -> "Predicate":
        return Predicate(
            self.session, self.frame_node, ("not", self.expr), self.scalar_parents
        )

    def _combine(self, o: "Predicate", op: str) -> "Predicate":
        shift = len(self.scalar_parents)
        expr2 = _shift_refs(o.expr, shift)
        return Predicate(
            self.session,
            self.frame_node,
            (op, self.expr, expr2),
            self.scalar_parents + o.scalar_parents,
        )


def _shift_refs(expr: tuple, k: int) -> tuple:
    if not isinstance(expr, tuple):
        return expr
    if expr[0] == "ref":
        return ("ref", expr[1] + k)
    return tuple(
        [expr[0]] + [_shift_refs(e, k) if isinstance(e, tuple) else e for e in expr[1:]]
    )


class ColumnRef(ColExpr):
    """``df["col"]`` — a named column with Series-flavoured methods."""

    def __init__(self, session: Session, frame_node: Node, name: str):
        super().__init__(session, frame_node, ("col", name))
        self.name = name

    # Series reductions become DAG nodes of their own (CSE merges repeats,
    # paper Fig. 8: data.mean().mean())
    def _project_node(self) -> Node:
        return self.session.engine.add(
            "project", parents=[self.frame_node], kwargs={"cols": (self.name,)}
        )

    def mean(self) -> ScalarHandle:
        proj = self._project_node()
        n = self.session.engine.add("mean_scalar", parents=[proj], est_rows=1)
        return ScalarHandle(self.session, n)

    def value_counts(self) -> "DataFrame":
        proj = self._project_node()
        n = self.session.engine.add(
            "value_counts", parents=[proj], kwargs={"col": self.name}
        )
        return DataFrame(self.session, n)

    def isin(self, values: Sequence) -> Predicate:
        return Predicate(
            self.session, self.frame_node, ("isin", ("col", self.name), list(values))
        )

    def isnull(self) -> Predicate:
        return Predicate(self.session, self.frame_node, ("isnull", ("col", self.name)))

    def notnull(self) -> Predicate:
        return Predicate(self.session, self.frame_node, ("notnull", ("col", self.name)))

    def between(self, lo, hi) -> Predicate:
        return Predicate(
            self.session, self.frame_node, ("between", ("col", self.name), lo, hi)
        )


class GroupBy:
    def __init__(self, session: Session, frame_node: Node, by: str):
        self.session = session
        self.frame_node = frame_node
        self.by = by

    def agg(self, spec: Union[str, Callable, Dict[str, Any]]) -> "DataFrame":
        from .schema import SchemaUnknown, infer_schema

        if isinstance(spec, dict):
            aggs = tuple((f"{c}", c, fn) for c, fn in spec.items())
        else:
            try:
                cols = [
                    c
                    for c in infer_schema(self.frame_node, self.session.catalog)
                    if c != self.by
                ]
            except SchemaUnknown:
                cols = [
                    c
                    for c in self.session.engine.value_of(self.frame_node).column_names
                    if c != self.by
                ]
            aggs = tuple((c, c, spec) for c in cols)
        est_parent = self.frame_node.est_rows or 1e6
        node = self.session.engine.add(
            "groupby_agg",
            parents=[self.frame_node],
            kwargs={"by": self.by, "aggs": aggs},
            est_rows=max(1.0, est_parent * 0.01),
        )
        return DataFrame(self.session, node)

    def mean(self):
        return self.agg("mean")

    def sum(self):
        return self.agg("sum")

    def count(self):
        return self.agg("count")

    def min(self):
        return self.agg("min")

    def max(self):
        return self.agg("max")


class ColumnsHandle:
    def __init__(self, session: Session, node: Node):
        self.session = session
        self.node = node


class DataFrame:
    """Deferred dataframe handle over a DAG node."""

    def __init__(self, session: Session, node: Node):
        self.session = session
        self.node = node

    # -- structure ----------------------------------------------------------------
    @property
    def columns(self) -> ColumnsHandle:
        n = self.session.engine.add("columns", parents=[self.node], est_rows=1)
        return ColumnsHandle(self.session, n)

    def __getitem__(self, key):
        if isinstance(key, str):
            return ColumnRef(self.session, self.node, key)
        if isinstance(key, (list, tuple)):
            n = self.session.engine.add(
                "project", parents=[self.node], kwargs={"cols": tuple(key)}
            )
            return DataFrame(self.session, n)
        if isinstance(key, Predicate):
            return self._filter(key)
        raise TypeError(f"unsupported subscript {type(key)}")

    def __setitem__(self, col: str, value) -> None:
        if not isinstance(value, ColExpr):
            value = ColExpr(self.session, self.node, ("lit", value))
        node = self.session.engine.add(
            "assign",
            parents=[self.node, *value.scalar_parents],
            kwargs={"col": col, "expr": value.expr},
            est_rows=self.node.est_rows,
        )
        self.node = node  # SSA rebinding, pandas-style in-place feel

    def _filter(self, pred: Predicate) -> "DataFrame":
        expr = pred.expr
        # simple comparisons with literal constants are *parametric* filters
        # (speculation recognises re-submissions with new constants)
        if (
            expr[0] in _CMP
            and isinstance(expr[1], tuple)
            and expr[1][0] == "col"
            and expr[2][0] == "lit"
        ):
            node = self.session.engine.add(
                "filter_cmp",
                parents=[self.node, *pred.scalar_parents],
                literals=[expr[2][1]],
                kwargs={"col": expr[1][1], "cmp": expr[0]},
            )
        elif (
            expr[0] in _CMP
            and isinstance(expr[1], tuple)
            and expr[1][0] == "col"
            and expr[2][0] == "ref"
        ):
            node = self.session.engine.add(
                "filter_cmp",
                parents=[self.node, *pred.scalar_parents],
                kwargs={"col": expr[1][1], "cmp": expr[0], "value_ref": True},
            )
        else:
            node = self.session.engine.add(
                "filter",
                parents=[self.node, *pred.scalar_parents],
                kwargs={"expr": expr},
            )
        return DataFrame(self.session, node)

    # -- ops --------------------------------------------------------------------------
    def head(self, k: int = 5) -> "DataFrame":
        n = self.session.engine.add(
            "head", parents=[self.node], literals=[k], est_rows=k
        )
        return DataFrame(self.session, n)

    def tail(self, k: int = 5) -> "DataFrame":
        n = self.session.engine.add(
            "tail", parents=[self.node], literals=[k], est_rows=k
        )
        return DataFrame(self.session, n)

    def describe(self) -> "DataFrame":
        n = self.session.engine.add("describe", parents=[self.node], est_rows=5)
        return DataFrame(self.session, n)

    def mean(self) -> SeriesLike:
        n = self.session.engine.add("mean", parents=[self.node], est_rows=1)
        return SeriesLike(self.session, n)

    def dropna(self, subset: Optional[Sequence[str]] = None) -> "DataFrame":
        n = self.session.engine.add(
            "dropna",
            parents=[self.node],
            kwargs={"subset": tuple(subset) if subset else None},
        )
        return DataFrame(self.session, n)

    def drop_sparse_cols(self, thresh: float) -> "DataFrame":
        """Keep columns with ≥ thresh fraction of values present (case study §6)."""
        n = self.session.engine.add(
            "drop_sparse_cols", parents=[self.node], kwargs={"thresh": float(thresh)},
            est_rows=self.node.est_rows,
        )
        return DataFrame(self.session, n)

    def fillna(self, value) -> "DataFrame":
        if isinstance(value, ScalarHandle):
            n = self.session.engine.add(
                "fillna",
                parents=[self.node, value.node],
                kwargs={"cols": None, "value_ref": True},
            )
        else:
            n = self.session.engine.add(
                "fillna",
                parents=[self.node],
                kwargs={"cols": None, "value": float(value)},
            )
        return DataFrame(self.session, n)

    def sort_values(self, by: str, ascending: bool = True) -> "DataFrame":
        n = self.session.engine.add(
            "sort_values",
            parents=[self.node],
            kwargs={"by": by, "ascending": bool(ascending)},
            est_rows=self.node.est_rows,
        )
        return DataFrame(self.session, n)

    def groupby(self, by: str) -> GroupBy:
        return GroupBy(self.session, self.node, by)

    def join(self, other: "DataFrame", on: str, how: str = "inner") -> "DataFrame":
        n = self.session.engine.add(
            "join",
            parents=[self.node, other.node],
            kwargs={"on": on, "how": how},
            est_rows=self.node.est_rows,
        )
        return DataFrame(self.session, n)

    def apply_udf(self, col: str, fn: Callable) -> "DataFrame":
        """df[col] = df[col].apply(fn) convenience."""
        out = DataFrame(self.session, self.node)
        out[col] = ColumnRef(self.session, self.node, col).apply(fn)
        return out

    # -- materialise -------------------------------------------------------------------
    def collect(self) -> PTable:
        return self.session.engine.value_of(self.node)

    def __repr__(self) -> str:
        return f"<DataFrame {self.node!r}>"
