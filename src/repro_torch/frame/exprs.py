"""Column-expression descriptors.

Row-wise expressions (predicates, assignments) are literal trees attached to
DAG nodes — e.g. ``("gt", ("col", "a"), ("lit", 3.0))``.  Scalar
subexpressions (``data.mean().mean()``) are *DAG nodes* of their own (so CSE
merges them, paper Fig. 8); expression leaves reference them as
``("ref", i)`` = the i-th non-frame parent of the node.

Null semantics match pandas: comparisons involving null are False; arithmetic
propagates null; ``fillna`` clears the mask.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np

from .table import Column, Partition

Expr = Tuple  # nested tuples


def _as_scalar(v: Any) -> float:
    """Extract a python scalar from a materialised scalar-node value."""
    from .table import PTable

    if isinstance(v, PTable):
        merged = v.concat()
        first = merged.columns[merged.order[0]]
        return float(np.asarray(first.data)[0])
    if hasattr(v, "item"):
        return float(v.item())
    return float(v)


def eval_expr(expr: Expr, part: Partition, extras: Sequence[Any]) -> Column:
    """Evaluate an expression tree against one partition."""
    op = expr[0]
    if op == "col":
        return part.columns[expr[1]]
    if op == "lit":
        n = part.nrows
        v = expr[1]
        if isinstance(v, str):
            raise ValueError("string literals only valid inside comparisons")
        return Column(data=np.full((n,), v))
    if op == "ref":
        n = part.nrows
        return Column(data=np.full((n,), _as_scalar(extras[expr[1]])))
    if op == "udf":
        fn, inner = expr[1], eval_expr(expr[2], part, extras)
        out = np.asarray(fn(inner.data))
        return Column(data=out, mask=inner.mask)
    if op in _BINOPS:
        left = eval_expr(expr[1], part, extras)
        right_spec = expr[2]
        # string comparison: encode the literal through the dictionary
        if (
            op in ("eq", "ne")
            and left.is_string
            and right_spec[0] == "lit"
            and isinstance(right_spec[1], str)
        ):
            code = np.searchsorted(left.dictionary.astype(str), right_spec[1])
            hit = (
                code < len(left.dictionary)
                and left.dictionary[code] == right_spec[1]
            )
            if not hit:
                data = np.zeros(part.nrows, dtype=bool)
                if op == "ne":
                    data = ~data
                return Column(data=data, mask=left.mask)
            right = Column(data=np.full((part.nrows,), int(code), dtype=left.data.dtype))
        else:
            right = eval_expr(right_spec, part, extras)
        data = _BINOPS[op](left.data, right.data)
        mask = _merge_mask(left.mask, right.mask)
        return Column(data=data, mask=mask)
    if op == "isin":
        inner = eval_expr(expr[1], part, extras)
        values = expr[2]
        if inner.is_string:
            dct = inner.dictionary.astype(str)
            codes = [
                int(np.searchsorted(dct, v))
                for v in values
                if (i := np.searchsorted(dct, v)) < len(dct) and dct[i] == v
            ]
            values = codes
        table = np.asarray(list(values) or [np.inf],
                           dtype=inner.data.dtype if values else np.float32)
        data = np.isin(inner.data, table)
        return Column(data=data, mask=inner.mask)
    if op == "between":
        inner = eval_expr(expr[1], part, extras)
        lo, hi = expr[2], expr[3]
        data = (inner.data >= lo) & (inner.data <= hi)
        return Column(data=data, mask=inner.mask)
    if op == "fillna":
        inner = eval_expr(expr[1], part, extras)
        if expr[2][0] == "ref":
            value = _as_scalar(extras[expr[2][1]])
        else:
            value = expr[2][1]
        if inner.mask is None:
            return inner
        data = np.where(inner.mask, inner.data, np.asarray(value, inner.data.dtype))
        return Column(data=data, mask=None, dictionary=inner.dictionary)
    if op == "not":
        inner = eval_expr(expr[1], part, extras)
        return Column(data=~inner.data.astype(bool), mask=inner.mask)
    if op == "isnull":
        inner = eval_expr(expr[1], part, extras)
        return Column(data=~inner.valid_mask())
    if op == "notnull":
        inner = eval_expr(expr[1], part, extras)
        return Column(data=inner.valid_mask())
    raise ValueError(f"unknown expression op {op!r}")


def predicate_mask(expr: Expr, part: Partition, extras: Sequence[Any]) -> np.ndarray:
    """Boolean keep-mask: null comparisons are False (pandas semantics)."""
    col = eval_expr(expr, part, extras)
    keep = col.data.astype(bool)
    if col.mask is not None:
        keep = keep & col.mask
    return keep


def _merge_mask(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


_BINOPS: dict[str, Callable] = {
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "and": lambda a, b: a.astype(bool) & b.astype(bool),
    "or": lambda a, b: a.astype(bool) | b.astype(bool),
}


def expr_columns(expr: Expr) -> List[str]:
    """Column names referenced by an expression."""
    out: List[str] = []
    def walk(e):
        if not isinstance(e, tuple):
            return
        if e[0] == "col":
            out.append(e[1])
            return
        for sub in e[1:]:
            walk(sub)
    walk(expr)
    return out
