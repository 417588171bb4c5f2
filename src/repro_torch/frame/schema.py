"""Static schema inference over the operator DAG.

Metadata-only interactions (``df.columns``) must not force materialisation of
their inputs (the paper's case study: ``data.columns`` displayed in 122 ms
while the 18.5 s read proceeds in the background) — so column sets are derived
from the DAG where statically possible.
"""
from __future__ import annotations

from typing import List

from ..core.dag import Node
from .io import Catalog


class SchemaUnknown(Exception):
    """Schema depends on data (e.g. drop_sparse_cols) — must materialise."""


def infer_schema(node: Node, catalog: Catalog) -> List[str]:
    op = node.op
    if op == "read_table":
        return list(catalog.spec(node.literals[0]).column_names)
    if op in ("filter", "filter_cmp", "isin", "between", "dropna", "head",
              "tail", "sort_values", "fillna"):
        return infer_schema(node.parents[0], catalog)
    if op == "project":
        return list(node.kwargs["cols"])
    if op == "assign":
        base = infer_schema(node.parents[0], catalog)
        col = node.kwargs["col"]
        return base + ([col] if col not in base else [])
    if op == "groupby_agg":
        return [node.kwargs["by"]] + [a[0] for a in node.kwargs["aggs"]]
    if op == "value_counts":
        parent_cols = infer_schema(node.parents[0], catalog)
        return [parent_cols[0], "count"]
    if op == "describe":
        return ["stat"] + infer_schema(node.parents[0], catalog)
    if op == "mean":
        return infer_schema(node.parents[0], catalog)
    if op == "join":
        left = infer_schema(node.parents[0], catalog)
        right = infer_schema(node.parents[1], catalog)
        on = node.kwargs["on"]
        extra = [
            (c if c not in left else f"{c}_right") for c in right if c != on
        ]
        return left + extra
    raise SchemaUnknown(op)
