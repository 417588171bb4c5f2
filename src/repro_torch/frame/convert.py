"""Carry state across from the JAX package: tables and fitted cost models.

Both packages describe a table the same way — per column a ``data`` array,
an optional boolean ``mask`` (True = valid) and an optional ``dictionary``
(code → string), split into row partitions — so a table travels as plain
numpy arrays plus the partition bounds, and arrives as this package's
:class:`PTable` with identical bytes.  The cost model travels as the JSON
file ``CostModel.save`` writes; only entries of backends this package has
are installed, since fitted times of other backends describe other hardware.
"""
from __future__ import annotations

import json
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.costmodel import CostModel, _OpStats
from .backend import BACKENDS
from .table import Column, Partition, PTable

ColumnArrays = Mapping[str, Optional[np.ndarray]]  # "data", "mask", "dictionary"


def table_from_numpy(
    columns: Mapping[str, ColumnArrays],
    bounds: Sequence[Tuple[int, int]],
) -> PTable:
    """Build a PTable from whole-table column arrays and ``[start, stop)``
    partition bounds; column order follows ``columns``."""
    order = list(columns)
    parts = []
    for a, b in bounds:
        cols: Dict[str, Column] = {}
        for name in order:
            spec = columns[name]
            mask = spec.get("mask")
            cols[name] = Column(
                data=np.asarray(spec["data"])[a:b],
                mask=None if mask is None else np.asarray(mask, bool)[a:b],
                dictionary=spec.get("dictionary"),
            )
        parts.append(Partition(cols, list(order)))
    return PTable(parts)


def load_cost_model(path: str, cost_model: Optional[CostModel] = None) -> CostModel:
    """Install the fitted costs of a ``CostModel.save`` JSON file into
    ``cost_model`` (a new one by default).  Per-op EWMA unit costs and
    planner decision counts carry over; per-(op, backend) fits only for the
    backends of this package (``numpy`` — the others name JAX backends)."""
    cm = cost_model if cost_model is not None else CostModel()
    with open(path) as f:
        payload = json.load(f)

    def _ours(table: Mapping[str, float]) -> Dict[Tuple[str, str], float]:
        out = {}
        for key, val in table.items():
            op, _, bk = key.rpartition("|")
            if op and bk in BACKENDS:
                out[(op, bk)] = float(val)
        return out

    cm._backend_unit_cost.update(_ours(payload.get("unit_costs", {})))
    cm._backend_overhead.update(
        {k: max(v, 0.0) for k, v in _ours(payload.get("overheads", {})).items()}
    )
    for k, v in payload.get("planner_decisions", {}).items():
        cm.planner_decisions[str(k)] = cm.planner_decisions.get(str(k), 0) + int(v)
    for op, st in payload.get("op_ewma", {}).items():
        cm._stats[op] = _OpStats(unit_cost=float(st["unit_cost"]), n_obs=int(st.get("n_obs", 1)))
    cm.version += 1
    return cm
