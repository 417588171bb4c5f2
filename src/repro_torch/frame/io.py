"""Synthetic table sources with deterministic per-partition generation.

Stands in for ``pd.read_csv``: each registered table has a column spec, row
count, a simulated total IO cost (so benchmarks can reproduce the paper's
"LARGE_FILE takes 18.5 s" scenarios on a virtual clock), and a seed.  Any
row range can be generated independently — that's what makes `read_table` a
*source-partitioned* operator whose partitions stream in one preemption
quantum at a time (paper §5.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .table import Column, Partition


@dataclass(frozen=True)
class ColSpec:
    name: str
    kind: str = "float"  # "float" | "int" | "cat" (dictionary string)
    null_frac: float = 0.0
    n_categories: int = 16
    low: float = 0.0
    high: float = 1.0


@dataclass(frozen=True)
class TableSpec:
    name: str
    nrows: int
    cols: Tuple[ColSpec, ...]
    io_seconds: float = 0.0  # simulated cost of a full scan/read
    seed: int = 0

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self.cols]

    def bytes_estimate(self) -> int:
        return self.nrows * len(self.cols) * 8


class Catalog:
    """Process-local registry of synthetic tables."""

    def __init__(self) -> None:
        self._tables: Dict[str, TableSpec] = {}
        self._dicts: Dict[Tuple[str, str], np.ndarray] = {}

    def register(self, spec: TableSpec) -> TableSpec:
        self._tables[spec.name] = spec
        for c in spec.cols:
            if c.kind == "cat":
                self._dicts[(spec.name, c.name)] = np.array(
                    [f"{c.name}_{i:03d}" for i in range(c.n_categories)],
                    dtype=object,
                )
        return spec

    def spec(self, name: str) -> TableSpec:
        try:
            return self._tables[name]
        except KeyError:
            raise KeyError(
                f"table {name!r} not registered; use Catalog.register(TableSpec(...))"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._tables

    # -- deterministic generation --------------------------------------------------
    def generate(self, name: str, start: int, stop: int) -> Partition:
        """Row i always gets the same value regardless of the partition plan —
        values are a counter-based hash of (seed, column, row index), so any
        (start, stop) range is independently generable (what lets `read_table`
        stream partitions in any order as preemption quanta)."""
        spec = self.spec(name)
        cols: Dict[str, Column] = {}
        idx = np.arange(start, stop, dtype=np.uint64)
        for ci, c in enumerate(spec.cols):
            salt = np.uint64(spec.seed * 1_000_003 + ci * 7919 + 1)
            u = _splitmix64(idx, salt)
            unit = (u >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
            if c.kind == "float":
                data = c.low + unit * (c.high - c.low)
            elif c.kind == "int":
                span = max(int(c.high) - int(c.low), 1)
                data = (int(c.low) + (u % np.uint64(span))).astype(np.int64)
            elif c.kind == "key":  # unique sequential keys (dim tables)
                data = np.arange(start, stop, dtype=np.int64)
            elif c.kind == "cat":
                data = (u % np.uint64(c.n_categories)).astype(np.int32)
            else:
                raise ValueError(f"unknown col kind {c.kind}")
            mask = None
            if c.null_frac > 0:
                u2 = _splitmix64(idx, salt ^ np.uint64(0xDEADBEEF))
                unit2 = (u2 >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
                mask = unit2 >= c.null_frac
            dictionary = self._dicts.get((name, c.name))
            cols[c.name] = Column(data=data, mask=mask, dictionary=dictionary)
        return Partition(cols, spec.column_names)


def _splitmix64(idx: np.ndarray, salt: np.uint64) -> np.ndarray:
    """Vectorised splitmix64: high-quality stateless per-row randomness."""
    with np.errstate(over="ignore"):
        z = idx * np.uint64(0x9E3779B97F4A7C15) + salt * np.uint64(
            0xD1B54A32D192ED03
        )
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


CATALOG = Catalog()


def default_catalog() -> Catalog:
    return CATALOG
