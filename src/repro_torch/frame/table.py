"""Partitioned columnar tables on host numpy arrays.

A :class:`PTable` is a list of row partitions; each :class:`Partition` maps
column name → :class:`Column` (data array + optional validity mask + optional
host-side dictionary for string columns, Arrow-style dictionary encoding —
TPUs do not process variable-length strings).

Partition-local operators are **numpy-backed** here; the accelerated path
(`frame.backend` → `kernels.ops`) keeps device copies of the columns it
touches in a per-Column cache.

Partitions are the paper's preemption quanta (§5.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class Column:
    data: np.ndarray  # (n,) numeric; for string cols: int32 dictionary codes
    mask: Optional[np.ndarray] = None  # bool (n,), True = valid; None = all valid
    dictionary: Optional[np.ndarray] = None  # global code -> str (object array)

    def __post_init__(self) -> None:
        self.data = np.asarray(self.data)
        if self.mask is not None:
            self.mask = np.asarray(self.mask)
        if self.data.ndim != 1:
            raise ValueError("columns are 1-D")
        if self.mask is not None and self.mask.shape != self.data.shape:
            raise ValueError("mask shape mismatch")

    @property
    def nrows(self) -> int:
        return int(self.data.shape[0])

    @property
    def nbytes(self) -> int:
        nb = self.data.size * self.data.dtype.itemsize
        if self.mask is not None:
            nb += self.mask.size
        return int(nb)

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None

    def valid_mask(self) -> np.ndarray:
        if self.mask is None:
            return np.ones(self.data.shape, dtype=bool)
        return self.mask

    def take(self, idx) -> "Column":
        return Column(
            data=self.data[idx],
            mask=None if self.mask is None else self.mask[idx],
            dictionary=self.dictionary,
        )

    def select(self, keep) -> "Column":
        return Column(
            data=self.data[keep],
            mask=None if self.mask is None else self.mask[keep],
            dictionary=self.dictionary,
        )

    def slice(self, start: int, stop: int) -> "Column":
        return Column(
            data=self.data[start:stop],
            mask=None if self.mask is None else self.mask[start:stop],
            dictionary=self.dictionary,
        )

    def to_numpy(self) -> np.ndarray:
        """Decode to host values (NaN / None for nulls)."""
        data = np.asarray(self.data)
        if self.dictionary is not None:
            out = self.dictionary[np.clip(data, 0, len(self.dictionary) - 1)]
            out = out.astype(object)
            if self.mask is not None:
                out[~np.asarray(self.mask)] = None
            return out
        out = data.astype(np.float64) if self.mask is not None else data
        if self.mask is not None:
            out = out.copy()
            out[~np.asarray(self.mask)] = np.nan
        return out

    @staticmethod
    def concat(cols: Sequence["Column"]) -> "Column":
        if len(cols) == 1:
            return cols[0]
        any_mask = any(c.mask is not None for c in cols)
        data = np.concatenate([c.data for c in cols])
        mask = (
            np.concatenate([c.valid_mask() for c in cols]) if any_mask else None
        )
        return Column(data=data, mask=mask, dictionary=cols[0].dictionary)


@dataclass
class Partition:
    columns: Dict[str, Column]
    order: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.order:
            self.order = list(self.columns)
        ns = {c.nrows for c in self.columns.values()}
        if len(ns) > 1:
            raise ValueError(f"ragged partition: {ns}")

    @property
    def nrows(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).nrows

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())

    def select_rows(self, keep) -> "Partition":
        return Partition(
            {k: c.select(keep) for k, c in self.columns.items()}, list(self.order)
        )

    def take(self, idx) -> "Partition":
        return Partition(
            {k: c.take(idx) for k, c in self.columns.items()}, list(self.order)
        )

    def slice(self, start: int, stop: int) -> "Partition":
        return Partition(
            {k: c.slice(start, stop) for k, c in self.columns.items()},
            list(self.order),
        )

    def project(self, cols: Sequence[str]) -> "Partition":
        return Partition({c: self.columns[c] for c in cols}, list(cols))

    def with_column(self, name: str, col: Column) -> "Partition":
        cols = dict(self.columns)
        cols[name] = col
        order = list(self.order) + ([name] if name not in self.order else [])
        return Partition(cols, order)


@dataclass
class PTable:
    partitions: List[Partition]

    @property
    def nrows(self) -> int:
        return sum(p.nrows for p in self.partitions)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.partitions)

    @property
    def column_names(self) -> List[str]:
        if not self.partitions:
            return []
        return list(self.partitions[0].order)

    @property
    def npartitions(self) -> int:
        return len(self.partitions)

    def shard(self, cols: Optional[Sequence[str]] = None):
        """Device-resident sharded view of this table's numeric column blocks
        along the ``data`` mesh axis (see ``frame.dist.ShardedPTable``) —
        cached on the table, so repeated sharded dispatches reuse the upload.
        ``None`` when no data mesh exists or the columns fall outside the
        sharded envelope (string/missing columns)."""
        from . import dist

        if not dist.sharded_available() or not self.partitions:
            return None
        if cols is None:
            from . import blocking as B

            cols = B.numeric_columns(self.partitions[0])
        if not cols:
            return None
        return dist.ShardedPTable.from_table(self, tuple(cols))

    def concat(self) -> Partition:
        if not self.partitions:
            return Partition({}, [])
        if len(self.partitions) == 1:
            return self.partitions[0]
        names = self.partitions[0].order
        return Partition(
            {
                n: Column.concat([p.columns[n] for p in self.partitions])
                for n in names
            },
            list(names),
        )

    def head(self, k: int) -> "PTable":
        out: List[Partition] = []
        need = k
        for p in self.partitions:
            if need <= 0:
                break
            take = min(need, p.nrows)
            out.append(p.slice(0, take))
            need -= take
        return PTable(out or [self._empty_like()])

    def tail(self, k: int) -> "PTable":
        out: List[Partition] = []
        need = k
        for p in reversed(self.partitions):
            if need <= 0:
                break
            take = min(need, p.nrows)
            out.append(p.slice(p.nrows - take, p.nrows))
            need -= take
        out.reverse()
        return PTable(out or [self._empty_like()])

    def _empty_like(self) -> Partition:
        if not self.partitions:
            return Partition({}, [])
        p0 = self.partitions[0]
        return Partition(
            {k: c.slice(0, 0) for k, c in p0.columns.items()}, list(p0.order)
        )

    def to_pydict(self) -> Dict[str, np.ndarray]:
        merged = self.concat()
        return {n: merged.columns[n].to_numpy() for n in merged.order}

    def column(self, name: str) -> np.ndarray:
        return self.to_pydict()[name]

    def __repr__(self) -> str:  # notebook-ish preview
        d = self.head(5).to_pydict()
        lines = ["  ".join(f"{k:>12}" for k in d)]
        n = min(5, self.nrows)
        for i in range(n):
            lines.append("  ".join(f"{str(v[i])[:12]:>12}" for v in d.values()))
        lines.append(f"[{self.nrows} rows x {len(self.column_names)} cols, "
                     f"{self.npartitions} partitions]")
        return "\n".join(lines)


def pydict_equal(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> bool:
    """Exact equality of two ``to_pydict()`` results: identical column sets
    and dtypes, bit-equal values (NaN matches NaN), ``None``-aware object
    columns.  The bit-for-bit oracle used by the batched-execution parity
    tests and ``bench_background``'s ``batched_bit_for_bit`` invariant."""
    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or len(x) != len(y):
            return False
        if x.dtype.kind == "f":
            if not np.array_equal(x, y, equal_nan=True):
                return False
        elif x.dtype == object:
            if any(
                not ((u is None and v is None) or u == v) for u, v in zip(x, y)
            ):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def from_pydict(data: Dict[str, np.ndarray], npartitions: int = 1) -> PTable:
    """Build a PTable from host arrays (strings become dictionary-encoded)."""
    cols: Dict[str, Column] = {}
    n = len(next(iter(data.values())))
    for name, values in data.items():
        values = np.asarray(values)
        if values.dtype.kind in ("U", "S", "O"):
            isnull = np.array([v is None for v in values], dtype=bool)
            safe = np.where(isnull, "", values).astype(str)
            uniq, codes = np.unique(safe, return_inverse=True)
            cols[name] = Column(
                data=codes.astype(np.int32),
                mask=(~isnull) if isnull.any() else None,
                dictionary=uniq.astype(object),
            )
        else:
            mask = None
            if values.dtype.kind == "f" and np.isnan(values).any():
                mask = ~np.isnan(values)
                values = np.nan_to_num(values)
            cols[name] = Column(data=values, mask=mask)
    full = Partition(cols, list(data))
    if npartitions <= 1:
        return PTable([full])
    bounds = np.linspace(0, n, npartitions + 1).astype(int)
    return PTable(
        [full.slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]
    )
