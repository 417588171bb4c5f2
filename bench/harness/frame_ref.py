"""The plain reference of the notebook cells: NumPy over the generated
tables, with the semantics of pandas on the same data.

It imports nothing of the port and reads only the tables the benchmark
generated and the notebook plans (``notebook.py``).  Answers come back in
a normal form that ``compare`` holds the port's answers against:

* ``("describe", names, counts, stats)``: stats (C, 4) = mean, sample std,
  min, max of each numeric column;
* ``("rows", names, arrays)``: head and tail, every column's values;
* ``("value_counts", codes, counts)``: by count, then by code;
* ``("columns", names)``;
* ``("groupby", codes, names, means)``: the first k groups by code, the
  mean of each numeric column (C, k).

``precision="bfloat16"`` is the control: every aggregate reads its values
rounded to bfloat16 first, the nearest precision below the float32 that the
configuration states for aggregates.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float64 values rounded to bfloat16 (to nearest, ties to even),
    returned as float64."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32).astype(np.float64)


class Frame:
    def __init__(self, cols: "OrderedDict[str, np.ndarray]", dicts: Dict[str, np.ndarray]):
        self.cols = cols
        self.dicts = dicts

    @property
    def nrows(self) -> int:
        return len(next(iter(self.cols.values())))

    def numeric(self) -> List[str]:
        return [c for c in self.cols if c not in self.dicts]

    def select(self, keep: np.ndarray) -> "Frame":
        return Frame(OrderedDict((k, v[keep]) for k, v in self.cols.items()), self.dicts)


class FrameReference:
    """Answers notebook plans over ``tables`` (name -> ``tpch.Table``)."""

    def __init__(self, tables, join_keys: Tuple[str, str], precision: str = "float64",
                 memo: int = 4):
        self.tables = tables
        self.join_keys = join_keys
        self.lowp = precision == "bfloat16"
        self._memo: "OrderedDict[tuple, Frame]" = OrderedDict()
        self._memo_max = memo

    # -- frames ------------------------------------------------------------------
    def _base(self, name: str) -> Frame:
        if name != "join":
            t = self.tables[name]
            return Frame(OrderedDict(t.columns), dict(t.dictionaries))
        li, od = self.tables["lineitem"], self.tables["orders"]
        lkey, okey = self.join_keys
        order = np.argsort(od.columns[okey], kind="stable")
        skeys = od.columns[okey][order]
        pos = np.searchsorted(skeys, li.columns[lkey])
        pos_c = np.minimum(pos, len(skeys) - 1)
        hit = skeys[pos_c] == li.columns[lkey]
        rows = order[pos_c[hit]]
        cols = OrderedDict((k, v[hit]) for k, v in li.columns.items())
        for k, v in od.columns.items():
            cols[k] = v[rows]
        return Frame(cols, {**li.dictionaries, **od.dictionaries})

    def frame(self, plan: tuple) -> Frame:
        if plan in self._memo:
            self._memo.move_to_end(plan)
            return self._memo[plan]
        if len(plan) == 1:
            out = self._base(plan[0][1])
        else:
            out = self._apply(self.frame(plan[:-1]), plan[-1])
        self._memo[plan] = out
        while len(self._memo) > self._memo_max:
            self._memo.popitem(last=False)
        return out

    @staticmethod
    def _apply(f: Frame, op: tuple) -> Frame:
        kind = op[0]
        if kind == "filter":
            return f.select(f.cols[op[1]] > op[2])
        if kind == "assign":
            _, name, col, k = op
            cols = OrderedDict(f.cols)
            cols[name] = f.cols[col] * np.full(f.nrows, k)
            return Frame(cols, f.dicts)
        if kind in ("fillna", "dropna"):
            # the configuration's columns hold no nulls: nothing to fill or drop
            return f
        raise ValueError(f"unknown op {op!r}")

    # -- answers -----------------------------------------------------------------
    def _vals(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return to_bfloat16(x) if self.lowp else x

    def answer(self, plan: tuple, inter: tuple) -> tuple:
        f = self.frame(plan)
        kind = inter[0]
        if kind == "describe":
            names = f.numeric()
            counts = np.full(len(names), float(f.nrows))
            stats = np.zeros((len(names), 4))
            for i, c in enumerate(names):
                x = self._vals(f.cols[c])
                if len(x):
                    stats[i] = (x.mean(), x.std(ddof=1) if len(x) > 1 else 0.0,
                                x.min(), x.max())
                else:
                    stats[i] = (0.0, 0.0, np.inf, -np.inf)
            return ("describe", names, counts, stats)
        if kind in ("head", "tail"):
            k = inter[1]
            sl = slice(0, k) if kind == "head" else slice(max(f.nrows - k, 0), f.nrows)
            return ("rows", list(f.cols), [v[sl] for v in f.cols.values()])
        if kind == "value_counts":
            codes, counts = np.unique(f.cols[inter[1]], return_counts=True)
            order = np.lexsort((codes, -counts))
            return ("value_counts", codes[order].astype(np.int64), counts[order].astype(np.int64))
        if kind == "columns":
            return ("columns", list(f.cols))
        if kind == "groupby_mean_head":
            by, k = inter[1], inter[2]
            keys = f.cols[by]
            order = np.argsort(keys, kind="stable")
            sk = keys[order]
            uniq, starts = np.unique(sk, return_index=True)
            ends = np.append(starts[1:], len(sk))
            uniq, starts, ends = uniq[:k], starts[:k], ends[:k]
            names = f.numeric()
            means = np.zeros((len(names), len(uniq)))
            for i, c in enumerate(names):
                x = self._vals(f.cols[c][order[: ends[-1] if len(uniq) else 0]])
                for j, (s, e) in enumerate(zip(starts, ends)):
                    means[i, j] = x[s:e].mean()
            return ("groupby", uniq.astype(np.int64), names, means)
        raise ValueError(f"unknown interaction {inter!r}")


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest |got - want|, equal values (infinities included) reading
    0 and a NaN on either side alone reading infinitely far."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):  # inf - inf where both are inf: masked
        d = np.where(same, 0.0, np.abs(got - want))
    return float(np.max(np.where(np.isnan(d), np.inf, d), initial=0.0))


def _scale(ref: np.ndarray) -> float:
    m = float(np.max(np.abs(ref))) if ref.size else 0.0
    return m if m > 0 and np.isfinite(m) else 1.0


def compare(got: tuple, want: tuple) -> Tuple[bool, float]:
    """(whether an exact part differs, the widest gap of a statistic as a
    share of its column's magnitude).  Counts, rows, codes and names are
    compared exactly; describe's counts as the float32 the port stores."""
    if got[0] != want[0]:
        return True, 0.0
    kind = got[0]
    if kind == "columns":
        return list(got[1]) != list(want[1]), 0.0
    if kind == "rows":
        if list(got[1]) != list(want[1]):
            return True, 0.0
        for a, b in zip(got[2], want[2]):
            if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b):
                return True, 0.0
        return False, 0.0
    if kind == "value_counts":
        same = (got[1].shape == want[1].shape and np.array_equal(got[1], want[1])
                and np.array_equal(got[2], want[2]))
        return not same, 0.0
    if kind == "describe":
        if list(got[1]) != list(want[1]):
            return True, 0.0
        exact_bad = not np.array_equal(np.asarray(got[2], np.float32),
                                       np.asarray(want[2], np.float32))
        gap = 0.0
        for i in range(len(want[1])):
            r = want[3][i]
            s = _scale(r[2:])  # the column's magnitude: the larger of |min|, |max|
            gap = max(gap, _gap(got[3][i], r) / s)
        return exact_bad, gap
    if kind == "groupby":
        if list(got[2]) != list(want[2]) or not np.array_equal(got[1], want[1]):
            return True, 0.0
        gap = 0.0
        for i in range(len(want[2])):
            r = want[3][i]
            gap = max(gap, _gap(got[3][i], r) / _scale(r))
        return False, gap
    raise ValueError(f"unknown answer kind {kind!r}")
