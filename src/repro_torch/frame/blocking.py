"""Blocking (all-partition) operators as partial/combine pairs.

Each blocking operator is decomposed into per-partition *partial* units (the
preemption quanta) and a *combine* step — the same shape that
`repro.frame.dist` runs under ``shard_map`` with `jax.lax` collectives, and
that the Pallas kernels in `repro.kernels` accelerate on TPU (segment_reduce
for groupby partials, masked_stats for describe partials, topk for
limit-sorts).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.scheduler import sample_first_order
from .table import Column, Partition, PTable


def _ci_priority_order(
    missing: Sequence[int], total: int, contrib: Dict[int, float]
) -> Optional[List[int]]:
    """Order ``missing`` partitions by expected shrink of the widest live
    confidence interval.  ``contrib`` maps each *seen* partition index to its
    (absolute) contribution to the widest-CI statistic; a missing partition is
    scored by its nearest contributor's mass with distance decay — positional
    locality (time-ordered facts, clustered categories) means neighbours of a
    heavy contributor usually carry similar mass, and resolving heavy
    contributions is what tightens a partition-spread interval.  Ties fall
    back to the bit-reversal lattice rank, so the ordering still spreads
    coverage when contributions are flat."""
    if not contrib:
        return None
    lattice = {
        i: r for r, i in enumerate(sample_first_order(list(missing), total))
    }
    seen = sorted(contrib)

    def score(j: int) -> float:
        nearest = min(seen, key=lambda s: (abs(s - j), s))
        return contrib[nearest] / (1.0 + abs(nearest - j))

    return sorted(missing, key=lambda j: (-score(j), lattice[j], j))

# --------------------------------------------------------------------------- #
# describe / mean — Welford partials                                           #
# --------------------------------------------------------------------------- #


@dataclass
class ColStats:
    n: float
    mean: float
    m2: float
    mn: float
    mx: float

    def merge(self, o: "ColStats") -> "ColStats":
        if o.n == 0:
            return self
        if self.n == 0:
            return o
        n = self.n + o.n
        delta = o.mean - self.mean
        mean = self.mean + delta * o.n / n
        m2 = self.m2 + o.m2 + delta * delta * self.n * o.n / n
        return ColStats(n, mean, m2, min(self.mn, o.mn), max(self.mx, o.mx))

    @property
    def std(self) -> float:
        return float(np.sqrt(self.m2 / (self.n - 1))) if self.n > 1 else 0.0


def numeric_columns(part: Partition) -> List[str]:
    return [n for n in part.order if not part.columns[n].is_string]


def partial_stats(part: Partition, cols: Optional[Sequence[str]] = None) -> Dict[str, ColStats]:
    """One partition's contribution to describe/mean — a single fused pass
    (the `masked_stats` Pallas kernel computes exactly this on TPU)."""
    out: Dict[str, ColStats] = {}
    for name in cols if cols is not None else numeric_columns(part):
        col = part.columns[name]
        data = np.asarray(col.data, dtype=np.float64)
        if col.mask is not None:
            valid = np.asarray(col.mask)
            data = data[valid]
        n = float(data.size)
        if n == 0:
            out[name] = ColStats(0.0, 0.0, 0.0, np.inf, -np.inf)
        else:
            mean = float(data.mean())
            out[name] = ColStats(
                n, mean, float(((data - mean) ** 2).sum()), float(data.min()),
                float(data.max()),
            )
    return out


def _pairwise_merge(items: List[ColStats]) -> ColStats:
    """Balanced pairwise reduction of Chan merges.

    A left fold applies the pairwise update n−1 times to an ever-growing
    accumulator, so rounding error in m2 grows O(n); the balanced tree keeps
    both merge operands at comparable magnitude and bounds the growth at
    O(log n) — this is what keeps confidence intervals honest on shifted
    data (|mean| ≫ std) merged across hundreds of partitions."""
    while len(items) > 1:
        items = [
            items[i].merge(items[i + 1]) if i + 1 < len(items) else items[i]
            for i in range(0, len(items), 2)
        ]
    return items[0]


def merge_stats(parts: Sequence[Dict[str, ColStats]]) -> Dict[str, ColStats]:
    per_key: Dict[str, List[ColStats]] = {}
    for p in parts:
        for k, s in p.items():
            per_key.setdefault(k, []).append(s)
    return {k: _pairwise_merge(v) for k, v in per_key.items()}


def stats_to_table(stats: Dict[str, ColStats]) -> PTable:
    names = list(stats)
    stat_rows = ["count", "mean", "std", "min", "max"]
    cols: Dict[str, Column] = {
        "stat": Column(
            data=np.arange(len(stat_rows), dtype=np.int32),
            dictionary=np.array(stat_rows, dtype=object),
        )
    }
    for n in names:
        s = stats[n]
        cols[n] = Column(
            data=np.asarray([s.n, s.mean, s.std, s.mn, s.mx], dtype=np.float32)
        )
    return PTable([Partition(cols, ["stat"] + names)])


def means_to_table(stats: Dict[str, ColStats]) -> PTable:
    cols = {
        n: Column(data=np.asarray([s.mean if s.n else np.nan]))
        for n, s in stats.items()
    }
    return PTable([Partition(cols, list(stats))])


# --------------------------------------------------------------------------- #
# value_counts / unique                                                        #
# --------------------------------------------------------------------------- #


def partial_value_counts(part: Partition, col: str) -> Tuple[np.ndarray, np.ndarray]:
    c = part.columns[col]
    data = np.asarray(c.data)
    if c.mask is not None:
        data = data[np.asarray(c.mask)]
    values, counts = np.unique(data, return_counts=True)
    return values, counts


def merge_value_counts(
    partials: Sequence[Tuple[np.ndarray, np.ndarray]],
    dictionary: Optional[np.ndarray],
    col: str,
) -> PTable:
    nonempty = [(v, c) for v, c in partials if len(v)]
    if nonempty:
        all_vals = np.concatenate([v for v, _ in nonempty])
        all_cnts = np.concatenate([c for _, c in nonempty]).astype(np.int64)
        uniq, inv = np.unique(all_vals, return_inverse=True)
        sums = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(sums, inv, all_cnts)
        # order by (-count, value): lexsort's last key is primary
        order = np.lexsort((uniq, -sums))
        vals = uniq[order]
        cnts = sums[order]
    else:
        vals = np.array([])
        cnts = np.array([], dtype=np.int64)
    value_col = Column(
        data=np.asarray(vals.astype(np.int32 if dictionary is not None else vals.dtype)),
        dictionary=dictionary,
    )
    return PTable(
        [
            Partition(
                {col: value_col, "count": Column(data=np.asarray(cnts))},
                [col, "count"],
            )
        ]
    )


# --------------------------------------------------------------------------- #
# groupby-aggregate                                                            #
# --------------------------------------------------------------------------- #

BUILTIN_AGGS = ("sum", "mean", "count", "min", "max")


def partial_groupby(
    part: Partition,
    by: str,
    aggs: Sequence[Tuple[str, str, Any]],  # (out_name, col, fn)
    topk_keys: Optional[int] = None,
) -> dict:
    """Per-partition partial aggregation (the `segment_reduce` kernel's job).

    ``topk_keys`` implements the paper's Fig. 2b rewrite: keep only the k
    smallest local keys — sufficient for a global top-k-groups head.
    """
    key_col = part.columns[by]
    keys = np.asarray(key_col.data)
    valid = np.asarray(key_col.valid_mask())
    keys_v = keys[valid]
    order = np.argsort(keys_v, kind="stable")
    sorted_keys = keys_v[order]
    uniq, starts = np.unique(sorted_keys, return_index=True)
    if topk_keys is not None and len(uniq) > topk_keys:
        cutoff = starts[topk_keys]
        uniq = uniq[:topk_keys]
        starts = starts[:topk_keys]
        order = order[:cutoff]
        sorted_keys = sorted_keys[:cutoff]
    partial: dict = {"keys": uniq, "aggs": {}}
    counts = np.diff(np.append(starts, len(sorted_keys)))
    for out_name, col, fn in aggs:
        if callable(fn):
            vals = np.asarray(part.columns[col].data)[valid][order]
            groups = np.split(vals, starts[1:]) if len(starts) else []
            partial["aggs"][out_name] = ("raw", groups)
            continue
        vals = np.asarray(part.columns[col].data, dtype=np.float64)[valid][order]
        vmask = part.columns[col].mask
        if vmask is not None:
            vm = np.asarray(vmask)[valid][order]
            vals = np.where(vm, vals, _neutral(fn))
            vcounts = (
                np.add.reduceat(vm.astype(np.float64), starts)
                if len(starts)
                else np.array([])
            )
        else:
            vcounts = counts.astype(np.float64)
        if fn == "sum":
            red = np.add.reduceat(vals, starts) if len(starts) else np.array([])
            partial["aggs"][out_name] = ("sum", red)
        elif fn == "count":
            # pandas semantics: count non-null values of the agg column
            partial["aggs"][out_name] = ("sum", vcounts)
        elif fn == "mean":
            s = np.add.reduceat(vals, starts) if len(starts) else np.array([])
            partial["aggs"][out_name] = ("sum_count", (s, vcounts))
        elif fn == "min":
            red = np.minimum.reduceat(vals, starts) if len(starts) else np.array([])
            partial["aggs"][out_name] = ("min", red)
        elif fn == "max":
            red = np.maximum.reduceat(vals, starts) if len(starts) else np.array([])
            partial["aggs"][out_name] = ("max", red)
        else:
            raise ValueError(f"unknown agg {fn!r}")
    return partial


def _neutral(fn: str) -> float:
    return {"sum": 0.0, "count": 0.0, "mean": 0.0, "min": np.inf, "max": -np.inf}[fn]


def merge_groupby(
    partials: Sequence[dict],
    by: str,
    aggs: Sequence[Tuple[str, str, Any]],
    dictionary: Optional[np.ndarray],
    topk_keys: Optional[int] = None,
) -> PTable:
    nonempty = [p for p in partials if len(p["keys"])]
    all_keys = (
        np.unique(np.concatenate([p["keys"] for p in nonempty]))
        if nonempty
        else np.array([])
    )
    if topk_keys is not None:
        all_keys = all_keys[:topk_keys]
    nk = len(all_keys)
    cols: Dict[str, Column] = {
        by: Column(
            data=np.asarray(
                all_keys.astype(np.int32) if dictionary is not None else all_keys
            ),
            dictionary=dictionary,
        )
    }
    # One shared scatter-index vector across all partials: partial keys are a
    # subset of all_keys (anything sliced off by topk is > max(all_keys), so
    # searchsorted parks it at nk and the in-bounds filter drops it).
    if nonempty:
        cat_keys = np.concatenate([p["keys"] for p in nonempty])
        idx_all = np.searchsorted(all_keys, cat_keys)
        inb = idx_all < nk
        idx_in = idx_all[inb]
    for out_name, col, fn in aggs:
        if callable(fn):
            buckets: List[List[np.ndarray]] = [[] for _ in range(nk)]
            for p in nonempty:
                idx = np.searchsorted(all_keys, p["keys"])
                _, groups = p["aggs"][out_name]
                for local_i, global_i in enumerate(idx):
                    if global_i < nk and all_keys[global_i] == p["keys"][local_i]:
                        buckets[global_i].append(groups[local_i])
            vals = np.array(
                [fn(np.concatenate(b)) if b else np.nan for b in buckets],
                dtype=np.float64,
            )
            cols[out_name] = Column(data=np.asarray(vals))
            continue
        acc = np.full(nk, _neutral(fn if fn != "mean" else "sum"))
        cnt = np.zeros(nk)
        if nonempty:
            kind = nonempty[0]["aggs"][out_name][0]
            if kind == "sum_count":
                s = np.concatenate([p["aggs"][out_name][1][0] for p in nonempty])
                c = np.concatenate([p["aggs"][out_name][1][1] for p in nonempty])
                np.add.at(acc, idx_in, s[inb])
                np.add.at(cnt, idx_in, c[inb])
            else:
                payload = np.concatenate([p["aggs"][out_name][1] for p in nonempty])
                if kind == "sum":
                    np.add.at(acc, idx_in, payload[inb])
                elif kind == "min":
                    np.minimum.at(acc, idx_in, payload[inb])
                elif kind == "max":
                    np.maximum.at(acc, idx_in, payload[inb])
        if fn == "mean":
            acc = np.divide(acc, cnt, out=np.full(nk, np.nan), where=cnt > 0)
        cols[out_name] = Column(data=np.asarray(acc))
    return PTable([Partition(cols, [by] + [a[0] for a in aggs])])


# --------------------------------------------------------------------------- #
# Running combines — progressive bounded estimates                             #
#                                                                              #
# Each blocking op above is a monoid (per-partition partials + associative     #
# combine), so a *prefix* of the partials is itself a valid aggregate of the   #
# rows covered so far.  The Running* state objects below fold completed        #
# partials in as they stream out of the executor and can produce, at any       #
# coverage fraction, (a) an estimate table in the same shape the exact         #
# combine produces and (b) CLT-style confidence intervals with a               #
# finite-population correction √(1 − coverage) that collapses the interval to  #
# a point exactly at 100% coverage.  Partitions are treated as the sampling    #
# unit (cluster sampling): the executor's sample-first ordering makes the      #
# covered prefix approximate a uniform draw over partitions.                   #
# --------------------------------------------------------------------------- #

Z95 = 1.959963984540054  # standard normal 97.5% quantile → 95% two-sided


class RunningStats:
    """Streaming describe/mean: Chan-merged ColStats per column plus a CLT
    interval on each column mean.  ``kind`` selects the estimate shape:
    ``describe`` → stats_to_table, ``mean`` → means_to_table,
    ``mean_scalar`` → float."""

    def __init__(self, total_units: int, kind: str = "describe"):
        self.total_units = total_units
        self.kind = kind
        self.merged: Dict[str, ColStats] = {}

    def update(self, index: int, partial: Dict[str, ColStats]) -> None:
        for k, s in partial.items():
            self.merged[k] = self.merged[k].merge(s) if k in self.merged else s

    def snapshot(self, coverage: float) -> Tuple[Any, Dict[str, Tuple[float, float]]]:
        fpc = math.sqrt(max(0.0, 1.0 - coverage))
        intervals: Dict[str, Tuple[float, float]] = {}
        for name, s in self.merged.items():
            if s.n > 1:
                se = s.std / math.sqrt(s.n) * fpc
                intervals[name] = (s.mean - Z95 * se, s.mean + Z95 * se)
            elif s.n == 1:
                # one valid row: the variance is unknowable, be honest
                intervals[name] = (
                    (s.mean, s.mean) if coverage >= 1.0 else (-math.inf, math.inf)
                )
        if self.kind == "describe":
            value: Any = stats_to_table(self.merged)
        elif self.kind == "mean":
            value = means_to_table(self.merged)
        else:  # mean_scalar: single-column mean as a float
            means = [s.mean for s in self.merged.values() if s.n]
            value = float(means[0]) if means else float("nan")
        return value, intervals


class RunningValueCounts:
    """Streaming value_counts: per-value count sums (and sums of squares)
    over the k partitions seen so far.  The estimate scales each count by
    m/k (m = total partitions); the interval per value comes from the
    partition-level spread: se(Ĉ) = m·√(var_c/k)·√(1 − k/m)."""

    def __init__(self, total_units: int, col: str, dictionary: Optional[np.ndarray]):
        self.total_units = total_units
        self.col = col
        self.dictionary = dictionary
        self._sum: Dict[Any, float] = {}
        self._sumsq: Dict[Any, float] = {}
        self._per_index: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.k = 0

    def _label(self, v: Any) -> str:
        if self.dictionary is not None:
            return str(self.dictionary[int(v)])
        return str(v)

    def update(self, index: int, partial: Tuple[np.ndarray, np.ndarray]) -> None:
        values, counts = partial
        for v, c in zip(np.asarray(values).tolist(), np.asarray(counts).tolist()):
            self._sum[v] = self._sum.get(v, 0.0) + c
            self._sumsq[v] = self._sumsq.get(v, 0.0) + c * c
        self._per_index[index] = (np.asarray(values), np.asarray(counts))
        self.k += 1

    def unit_priority(
        self, missing: Sequence[int], total: int
    ) -> Optional[List[int]]:
        """Refinement ordering: prefer partitions expected to shrink the
        widest live count interval.  The interval widths share every factor
        except the partition-level count variance, so the widest CI belongs
        to the value with the largest var_c — missing partitions are scored
        by their neighbours' counts of that value."""
        if self.k < 2 or not self._per_index:
            return None
        k = self.k
        var = {
            v: max(self._sumsq[v] - k * (self._sum[v] / k) ** 2, 0.0)
            for v in self._sum
        }
        target = max(sorted(var), key=lambda v: var[v])
        contrib: Dict[int, float] = {}
        for i, (values, counts) in self._per_index.items():
            pos = np.nonzero(values == target)[0]
            contrib[i] = float(counts[pos[0]]) if len(pos) else 0.0
        return _ci_priority_order(missing, total, contrib)

    def snapshot(self, coverage: float) -> Tuple[Any, Dict[str, Tuple[float, float]]]:
        m = max(self.total_units, 1)
        k = max(self.k, 1)
        scale = m / k
        intervals: Dict[str, Tuple[float, float]] = {}
        if self._sum:
            uniq = np.array(sorted(self._sum))
            sums = np.array([self._sum[v] for v in uniq.tolist()], dtype=np.float64)
            cnts = np.rint(sums * scale).astype(np.int64)
            order = np.lexsort((uniq, -cnts))
            vals_o = uniq[order]
            cnts_o = cnts[order]
            fpc = math.sqrt(max(0.0, 1.0 - self.k / m))
            for v in uniq.tolist():
                est = self._sum[v] * scale
                if self.k > 1:
                    mean_c = self._sum[v] / k
                    var_c = max(
                        (self._sumsq[v] - k * mean_c * mean_c) / (k - 1), 0.0
                    )
                    se = m * math.sqrt(var_c / k) * fpc
                    intervals[self._label(v)] = (est - Z95 * se, est + Z95 * se)
                else:
                    intervals[self._label(v)] = (
                        (est, est) if coverage >= 1.0 else (-math.inf, math.inf)
                    )
        else:
            vals_o = np.array([])
            cnts_o = np.array([], dtype=np.int64)
        value_col = Column(
            data=np.asarray(
                vals_o.astype(np.int32 if self.dictionary is not None else vals_o.dtype)
            ),
            dictionary=self.dictionary,
        )
        value = PTable(
            [
                Partition(
                    {self.col: value_col, "count": Column(data=np.asarray(cnts_o))},
                    [self.col, "count"],
                )
            ]
        )
        return value, intervals


class RunningGroupby:
    """Streaming groupby_agg: keeps the raw partials seen so far and re-runs
    the exact combine over them per snapshot (k ≤ partitions, cheap), then
    scales additive aggregates (sum/count) by m/k.  Intervals are produced
    per ``out_name[key]`` for sum/count (partition-level totals) and mean
    (spread of per-partition ratios)."""

    def __init__(
        self,
        total_units: int,
        by: str,
        aggs: Sequence[Tuple[str, str, Any]],
        dictionary: Optional[np.ndarray],
        topk_keys: Optional[int] = None,
    ):
        self.total_units = total_units
        self.by = by
        self.aggs = list(aggs)
        self.dictionary = dictionary
        self.topk_keys = topk_keys
        self.partials: Dict[int, dict] = {}

    def _label(self, v: Any) -> str:
        if self.dictionary is not None:
            return str(self.dictionary[int(v)])
        return str(v)

    def update(self, index: int, partial: dict) -> None:
        self.partials[index] = partial

    def unit_priority(
        self, missing: Sequence[int], total: int
    ) -> Optional[List[int]]:
        """Refinement ordering: locate the (agg, key) with the widest live
        interval (recomputing the same widths :meth:`_intervals` reports),
        measure each seen partition's contribution to it, and score missing
        partitions by their nearest contributor's mass with distance decay."""
        if len(self.partials) < 2:
            return None
        idxs = sorted(self.partials)
        parts = [self.partials[i] for i in idxs]
        k = len(parts)
        m = max(self.total_units, 1)
        fpc = math.sqrt(max(0.0, 1.0 - k / m))
        keys_all = sorted(
            {kk for p in parts for kk in np.asarray(p["keys"]).tolist()}
        )
        best: Optional[Tuple[float, Dict[int, float]]] = None
        for out_name, _col, fn in self.aggs:
            if callable(fn) or fn in ("min", "max"):
                continue  # non-additive: no partition-level CI to shrink
            for key in keys_all:
                contribs: List[float] = []
                ratios: List[float] = []
                for p in parts:
                    pk = np.asarray(p["keys"])
                    pos = int(np.searchsorted(pk, key))
                    has = pos < len(pk) and pk[pos] == key
                    _kind, payload = p["aggs"][out_name]
                    if fn == "mean":
                        ok = has and payload[1][pos] > 0
                        contribs.append(float(payload[0][pos]) if ok else 0.0)
                        if ok:
                            ratios.append(float(payload[0][pos] / payload[1][pos]))
                    else:
                        contribs.append(float(payload[pos]) if has else 0.0)
                if fn == "mean":
                    if len(ratios) <= 1:
                        continue
                    r = np.asarray(ratios)
                    width = (
                        2 * Z95 * float(r.std(ddof=1)) / math.sqrt(len(r)) * fpc
                    )
                else:
                    arr = np.asarray(contribs)
                    mean_c = float(arr.sum()) / k
                    var_c = float(((arr - mean_c) ** 2).sum()) / (k - 1)
                    width = 2 * Z95 * m * math.sqrt(var_c / k) * fpc
                if best is None or width > best[0]:
                    best = (
                        width,
                        {i: abs(c) for i, c in zip(idxs, contribs)},
                    )
        if best is None or best[0] <= 0:
            return None
        return _ci_priority_order(missing, total, best[1])

    def snapshot(self, coverage: float) -> Tuple[Any, Dict[str, Tuple[float, float]]]:
        parts = [self.partials[i] for i in sorted(self.partials)]
        table = merge_groupby(parts, self.by, self.aggs, self.dictionary, self.topk_keys)
        k = max(len(parts), 1)
        m = max(self.total_units, 1)
        scale = m / k
        part0 = table.partitions[0]
        for out_name, _col, fn in self.aggs:
            if fn in ("sum", "count"):
                c = part0.columns[out_name]
                part0 = part0.with_column(
                    out_name,
                    Column(data=np.asarray(c.data, np.float64) * scale, mask=c.mask),
                )
        return PTable([part0]), self._intervals(parts, k, m)

    def _intervals(
        self, parts: Sequence[dict], k: int, m: int
    ) -> Dict[str, Tuple[float, float]]:
        out: Dict[str, Tuple[float, float]] = {}
        if k < 2:
            return out
        fpc = math.sqrt(max(0.0, 1.0 - k / m))
        keys_all = sorted({kk for p in parts for kk in np.asarray(p["keys"]).tolist()})
        for out_name, _col, fn in self.aggs:
            if callable(fn) or fn in ("min", "max"):
                continue  # non-additive: no sensible partition-level CI
            for key in keys_all:
                contribs: List[float] = []
                ratios: List[float] = []
                for p in parts:
                    pk = np.asarray(p["keys"])
                    pos = int(np.searchsorted(pk, key))
                    has = pos < len(pk) and pk[pos] == key
                    _kind, payload = p["aggs"][out_name]
                    if fn == "mean":
                        if has and payload[1][pos] > 0:
                            ratios.append(float(payload[0][pos] / payload[1][pos]))
                    else:
                        contribs.append(float(payload[pos]) if has else 0.0)
                label = f"{out_name}[{self._label(key)}]"
                if fn == "mean":
                    if len(ratios) > 1:
                        r = np.asarray(ratios)
                        mu = float(r.mean())
                        se = float(r.std(ddof=1)) / math.sqrt(len(r)) * fpc
                        out[label] = (mu - Z95 * se, mu + Z95 * se)
                else:
                    arr = np.asarray(contribs)
                    total = float(arr.sum())
                    mean_c = total / k
                    var_c = float(((arr - mean_c) ** 2).sum()) / (k - 1)
                    est = total * m / k
                    se = m * math.sqrt(var_c / k) * fpc
                    out[label] = (est - Z95 * se, est + Z95 * se)
        return out


# --------------------------------------------------------------------------- #
# sort (sample sort, optional top-k limit)                                     #
# --------------------------------------------------------------------------- #


def partial_sort(
    part: Partition, by: str, ascending: bool, limit: Optional[int], n_samples: int = 32
) -> Tuple[Partition, np.ndarray]:
    keys = np.asarray(part.columns[by].data, dtype=np.float64)
    if part.columns[by].mask is not None:
        # nulls sort last: replace with +/- inf
        m = np.asarray(part.columns[by].mask)
        keys = np.where(m, keys, np.inf if ascending else -np.inf)
    order = np.argsort(keys if ascending else -keys, kind="stable")
    if limit is not None:
        order = order[:limit]
    sorted_part = part.take(np.asarray(order))
    skeys = keys[order]
    if len(skeys) == 0:
        samples = np.array([])
    else:
        samples = skeys[np.linspace(0, len(skeys) - 1, min(n_samples, len(skeys))).astype(int)]
    return sorted_part, samples


def merge_sort(
    partials: Sequence[Tuple[Partition, np.ndarray]],
    by: str,
    ascending: bool,
    limit: Optional[int],
) -> PTable:
    parts = [p for p, _ in partials if p.nrows > 0]
    if not parts:
        return PTable([partials[0][0]])
    merged = PTable(list(parts)).concat()
    keys = np.asarray(merged.columns[by].data, dtype=np.float64)
    if merged.columns[by].mask is not None:
        m = np.asarray(merged.columns[by].mask)
        keys = np.where(m, keys, np.inf if ascending else -np.inf)
    order = np.argsort(keys if ascending else -keys, kind="stable")
    if limit is not None:
        order = order[:limit]
    sorted_all = merged.take(np.asarray(order))
    # re-partition to roughly the input partition granularity
    nparts = max(1, len(partials) if limit is None else 1)
    n = sorted_all.nrows
    cuts = np.linspace(0, n, nparts + 1).astype(int)
    return PTable(
        [sorted_all.slice(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
        or [sorted_all]
    )


# --------------------------------------------------------------------------- #
# join (broadcast right side, unique right keys) — partitionwise on the left   #
# --------------------------------------------------------------------------- #


def join_build(right: PTable, on: str) -> Tuple[Partition, np.ndarray, np.ndarray]:
    """Build phase of the broadcast join: merge the right side and sort its
    keys once.  Rows with a *null* key are excluded from the build — they can
    never match (pandas semantics) — and uniqueness is required among the
    remaining keys (dim-table join).

    Returns ``(rmerged, r_sorted, r_order)`` where ``r_sorted`` is the
    ascending valid key array and ``r_order[i]`` is the row index in
    ``rmerged`` holding ``r_sorted[i]``.
    """
    rmerged = right.concat()
    kcol = rmerged.columns[on]
    rkeys = _decode_keys(kcol)
    ridx = np.nonzero(np.asarray(kcol.valid_mask()))[0]
    order_local = np.argsort(rkeys[ridx], kind="stable")
    r_sorted = rkeys[ridx][order_local]
    if len(np.unique(r_sorted)) != len(r_sorted):
        raise ValueError("join: right-side keys must be unique (dim-table join)")
    return rmerged, r_sorted, ridx[order_local]


def join_assemble(
    left: Partition,
    rmerged: Partition,
    gather: np.ndarray,
    hit: np.ndarray,
    how: str,
    on: str,
) -> Partition:
    """Shared tail of every join path (numpy probe and kernel probe): row
    selection plus the right-column gather.  ``gather`` holds in-range row
    indices into ``rmerged``; rows with ``hit`` False are forced to index 0 so
    every backend assembles bit-identical partitions."""
    if how == "inner":
        keep = np.nonzero(hit)[0]
        out = left.take(keep)
        gather = gather[keep]
        hit = hit[keep]
    elif how == "left":
        out = left
    else:
        raise ValueError(f"unsupported join how={how!r}")
    gather = np.where(hit, gather, 0)
    miss = ~np.asarray(hit)
    cols = dict(out.columns)
    order = list(out.order)
    for name in rmerged.order:
        if name == on:
            continue
        src = rmerged.columns[name]
        if rmerged.nrows == 0:
            # nothing to gather from: all-null columns of the output length
            taken = Column(
                data=np.zeros(out.nrows, dtype=src.data.dtype),
                mask=np.zeros(out.nrows, dtype=bool),
                dictionary=src.dictionary,
            )
        else:
            taken = src.take(np.asarray(gather))
            if how == "left":
                mask = taken.valid_mask() & ~miss
                taken = Column(data=taken.data, mask=mask, dictionary=taken.dictionary)
        out_name = name if name not in cols else f"{name}_right"
        cols[out_name] = taken
        order.append(out_name)
    return Partition(cols, order)


def join_partition(
    left: Partition, right: PTable, on: str, how: str = "inner"
) -> Partition:
    rmerged, r_sorted, r_order = join_build(right, on)
    lkeys = _decode_keys(left.columns[on])
    if len(r_sorted):
        pos = np.clip(np.searchsorted(r_sorted, lkeys), 0, len(r_sorted) - 1)
        hit = r_sorted[pos] == lkeys
        gather = r_order[pos]
    else:
        hit = np.zeros(len(lkeys), dtype=bool)
        gather = np.zeros(len(lkeys), dtype=np.intp)
    lmask = left.columns[on].mask
    if lmask is not None:
        hit = hit & np.asarray(lmask)  # null left keys never match
    return join_assemble(left, rmerged, gather, hit, how, on)


def _decode_keys(col: Column) -> np.ndarray:
    if col.is_string:
        return col.dictionary[np.asarray(col.data)].astype(str)
    return np.asarray(col.data)


# --------------------------------------------------------------------------- #
# drop sparse columns (case study §6)                                          #
# --------------------------------------------------------------------------- #


def partial_null_counts(part: Partition) -> Dict[str, Tuple[int, int]]:
    return {
        n: (
            int(np.asarray(c.valid_mask()).sum()),
            c.nrows,
        )
        for n, c in part.columns.items()
    }


def combine_drop_sparse(
    parent: PTable, partials: Sequence[Dict[str, Tuple[int, int]]], thresh: float
) -> PTable:
    total: Dict[str, List[int]] = {}
    for p in partials:
        for n, (v, t) in p.items():
            acc = total.setdefault(n, [0, 0])
            acc[0] += v
            acc[1] += t
    keep = [n for n in parent.column_names if total[n][0] >= thresh * total[n][1]]
    return PTable([p.project(keep) for p in parent.partitions])
