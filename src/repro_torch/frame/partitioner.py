"""Think-time-aware dataframe partitioning (paper §5.1).

The trade-off: many small partitions → cheap preemption (little lost progress)
but more per-partition overhead and fewer holistic optimisations; few large
partitions → the opposite.  The paper's strategy, implemented here:

1. **small head and tail partitions** — serve rapid `head`/`tail` interactions
   and partial-result queries immediately;
2. the middle sized by the think-time distribution: partition boundaries are
   placed so that each boundary is crossed roughly when an interaction is
   *likely* to arrive — i.e. partitions get *smaller* where the interaction
   hazard is high (the paper's example: "if the median think time is 20 s and
   the operator's estimated execution time is 40 s, it might be desirable to
   have smaller partitions after 50 % of the rows").
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ..core.thinktime import ThinkTimeModel

DEFAULT_HEAD_ROWS = 1024
DEFAULT_MIN_PARTS = 4
DEFAULT_MAX_PARTS = 64


def plan_partitions(
    nrows: int,
    est_cost_s: float,
    think: Optional[ThinkTimeModel] = None,
    head_rows: int = DEFAULT_HEAD_ROWS,
    max_parts: int = DEFAULT_MAX_PARTS,
) -> Tuple[Tuple[int, int], ...]:
    """Return partition (start, stop) bounds for a table of ``nrows`` whose
    full-scan cost is ``est_cost_s``."""
    if nrows <= 0:
        return ((0, 0),)
    if nrows <= 4 * head_rows:
        # small table: split evenly into a handful of partitions
        nparts = max(1, min(DEFAULT_MIN_PARTS, nrows))
        bounds = _even(nrows, nparts)
        return bounds

    think = think or ThinkTimeModel()
    head = head_rows
    tail = head_rows
    mid_rows = nrows - head - tail

    # target partition duration: a fraction of the median think time, so a
    # background scan checkpoints several times per think window
    target_dt = max(think.median() / 4.0, 1e-3)
    cost_per_row = max(est_cost_s / nrows, 1e-12)
    rows_per_part = max(int(target_dt / cost_per_row), 1)
    n_mid = max(1, min(max_parts - 2, math.ceil(mid_rows / rows_per_part)))

    # hazard-shaped sizing: more (smaller) partitions where the interaction
    # arrival hazard is high.  Weight w_i ∝ hazard at the cumulative time the
    # scan reaches that region; allocate boundaries by inverse-hazard.
    weights = []
    for i in range(n_mid):
        frac = (i + 0.5) / n_mid
        t_at = est_cost_s * frac
        h = think.hazard_after(max(t_at, 1e-3))
        weights.append(1.0 / max(h, 1e-9))  # low hazard → long partition
    total_w = sum(weights)
    bounds: List[Tuple[int, int]] = [(0, head)]
    pos = head
    for i, w in enumerate(weights):
        size = int(round(mid_rows * w / total_w)) if i < n_mid - 1 else (
            nrows - tail - pos
        )
        size = max(size, 1)
        stop = min(pos + size, nrows - tail)
        if stop > pos:
            bounds.append((pos, stop))
        pos = stop
    if pos < nrows - tail:
        bounds.append((pos, nrows - tail))
        pos = nrows - tail
    bounds.append((nrows - tail, nrows))
    return tuple(bounds)


def _even(nrows: int, nparts: int) -> Tuple[Tuple[int, int], ...]:
    step = nrows / nparts
    cuts = [round(i * step) for i in range(nparts + 1)]
    cuts[-1] = nrows
    return tuple(
        (a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a
    )


def uniform_partitions(nrows: int, nparts: int) -> Tuple[Tuple[int, int], ...]:
    return _even(nrows, max(1, nparts))
