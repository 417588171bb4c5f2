"""Notebook traffic: an endless stream of 12-cell notebooks, generated from
the seed as the reference's ``benchmarks/workloads.py:run_notebook``
generates them (the paper's interaction mix, Figs 3-5), over the tables of
a dataframe configuration.

A cell also names the frames it creates (``new_frames``): the kind
specifies each when it is created, as the notebook's ``read_table`` would,
so that think time may materialise it before an interaction reads it.

The stream is plain data that two sides read: ``kinds/notebook.py`` drives
the port's ``Session`` with it and ``frame_ref.py`` answers it in NumPy.

A frame is a plan: a base (``lineitem``, ``orders`` or ``join``: LINEITEM
joined with ORDERS on the order key) followed by specification ops:
``("filter", col, threshold)`` (rows with col > threshold),
``("assign", "z", col, k)`` (z = col * k), ``("fillna", col)`` (col's nulls
filled with its mean) and ``("dropna", col)``.  An interaction is
``("describe",)``, ``("head", k)``, ``("tail", k)``, ``("value_counts",
col)``, ``("columns",)`` or ``("groupby_mean_head", by, k)`` (the mean of
every numeric column by ``by``, the first k groups).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

_Z75 = 0.6744897501960817  # the standard normal's 75th percentile


@dataclass
class Schema:
    numeric: List[str]  # in frame order: what describe and the groupby read
    category: List[str]  # dictionary columns value_counts and groupbys use
    columns: List[str]  # every column, in frame order


def base_schemas(config: Dict[str, Any]) -> Dict[str, Schema]:
    """The three bases' columns, from the configuration file."""
    cols = config["columns"]
    out = {}
    for t in ("lineitem", "orders"):
        names = list(cols[t])
        out[t] = Schema(numeric=[c for c in names if cols[t][c] != "dictionary"],
                        category=list(config["category_columns"][t]), columns=names)
    li, od = out["lineitem"], out["orders"]
    # the join adds every ORDERS column: the key it joins on is a copy of
    # ORDERS' key under LINEITEM's name, which the join drops
    out["join"] = Schema(numeric=li.numeric + od.numeric, category=li.category + od.category,
                         columns=li.columns + od.columns)
    return out


def think_sampler(median_s: float, p75_s: float):
    mu = math.log(median_s)
    sigma = (math.log(p75_s) - math.log(median_s)) / _Z75
    return lambda rng: float(rng.lognormal(mu, sigma))


def _pick(rng: np.random.Generator, table: List[List[Any]]):
    names = [n for n, _ in table]
    w = np.array([p for _, p in table], dtype=np.float64)
    return names[int(rng.choice(len(names), p=w / w.sum()))]


def cells(config: Dict[str, Any], traffic: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """The cells of notebook after notebook: each a dict with the frame's
    plan, the interaction and the think time drawn after it (drawn whether
    or not the mix thinks, so that a mix without think time runs the same
    notebooks).  The notebooks are the mix's own, drawn from its
    ``stream_seed``: a run's seed draws the data, so that every seed runs
    the same work."""
    rng = np.random.default_rng(int(traffic["stream_seed"]))
    schemas = base_schemas(config)
    ranges = config["numeric_ranges"]
    think = think_sampler(*traffic["think_prior_s"])
    lo_ops, hi_ops = traffic["ops_per_cell"]
    nb = 0
    while True:
        frames: List[Tuple[tuple, Schema]] = []
        created: List[tuple] = []  # the frames specified in this cell so far

        def new_frame():
            base = _pick(rng, traffic["frames"])
            s = schemas[base]
            plan = (("base", base),)
            frames.append((plan, Schema(list(s.numeric), list(s.category), list(s.columns))))
            created.append(plan)

        new_frame()
        for c in range(traffic["cells_per_notebook"]):
            if rng.random() < traffic["p_new_frame_at_cell"]:
                new_frame()
            fidx = int(rng.integers(0, len(frames)))
            plan, schema = frames[fidx]
            filterable = [col for col in schema.numeric if col in ranges]
            for _ in range(int(rng.integers(lo_ops, hi_ops + 1))):
                op = _pick(rng, traffic["spec_ops"])
                if op == "filter":
                    col = filterable[int(rng.integers(0, len(filterable)))]
                    lo, hi = ranges[col]
                    plan = plan + (("filter", col, float(rng.uniform(lo, hi))),)
                elif op == "assign":
                    col = schema.numeric[int(rng.integers(0, len(schema.numeric)))]
                    plan = plan + (("assign", "z", col, float(rng.uniform(0.5, 2.0))),)
                    if "z" not in schema.columns:
                        schema = Schema(schema.numeric + ["z"], schema.category,
                                        schema.columns + ["z"])
                elif op == "fillna":
                    col = schema.numeric[int(rng.integers(0, len(schema.numeric)))]
                    plan = plan + (("fillna", col),)
                elif op == "dropna":
                    col = schema.numeric[int(rng.integers(0, len(schema.numeric)))]
                    plan = plan + (("dropna", col),)
                else:  # a new frame joins the notebook; this one is unchanged
                    new_frame()
            frames[fidx] = (plan, schema)
            kind = _pick(rng, traffic["interactions"])
            if kind in ("head", "tail"):
                lo, hi = traffic["head_rows"]
                inter: tuple = (kind, int(rng.integers(lo, hi + 1)))
            elif kind == "value_counts":
                inter = (kind, schema.category[int(rng.integers(0, len(schema.category)))])
            elif kind == "groupby_mean_head":
                inter = (kind, schema.category[int(rng.integers(0, len(schema.category)))],
                         int(traffic["groupby_head_rows"]))
            else:
                inter = (kind,)
            yield {"notebook": nb, "cell": c, "plan": plan, "numeric": list(schema.numeric),
                   "interaction": inter, "think": think(rng), "new_frames": list(created)}
            created.clear()
        nb += 1


def sample_checked(cells: List[Dict], k: int, seed: int) -> List[int]:
    """Which of the finished interactions (their cells, in order) are
    checked, drawn from the seed: one of each interaction kind and of each
    base frame the window reached, then others up to ``k`` in all, without
    repeats, in order."""
    order = [int(i) for i in np.random.default_rng([seed, 0x5EED]).permutation(len(cells))]
    pick: set = set()
    for key in (lambda c: c["interaction"][0], lambda c: c["plan"][0][1]):
        covered = {key(cells[i]) for i in pick}
        for i in order:
            if key(cells[i]) not in covered:
                pick.add(i)
                covered.add(key(cells[i]))
    for i in order:
        if len(pick) >= k:
            break
        pick.add(i)
    return sorted(pick)
