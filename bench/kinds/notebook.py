"""The notebook cells: an analyst's notebooks over a dataframe
configuration, run through the port's ``Session`` (``repro_torch.frame``).

Set-up generates the tables from the seed (``harness/tpch.py``), loads them
into a session as the notebook's first cell would (each read materialised,
then ``warm_device_cache``), and warms every code path the window takes on
a small copy in a throwaway session.  The window then runs cells from
``harness/notebook.py``'s stream: the cell's specification ops, one
interaction timed from the call to ``Session.show`` to the answer on the
host, and, where the mix thinks, ``Session.think`` for the drawn
simulated seconds (in steps, so that the window closes on time).  A
notebook's frames are specified once, as its variables would hold them
(``Frames``).  After the window a sample of the answers drawn from the
seed, with every interaction kind and every base frame in it, is held
against ``harness/frame_ref.py``.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from harness import clock, frame_ref, notebook, tpch
from harness.cli import Outcome
from harness.trace import Recorder


CONTROL = "bfloat16"  # the precision below the float32 of the aggregates
DF_KERNELS = ("masked_stats", "segment_reduce", "topk", "filter_compact", "join_probe")


def make_catalog(tables: Dict[str, tpch.Table], config: Dict[str, Any]):
    """A port ``Catalog`` that serves slices of the generated tables (numpy
    views: a read copies nothing on the host).  It keeps no partition: what
    the session keeps, and the device copies with it, is the engine's to
    keep or evict."""
    from repro_torch.frame import Catalog, ColSpec, TableSpec
    from repro_torch.frame.table import Column, Partition

    class TableCatalog(Catalog):
        def __init__(self):
            super().__init__()
            for name, t in tables.items():
                cols = tuple(ColSpec(c, kind="cat" if c in t.dictionaries else "float")
                             for c in t.columns)
                self._tables[name] = TableSpec(
                    name, nrows=t.nrows, cols=cols,
                    io_seconds=float(config["tables"][name]["io_seconds"]))

        def generate(self, name: str, start: int, stop: int) -> Partition:
            t = tables[name]
            return Partition({c: Column(data=v[start:stop], dictionary=t.dictionaries.get(c))
                              for c, v in t.columns.items()}, list(t.columns))

    return TableCatalog()


def make_session(tables, config: Dict[str, Any], device: str):
    from repro_torch.frame import Session

    sc = config["session"]
    backend = sc["kernel_backend"] if device != "cpu" else "torch"
    return Session(catalog=make_catalog(tables, config), mode=sc["mode"],
                   kernel_backend=backend, budget_bytes=int(sc["budget_bytes"]),
                   device=device)


def load(session, device: str) -> None:
    """The notebook's first cell: read both tables and keep them on the card."""
    from repro_torch.frame import backend as BK

    for name in ("lineitem", "orders"):
        table = session.engine.value_of(session.read_table(name).node)
        BK.warm_device_cache(table, device=device)


class Frames:
    """One notebook's frames, each specified once through the port's API and
    kept, as the notebook's variables keep them: a frame is specified when
    the stream creates it, and a cell's specification ops extend the frame
    it picks.  A new notebook starts with no frames (``reset``)."""

    def __init__(self, session, keys):
        self.session = session
        self.keys = keys
        self.memo: Dict[tuple, Any] = {}

    def reset(self) -> None:
        self.memo.clear()

    def get(self, plan: tuple):
        df = self.memo.get(plan)
        if df is None:
            df = self._base(plan[0][1]) if len(plan) == 1 else apply(self.get(plan[:-1]),
                                                                       plan[-1])
            self.memo[plan] = df
        return df

    def _base(self, base: str):
        s = self.session
        if base != "join":
            return s.read_table(base)
        left, right = s.read_table("lineitem"), s.read_table("orders")
        right[self.keys[0]] = right[self.keys[1]]
        return left.join(right, on=self.keys[0])


def apply(df, op: tuple):
    """One specification op on a frame, through the port's API."""
    from repro_torch.frame import DataFrame

    if op[0] == "filter":
        return df[df[op[1]] > op[2]]
    df = DataFrame(df.session, df.node)
    if op[0] == "assign":
        df[op[1]] = df[op[2]] * op[3]
    elif op[0] == "fillna":
        df[op[1]] = df[op[1]].fillna(df[op[1]].mean())
    elif op[0] == "dropna":
        df = df.dropna(subset=[op[1]])
    else:
        raise ValueError(f"unknown op {op!r}")
    return df


def specify(frames: Frames, c: Dict[str, Any]):
    """The cell's frames up to its interaction: the frames it creates, then
    the frame its ops end in."""
    if c["cell"] == 0:
        frames.reset()
    for plan in c["new_frames"]:
        frames.get(plan)
    return frames.get(c["plan"])


def target(df, inter: tuple, numeric: List[str]):
    kind = inter[0]
    if kind == "describe":
        return df.describe()
    if kind == "head":
        return df.head(inter[1])
    if kind == "tail":
        return df.tail(inter[1])
    if kind == "value_counts":
        return df[inter[1]].value_counts()
    if kind == "columns":
        return df.columns
    if kind == "groupby_mean_head":
        return df.groupby(inter[1]).agg({c: "mean" for c in numeric}).head(inter[2])
    raise ValueError(f"unknown interaction {inter!r}")


def normal_form(value, inter: tuple) -> tuple:
    """The port's answer in ``frame_ref``'s normal form."""
    kind = inter[0]
    if kind == "columns":
        return ("columns", list(value))
    p = value.concat()
    cols = p.columns
    if kind == "describe":
        names = list(p.order[1:])
        arr = np.stack([np.asarray(cols[n].data, np.float64) for n in names]) \
            if names else np.zeros((0, 5))
        return ("describe", names, arr[:, 0], arr[:, 1:5])
    if kind in ("head", "tail"):
        arrays = []
        for n in p.order:
            c = cols[n]
            if c.mask is not None and not np.all(c.mask):
                arrays.append(np.asarray([]))  # a null where the data has none
            else:
                arrays.append(np.asarray(c.data))
        return ("rows", list(p.order), arrays)
    if kind == "value_counts":
        return ("value_counts", np.asarray(cols[p.order[0]].data).astype(np.int64),
                np.asarray(cols["count"].data).astype(np.int64))
    if kind == "groupby_mean_head":
        names = list(p.order[1:])
        means = np.stack([np.asarray(cols[n].data, np.float64) for n in names]) \
            if names else np.zeros((0, 0))
        return ("groupby", np.asarray(cols[p.order[0]].data).astype(np.int64), names, means)
    raise ValueError(f"unknown interaction {inter!r}")


def warm_paths(config: Dict[str, Any], traffic: Dict[str, Any], device: str) -> None:
    """Every operator, interaction and kernel the window uses, once, on a
    small copy of the tables in a throwaway session: loads the kernel
    libraries and the framework's lazy state before the window."""
    small = dict(config)
    small["tables"] = {k: dict(v) for k, v in config["tables"].items()}
    small["tables"]["orders"]["rows"] = 4096
    small["tables"]["lineitem"]["rows"] = 4096 * 4
    small["comment_dictionary"] = 64
    if device != "cpu":  # every dataframe kernel's library built and loaded now
        from repro_torch.kernels import _build

        _build.build_all(DF_KERNELS)  # one nvcc a source, at once
        for name in DF_KERNELS:
            _build.load(name)
    tables = tpch.generate(small, 12345, device)
    s = make_session(tables, small, device)
    load(s, device)
    frames = Frames(s, config["join_keys"])
    every = ({op for op, _ in traffic["spec_ops"]} - {"new_frame"}
             | {name for name, _ in traffic["interactions"]} | {name for name, _ in traffic["frames"]})
    seen: set = set()
    stream = notebook.cells(small, dict(traffic, stream_seed=12345))
    for _ in range(500):
        if seen >= every:
            break
        c = next(stream)
        kinds = {op[0] for op in c["plan"][1:]} | {c["interaction"][0], c["plan"][0][1]}
        if kinds <= seen:
            continue
        seen |= kinds
        s.show(target(specify(frames, c), c["interaction"], c["numeric"]))
        if traffic["think"]:
            think(s, c["think"], float(traffic["think_step_s"]), lambda: False)
    del s, frames, tables
    gc.collect()


def think(session, seconds: float, step: float, closed) -> None:
    """``Session.think`` for ``seconds`` of simulated time, given to the
    engine in steps of at most ``step`` seconds, until ``closed()``: the
    window closes in the middle of a long think instead of after it (a
    think of 800 simulated seconds takes a minute of work).  The engine
    checkpoints a unit that a step's deadline preempts and resumes it in
    the next step, so the steps do the work of one call."""
    while seconds > 0 and not closed():
        session.think(min(step, seconds))
        seconds -= step


def _sync(device: str) -> None:
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        checked: Optional[int] = None) -> Outcome:
    import torch

    config, traffic = cell.config, cell.traffic
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    tables = tpch.generate(config, seed, device)
    if device != "cpu":
        torch.cuda.empty_cache()
    warm_paths(config, traffic, device)
    session = make_session(tables, config, device)
    load(session, device)
    _sync(device)

    rec = Recorder(trace, float(traffic["trace_seconds"]))
    stream = notebook.cells(config, traffic)
    frames = Frames(session, config["join_keys"])
    cache = session.engine.cache
    done: List[Dict[str, Any]] = []
    errors: List[str] = []
    t0 = rec.start_window()
    setup_s = t0 - clock.process_start()
    while time.perf_counter() - t0 < seconds:
        c = next(stream)
        df = specify(frames, c)
        tgt = target(df, c["interaction"], c["numeric"])
        hit = tgt.node.nid in cache or df.node.nid in cache
        with rec.span("interaction", hit=hit, what=c["interaction"][0]):
            try:
                value = session.show(tgt)
                _sync(device)
            except Exception as exc:  # counted against the attempts
                errors.append(f"interaction {len(done)} ({c['interaction'][0]}): "
                              f"{type(exc).__name__}: {str(exc)[:300]}")
                value = exc
        done.append({"cell": c, "value": value})
        if traffic["think"]:
            with rec.span("think", sim_s=c["think"]):
                think(session, c["think"], float(traffic["think_step_s"]),
                      lambda: time.perf_counter() - t0 >= seconds)
                _sync(device)
    rec.end_window()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    # the program's state goes before the reference runs
    for e in errors[:10]:
        print("failed " + e, file=sys.stderr)
    answers = [(d["cell"], d["value"]) for d in done]
    del session, frames, done, df, tgt
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(tables, config, traffic, answers, seed, checked)
    return Outcome(setup_s=setup_s, rec=rec, attempted=len(answers), failed=len(errors),
                   checks=checks, memory_peak_bytes=peak, config=config, traffic=traffic,
                   data={"check_s": time.perf_counter() - t_check})


def check(tables, config, traffic, answers, seed: int, checked: Optional[int] = None,
          control: Optional[str] = None) -> Dict[str, tuple]:
    """Hold a sample of the window's answers, drawn from the seed
    (``notebook.sample_checked``), against the reference: (the answers
    whose exact parts differ, limit 0) and (the widest statistic gap, the
    configuration's limit).  With ``control`` (a
    precision), the reference at that precision answers in the program's
    place."""
    ref = frame_ref.FrameReference(tables, tuple(config["join_keys"]))
    low = frame_ref.FrameReference(tables, tuple(config["join_keys"]), control) \
        if control else None
    k = int(traffic["checked_answers"] if checked is None else checked)
    mismatches, gap = 0, 0.0
    for i in notebook.sample_checked([c for c, _ in answers], k, seed):
        c, value = answers[i]
        if isinstance(value, Exception):
            mismatches += 1
            continue
        got = low.answer(c["plan"], c["interaction"]) if low else \
            normal_form(value, c["interaction"])
        bad, g = frame_ref.compare(got, ref.answer(c["plan"], c["interaction"]))
        if bad:
            print(f"mismatch at interaction {i}: {c['interaction']} on {c['plan']}",
                  file=sys.stderr)
        mismatches += int(bad)
        gap = max(gap, g)
    lim = config["limits"]
    return {"exact_mismatches": (float(mismatches), 0.0),
            "stat_gap": (gap, float(lim["stat_gap"]))}


def control(cell, seed: int, device: str = "cuda", faults: bool = True
            ) -> Dict[str, Dict[str, tuple]]:
    """The control's readings: the reference at bfloat16 in the program's
    place, over as many of the stream's interactions as a window answers
    (the mix's ``control_answers``), sampled as a run samples them."""
    import itertools

    config, traffic = cell.config, cell.traffic
    tables = tpch.generate(config, seed, device)
    cells = list(itertools.islice(notebook.cells(config, traffic),
                                  int(traffic["control_answers"])))
    answers = [(c, None) for c in cells]
    return {CONTROL: check(tables, config, traffic, answers, seed, control=CONTROL)}
