"""Hypothesis property tests of the port's invariants, test for test beside
the JAX package's ``tests/test_property.py``.  Sessions run on the port's
``numpy`` and ``torch`` (``device="cpu"``) kernel backends, each a
parametrised case; the cache and scheduler properties are ``core``,
byte-identical in both packages, and run over both.  Inside the port,
preempt / resume equals the uninterrupted run bit for bit."""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="dev extra: pip install -r requirements-dev.txt")

from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import repro.core as RC
import repro_torch.core as TC
from repro_torch.frame import Catalog, ColSpec, Session, TableSpec
from repro_torch.frame.partitioner import plan_partitions, uniform_partitions
from repro_torch.frame.table import pydict_equal

SETTINGS = dict(
    max_examples=15,
    deadline=None,
    suppress_health_check=[HealthCheck.function_scoped_fixture],
)
CORES = pytest.mark.parametrize("core", [RC, TC], ids=["repro", "repro_torch"])
BACKENDS = pytest.mark.parametrize("bk", ["numpy", "torch"])


def _catalog(seed=0):
    cat = Catalog()
    cat.register(
        TableSpec(
            "t",
            nrows=800,
            cols=(
                ColSpec("x", low=0, high=10),
                ColSpec("y", null_frac=0.25),
                ColSpec("k", kind="cat", n_categories=5),
            ),
            io_seconds=2.0,
            seed=seed,
        )
    )
    return cat


def _session(cat, bk, **kw):
    return Session(catalog=cat, mode="sim", kernel_backend=bk,
                   device="cpu" if bk == "torch" else None, **kw)


def _random_program(session, rng: np.random.Generator):
    """A random but valid deferred program; returns the terminal DataFrame."""
    df = session.read_table("t")
    n_steps = rng.integers(1, 5)
    for _ in range(n_steps):
        choice = rng.integers(0, 4)
        if choice == 0:
            df = df[df["x"] > float(rng.uniform(0, 10))]
        elif choice == 1:
            df["z%d" % rng.integers(0, 3)] = df["x"] * float(rng.uniform(0.5, 2))
        elif choice == 2:
            df["y"] = df["y"].fillna(float(rng.uniform(0, 1)))
        else:
            df = df.dropna(subset=["y"])
    return df


def _close(out, ref, rtol):
    for k in ref:
        if k == "stat":
            continue
        np.testing.assert_allclose(
            np.asarray(out[k], dtype=np.float64),
            np.asarray(ref[k], dtype=np.float64),
            rtol=rtol,
            err_msg=k,
        )


@BACKENDS
@settings(**SETTINGS)
@given(seed=st.integers(0, 10_000))
def test_opportunistic_equals_eager(bk, seed):
    """Slicing soundness: interaction results identical to eager execution."""
    cat = _catalog()
    s_opp = _session(cat, bk, policy="utility")
    s_eager = _session(cat, bk, opportunistic=False)
    df_o = _random_program(s_opp, np.random.default_rng(seed))
    df_e = _random_program(s_eager, np.random.default_rng(seed))
    out_o = s_opp.show(df_o.describe()).to_pydict()
    out_e = s_eager.show(df_e.describe()).to_pydict()
    _close(out_o, out_e, 1e-5)


@BACKENDS
@settings(**SETTINGS)
@given(seed=st.integers(0, 10_000), nparts=st.integers(1, 9))
def test_partitioning_invariance(bk, seed, nparts):
    cat = _catalog()
    s = _session(cat, bk)
    df = _random_program(s, np.random.default_rng(seed))
    cur = df.node  # find the read node and repartition it
    while cur.parents:
        cur = cur.parents[0]
    cur.kwargs["partition_bounds"] = uniform_partitions(800, nparts)
    out = s.show(df.describe()).to_pydict()

    s1 = _session(cat, bk)
    df1 = _random_program(s1, np.random.default_rng(seed))
    cur = df1.node
    while cur.parents:
        cur = cur.parents[0]
    cur.kwargs["partition_bounds"] = uniform_partitions(800, 1)
    ref = s1.show(df1.describe()).to_pydict()
    _close(out, ref, 1e-4)


@BACKENDS
@settings(**SETTINGS)
@given(
    budgets=st.lists(st.floats(0.05, 3.0), min_size=1, max_size=8),
    seed=st.integers(0, 1000),
)
def test_preempt_resume_equals_uninterrupted(bk, budgets, seed):
    """Chopping background work into arbitrary think windows never changes
    the result (bit for bit) and never re-runs a completed unit."""
    cat = _catalog()
    s = _session(cat, bk)
    df = _random_program(s, np.random.default_rng(seed))
    terminal = df.describe()
    for b in budgets:
        s.think(b)
    s.drain()
    units_after_drain = s.engine.executor.stats.units_run
    out = s.show(terminal).to_pydict()
    # everything was already cached: display ran zero extra units
    assert s.engine.executor.stats.units_run == units_after_drain

    s_ref = _session(cat, bk)
    df_ref = _random_program(s_ref, np.random.default_rng(seed))
    ref = s_ref.show(df_ref.describe()).to_pydict()
    _close(out, ref, 1e-5)
    assert pydict_equal(out, ref)


@CORES
@settings(**SETTINGS)
@given(
    sizes=st.lists(st.integers(50, 400), min_size=3, max_size=12),
    policy=st.sampled_from(["paper_eq3", "corrected", "lru", "size"]),
)
def test_cache_respects_budget(core, sizes, policy):
    d = core.DAG()
    cache = core.MaterializedCache(budget_bytes=1000, cost_model=core.CostModel(),
                                   policy=policy)

    class Blob:
        def __init__(self, n):
            self.nbytes = n

    prev = None
    for i, n in enumerate(sizes):
        node = d.add("synthetic", parents=[prev] if prev else [],
                     kwargs={"cost_s": 1.0 + i, "tag": str(i)})
        cache.put(node, Blob(n))
        prev = node
        assert cache.used_bytes <= max(
            cache.budget_bytes, max(sizes)
        )  # single oversize entries allowed, otherwise bounded
    # after all puts: under the GC threshold or only one (oversize) entry left
    assert (
        cache.used_bytes <= cache.gc_threshold * cache.budget_bytes
        or len(cache._entries) == 1
    )


@settings(**SETTINGS)
@given(
    think_median=st.floats(0.5, 60.0),
    cost=st.floats(0.1, 200.0),
    nrows=st.integers(100, 2_000_000),
)
def test_partition_plan_invariants(think_median, cost, nrows):
    tm = TC.ThinkTimeModel()
    for _ in range(64):
        tm.update(think_median)
    bounds = plan_partitions(nrows, cost, tm)
    # covers [0, nrows) exactly, in order, no empty partitions
    assert bounds[0][0] == 0 and bounds[-1][1] == nrows
    for (a, b), (c, d) in zip(bounds[:-1], bounds[1:]):
        assert b == c and b > a and d > c


@CORES
@settings(**SETTINGS)
@given(seed=st.integers(0, 10_000))
def test_scheduler_never_picks_blocked_or_done(core, seed):
    rng = np.random.default_rng(seed)
    d = core.DAG()
    nodes = []
    for i in range(12):
        parents = (
            list(rng.choice(nodes, size=min(len(nodes), rng.integers(0, 3)),
                            replace=False))
            if nodes
            else []
        )
        nodes.append(
            d.add("synthetic", parents=parents, kwargs={"cost_s": 1.0, "tag": str(i)})
        )
    s = core.Scheduler(dag=d, cost_model=core.CostModel(), policy="utility")
    done: set[int] = set()
    while True:
        pick = s.pick(done)
        if pick is None:
            break
        assert pick.nid not in done
        assert all(p.nid in done for p in pick.parents)
        done.add(pick.nid)
    assert len(done) == len(d)  # no starvation: everything eventually runs
