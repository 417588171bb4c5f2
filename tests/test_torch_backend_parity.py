"""Backend parity in the port, test for test beside the JAX package's
``tests/test_backend_parity.py``: the kernel-dispatch frame backend must
agree with the scalar numpy reference on every blocking partial, null-masked
columns included, and the scheduler's memoised graph walks must stay
coherent under DAG growth and cache eviction.

``torch`` (the plain PyTorch versions, ``device="cpu"``) takes the
reference's ``xla`` and ``interpret`` roles.  It accumulates in float32, so
numbers agree to about 1e-4 relative (the reference's tolerances, its lines
51-54); structure (keys, row selections, orderings, counts) exactly.  The
scheduler tests exercise ``core``, byte-identical in both packages: they
run over both, one parametrised case each.
"""
import numpy as np
import pytest

import repro.core as RC
import repro_torch.core as TC
from repro_torch.frame import Catalog, ColSpec, Session, TableSpec, from_pydict
from repro_torch.frame import backend as BK
from repro_torch.frame import blocking as B

CPU_BACKENDS = ["numpy", "torch"]
KERNEL_BACKENDS = ["torch"]
CORES = pytest.mark.parametrize("core", [RC, TC], ids=["repro", "repro_torch"])

AGGS = (
    ("s", "x", "sum"),
    ("m", "y", "mean"),
    ("c", "y", "count"),
    ("mn", "x", "min"),
    ("mx", "x", "max"),
)


def _on(backend):
    """A dispatch's backend and device: the CPU for ``torch``."""
    return {"backend": backend, "device": "cpu"}


@pytest.fixture()
def catalog() -> Catalog:
    cat = Catalog()
    cat.register(TableSpec("small", nrows=5_000, cols=(
        ColSpec("x", low=0.0, high=10.0),
        ColSpec("y", null_frac=0.2),
        ColSpec("k", kind="cat", n_categories=7),
        ColSpec("i", kind="int", low=0, high=100),
        ColSpec("j", kind="int", low=0, high=7),
    ), io_seconds=1.0, seed=7))
    cat.register(TableSpec("dim", nrows=7, cols=(ColSpec("j", kind="key"), ColSpec("w")),
                           io_seconds=0.01, seed=3))
    return cat


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(42)
    n = 6_000
    y = rng.uniform(0, 10, n)
    y[rng.random(n) < 0.3] = np.nan  # masked column
    return from_pydict(
        {
            "x": rng.normal(5, 2, n),
            "y": y,
            "k": rng.choice(np.array(["a", "b", "c", "d", "e", "f"]), n),
            "i": rng.integers(0, 50, n),
            "f32": rng.normal(0, 1, n).astype(np.float32),
            "big": rng.integers(2**40, 2**41, n),  # past float32's exact integers
        },
        npartitions=4,
    )


def _stats_close(a, b):
    assert a.n == b.n
    np.testing.assert_allclose(b.mean, a.mean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b.std, a.std, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(b.mn, a.mn, rtol=1e-5)
    np.testing.assert_allclose(b.mx, a.mx, rtol=1e-5)


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_describe_stats_parity(table, backend):
    for part in table.partitions:
        ref = B.partial_stats(part)
        got = BK.partial_stats(part, **_on(backend))
        assert set(got) == set(ref)
        for name in ref:
            _stats_close(ref[name], got[name])
    merged_ref = B.merge_stats([B.partial_stats(p) for p in table.partitions])
    merged_got = B.merge_stats([BK.partial_stats(p, **_on(backend)) for p in table.partitions])
    for name in merged_ref:
        _stats_close(merged_ref[name], merged_got[name])


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_groupby_agg_parity(table, backend):
    dictionary = table.partitions[0].columns["k"].dictionary
    ref_parts = [B.partial_groupby(p, "k", AGGS) for p in table.partitions]
    got_parts = [BK.partial_groupby(p, "k", AGGS, **_on(backend)) for p in table.partitions]
    for r, g in zip(ref_parts, got_parts):
        np.testing.assert_array_equal(g["keys"], r["keys"])
    ref = B.merge_groupby(ref_parts, "k", AGGS, dictionary).to_pydict()
    got = B.merge_groupby(got_parts, "k", AGGS, dictionary).to_pydict()
    np.testing.assert_array_equal(got["k"], ref["k"])
    for col in ("s", "m", "c", "mn", "mx"):
        np.testing.assert_allclose(np.asarray(got[col], np.float64),
                                   np.asarray(ref[col], np.float64), rtol=1e-4, err_msg=col)


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_value_counts_parity(table, backend):
    for part in table.partitions:
        rv, rc = B.partial_value_counts(part, "k")
        gv, gc = BK.partial_value_counts(part, "k", **_on(backend))
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(gc, rc)


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
@pytest.mark.parametrize("by,ascending", [("x", True), ("x", False), ("y", True)])
def test_topk_sort_parity(table, backend, by, ascending):
    k = 12
    for part in table.partitions:
        ref_part, ref_samples = B.partial_sort(part, by, ascending, k)
        got_part, got_samples = BK.partial_sort(part, by, ascending, k, **_on(backend))
        assert got_part.nrows == ref_part.nrows == k
        # the same rows in the same order (the threshold select is lossless)
        for col in part.order:
            np.testing.assert_array_equal(got_part.columns[col].data,
                                          ref_part.columns[col].data, err_msg=col)
        np.testing.assert_allclose(got_samples, ref_samples)


def _partitions_equal(got, ref):
    """Bit for bit: the same column order, bytes and validity."""
    assert got.order == ref.order
    for col in ref.order:
        gc, rc = got.columns[col], ref.columns[col]
        assert gc.data.dtype == rc.data.dtype, col
        np.testing.assert_array_equal(gc.data, rc.data, err_msg=col)
        np.testing.assert_array_equal(gc.valid_mask(), rc.valid_mask(), err_msg=col)


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
@pytest.mark.parametrize("by,ascending", [("x", True), ("x", False), ("y", True), ("y", False),
                                          ("k", True), ("big", True)])
def test_full_sort_parity(table, backend, by, ascending):
    """A full sort agrees bit for bit with numpy's stable float64 argsort:
    float keys, null-masked keys (nulls last), string keys (sorted
    dictionary codes) and int64 past float32's range, through the
    per-partition partial and the sample-sort merge."""
    refs = [B.partial_sort(p, by, ascending, None) for p in table.partitions]
    gots = [BK.partial_sort(p, by, ascending, None, **_on(backend)) for p in table.partitions]
    for (rp, rs), (gp, gs) in zip(refs, gots):
        _partitions_equal(gp, rp)
        np.testing.assert_array_equal(gs, rs)
    mref = B.merge_sort(refs, by, ascending, None).concat()
    mgot = BK.merge_sort(gots, by, ascending, None, **_on(backend)).concat()
    _partitions_equal(mgot, mref)


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_full_sort_fallbacks_match(backend):
    """Unmasked NaN keys, magnitudes past float32 and ones below its
    subnormals sort as numpy does."""
    from repro_torch.frame.table import Column, Partition

    for raw in (
        np.array([5.0, np.nan, 1.0, 3.0, 2.0, np.nan, 0.5]),
        np.array([1e39, -2e39, 3.0, 1e39 / 2, 0.0]),
        np.array([3e-60, 1e-60, 2e-60, -1e-50, 5e-39]),
        np.array([1e-40, -1e-40, 0.0, 2e-44, 3e-44]),
    ):
        part = Partition({"x": Column(data=raw)})
        ref, _ = B.partial_sort(part, "x", True, None)
        got, _ = BK.partial_sort(part, "x", True, None, **_on(backend))
        _partitions_equal(got, ref)


# ----------------------------------------------------------------------- join --


@pytest.fixture(scope="module")
def dim_table():
    rng = np.random.default_rng(7)
    w = rng.normal(0, 1, 40)
    w[::5] = np.nan  # null right values: gathered nulls stay null
    return from_pydict({"i": np.arange(40), "w": w,
                        "label": np.array([f"n{j}" for j in range(40)])})


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_parity(table, dim_table, backend, how):
    """Inner and left broadcast joins bit for bit the numpy reference's:
    rows, gathered right values, and the null masks of left-join misses and
    null right values."""
    for part in table.partitions:
        ref = B.join_partition(part, dim_table, "i", how)
        got = BK.join_partition(part, dim_table, "i", how, **_on(backend))
        _partitions_equal(got, ref)
        if how == "left":  # keys 40..49 miss the dim table
            miss = np.asarray(part.columns["i"].data) >= 40
            assert miss.any()
            assert not got.columns["w"].valid_mask()[miss].any()


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_empty_right(table, backend, how):
    """An empty right table: inner drops every row, left nulls every
    gathered column."""
    empty = from_pydict({"i": np.array([], np.int64), "w": np.array([])})
    part = table.partitions[0]
    out = BK.join_partition(part, empty, "i", how, **_on(backend))
    assert out.order == list(part.order) + ["w"]
    if how == "inner":
        assert out.nrows == 0
    else:
        assert out.nrows == part.nrows
        assert not out.columns["w"].valid_mask().any()
        np.testing.assert_array_equal(out.columns["i"].data, part.columns["i"].data)


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_join_string_keys_fall_back(backend):
    """String join keys take the numpy path (dictionary codes are a
    table's own) and still match."""
    left = from_pydict({"k": np.array(["a", "b", "z", "b"]), "x": np.arange(4.0)})
    right = from_pydict({"k": np.array(["b", "a", "c"]), "v": np.array([10.0, 20.0, 30.0])})
    for how in ("inner", "left"):
        ref = B.join_partition(left.partitions[0], right, "k", how)
        got = BK.join_partition(left.partitions[0], right, "k", how, **_on(backend))
        _partitions_equal(got, ref)
    out = BK.join_partition(left.partitions[0], right, "k", "left", **_on(backend))
    got_v = out.columns["v"].to_numpy()
    np.testing.assert_array_equal(got_v[[0, 1, 3]], [20.0, 10.0, 10.0])
    assert np.isnan(got_v[2])


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_join_null_keys_never_match(backend):
    """Null join keys never match: on the left they miss, on the right they
    are left out of the build and of the uniqueness check."""
    from repro_torch.frame.table import Column, Partition, PTable

    left = Partition({
        "i": Column(data=np.array([0, 1, 2, 1], np.int64),
                    mask=np.array([True, False, True, True])),
        "x": Column(data=np.arange(4.0)),
    })
    right = PTable([Partition({
        "i": Column(data=np.array([0, 1, 1], np.int64), mask=np.array([True, True, False])),
        "w": Column(data=np.array([5.0, 6.0, 7.0])),
    })])
    inner = BK.join_partition(left, right, "i", "inner", **_on(backend))
    np.testing.assert_array_equal(inner.columns["x"].data, [0.0, 3.0])
    np.testing.assert_array_equal(inner.columns["w"].data, [5.0, 6.0])
    lj = BK.join_partition(left, right, "i", "left", **_on(backend))
    np.testing.assert_array_equal(lj.columns["w"].valid_mask(), [True, False, False, True])


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_join_duplicate_right_keys_raise(table, backend):
    dup = from_pydict({"i": np.array([1, 1, 2]), "w": np.arange(3.0)})
    with pytest.raises(ValueError, match="unique"):
        BK.join_partition(table.partitions[0], dup, "i", "inner", **_on(backend))


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_filter_compaction_parity(table, backend):
    """Row selection is exact on every backend, every dtype."""
    for part in table.partitions:
        keep = np.asarray(part.columns["x"].data) > 5.0
        ref = part.select_rows(keep)
        got = BK.select_rows(part, keep, **_on(backend))
        assert got.nrows == ref.nrows == int(keep.sum())
        for col in part.order:
            rc, gc = ref.columns[col], got.columns[col]
            assert gc.data.dtype == rc.data.dtype, col
            np.testing.assert_array_equal(gc.data, rc.data, err_msg=col)
            np.testing.assert_array_equal(gc.valid_mask(), rc.valid_mask(), err_msg=col)


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_topk_sort_nan_keys_fall_back(backend):
    """Unmasked NaN sort keys (a merge_groupby mean, say) do not poison the
    top-k."""
    from repro_torch.frame.table import Column, Partition

    raw = Partition({"x": Column(data=np.array([5.0, np.nan, 1.0, 3.0, 2.0, 4.0, np.nan, 0.5]))})
    ref_part, _ = B.partial_sort(raw, "x", False, 3)
    got_part, _ = BK.partial_sort(raw, "x", False, 3, **_on(backend))
    assert got_part.nrows == ref_part.nrows == 3
    np.testing.assert_array_equal(got_part.columns["x"].data, ref_part.columns["x"].data)


def test_numpy_fallbacks():
    """Shapes the kernels do not take fall back to the scalar path."""
    t = from_pydict({"x": np.arange(10.0), "k": np.array(list("ababababab"))})
    p = t.partitions[0]
    median = (("u", "x", lambda v: float(np.median(v))),)
    got = BK.partial_groupby(p, "k", median, **_on("torch"))
    np.testing.assert_array_equal(got["keys"], B.partial_groupby(p, "k", median)["keys"])
    gv, gc = BK.partial_value_counts(p, "x", **_on("torch"))  # not a dictionary column
    rv, rc = B.partial_value_counts(p, "x")
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gc, rc)
    sp, _ = BK.partial_sort(p, "x", True, BK.TOPK_MAX_K + 1, **_on("torch"))  # k past the kernel
    rp, _ = B.partial_sort(p, "x", True, BK.TOPK_MAX_K + 1)
    np.testing.assert_array_equal(sp.columns["x"].data, rp.columns["x"].data)


def test_backend_resolution_order(monkeypatch):
    pol = BK.BackendPolicy(engine_default="torch")
    monkeypatch.delenv(BK.ENV_VAR, raising=False)
    assert pol.resolve() == "torch"  # engine config
    monkeypatch.setenv(BK.ENV_VAR, "numpy")
    assert pol.resolve() == "numpy"  # env beats engine config
    with BK.use_backend("cuda"):
        assert pol.resolve() == "cuda"  # global beats env
        assert pol.resolve("torch") == "torch"  # per call beats everything
    assert pol.resolve() == "numpy"
    with pytest.raises(ValueError):
        pol.resolve("xla")


def _run_program(catalog, backend):
    s = Session(catalog=catalog, mode="sim", kernel_backend=backend,
                device="cpu" if backend == "torch" else None)
    df = s.read_table("small")
    dim = s.read_table("dim")
    df = df[df["x"] > 2.0]
    return {
        "describe": s.show(df.describe()).to_pydict(),
        "group": s.show(df.groupby("k").mean()).to_pydict(),
        "vc": s.show(df["k"].value_counts()).to_pydict(),
        "sorted": s.show(df.sort_values("y", ascending=False)).to_pydict(),
        "join": s.show(df.join(dim, on="j")).to_pydict(),
    }


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_end_to_end_session_parity(catalog, backend):
    """One notebook program through the engine on each backend: the kernel
    dispatch's answers match the numpy baseline."""
    ref = _run_program(catalog, "numpy")
    got = _run_program(catalog, backend)
    for q in ref:
        assert set(got[q]) == set(ref[q])
        for col in ref[q]:
            r, g = np.asarray(ref[q][col]), np.asarray(got[q][col])
            if r.dtype.kind in "OU":  # decoded strings
                np.testing.assert_array_equal(g, r, err_msg=f"{q}/{col}")
            else:
                np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64),
                                           rtol=2e-3, atol=1e-5, err_msg=f"{q}/{col}")


def test_join_units_feed_calibration(catalog):
    """Join partials record samples per backend like every blocking op, so
    calibrate() fits a unit cost for the probe path (the global override
    pins ``torch``, bypassing the planner by design)."""
    s = Session(catalog=catalog, mode="sim", kernel_backend="torch", device="cpu")
    df = s.read_table("small")
    dim = s.read_table("dim")
    with BK.use_backend("torch"):
        s.show(df.join(dim, on="j"))
    cm = s.engine.cost_model
    assert ("join", "torch") in cm.samples()
    assert cm.calibrate()[("join", "torch")] > 0


def test_unit_times_feed_calibration(catalog):
    """Frame units record (op, backend, rows, seconds) samples, and
    calibrate() turns them into the unit costs the estimator uses."""
    s = Session(catalog=catalog, mode="sim", kernel_backend="numpy")
    df = s.read_table("small")
    s.show(df.describe())
    cm = s.engine.cost_model
    samples = cm.samples()
    assert ("describe", "numpy") in samples
    assert sum(r for r, _ in samples[("describe", "numpy")]) == 5_000  # every partition's rows
    fitted = cm.calibrate()
    assert fitted[("describe", "numpy")] > 0
    cm.active_backend = "numpy"
    assert cm.unit_cost("describe") == fitted[("describe", "numpy")]
    # a backend with no samples falls through to the EWMA / default path
    assert cm.unit_cost("describe", backend="cuda") != fitted[("describe", "numpy")]


# --------------------------------------------------------- scheduler memos --


def _chain(dag, n, cost=1.0):
    nodes, prev = [], None
    for i in range(n):
        prev = dag.add("synthetic", parents=[prev] if prev else [],
                       kwargs={"cost_s": cost, "tag": str(i)})
        nodes.append(prev)
    return nodes


@CORES
def test_scheduler_cache_invalidated_on_dag_growth(core):
    dag = core.DAG()
    nodes = _chain(dag, 4)
    sched = core.Scheduler(dag=dag, cost_model=core.CostModel(), policy="utility")
    u_before = sched.utility(nodes[0], set())
    assert sched._desc_cache  # the memo is filled
    tail = dag.add("synthetic", parents=[nodes[-1]], kwargs={"cost_s": 5.0, "tag": "t"})
    assert sched.utility(nodes[0], set()) > u_before  # the new descendant adds utility
    assert tail.nid in {n.nid for n in sched._descendants(nodes[0])}


@CORES
def test_scheduler_cache_invalidated_on_eviction(core):
    """Evicted nodes cost again: the delivery-cost memo is keyed on the
    executed set."""
    dag = core.DAG()
    nodes = _chain(dag, 3)
    sched = core.Scheduler(dag=dag, cost_model=core.CostModel(), policy="utility")
    done = {n.nid for n in nodes[:2]}
    u_done = sched.utility(nodes[2], done)
    assert sched.utility(nodes[2], set()) > u_done
    assert sched.utility(nodes[2], done) == u_done


@CORES
def test_scheduler_pick_results_unchanged_by_memo(core):
    """The memoised pick() returns the greedy order a fresh scheduler does."""
    rng = np.random.default_rng(3)
    dag = core.DAG()
    nodes = []
    for i in range(15):
        parents = (list(rng.choice(nodes, size=min(len(nodes), int(rng.integers(0, 3))),
                                   replace=False)) if nodes else [])
        nodes.append(dag.add("synthetic", parents=parents,
                             kwargs={"cost_s": float(rng.uniform(0.5, 2.0)), "tag": str(i)}))
    cm = core.CostModel()
    memo = core.Scheduler(dag=dag, cost_model=cm, policy="utility")
    order, done = [], set()
    while True:
        nxt = memo.pick(done)
        if nxt is None:
            break
        fresh = core.Scheduler(dag=dag, cost_model=cm, policy="utility")
        assert fresh.pick(done).nid == nxt.nid
        order.append(nxt.nid)
        done.add(nxt.nid)
    assert len(order) == len(dag)


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_real_mode_background_busy_accrues(catalog, backend):
    """The real-mode worker accounts its busy time."""
    import time as _time

    s = Session(catalog=catalog, mode="real", kernel_backend=backend,
                device="cpu" if backend == "torch" else None)
    df = s.read_table("small")
    df.describe()  # declared, never shown: background work
    s.engine.start_background()
    deadline = _time.monotonic() + 5.0
    while _time.monotonic() < deadline:
        if s.engine.metrics.background_busy_s > 0:
            break
        _time.sleep(0.01)
    s.engine.stop_background()
    assert s.engine.metrics.background_busy_s > 0
