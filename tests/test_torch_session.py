"""Whole programs through both packages: the JAX package's
``Session(kernel_backend="xla")`` and the port's
``Session(kernel_backend="torch", device="cpu")`` on the same catalog specs.

Answers are compared as ``to_pydict`` results under the backend-parity
tolerances (``tests/test_backend_parity.py``: rtol 2e-3, atol 1e-5 for float
columns; exact for strings, counts, row selections and orderings).  Also
pinned: the same ``reference_pick`` plan order on the same DAG, progressive
``upgrade()`` == blocking bit for bit, batched == unbatched bit for bit, and
that the port's entry points refuse to run on the CPU unless asked to.
"""
import numpy as np
import pytest
import torch

import repro.frame as R
import repro_torch.frame as T
from repro.frame.partitioner import uniform_partitions as r_uniform
from repro_torch.frame import backend as TBK
from repro_torch.frame.partitioner import uniform_partitions as t_uniform
from repro_torch.frame.table import pydict_equal


def _specs(pkg):
    C, S = pkg.ColSpec, pkg.TableSpec
    return [
        S("small", nrows=5_000, io_seconds=1.0, seed=7, cols=(
            C("x", low=0.0, high=10.0), C("y", null_frac=0.2),
            C("k", kind="cat", n_categories=7), C("i", kind="int", low=0, high=100),
            C("j", kind="int", low=0, high=7))),
        S("large", nrows=200_000, io_seconds=18.5, seed=11, cols=(
            C("a"), C("b", null_frac=0.3))),
        S("dim", nrows=7, io_seconds=0.01, seed=3, cols=(
            C("j", kind="key"), C("w"))),
    ]


def _catalog(pkg):
    cat = pkg.Catalog()
    for spec in _specs(pkg):
        cat.register(spec)
    return cat


def _ref_session(**kw):
    return R.Session(catalog=_catalog(R), mode="sim", kernel_backend="xla", **kw)


def _port_session(**kw):
    return T.Session(catalog=_catalog(T), mode="sim", kernel_backend="torch",
                     device="cpu", **kw)


# -- the programs: each builds on a session and returns what it displays -------


def p_filter(s):
    df = s.read_table("small")
    return df[df["x"] > 5.0]


def p_filter_nulls(s):
    df = s.read_table("small")
    return df[df["y"] > 0.5]


def p_assign_udf(s):
    df = s.read_table("small")
    df["z"] = df["x"] * 2.0 + 1.0
    df["w"] = df["x"].apply(lambda v: v ** 2)
    return df


def p_fillna_scalar(s):
    df = s.read_table("small")
    df["y"] = df["y"].fillna(df["y"].mean())
    return df


def p_describe(s):
    return s.read_table("small").describe()


def p_describe_large(s):
    return s.read_table("large").describe()


def p_groupby(s):
    df = s.read_table("small")
    return df.groupby("k").agg({"x": "mean", "y": "sum", "i": "max", "j": "min"})


def p_filter_groupby(s):
    df = s.read_table("small")
    df["z"] = df["x"] * 3.0
    return df[df["z"] > 15.0].groupby("k").agg({"z": "mean", "y": "count"})


def p_value_counts(s):
    return s.read_table("small")["k"].value_counts()


def p_sort_full(s):
    return s.read_table("small").sort_values("y", ascending=False)


def p_sort_head(s):
    return s.read_table("small").sort_values("x").head(25)


def p_join(s):
    df = s.read_table("small")
    return df.join(s.read_table("dim"), on="j")


def p_dropna_sparse(s):
    return s.read_table("small").dropna(subset=["y"]).drop_sparse_cols(0.9)


def p_notebook_cells(s):
    s.cell('df = pd.read_csv("small")\nf = df[df["x"] > 2.5]')
    s.cell("f.describe()")
    s.think(3.0)
    return s.cell('f.groupby("k").agg({"y": "mean", "x": "max"})')


def p_partitions_11(s):
    df = s.read_table("small")
    uni = r_uniform if isinstance(s, R.Session) else t_uniform
    df.node.kwargs["partition_bounds"] = uni(5_000, 11)
    return df[df["i"] < 40].groupby("k").agg({"x": "sum", "y": "min"})


PROGRAMS = {f.__name__[2:]: f for f in (
    p_filter, p_filter_nulls, p_assign_udf, p_fillna_scalar, p_describe,
    p_describe_large, p_groupby, p_filter_groupby, p_value_counts, p_sort_full,
    p_sort_head, p_join, p_dropna_sparse, p_notebook_cells, p_partitions_11,
)}


def _run(make, program):
    s = make()
    out = program(s)
    value = out if isinstance(out, (R.table.PTable, T.table.PTable)) else s.show(out)
    return value.to_pydict()


@pytest.fixture(scope="module")
def answers():
    TBK.reset_breakers()
    out = {
        name: (_run(_ref_session, prog), _run(_port_session, prog))
        for name, prog in PROGRAMS.items()
    }
    out["breakers"] = TBK.breaker_board().snapshot()
    return out


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_matches_reference(answers, name):
    ref, got = answers[name]
    assert list(got) == list(ref)
    for col in ref:
        r, g = np.asarray(ref[col]), np.asarray(got[col])
        assert r.shape == g.shape, col
        if r.dtype.kind in "OU":
            np.testing.assert_array_equal(g, r, err_msg=col)
        else:
            np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64),
                                       rtol=2e-3, atol=1e-5, err_msg=col)


def test_row_selection_and_order_exact(answers):
    """Filters, sorts and joins move rows, not arithmetic: bit-equal."""
    for name in ("filter", "filter_nulls", "sort_full", "sort_head", "join", "dropna_sparse"):
        ref, got = answers[name]
        assert pydict_equal(ref, got), name


def test_reference_pick_order_identical():
    def plan(make):
        s = make()
        df = s.read_table("small")
        big = s.read_table("large")
        # specification only: these build the DAG, nothing is displayed
        df.describe()
        df[df["x"] > 3].groupby("k").agg({"y": "mean"})
        df["k"].value_counts()
        big.describe()
        df.sort_values("x").head(5)
        sched = s.engine.scheduler
        done, order = set(), []
        while True:
            nxt = sched.reference_pick(done)
            if nxt is None:
                return order
            order.append((nxt.op, nxt.label))
            done.add(nxt.nid)

    ref, got = plan(_ref_session), plan(_port_session)
    assert got == ref and len(ref) > 5


def test_progressive_upgrade_equals_blocking_bitforbit():
    def build(s):
        df = s.read_table("large")
        df.node.kwargs["partition_bounds"] = t_uniform(200_000, 16)
        return df.describe()

    s = _port_session()
    pr = s.interact(build(s), progressive=True)
    assert pr.estimate().coverage < 1.0
    got = pr.upgrade()
    s2 = _port_session()
    exact = s2.show(build(s2))
    assert pydict_equal(got.to_pydict(), exact.to_pydict())


def test_batched_equals_unbatched_bitforbit():
    def run(batching):
        s = _port_session(batching=batching)
        df = s.read_table("small")
        df.node.kwargs["partition_bounds"] = t_uniform(5_000, 8)
        nodes = [df.describe().node, df.groupby("k").agg({"x": "mean", "y": "sum"}).node,
                 df["k"].value_counts().node, df[df["x"] > 5.0].node,
                 df.sort_values("x").node]
        s.think(1000.0)
        s.drain()
        return s, [s.engine.value_of(n).to_pydict() for n in nodes]

    sb, vb = run(True)
    su, vu = run(False)
    assert sb.engine.executor.stats.units_batched > 0
    assert su.engine.executor.stats.units_batched == 0
    for a, b in zip(vb, vu):
        assert pydict_equal(a, b)


def test_breakers_clean_on_torch_backend(answers):
    """No port dispatch of the programs failed or fell back to numpy."""
    snap = answers["breakers"]
    assert {"stats|torch", "groupby|torch", "value_counts|torch", "topk|torch",
            "filter|torch"} <= set(snap)
    assert all(st["failures"] == 0 and st["fallbacks"] == 0 for st in snap.values())


@pytest.mark.parametrize("kwargs", [{}, {"kernel_backend": "cuda"},
                                    {"kernel_backend": "torch"}])
def test_entry_points_refuse_cpu_without_a_card(kwargs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: these sessions would run on it")
    with pytest.raises(RuntimeError, match="CUDA device"):
        T.Session(catalog=_catalog(T), **kwargs)


def test_cpu_only_when_asked(monkeypatch):
    T.Session(catalog=_catalog(T), kernel_backend="numpy")
    T.Session(catalog=_catalog(T), kernel_backend="torch", device="cpu")
    with pytest.raises(ValueError):
        T.Session(catalog=_catalog(T), kernel_backend="cuda", device="cpu")
    monkeypatch.setenv("REPRO_TORCH_FRAME_BACKEND", "numpy")
    s = T.Session(catalog=_catalog(T))  # the port's own variable is honoured
    assert s.runtime.backend() == "numpy"


@pytest.mark.parametrize("keep_kind", ["half", "sparse", "all"])
def test_fused_partitions_equal_unfused_bitforbit(keep_kind):
    """The fused filter→{describe, groupby, topk} partials on the unfiltered
    partition equal select_rows followed by the unfused partial, bit for bit."""
    TBK.reset_breakers()
    rng = np.random.default_rng(11)
    n = 6_000
    y = rng.uniform(0, 10, n)
    y[rng.random(n) < 0.3] = np.nan
    table = T.from_pydict({"x": rng.normal(5, 2, n), "y": y,
                           "k": rng.choice(np.array(list("abcdef")), n),
                           "i": rng.integers(0, 50, n)}, npartitions=3)
    aggs = (("s", "x", "sum"), ("m", "y", "mean"), ("c", "y", "count"), ("mx", "x", "max"))
    for part in table.partitions:
        x = part.columns["x"].data
        keep = {"half": x > 5.0, "sparse": x > 8.0, "all": np.ones(part.nrows, bool)}[keep_kind]
        filt = TBK.select_rows(part, keep, backend="torch", device="cpu")
        fs = TBK.fused_stats_partition(part, keep, backend="torch", device="cpu")
        us = TBK.partial_stats(filt, backend="torch", device="cpu")
        assert {k: tuple(vars(v).values()) for k, v in fs.items()} == \
            {k: tuple(vars(v).values()) for k, v in us.items()}
        fg = TBK.fused_groupby_partition(part, keep, "k", aggs, backend="torch", device="cpu")
        ug = TBK.partial_groupby(filt, "k", aggs, None, backend="torch", device="cpu")
        assert np.array_equal(fg["keys"], ug["keys"])
        for name in ug["aggs"]:
            assert repr(fg["aggs"][name]) == repr(ug["aggs"][name]), name
        for asc in (True, False):
            ft = TBK.fused_topk_partition(part, keep, "y", asc, 16, backend="torch", device="cpu")
            ut = TBK.partial_sort(filt, "y", asc, 16, backend="torch", device="cpu")
            assert pydict_equal(T.PTable([ft[0]]).to_pydict(), T.PTable([ut[0]]).to_pydict())
            assert np.array_equal(ft[1], ut[1])
    snap = TBK.breaker_board().snapshot()  # nothing fell back to numpy
    assert snap and all(st["failures"] == 0 and st["fallbacks"] == 0 for st in snap.values())


@pytest.mark.parametrize("dev,contained", [("cuda", False), ("cpu", True)])
def test_dispatch_error_falls_back_only_where_contained(dev, contained):
    """On a CUDA device a dispatch error that is not an injected fault raises
    and scores no breaker; on the CPU it falls back to numpy."""
    TBK.reset_breakers()

    def broken():
        raise RuntimeError("launch failed")

    if contained:
        assert TBK._guarded("stats", "torch", torch.device(dev), broken, lambda: "numpy") == "numpy"
    else:
        with pytest.raises(RuntimeError, match="launch failed"):
            TBK._guarded("stats", "cuda", torch.device(dev), broken, lambda: "numpy")
        with pytest.raises(RuntimeError, match="launch failed"):
            with TBK._breaker_watch("groupby", "cuda", torch.device(dev)):
                broken()
    snap = TBK.breaker_board().snapshot()
    assert sum(st["failures"] for st in snap.values()) == (1 if contained else 0)


def test_injected_fault_on_the_card_falls_back_and_trips_the_breaker():
    """The chaos feature is kept on the card: injected faults fall back to
    numpy, score the breaker, and an open breaker serves from numpy."""
    TBK.reset_breakers()
    board = TBK.breaker_board()
    cuda = torch.device("cuda")

    def injected():
        raise TBK._faults.InjectedFault("chaos")

    for _ in range(board.failure_threshold):
        assert TBK._guarded("topk", "cuda", cuda, injected, lambda: "numpy") == "numpy"
    assert not board.is_closed("topk", "cuda")
    assert TBK._guarded("topk", "cuda", cuda, lambda: "kernel", lambda: "numpy") == "numpy"
    assert board.snapshot()["topk|cuda"]["fallbacks"] == 1
    TBK.reset_breakers()


def test_device_is_per_session():
    """A later session on another device leaves an earlier session's
    dispatches where they were."""
    s = _port_session()
    assert s.runtime.device == torch.device("cpu")
    other = T.Session(catalog=_catalog(T), mode="sim", kernel_backend="torch", device="meta")
    assert other.runtime.device == torch.device("meta")
    TBK.reset_breakers()
    df = s.read_table("small")
    got = s.show(df.groupby("k").agg({"x": "mean"})).to_pydict()
    ref = _ref_session()
    rdf = ref.read_table("small")
    want = ref.show(rdf.groupby("k").agg({"x": "mean"})).to_pydict()
    assert list(got["k"]) == list(want["k"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=2e-3, atol=1e-5)
    snap = TBK.breaker_board().snapshot()  # served on the CPU, not by numpy
    assert snap and all(st["failures"] == 0 and st["successes"] > 0 for st in snap.values())


def test_device_of_defaults_to_the_card():
    assert TBK.device_of("cuda", "cpu") == torch.device("cuda")
    assert TBK.device_of("torch") == torch.device("cuda")
    assert TBK.device_of("torch", "cpu") == torch.device("cpu")
