"""The port's frame operators against numpy oracles, test for test beside
the JAX package's ``tests/test_frame_ops.py``: filter and its null
semantics, assign and UDFs, fillna with a scalar subexpression, describe,
groupby aggregations and callable UDFs, sort and the top-k fast path,
value_counts, the broadcast join, dropna and sparse-column dropping,
column lists without materialisation, and partition invariance.

Sessions run on the port's ``numpy`` and ``torch`` (``device="cpu"``)
kernel backends, each a parametrised case; the catalog is the reference's
test catalog (``tests/conftest.py``) built from ``repro_torch.frame``.
"""
import numpy as np
import pytest

from repro_torch.frame import Catalog, ColSpec, Session, TableSpec

BACKENDS = pytest.mark.parametrize("bk", ["numpy", "torch"])


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
    cat.register(TableSpec("large", nrows=200_000, cols=(ColSpec("a"), ColSpec("b", null_frac=0.3)),
                           io_seconds=18.5, seed=11))
    cat.register(TableSpec("dim", nrows=7, cols=(ColSpec("j", kind="key"), ColSpec("w")),
                           io_seconds=0.01, seed=3))
    return cat


def _session(catalog, bk, mode="sim") -> Session:
    return Session(catalog=catalog, mode=mode, kernel_backend=bk,
                   device="cpu" if bk == "torch" else None)


def _np(catalog, name="small") -> dict:
    spec = catalog.spec(name)
    part = catalog.generate(name, 0, spec.nrows)
    return {n: part.columns[n].to_numpy() for n in part.order}


@BACKENDS
def test_filter_matches_numpy(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    out = df[df["x"] > 5.0].collect().to_pydict()
    ref = _np(catalog)
    keep = ref["x"] > 5.0
    np.testing.assert_allclose(out["x"], ref["x"][keep], rtol=1e-6)
    assert len(out["x"]) == keep.sum()


@BACKENDS
def test_filter_null_semantics(catalog, bk):
    """Comparisons with null are False (pandas semantics)."""
    s = _session(catalog, bk)
    df = s.read_table("small")
    out = df[df["y"] > 0.5].collect().to_pydict()
    y = _np(catalog)["y"]
    keep = ~np.isnan(y) & (np.nan_to_num(y) > 0.5)
    assert len(out["y"]) == keep.sum()


@BACKENDS
def test_assign_and_udf(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    df["z"] = df["x"] * 2.0 + 1.0
    df["w"] = df["x"].apply(lambda v: v**2)
    out = df.collect().to_pydict()
    ref = _np(catalog)
    np.testing.assert_allclose(out["z"], ref["x"] * 2 + 1, rtol=1e-6)
    np.testing.assert_allclose(out["w"], ref["x"] ** 2, rtol=1e-5)


@BACKENDS
def test_fillna_with_scalar_subexpression(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    m = df["y"].mean()
    df["y"] = df["y"].fillna(m)
    out = df.collect().to_pydict()
    ref = _np(catalog)["y"]
    expect = np.where(np.isnan(ref), np.nanmean(ref), ref)
    np.testing.assert_allclose(out["y"], expect, rtol=1e-5)


@BACKENDS
def test_describe_matches_numpy(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    out = s.show(df.describe()).to_pydict()
    ref = _np(catalog)
    stats = {name: i for i, name in enumerate(out["stat"])}
    x, y = ref["x"], ref["y"]
    assert out["x"][stats["count"]] == pytest.approx(len(x))
    assert out["x"][stats["mean"]] == pytest.approx(x.mean(), rel=1e-5)
    assert out["x"][stats["std"]] == pytest.approx(x.std(ddof=1), rel=1e-4)
    assert out["y"][stats["count"]] == pytest.approx((~np.isnan(y)).sum())
    assert out["y"][stats["mean"]] == pytest.approx(np.nanmean(y), rel=1e-5)


@BACKENDS
def test_groupby_agg_matches_numpy(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    d = df.groupby("k").agg({"x": "sum", "y": "mean", "i": "count"}).collect().to_pydict()
    ref = _np(catalog)
    for row, key in enumerate(d["k"]):
        sel = ref["k"] == key
        assert d["x"][row] == pytest.approx(ref["x"][sel].sum(), rel=1e-5)
        assert d["y"][row] == pytest.approx(np.nanmean(ref["y"][sel]), rel=1e-5)
        assert d["i"][row] == pytest.approx(sel.sum())


@BACKENDS
def test_groupby_callable_udf(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    d = df[["k", "x"]].groupby("k").agg(lambda v: float(np.median(v))).collect().to_pydict()
    ref = _np(catalog)
    for row, key in enumerate(d["k"]):
        assert d["x"][row] == pytest.approx(np.median(ref["x"][ref["k"] == key]), rel=1e-5)


@BACKENDS
def test_sort_values_and_topk_fastpath(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    full = df.sort_values("x", ascending=False).collect().to_pydict()
    ref = np.sort(_np(catalog)["x"])[::-1]
    np.testing.assert_allclose(full["x"], ref, rtol=1e-6)
    # head over an unexecuted sort: the top-k fast path
    s2 = _session(catalog, bk)
    df2 = s2.read_table("small")
    top = s2.show(df2.sort_values("x", ascending=False).head(10))
    np.testing.assert_allclose(top.column("x"), ref[:10], rtol=1e-6)
    assert s2.engine.metrics.interactions[-1].partial


@BACKENDS
def test_value_counts(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    out = s.show(df["k"].value_counts()).to_pydict()
    values, counts = np.unique(_np(catalog)["k"].astype(str), return_counts=True)
    got = dict(zip(out["k"], out["count"]))
    for v, c in zip(values, counts):
        assert got[v] == c
    assert list(out["count"]) == sorted(out["count"], reverse=True)


@BACKENDS
def test_join_broadcast(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    dim = s.read_table("dim")
    out = df.join(dim, on="j").collect().to_pydict()
    ref = _np(catalog)
    dimref = _np(catalog, "dim")
    w_by_key = dict(zip(dimref["j"], dimref["w"]))
    assert len(out["j"]) == len(ref["j"])  # every key 0..6 is in dim
    np.testing.assert_allclose(out["w"], [w_by_key[j] for j in out["j"]], rtol=1e-6)


@BACKENDS
def test_dropna_and_drop_sparse_cols(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("small")
    kept = df.dropna(subset=["y"]).collect()
    assert kept.nrows == (~np.isnan(_np(catalog)["y"])).sum()
    # y is 20% null: dropped at thresh 0.9; x has no null: kept
    slim = df.drop_sparse_cols(0.9).collect()
    assert "y" not in slim.column_names
    assert "x" in slim.column_names


@BACKENDS
def test_columns_without_materialisation(catalog, bk):
    s = _session(catalog, bk)
    df = s.read_table("large")
    assert list(s.show(df.columns)) == ["a", "b"]
    # the 18.5 s read must not have run for a metadata interaction
    assert s.engine.metrics.interactions[-1].latency_s < 0.1
    assert df.node.nid not in s.engine.cache


@BACKENDS
def test_partition_invariance(catalog, bk):
    """The same results whatever the partitioning (paper §5.1)."""
    from repro_torch.frame.partitioner import uniform_partitions

    results = []
    for nparts in (1, 3, 11):
        s = _session(catalog, bk)
        df = s.read_table("small")
        df.node.kwargs["partition_bounds"] = uniform_partitions(catalog.spec("small").nrows,
                                                                nparts)
        df["z"] = df["x"] * 3.0
        results.append(df[df["z"] > 15.0].groupby("k").agg({"z": "mean"}).collect().to_pydict())
    for other in results[1:]:
        assert list(other["k"]) == list(results[0]["k"])
        np.testing.assert_allclose(other["z"], results[0]["z"], rtol=1e-5)
