"""Operator fusion in the port, test for test beside the JAX package's
``tests/test_fused.py``: filter→{describe, groupby, topk} lowered as one
composite must be *bit-for-bit* identical to the unfused two-dispatch
sequence on the same kernel backend (``torch`` on the CPU here).

Partition-level tests pin that contract per composite (masked columns,
dictionary keys, all-masked filters, empty partitions, both sort
directions); engine-level tests pin the ``try_fused`` driver: fusion fires
only on single-consumer uncached filter chains at planner-governed tiers,
skips the filter materialisation, calibrates the fused key, and never
changes a result (planner-on ≡ planner-off, bit for bit).

The port ships no cold-start priors, so a fresh session never fuses (a
chain is never fused blind).  The engine-level tests therefore first
calibrate the session's cost model with injected samples under which the
fused lowering wins (``_favour_fusion``), as measured samples would on a
card where it does.
"""
import numpy as np
import pytest

from repro_torch.frame import Catalog, ColSpec, Session, TableSpec, from_pydict
from repro_torch.frame import backend as BK
from repro_torch.frame.partitioner import uniform_partitions
from repro_torch.frame.table import Column, Partition

AGGS = (
    ("s", "x", "sum"),
    ("m", "y", "mean"),
    ("c", "y", "count"),
    ("mn", "x", "min"),
    ("mx", "x", "max"),
)
CPU = dict(backend="torch", device="cpu")
FUSED_KEYS = ("fused:filter|describe", "fused:filter|groupby_agg",
              "fused:filter|sort_values:topk")


@pytest.fixture(autouse=True)
def _clean_breakers():
    BK.reset_breakers()
    yield
    BK.reset_breakers()


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(11)
    n = 6_000
    y = rng.uniform(0, 10, n)
    y[rng.random(n) < 0.3] = np.nan  # masked column
    return from_pydict(
        {
            "x": rng.normal(5, 2, n),
            "y": y,
            "k": rng.choice(np.array(["a", "b", "c", "d", "e", "f"]), n),
            "i": rng.integers(0, 50, n),
        },
        npartitions=4,
    )


def _keeps(part):
    x = np.asarray(part.columns["x"].data)
    return {
        "half": x > 5.0,
        "sparse": x > 8.0,
        "all": np.ones(part.nrows, bool),
    }


def _stats_equal(got, ref):
    assert set(got) == set(ref)
    for name in ref:
        g, r = got[name], ref[name]
        for f in ("n", "mean", "m2", "mn", "mx"):
            assert getattr(g, f) == getattr(r, f), (name, f)


def _partitions_equal(got, ref):
    assert got.order == ref.order
    for col in ref.order:
        gc, rc = got.columns[col], ref.columns[col]
        assert gc.data.dtype == rc.data.dtype, col
        np.testing.assert_array_equal(gc.data, rc.data, err_msg=col)
        np.testing.assert_array_equal(gc.valid_mask(), rc.valid_mask(), err_msg=col)


# ------------------------------------------------------- partition-level parity --
@pytest.mark.parametrize("tag", ["half", "sparse", "all"])
def test_fused_stats_bitforbit(table, tag):
    for part in table.partitions:
        keep = _keeps(part)[tag]
        fused = BK.fused_stats_partition(part, keep, **CPU)
        assert fused is not None, tag
        filtered = part.select_rows(keep)
        ref = BK.partial_stats(filtered, **CPU)
        _stats_equal(fused, ref)


def _deep_equal(g, r, msg=""):
    if isinstance(r, dict):
        assert set(g) == set(r), msg
        for k in r:
            _deep_equal(g[k], r[k], f"{msg}/{k}")
    elif isinstance(r, tuple):
        assert isinstance(g, tuple) and len(g) == len(r), msg
        for i, (gi, ri) in enumerate(zip(g, r)):
            _deep_equal(gi, ri, f"{msg}[{i}]")
    elif isinstance(r, str):
        assert g == r, msg
    else:
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r), err_msg=msg)


@pytest.mark.parametrize("tag", ["half", "sparse", "all"])
def test_fused_groupby_bitforbit(table, tag):
    for part in table.partitions:
        keep = _keeps(part)[tag]
        fused = BK.fused_groupby_partition(part, keep, "k", AGGS, **CPU)
        assert fused is not None, tag
        ref = BK.partial_groupby(part.select_rows(keep), "k", AGGS, **CPU)
        _deep_equal(fused, ref, tag)


@pytest.mark.parametrize("by,ascending", [("x", True), ("x", False), ("y", True),
                                          ("y", False), ("i", True)])
def test_fused_topk_bitforbit(table, by, ascending):
    limit = 12
    for part in table.partitions:
        keep = _keeps(part)["half"]
        fused = BK.fused_topk_partition(part, keep, by, ascending, limit, **CPU)
        assert fused is not None
        got_part, got_samples = fused
        ref_part, ref_samples = BK.partial_sort(
            part.select_rows(keep), by, ascending, limit, **CPU
        )
        _partitions_equal(got_part, ref_part)
        np.testing.assert_array_equal(got_samples, ref_samples)


def test_fused_declines_outside_envelope(table):
    """Every decline condition returns None — the runtime then runs the
    plain two-step sequence for that partition, never a wrong answer."""
    part = table.partitions[0]
    none_keep = np.zeros(part.nrows, bool)
    assert BK.fused_stats_partition(part, none_keep, **CPU) is None
    assert BK.fused_groupby_partition(part, none_keep, "k", AGGS, **CPU) is None
    assert BK.fused_topk_partition(part, none_keep, "x", True, 5, **CPU) is None
    # empty partition
    empty = part.select_rows(none_keep)
    assert BK.fused_stats_partition(empty, np.zeros(0, bool), **CPU) is None
    # numpy backend: fusion is a kernel-path concept
    half = _keeps(part)["half"]
    assert BK.fused_stats_partition(part, half, backend="numpy") is None
    # topk: fewer kept rows than limit (host sort is cheaper), string keys
    assert BK.fused_topk_partition(part, half, "x", True, part.nrows, **CPU) is None
    assert BK.fused_topk_partition(part, half, "k", True, 5, **CPU) is None
    # topk: a limit past the kernel's 128 winners
    assert BK.fused_topk_partition(part, half, "x", True, BK.TOPK_MAX_K + 1, **CPU) is None
    # topk: unmasked NaN keys must not poison the threshold
    raw = Partition({"x": Column(data=np.array([5.0, np.nan, 1.0, 3.0, 2.0, 4.0]))})
    assert BK.fused_topk_partition(raw, np.ones(6, bool), "x", True, 2, **CPU) is None


# ----------------------------------------------------------- engine-level driver --
def _catalog():
    cat = Catalog()
    cat.register(
        TableSpec(
            "t",
            nrows=32_000,
            cols=(
                ColSpec("x", low=0.0, high=10.0),
                ColSpec("y", null_frac=0.2),
                ColSpec("k", kind="cat", n_categories=7),
            ),
            io_seconds=2.0,
            seed=7,
        )
    )
    return cat


def _favour_fusion(s: Session) -> Session:
    """Calibrate the session's cost model with samples under which each
    fused lowering wins and no stage is demoted to numpy: torch 1e-7 s a
    row, numpy 2e-7, the fused composites 1e-9."""
    cm = s.engine.cost_model
    for rows in (1e3, 1e4, 1e5):
        for key in ("filter", "describe", "groupby_agg", "sort_values:topk"):
            cm.add_sample(key, "torch", rows, 1e-7 * rows)
            cm.add_sample(key, "numpy", rows, 2e-7 * rows)
        for key in FUSED_KEYS:
            cm.add_sample(key, "torch", rows, 1e-9 * rows)
    cm.calibrate()
    return s


def _session(calibrated=True, **kw):
    s = Session(catalog=_catalog(), mode="sim", kernel_backend="torch", device="cpu", **kw)
    return _favour_fusion(s) if calibrated else s


def _queries(s: Session, thresholds=(2.0, 3.0, 4.0)):
    """Three filter→op chains, each on its *own* filter node (one consumer
    per filter — the fusable shape).  Returns result dicts/objects."""
    df = s.read_table("t")
    df.node.kwargs = dict(df.node.kwargs)
    df.node.kwargs["partition_bounds"] = uniform_partitions(32_000, 8)
    t_desc, t_gb, t_topk = thresholds
    out = {}
    out["describe"] = s.show(df[df["x"] > t_desc].describe()).to_pydict()
    out["group"] = s.show(
        df[df["x"] > t_gb].groupby("k").agg({"x": "mean", "y": "sum"})
    ).to_pydict()
    fdf = df[df["x"] > t_topk]
    topk = s.engine.add(
        "sort_values",
        parents=[fdf.node],
        kwargs={"by": "y", "ascending": False, "limit": 16},
    )
    out["topk"] = s.engine.display(topk).to_pydict()
    return out


def _assert_same_results(got, ref):
    for q in ref:
        g, r = got[q], ref[q]
        assert set(g) == set(r)
        for col in r:
            np.testing.assert_array_equal(
                np.asarray(g[col]), np.asarray(r[col]), err_msg=f"{q}/{col}"
            )


def test_engine_fusion_fires_and_matches_planner_off():
    s_on = _session()
    got = _queries(s_on)
    s_off = _session(calibrated=False, planner=False)
    ref = _queries(s_off)
    _assert_same_results(got, ref)

    # all three chains actually lowered fused (decision + calibration sample)
    cm = s_on.engine.cost_model
    rep = cm.planner_report()
    samples = cm.samples()
    for key in FUSED_KEYS:
        assert rep.get(f"{key}|torch|fused", 0) >= 1, rep
        assert len(samples[(key, "torch")]) > 3  # the injected three + the run's
    # nothing fell back to numpy on the way
    snap = BK.breaker_board().snapshot()
    for op in ("fused_stats", "fused_groupby", "fused_topk"):
        assert snap[f"{op}|torch"]["successes"] >= 1
    assert all(st["failures"] == 0 and st["fallbacks"] == 0 for st in snap.values())
    # planner-off recorded no decision and no fused sample
    assert s_off.engine.cost_model.planner_report() == {}
    assert not any(k[0].startswith("fused:") for k in s_off.engine.cost_model.samples())


def test_uncalibrated_session_never_fuses():
    """The port's default (no priors, no samples): every chain runs unfused,
    with the same answers as a calibrated session that fused them."""
    s = _session(calibrated=False)
    got = _queries(s)
    cm = s.engine.cost_model
    assert not any(k[0].startswith("fused:") for k in cm.samples())
    assert not any(k.startswith("fused:") for k in cm.planner_report())
    _assert_same_results(got, _queries(_session()))


def test_fused_chain_skips_filter_materialisation():
    s = _session()
    df = s.read_table("t")
    df.node.kwargs = dict(df.node.kwargs)
    df.node.kwargs["partition_bounds"] = uniform_partitions(32_000, 8)
    fdf = df[df["x"] > 2.0]
    desc = fdf.describe()
    s.show(desc)
    eng = s.engine
    assert desc.node.nid in eng.cache  # the interaction result is cached
    assert fdf.node.nid not in eng.cache  # the filter was never materialised
    assert len(eng.cost_model.samples()[("fused:filter|describe", "torch")]) == 4


def test_shared_filter_output_is_not_fused():
    """Two consumers of one filter: materialising the filter pays off, so
    the driver declines and the unfused path caches it."""
    s = _session()
    df = s.read_table("t")
    df.node.kwargs = dict(df.node.kwargs)
    df.node.kwargs["partition_bounds"] = uniform_partitions(32_000, 8)
    fdf = df[df["x"] > 2.0]
    desc = fdf.describe()
    grp = fdf.groupby("k").agg({"x": "mean"})  # second consumer exists up front
    s.show(desc)
    s.show(grp)
    cm = s.engine.cost_model
    assert all(len(cm.samples()[(k, "torch")]) == 3 for k in FUSED_KEYS)  # injected only
    assert not any(k.startswith("fused:") for k in cm.planner_report())
    assert fdf.node.nid in s.engine.cache  # unfused path materialised it


def test_all_masked_filter_falls_back_per_partition():
    """A filter keeping zero rows everywhere: every partition declines the
    fused kernel, the in-chain fallback runs the two-step sequence, and the
    end-to-end result still matches planner-off exactly."""
    thresholds = (11.0, 11.0, 11.0)  # x is uniform [0, 10): keeps nothing
    got = _queries(_session(), thresholds)
    ref = _queries(_session(calibrated=False, planner=False), thresholds)
    _assert_same_results(got, ref)
    count_row = list(got["describe"]["stat"]).index("count")
    assert float(got["describe"]["x"][count_row]) == 0.0
    assert len(got["topk"]["y"]) == 0


def test_fusion_respects_precedence_override():
    """A global use_backend override bypasses the planner, so no fused
    lowering happens inside the override scope."""
    s = _session()
    with BK.use_backend("torch"):
        _queries(s)
    cm = s.engine.cost_model
    assert all(len(cm.samples()[(k, "torch")]) == 3 for k in FUSED_KEYS)  # injected only


def test_fused_answers_match_the_reference_package():
    """The port's fused chains (``torch``, calibrated) against the JAX
    package's (``xla``, its cold-start priors fuse them) on the same
    catalog spec: floats within rtol 2e-3 / atol 1e-5, strings exact, and
    the top-k rows exact."""
    import repro.frame as R
    from repro.frame.partitioner import uniform_partitions as r_uniform

    got = _queries(_session())
    rcat = R.Catalog()
    rcat.register(R.TableSpec("t", nrows=32_000, io_seconds=2.0, seed=7, cols=(
        R.ColSpec("x", low=0.0, high=10.0), R.ColSpec("y", null_frac=0.2),
        R.ColSpec("k", kind="cat", n_categories=7))))
    rs = R.Session(catalog=rcat, mode="sim", kernel_backend="xla")
    rdf = rs.read_table("t")
    rdf.node.kwargs = dict(rdf.node.kwargs)
    rdf.node.kwargs["partition_bounds"] = r_uniform(32_000, 8)
    want = {
        "describe": rs.show(rdf[rdf["x"] > 2.0].describe()).to_pydict(),
        "group": rs.show(rdf[rdf["x"] > 3.0].groupby("k").agg(
            {"x": "mean", "y": "sum"})).to_pydict(),
        "topk": rs.engine.display(rs.engine.add(
            "sort_values", parents=[rdf[rdf["x"] > 4.0].node],
            kwargs={"by": "y", "ascending": False, "limit": 16})).to_pydict(),
    }
    assert any(k.startswith("fused:") for k in rs.engine.cost_model.planner_report())
    for q, w in want.items():
        g = got[q]
        assert list(g) == list(w), q
        for col in w:
            gv, wv = np.asarray(g[col]), np.asarray(w[col])
            if wv.dtype.kind in "OU" or q == "topk":
                np.testing.assert_array_equal(gv, wv, err_msg=f"{q}/{col}")
            else:
                np.testing.assert_allclose(gv.astype(np.float64), wv.astype(np.float64),
                                           rtol=2e-3, atol=1e-5, err_msg=f"{q}/{col}")
