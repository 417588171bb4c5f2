"""The port's data mesh (``repro_torch.frame.dist`` and the sharded paths in
``frame/backend.py`` / ``frame/runtime.py``), on the CPU.

Meshes are installed explicitly (``dist.use_mesh([cpu] * 8)`` and
``[cpu] * 2``), in-process: the counterpart of the JAX package's forced
8-device host platform.  Each sharded op family is held bit for bit against
the port's own host path (the plain kernel versions, ``kernel_backend=
"torch"`` on the CPU), and against the JAX package's host ``xla`` partial +
merge path under the parity tolerances of ``tests/test_backend_parity.py``
(describe: count exact, mean rtol 1e-4 / atol 1e-5, std rtol 1e-3 / atol
1e-4, min and max rtol 1e-5; groupby aggregates rtol 1e-4; counts, keys, row
selections, top-k and joins exact).  Also pinned: the combine's float64
replay of ``ColStats.merge`` on edge operands, the kernels' padding as an
exact no-op, single-device and non-power-of-two inertness, the seed API
against the JAX package's on a 1-device mesh, and the planner's
``no_estimate`` under ``"auto"`` with the size gate alone engaging the
partition-parallel join build.
"""
import numpy as np
import pytest
import torch

import repro.frame as R
import repro_torch.frame as T
from repro.frame import backend as RBK
from repro.frame import blocking as RB
from repro.frame import dist as RD
from repro.jaxcompat import make_mesh
from repro_torch.frame import backend as BK
from repro_torch.frame import blocking as B
from repro_torch.frame import dist
from repro_torch.frame.table import Column, Partition, PTable, from_pydict, pydict_equal
from repro_torch.kernels import ops
from repro_torch.kernels.masked_stats import TILE, masked_stats_plain
from repro_torch.kernels.segment_reduce import segment_reduce_plain

CPU = torch.device("cpu")
N_CAT = 13
AGGS = (("x", "x", "mean"), ("y", "y", "sum"), ("c", "x", "count"),
        ("mn", "y", "min"), ("mx", "x", "max"))
HOST = dict(backend="torch", device="cpu")


@pytest.fixture(params=[8, 2], ids=["mesh8", "mesh2"])
def mesh(request):
    with dist.use_mesh([CPU] * request.param) as m:
        yield m


@pytest.fixture(autouse=True)
def _clean():
    BK.reset_breakers()
    dist.reset_dispatch_counts()
    yield
    snap = BK.breaker_board().snapshot()  # no sharded call fell back quietly
    bad = {k: v for k, v in snap.items() if k.endswith("|sharded") and v["failures"]}
    BK.reset_breakers()
    assert not bad, bad


def _data(n=30_000, seed=5):
    rng = np.random.default_rng(seed)
    y = rng.normal(3.0, 2.0, n)
    y[rng.random(n) < 0.25] = np.nan
    cats = np.array([f"g{i}" for i in range(N_CAT)])
    return {"x": rng.uniform(-5.0, 5.0, n), "y": y, "k": cats[rng.integers(0, N_CAT, n)]}


@pytest.fixture()
def table() -> PTable:
    return from_pydict(_data(), npartitions=8)


def _stats_tuple(s):
    return tuple(np.float64(v) for v in (s.n, s.mean, s.m2, s.mn, s.mx))


def _host_topk(t, by, asc, limit):
    return B.merge_sort([BK.partial_sort(p, by, asc, limit, **HOST) for p in t.partitions],
                        by, asc, limit)


# --------------------------------------------------------------------------- #
# per-op parity vs the port's host path                                       #
# --------------------------------------------------------------------------- #


def test_sharded_stats_raws_per_partition_bit_equal(mesh, table):
    names = tuple(B.numeric_columns(table.partitions[0]))
    raws = BK.sharded_stats_raws(table, names)
    assert raws is not None and raws.shape[1:] == (len(names), 5)
    for i, part in enumerate(table.partitions):
        got = BK._stats_from_raw(names, np.asarray(raws[i], np.float64))
        ref = BK.partial_stats(part, **HOST)
        for c in names:
            assert _stats_tuple(got[c]) == _stats_tuple(ref[c]), (i, c)
    assert dist.dispatch_counts() == {"stats_raws": 1}


def test_sharded_stats_merged_bit_equal(mesh, table):
    merged = BK.sharded_stats(table)
    assert merged is not None
    ref = B.merge_stats([BK.partial_stats(p, **HOST) for p in table.partitions])
    assert set(merged) == set(ref)
    for c in ref:
        assert _stats_tuple(merged[c]) == _stats_tuple(ref[c]), c


@pytest.mark.parametrize("nparts", [3, 5, 11])
def test_sharded_stats_uneven_partition_counts(mesh, nparts):
    """Partition counts that are no power of two (pad partitions all
    masked) and of unequal length, one of them empty."""
    t = from_pydict(_data(20_001, seed=nparts), npartitions=nparts)
    t.partitions[1] = t.partitions[1].slice(0, 0)
    merged = BK.sharded_stats(t)
    ref = B.merge_stats([BK.partial_stats(p, **HOST) for p in t.partitions])
    for c in ref:
        assert _stats_tuple(merged[c]) == _stats_tuple(ref[c]), c


def test_sharded_value_counts_bit_equal(mesh, table):
    dictionary = table.partitions[0].columns["k"].dictionary
    partial = BK.sharded_value_counts(table, "k")
    assert partial is not None
    got = B.merge_value_counts([partial], dictionary, "k")
    ref = B.merge_value_counts(
        [BK.partial_value_counts(p, "k", **HOST) for p in table.partitions], dictionary, "k"
    )
    assert pydict_equal(got.to_pydict(), ref.to_pydict())


def test_sharded_groupby_bit_equal(mesh, table):
    dictionary = table.partitions[0].columns["k"].dictionary
    partial = BK.sharded_groupby(table, "k", AGGS)
    assert partial is not None
    got = B.merge_groupby([partial], "k", AGGS, dictionary, None)
    ref = B.merge_groupby(
        [BK.partial_groupby(p, "k", AGGS, None, **HOST) for p in table.partitions],
        "k", AGGS, dictionary, None,
    )
    assert pydict_equal(got.to_pydict(), ref.to_pydict())


@pytest.mark.parametrize("ascending", [True, False])
def test_sharded_topk_bit_equal(mesh, table, ascending):
    limit = 17
    partials = BK.sharded_topk(table, "x", ascending, limit)
    assert partials is not None
    got = B.merge_sort(partials, "x", ascending, limit)
    assert pydict_equal(got.to_pydict(), _host_topk(table, "x", ascending, limit).to_pydict())


def test_sharded_topk_null_keys_partition_falls_back(mesh, table):
    # poison one partition's sort keys with NaN: that partition must take the
    # numpy partial individually while the rest stay on the winners path
    rng = np.random.default_rng(0)
    parts = list(table.partitions)
    x = np.asarray(parts[3].columns["x"].data, np.float64).copy()
    x[rng.integers(0, len(x), 10)] = np.nan
    cols = dict(parts[3].columns)
    cols["x"] = Column(data=x)
    parts[3] = Partition(cols, list(parts[3].order))
    poisoned = PTable(parts)
    partials = BK.sharded_topk(poisoned, "x", True, 9)
    assert partials is not None
    got = B.merge_sort(partials, "x", True, 9)
    ref = B.merge_sort([B.partial_sort(p, "x", True, 9) for p in poisoned.partitions],
                       "x", True, 9)
    assert pydict_equal(got.to_pydict(), ref.to_pydict())


def test_shard_view_cached_and_per_mesh(table):
    with dist.use_mesh([CPU] * 4):
        st = table.shard()
        assert st is not None and table.shard() is st
        assert (st.ppad, st.pl, st.nb, len(st.xs)) == (8, 2, TILE, 4)
        assert all(x.shape == (2, 2, TILE) for x in st.xs)
    with dist.use_mesh([CPU] * 2):
        st2 = table.shard()
        assert st2 is not st and len(st2.xs) == 2 and st2.pl == 4


# --------------------------------------------------------------------------- #
# the combine's float64 replay and the kernels' padding                        #
# --------------------------------------------------------------------------- #


def test_merge_replay_matches_colstats_merge_on_edges():
    """Every operand pair of a small edge set, through the torch replica and
    through ``ColStats.merge``: bit for bit, empties and NaN extremes too."""
    rng = np.random.default_rng(1)
    items = [B.ColStats(0.0, 0.0, 0.0, np.inf, -np.inf),
             B.ColStats(1.0, -0.0, 0.0, -0.0, -0.0),
             B.ColStats(3.0, 1e8 + 0.5, 2.5, 1e8, 1e8 + 1),
             B.ColStats(2.0, np.nan, np.nan, np.nan, np.nan)]
    for _ in range(12):
        n = float(rng.integers(1, 10_000))
        mn, mx = sorted(rng.normal(0, 1e3, 2))
        items.append(B.ColStats(n, float(rng.normal(0, 1e3)), float(rng.random() * 1e6), mn, mx))
    pairs = [(a, b) for a in items for b in items]
    comp = lambda xs, f: torch.tensor([getattr(s, f) for s in xs], dtype=torch.float64)  # noqa: E731
    fields = ("n", "mean", "m2", "mn", "mx")
    got = dist._merge_colstats(tuple(comp([a for a, _ in pairs], f) for f in fields),
                               tuple(comp([b for _, b in pairs], f) for f in fields))
    for j, (a, b) in enumerate(pairs):
        want = np.array(_stats_tuple(a.merge(b)))
        have = np.array([float(t[j]) for t in got])
        assert np.array_equal(have.view(np.int64), want.view(np.int64)) or (
            np.array_equal(have, want, equal_nan=True)), (a, b, have, want)


def test_stats_from_raw_replay_matches_host():
    raw = np.array([[0, 0, 0, np.inf, -np.inf], [0, 5, 3, 1, 2], [3, 7.5, -0.0, 1, 4],
                    [2, 1, -1e-9, 0, 1], [4, -8, np.nan, -3, -1]], np.float64)
    names = [f"c{i}" for i in range(len(raw))]
    want = BK._stats_from_raw(names, raw)
    got = dist._stats_from_raw(torch.from_numpy(raw))
    for i, c in enumerate(names):
        have = np.array([float(t[i]) for t in got])
        w = np.array(_stats_tuple(want[c]))
        assert np.array_equal(have.view(np.int64), w.view(np.int64)) or np.array_equal(
            have, w, equal_nan=True), c


def test_padding_is_an_exact_noop_in_the_plain_kernels():
    """The common bucket (several masked_stats tiles) against each host
    bucket: masked_stats rows, segment_reduce's sums and counts, and topk
    winners are bit-equal whatever the padding."""
    g = torch.Generator().manual_seed(3)
    for n in (3, 700, TILE + 5):
        x = torch.randn(2, n, generator=g) * 50 + 1e3
        m = torch.rand(2, n, generator=g) > 0.3
        host_nb, common = ops.pad_len(n), 4 * TILE
        pad = lambda t, nb, v: torch.nn.functional.pad(t, (0, nb - n), value=v)  # noqa: E731
        a = masked_stats_plain(pad(x, host_nb, 0.0), pad(m, host_nb, False))
        b = masked_stats_plain(pad(x, common, 0.0), pad(m, common, False))
        assert torch.equal(a, b), n
        k = torch.randint(0, 9, (n,), generator=g, dtype=torch.int32)
        ra = segment_reduce_plain(pad(k, host_nb, 0), pad(x, host_nb, 0.0), pad(m, host_nb, False),
                                  9, ["sum", "min"], [0, 1])
        rb = segment_reduce_plain(pad(k, common, 0), pad(x, common, 0.0), pad(m, common, False),
                                  9, ["sum", "min"], [0, 1])
        assert all(torch.equal(u, v) for u, v in zip(ra, rb)), n
        for largest in (True, False):
            s = float("-inf") if largest else float("inf")
            wa = ops.topk_padded(x[0], min(n, 5), largest)
            wb = ops.topk_rows(pad(x[:1], common, s), min(n, 5), largest)[0]
            assert torch.equal(wa, wb), (n, largest)


def test_plain_segment_sums_repeat_in_row_order():
    """ROADMAP C9: above 32,768 rows the plain version's sums must not move
    between calls on the CPU; they add in row order, as ``np.add.at``."""
    g = torch.Generator().manual_seed(9)
    n = 40_000
    k = torch.randint(0, 7, (n,), generator=g, dtype=torch.int32)
    x = torch.randn(1, n, generator=g)
    valid = torch.ones(1, n, dtype=torch.bool)
    first = segment_reduce_plain(k, x, valid, 7, ["sum"], [0])[0]
    want = np.zeros(7, np.float32)
    np.add.at(want, k.numpy(), x[0].numpy())
    for _ in range(4):
        assert torch.equal(segment_reduce_plain(k, x, valid, 7, ["sum"], [0])[0], first)
    assert np.array_equal(first[0].numpy(), want)


# --------------------------------------------------------------------------- #
# partition-parallel join build                                                #
# --------------------------------------------------------------------------- #


def _join_data(left_rows=20_000, right_rows=4_000, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2 * right_rows, left_rows).astype(np.int64),
            rng.uniform(0.0, 1.0, left_rows), rng.permutation(right_rows).astype(np.int64),
            rng.uniform(0.0, 1.0, right_rows), rng.integers(0, left_rows // 6, 50))


def _join_tables(pkg, left_rows=20_000, right_rows=4_000):
    j, x, rj, w, nulls = _join_data(left_rows, right_rows)
    left = pkg.from_pydict({"j": j, "x": x}, npartitions=6)
    p = left.partitions[2]  # null keys on a mid partition: they must never match
    mask = np.ones(p.nrows, bool)
    mask[nulls] = False
    left.partitions[2] = type(p)(
        {"j": type(p.columns["j"])(data=p.columns["j"].data, mask=mask), "x": p.columns["x"]},
        list(p.order),
    )
    right = pkg.from_pydict({"j": rj, "w": w}, npartitions=2)
    return left, right


@pytest.mark.parametrize("how", ["inner", "left"])
def test_sharded_join_bit_equal(mesh, monkeypatch, how):
    left, right = _join_tables(T)
    monkeypatch.setattr(BK, "JOIN_BROADCAST_MAX_BYTES", 1024)
    got = PTable([BK.join_partition(p, right, "j", how, **HOST) for p in left.partitions])
    counts = dist.dispatch_counts()
    assert counts.get("join_build", 0) == 1  # build once, cached
    assert counts.get("join_probe", 0) == len(left.partitions)
    with dist.use_sharded("off"):
        ref = PTable([BK.join_partition(p, right, "j", how, **HOST) for p in left.partitions])
    assert pydict_equal(got.to_pydict(), ref.to_pydict())
    numpy_ref = PTable([B.join_partition(p, right, "j", how) for p in left.partitions])
    assert pydict_equal(got.to_pydict(), numpy_ref.to_pydict())
    if how == "left":  # misses surface as masked-out w values
        w = got.to_pydict()["w"]
        assert np.isnan(w).any() and not np.isnan(w).all()


@pytest.mark.parametrize("keys", ["float32", "int32", "uint64"])
def test_sharded_join_key_types(monkeypatch, keys):
    """Keys stay native through the build and the probe, as on the host
    path: float32 (±0 matching, inf keys), int32, and uint64 above 2^63."""
    rng = np.random.default_rng(8)
    rk = (rng.permutation(3_000) + 1).astype(keys)
    lk = rng.integers(0, 6_000, 9_000).astype(keys)
    if keys == "uint64":
        rk, lk = rk + np.uint64(1 << 63), lk + np.uint64(1 << 63)
    if keys == "float32":
        rk[:2], lk[:4] = (np.inf, -0.0), (np.inf, 0.0, -0.0, np.nan)
    left = from_pydict({"j": lk}, npartitions=3)
    right = from_pydict({"j": rk, "w": rng.uniform(0, 1, 3_000)}, npartitions=2)
    monkeypatch.setattr(BK, "JOIN_BROADCAST_MAX_BYTES", 1024)
    with dist.use_mesh([CPU] * 4):
        got = PTable([BK.join_partition(p, right, "j", "left", **HOST) for p in left.partitions])
        assert dist.dispatch_counts().get("join_build") == 1
    ref = PTable([B.join_partition(p, right, "j", "left") for p in left.partitions])
    assert pydict_equal(got.to_pydict(), ref.to_pydict())


def test_sharded_join_below_threshold_broadcasts(mesh, monkeypatch):
    left, right = _join_tables(T, right_rows=500)
    monkeypatch.setattr(BK, "JOIN_BROADCAST_MAX_BYTES", 1 << 30)
    PTable([BK.join_partition(p, right, "j", "inner", **HOST) for p in left.partitions])
    assert dist.dispatch_counts().get("join_build", 0) == 0


@pytest.mark.parametrize("where", ["same_shard", "across_shards"])
def test_sharded_join_duplicate_right_keys_raise(mesh, monkeypatch, where):
    left, right = _join_tables(T)
    dup = right.concat()
    key = np.asarray(dup.columns["j"].data).copy()
    key[1 if where == "same_shard" else -1] = key[0]
    cols = dict(dup.columns)
    cols["j"] = Column(data=key)
    bad = PTable([Partition(cols, list(dup.order))])
    monkeypatch.setattr(BK, "JOIN_BROADCAST_MAX_BYTES", 1024)
    probe = PTable([Partition({"j": Column(data=key[:1].copy())}, ["j"])]).partitions[0]
    with pytest.raises(ValueError, match="unique"):
        BK.join_partition(probe, bad, "j", "inner", **HOST)
    BK.reset_breakers()  # the straddling case scores the breaker on its way


# --------------------------------------------------------------------------- #
# against the JAX package's host xla partial + merge path                     #
# --------------------------------------------------------------------------- #


def _stats_close(a, b):
    assert a.n == b.n
    np.testing.assert_allclose(b.mean, a.mean, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b.std, a.std, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(b.mn, a.mn, rtol=1e-5)
    np.testing.assert_allclose(b.mx, a.mx, rtol=1e-5)


@pytest.fixture(scope="module")
def both_tables():
    data = _data(24_000, seed=21)
    return R.from_pydict(dict(data), npartitions=8), T.from_pydict(dict(data), npartitions=8)


def test_sharded_against_reference_xla_host_path(both_tables):
    rt, tt = both_tables
    dictionary = rt.partitions[0].columns["k"].dictionary
    with dist.use_mesh([CPU] * 8):
        merged = BK.sharded_stats(tt)
        vc = BK.sharded_value_counts(tt, "k")
        gb = BK.sharded_groupby(tt, "k", AGGS)
        tops = {asc: BK.sharded_topk(tt, "x", asc, 12) for asc in (True, False)}
    ref = RB.merge_stats([RBK.partial_stats(p, backend="xla") for p in rt.partitions])
    for c in ref:
        _stats_close(ref[c], merged[c])
    want = RB.merge_value_counts(
        [RBK.partial_value_counts(p, "k", backend="xla") for p in rt.partitions], dictionary, "k"
    ).to_pydict()
    got = B.merge_value_counts([vc], dictionary, "k").to_pydict()
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
    want = RB.merge_groupby([RBK.partial_groupby(p, "k", AGGS, None, backend="xla")
                             for p in rt.partitions], "k", AGGS, dictionary, None).to_pydict()
    got = B.merge_groupby([gb], "k", AGGS, dictionary, None).to_pydict()
    np.testing.assert_array_equal(got["k"], want["k"])
    for c in ("x", "y", "c", "mn", "mx"):
        np.testing.assert_allclose(got[c], want[c], rtol=1e-4, err_msg=c)
    for asc, partials in tops.items():  # row selection: bit for bit
        want = RB.merge_sort([RBK.partial_sort(p, "x", asc, 12, backend="xla")
                              for p in rt.partitions], "x", asc, 12).to_pydict()
        got = B.merge_sort(partials, "x", asc, 12).to_pydict()
        assert pydict_equal(got, want), asc


@pytest.mark.parametrize("how", ["inner", "left"])
def test_sharded_join_against_reference_xla(monkeypatch, how):
    rl, rr = _join_tables(R)
    tl, tr = _join_tables(T)
    monkeypatch.setattr(BK, "JOIN_BROADCAST_MAX_BYTES", 1024)
    with dist.use_mesh([CPU] * 8):
        got = PTable([BK.join_partition(p, tr, "j", how, **HOST) for p in tl.partitions])
    want = R.table.PTable([RBK.join_partition(p, rr, "j", how, backend="xla")
                           for p in rl.partitions])
    assert dist.dispatch_counts().get("join_build") == 1
    assert pydict_equal(got.to_pydict(), want.to_pydict())


def test_seed_api_against_reference_on_one_device():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    x = rng.normal(3.0, 2.0, 4_096).astype(np.float32)
    m = rng.random(4_096) > 0.2
    k = rng.integers(0, 9, 4_096).astype(np.int32)
    rmesh = make_mesh((1,), ("data",))
    want_d = np.asarray(RD.make_distributed_describe(rmesh)(jnp.asarray(x), jnp.asarray(m)))
    want_s, want_c = (np.asarray(a) for a in RD.make_distributed_groupby_sum(rmesh, 9)(
        jnp.asarray(k), jnp.asarray(x), jnp.asarray(m)))
    for tmesh in ((CPU,), (CPU,) * 4):  # one shard, then four
        got_d = dist.make_distributed_describe(tmesh)(torch.from_numpy(x), torch.from_numpy(m))
        np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5)
        got_s, got_c = dist.make_distributed_groupby_sum(tmesh, 9)(
            torch.from_numpy(k), torch.from_numpy(x), torch.from_numpy(m))
        np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-5)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
    n, s, m2, mn, mx = dist.masked_stats_local(torch.from_numpy(x), torch.from_numpy(m))
    assert (float(n), float(mn), float(mx)) == (m.sum(), x[m].min(), x[m].max())
    with pytest.raises(ValueError):
        dist.shard_column((CPU,) * 3, torch.zeros(4_096))


# --------------------------------------------------------------------------- #
# session-level dispatch parity and plan-order invariance                      #
# --------------------------------------------------------------------------- #


def _catalog(pkg, nrows=40_000):
    cat = pkg.Catalog()
    cat.register(pkg.TableSpec("fact", nrows=nrows, io_seconds=0.0, seed=9, cols=(
        pkg.ColSpec("x", low=0.0, high=10.0), pkg.ColSpec("y", null_frac=0.2),
        pkg.ColSpec("k", kind="cat", n_categories=7))))
    return cat


def _session(mode="real"):
    return T.Session(catalog=_catalog(T), mode=mode, **{"kernel_backend": "torch",
                                                        "device": "cpu"})


def _workload(s):
    df = s.read_table("fact")
    return {
        "describe": s.interact(df.describe()),
        "vc": s.interact(df["k"].value_counts()),
        "gb": s.interact(df.groupby("k").agg({"x": "mean", "y": "sum"})),
        "topk": s.interact(df.sort_values("x").head(10)),
    }


@pytest.fixture(scope="module")
def session_answers():
    with dist.use_mesh([CPU] * 8), dist.use_sharded("on"):
        dist.reset_dispatch_counts()
        got = _workload(_session())
        counts = dist.dispatch_counts()
    with dist.use_mesh([CPU] * 8), dist.use_sharded("off"):
        ref = _workload(_session())
    rs = R.Session(catalog=_catalog(R), mode="real", kernel_backend="xla")
    return got, counts, ref, _workload(rs)


def test_session_sharded_dispatch_parity(session_answers):
    got, counts, ref, _ = session_answers
    for fam in ("stats", "value_counts", "groupby", "topk"):
        assert counts.get(fam, 0) > 0, (fam, counts)
    for q in got:
        assert pydict_equal(got[q].to_pydict(), ref[q].to_pydict()), q


def test_session_sharded_against_reference_session(session_answers):
    got, _, _, want = session_answers
    for q in got:
        g, w = got[q].to_pydict(), want[q].to_pydict()
        assert list(g) == list(w), q
        for c in w:
            if q in ("vc", "topk") or np.asarray(w[c]).dtype.kind in "OU":
                np.testing.assert_array_equal(g[c], w[c], err_msg=f"{q}/{c}")
            else:
                np.testing.assert_allclose(g[c], w[c], rtol=1e-3, atol=1e-4, err_msg=f"{q}/{c}")


def _plan_order(s):
    df = s.read_table("fact")
    s.interact(df.describe())
    s.interact(df.sort_values("x").head(5))
    df.groupby("k").agg({"x": "mean"})  # background work for the plan walk
    df["k"].value_counts()
    eng = s.engine
    done = set(eng.cache.executed_ids())
    plan = [n.nid for n in eng.scheduler.plan(set(done))]
    ref, ref_done = [], set(done)
    while True:
        nxt = eng.scheduler.reference_pick(ref_done)
        if nxt is None:
            return plan, ref
        ref.append(nxt.nid)
        ref_done.add(nxt.nid)


def test_reference_pick_parity_with_sharded_dispatch():
    with dist.use_mesh([CPU] * 8), dist.use_sharded("on"):
        plan, ref = _plan_order(_session())
    assert plan == ref and ref


def test_sharded_executor_batches_counted():
    """Think-time work on an undisplayed describe rides ONE sharded
    UnitBatch covering every partition, bit for bit the host answer."""
    with dist.use_mesh([CPU] * 8), dist.use_sharded("on"):
        s = _session(mode="sim")
        node = s.read_table("fact").describe().node
        s.think(1000.0)
        s.drain()
        stats = s.engine.executor.stats
        got = s.engine.value_of(node).to_pydict()
    assert stats.sharded_batches == 1
    assert stats.units_sharded == len(s.engine.value_of(node.parents[0]).partitions)
    with dist.use_sharded("off"):
        s2 = _session(mode="sim")
        want = s2.show(s2.read_table("fact").describe()).to_pydict()
    assert pydict_equal(got, want)


def test_auto_mode_size_gate_alone(monkeypatch):
    """Under ``"auto"`` the empty priors keep describe on the host path
    (``no_estimate``), while a right side above the broadcast threshold
    engages the partition-parallel build by its size alone."""
    monkeypatch.setattr(BK, "JOIN_BROADCAST_MAX_BYTES", 4_096)
    cat = _catalog(T)
    cat.register(T.TableSpec("dim", nrows=2_000, io_seconds=0.0, seed=4,
                             cols=(T.ColSpec("j", kind="key"), T.ColSpec("w"))))
    cat.register(T.TableSpec("fact2", nrows=20_000, io_seconds=0.0, seed=5, cols=(
        T.ColSpec("j", kind="int", low=0, high=2_200), T.ColSpec("x"))))
    with dist.use_mesh([CPU] * 4), dist.use_sharded("auto"):
        s = T.Session(catalog=cat, mode="sim", kernel_backend="torch", device="cpu")
        d = s.show(s.read_table("fact").describe()).to_pydict()
        j = s.show(s.read_table("fact2").join(s.read_table("dim"), on="j")).to_pydict()
        counts = dist.dispatch_counts()
        decisions = s.engine.cost_model.planner_decisions
    assert "stats" not in counts and counts.get("join_build") == 1 and counts["join_probe"] > 0
    assert decisions.get("describe|sharded|no_estimate", 0) > 0, decisions
    with dist.use_sharded("off"):
        s2 = T.Session(catalog=cat, mode="sim", kernel_backend="torch", device="cpu")
        assert pydict_equal(d, s2.show(s2.read_table("fact").describe()).to_pydict())
        assert pydict_equal(j, s2.show(s2.read_table("fact2").join(
            s2.read_table("dim"), on="j")).to_pydict())


# --------------------------------------------------------------------------- #
# the shards' kernel backend, the mesh stacks and their cache                  #
# --------------------------------------------------------------------------- #

SHARDED_OPS = ("masked_stats_batch", "segment_reduce_batch", "topk_rows", "join_probe_padded")
FAMILY_CALLS = {
    "stats": lambda t, bk: BK.sharded_stats(t, backend=bk),
    "stats_raws": lambda t, bk: BK.sharded_stats_raws(t, ("x", "y"), backend=bk),
    "value_counts": lambda t, bk: BK.sharded_value_counts(t, "k", backend=bk),
    "groupby": lambda t, bk: BK.sharded_groupby(t, "k", AGGS, backend=bk),
    "topk": lambda t, bk: BK.sharded_topk(t, "x", False, 9, backend=bk),
}


@pytest.mark.parametrize("family", [*FAMILY_CALLS, "join"])
@pytest.mark.parametrize("session_bk, kernel_bk",
                         [("torch", "torch"), ("cuda", "cuda"), ("numpy", "cuda")])
def test_sharded_calls_run_under_the_sessions_kernel_backend(
        table, monkeypatch, family, session_bk, kernel_bk):
    """A torch session's shards run the plain versions as its host path
    does, a cuda session's the kernels' wrappers; a numpy session's sharded
    path takes the kernels.  (A cuda session's join needs the card.)"""
    if family == "join" and session_bk == "cuda":
        session_bk, kernel_bk = "torch", "torch"
    seen = []
    for name in SHARDED_OPS:
        def spy(*args, _fn=getattr(ops, name), **kwargs):
            seen.append(ops.backend())
            return _fn(*args, **kwargs)
        monkeypatch.setattr(ops, name, spy)
    with dist.use_mesh([CPU] * 2), dist.use_sharded("on"):
        if family == "join":
            left, right = _join_tables(T)
            monkeypatch.setattr(BK, "JOIN_BROADCAST_MAX_BYTES", 1024)
            BK.join_partition(left.partitions[0], right, "j", "inner", backend=session_bk,
                              device="cpu")
            assert dist.dispatch_counts().get("join_probe") == 1
        else:
            assert FAMILY_CALLS[family](table, session_bk) is not None
    assert seen and set(seen) == {kernel_bk}


def test_stack_rows_places_partitions_and_fills_the_rest():
    """Five partitions over four shards pad to eight: shard s holds
    partitions 2s and 2s + 1 on mesh[s], each row written up to its length,
    everything else the fill value."""
    mesh = (CPU,) * 4
    lengths = [3, 5, 0, 4, 2]
    rows = {i: [torch.arange(n, dtype=torch.float32) + 10 * i + j for j in range(2)]
            for i, n in enumerate(lengths)}
    stack = dist.stack_rows(mesh, 5, 6, 2, torch.float32, -1.0, lambda i, dev: rows[i])
    assert len(stack) == 4 and all(t.shape == (2, 2, 6) for t in stack)
    for s, t in enumerate(stack):
        for p in range(2):
            i = 2 * s + p
            n = lengths[i] if i < 5 else 0
            for j in range(2):
                if n:
                    assert torch.equal(t[p, j, :n], rows[i][j])
                assert (t[p, j, n:] == -1.0).all()


def test_mesh_cached_keeps_one_entry_per_slot(table):
    built = []

    def build(tag):
        built.append(tag)
        return tag

    with dist.use_mesh([CPU] * 2):
        assert dist.mesh_cached(table, "a", 1, lambda: build("a1")) == "a1"
        assert dist.mesh_cached(table, "a", 1, lambda: build("again")) == "a1"
        assert dist.mesh_cached(table, "b", 1, lambda: build("b1")) == "b1"
        assert dist.mesh_cached(table, "a", 2, lambda: build("a2")) == "a2"  # replaces
        assert dist.mesh_cached(table, "a", 1, lambda: build("a1'")) == "a1'"
        assert dist.mesh_cached(table, "n", 1, lambda: None, keep_none=False) is None
        assert dist.mesh_cached(table, "n", 1, lambda: build("n1"), keep_none=False) == "n1"
    with dist.use_mesh([CPU] * 4):  # another mesh is another key
        assert dist.mesh_cached(table, "a", 1, lambda: build("a1@4")) == "a1@4"
    assert built == ["a1", "b1", "a2", "a1'", "n1", "a1@4"]


# --------------------------------------------------------------------------- #
# inert without a usable mesh                                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("devices", [None, [CPU], [CPU] * 3], ids=["none", "one", "three"])
def test_paths_inert_without_a_usable_mesh(devices, table, monkeypatch):
    """No mesh (and no cards here), one device, or a count that is no power
    of two: every sharded entry point declines, and the session's answers
    and plan order under mode "on" equal mode "off"."""
    if devices is None and torch.cuda.device_count() >= 2:
        pytest.skip("local cards form a mesh")
    monkeypatch.setattr(BK, "JOIN_BROADCAST_MAX_BYTES", 0)
    ctx = dist.use_mesh(devices) if devices is not None else dist.use_sharded("on")
    with ctx, dist.use_sharded("on"):
        assert dist.data_mesh() is None and dist.device_count() == 1
        assert not dist.sharded_available() and not BK.sharded_available()
        assert BK.sharded_stats(table) is None
        assert BK.sharded_stats_raws(table, ("x", "y")) is None
        assert BK.sharded_value_counts(table, "k") is None
        assert BK.sharded_groupby(table, "k", AGGS) is None
        assert BK.sharded_topk(table, "x", True, 5) is None
        assert BK.plan_stats_sharded_batch(table, [0, 1]) is None
        assert BK._sharded_join_build_cached(table, "x", np.dtype(np.float64)) is None
        assert table.shard() is None
        got = _workload(_session())
        plan = _plan_order(_session())
    assert dist.dispatch_counts() == {}
    with dist.use_sharded("off"):
        want = _workload(_session())
        assert plan == _plan_order(_session())
    for q in got:
        assert pydict_equal(got[q].to_pydict(), want[q].to_pydict()), q
    with pytest.raises(ValueError):
        dist.set_mode("sometimes")
