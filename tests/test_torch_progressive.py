"""The progressive interaction path in the port, test for test beside the
JAX package's ``tests/test_progressive.py``: bounded estimates,
sample-first ordering, Chan variance merging, and scheduler memo
persistence.

* a blocking interaction with ``progressive=True`` returns at once with a
  bounded estimate (coverage < 1) and upgrades in place;
* coverage is monotone over refinement and the completed result is bit for
  bit the non-progressive path's (under hypothesis too);
* confidence intervals contain the exact value at >= the nominal rate over
  seeded trials, and stay accurate on shifted data (mean >> std) thanks to
  the Chan pairwise variance merge in the plain masked_stats and
  ``merge_stats``;
* sample-first ordering is a permutation that spreads any prefix over the
  partitions (``core``: both packages, one parametrised case each);
* scheduler memos persist across sessions and are dropped on a DAG
  fingerprint mismatch;
* the serving layers: ``repro_torch.serve``'s multi-tenant progressive
  channel and ``OpportunisticServer.request(progressive=True)``.

Sessions run on the port's ``numpy`` and ``torch`` (``device="cpu"``)
kernel backends, each a parametrised case.
"""
import math
import os

import numpy as np
import pytest
import torch

import repro.core.scheduler as r_sched
import repro_torch.core.scheduler as t_sched
from repro_torch.frame import Catalog, ColSpec, Session, TableSpec
from repro_torch.frame import blocking as B
from repro_torch.frame.partitioner import uniform_partitions

SCHEDULERS = pytest.mark.parametrize("sched", [r_sched, t_sched], ids=["repro", "repro_torch"])
BACKENDS = pytest.mark.parametrize("bk", ["numpy", "torch"])


def _catalog(seed: int = 7, nrows: int = 40_000) -> Catalog:
    cat = Catalog()
    cat.register(
        TableSpec(
            "fact",
            nrows=nrows,
            cols=(
                ColSpec("x", low=0.0, high=10.0),
                ColSpec("y", null_frac=0.2),
                ColSpec("k", kind="cat", n_categories=8),
            ),
            io_seconds=2.0,
            seed=seed,
        )
    )
    return cat


def _session(cat, bk, **kw):
    return Session(catalog=cat, mode="sim", kernel_backend=bk,
                   device="cpu" if bk == "torch" else None, **kw)


def _tables_equal(a, b) -> bool:
    """Bit-for-bit equality of two PTables (NaN == NaN)."""
    da, db = a.to_pydict(), b.to_pydict()
    if set(da) != set(db):
        return False
    for c in da:
        xa, xb = np.asarray(da[c]), np.asarray(db[c])
        if xa.shape != xb.shape:
            return False
        if xa.dtype.kind in "OU":
            if not (xa == xb).all():
                return False
        elif not np.array_equal(xa, xb, equal_nan=True):
            return False
    return True


def _frame(session, nparts=None):
    df = session.read_table("fact")
    if nparts is not None:
        spec = session.catalog.spec("fact")
        df.node.kwargs["partition_bounds"] = uniform_partitions(spec.nrows, nparts)
    return df


# --------------------------------------------------------------------------- #
# sample-first ordering (core: both packages)                                  #
# --------------------------------------------------------------------------- #


@SCHEDULERS
@pytest.mark.parametrize(
    "missing,total",
    [
        (list(range(16)), 16),
        (list(range(128)), 128),
        ([3, 7, 11, 100], 128),
        (list(range(5)), 7),  # non-power-of-two
        ([0], 1),
        ([], 16),
    ],
)
def test_sample_first_order_is_permutation(sched, missing, total):
    order = sched.sample_first_order(list(missing), total)
    assert sorted(order) == sorted(missing)


@SCHEDULERS
def test_sample_first_order_spreads_prefix(sched):
    total = 128
    order = sched.sample_first_order(list(range(total)), total)
    # bit-reversal: the first 8 picks are the 8 strided anchors 0,16,..,112
    assert set(order[:8]) == set(range(0, total, total // 8))
    # any prefix of length k leaves no gap wider than ~2 * total / k
    for k in (4, 8, 16, 32):
        chosen = sorted(order[:k])
        gaps = np.diff(chosen + [chosen[0] + total])
        assert gaps.max() <= 2 * total // k


def test_sample_first_order_identical_across_packages():
    for total in (1, 7, 16, 100, 128):
        for missing in (list(range(total)), list(range(0, total, 3))):
            assert t_sched.sample_first_order(list(missing), total) == \
                r_sched.sample_first_order(list(missing), total)


@BACKENDS
def test_sample_first_order_exact_path_untouched(bk):
    """Without a registered progress listener the executor keeps natural
    order, so background / exact execution and reference_pick parity are
    unaffected."""
    s = _session(_catalog(), bk)
    df = _frame(s, nparts=8)
    out = s.show(df.describe())
    eng = s.engine
    df.groupby("k").mean()  # leave a non-critical node for background
    done = eng.cache.executed_ids()
    got = eng.scheduler.pick(done, now=eng.clock.now())
    ref = eng.scheduler.reference_pick(done, now=eng.clock.now())
    assert (got is None) == (ref is None)
    if got is not None:
        assert got.nid == ref.nid
    assert out is not None


# --------------------------------------------------------------------------- #
# Chan variance merge on shifted data                                          #
# --------------------------------------------------------------------------- #


def test_kernel_variance_shifted_data():
    """mean >> std in float32: the plain masked_stats (what the kernel
    computes, on the CPU) keeps the centered m2 to ~1% of the true std."""
    from repro_torch.kernels import ops as K

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(50_000) + 1e6).astype(np.float32)
    m = np.ones_like(x, dtype=bool)
    rows = K.masked_stats_batch(torch.from_numpy(x)[None, :], torch.from_numpy(m)[None, :])
    cnt, s, m2, mn, mx = rows.double().numpy()[0]
    assert cnt == x.size
    std = math.sqrt(m2 / (cnt - 1))
    true_std = float(np.std(x.astype(np.float64), ddof=1))
    assert abs(std - true_std) / true_std < 0.02
    assert abs(s / cnt - 1e6) < 1.0


def test_merge_stats_pairwise_shifted_data():
    rng = np.random.default_rng(1)
    parts = []
    chunks = []
    for _ in range(256):
        c = rng.standard_normal(500) + 1e8
        chunks.append(c)
        n = float(c.size)
        mean = float(c.mean())
        parts.append(
            {
                "x": B.ColStats(
                    n, mean, float(((c - mean) ** 2).sum()),
                    float(c.min()), float(c.max()),
                )
            }
        )
    merged = B.merge_stats(parts)["x"]
    allx = np.concatenate(chunks)
    assert abs(merged.std - allx.std(ddof=1)) / allx.std(ddof=1) < 1e-6
    assert merged.n == allx.size


# --------------------------------------------------------------------------- #
# progressive estimates: immediacy, convergence, exactness                     #
# --------------------------------------------------------------------------- #


@BACKENDS
def test_progressive_describe_first_estimate_is_partial(bk):
    s = _session(_catalog(), bk)
    df = _frame(s, nparts=16)
    pr = s.interact(df.describe(), progressive=True)
    est = pr.estimate()
    assert 0.0 < est.coverage < 1.0
    assert not est.exact
    assert est.value is not None and "x" in est.intervals
    rec = s.engine.metrics.interactions[-1]
    assert rec.progressive and rec.partial


@BACKENDS
def test_progressive_converges_to_exact_bitforbit(bk):
    cat = _catalog()
    s = _session(cat, bk)
    pr = s.interact(_frame(s, nparts=16).describe(), progressive=True)
    covs = []
    final = None
    for est in pr:
        covs.append(est.coverage)
        if est.exact:
            final = est.value
            break
    assert all(b >= a for a, b in zip(covs, covs[1:]))
    assert covs[-1] == 1.0
    s2 = _session(cat, bk)
    exact = s2.show(_frame(s2, nparts=16).describe())
    assert _tables_equal(final, exact)


@BACKENDS
@pytest.mark.parametrize("q", ["value_counts", "groupby_mean", "groupby_sum", "mean"])
def test_progressive_upgrade_bitforbit_all_ops(bk, q):
    cat = _catalog()

    def build(sess):
        df = _frame(sess, nparts=16)
        if q == "value_counts":
            return df["k"].value_counts()
        if q == "groupby_mean":
            return df.groupby("k").mean()
        if q == "groupby_sum":
            return df.groupby("k").sum()
        return df.mean()

    s = _session(cat, bk)
    pr = s.interact(build(s), progressive=True)
    assert pr.estimate().coverage < 1.0
    got = pr.upgrade()
    s2 = _session(cat, bk)
    exact = s2.show(build(s2))
    assert _tables_equal(got, exact)


@BACKENDS
def test_progressive_value_counts_estimate_scales(bk):
    """Counts estimated from k of m partitions scale by m/k: the estimated
    total stays within 20% of the true row count at 25% coverage."""
    s = _session(_catalog(), bk)
    df = _frame(s, nparts=16)
    pr = s.interact(df["k"].value_counts(), progressive=True)
    pr.refine(3)  # 4 of 16 partitions
    est = pr.estimate()
    assert not est.exact
    total_est = int(np.asarray(est.value.to_pydict()["count"]).sum())
    nrows = s.catalog.spec("fact").nrows
    assert abs(total_est - nrows) / nrows < 0.2
    assert len(est.intervals) > 0


@BACKENDS
def test_progressive_interval_containment_rate(bk):
    """Over seeded trials, the 95% interval on a column mean at partial
    coverage contains the exact mean at >= the nominal rate."""
    hits = 0
    trials = 40
    for seed in range(trials):
        cat = _catalog(seed=seed, nrows=8_000)
        s = _session(cat, bk)
        df = _frame(s, nparts=16)
        pr = s.interact(df.mean(), progressive=True)
        pr.refine(3)  # 4 of 16 partitions
        est = pr.estimate()
        lo, hi = est.intervals["x"]
        exact = float(np.asarray(pr.upgrade().to_pydict()["x"])[0])
        if lo <= exact <= hi:
            hits += 1
    assert hits / trials >= 0.95


@BACKENDS
def test_background_think_refines_progressive(bk):
    """Think-time background execution streams completed partitions into the
    running combine; draining finishes the node and the handle turns exact."""
    cat = _catalog()
    s = _session(cat, bk)
    pr = s.interact(_frame(s, nparts=16).describe(), progressive=True)
    assert pr.estimate().coverage < 1.0
    s.drain()
    est = pr.estimate()
    assert est.exact and est.coverage == 1.0
    s2 = _session(cat, bk)
    assert _tables_equal(est.value, s2.show(_frame(s2, nparts=16).describe()))


@BACKENDS
def test_progressive_on_cached_node_is_exact_immediately(bk):
    s = _session(_catalog(), bk)
    df = _frame(s, nparts=16)
    exact = s.show(df.describe())
    pr = s.interact(df.describe(), progressive=True)
    est = pr.estimate()
    assert est.exact and est.coverage == 1.0
    assert _tables_equal(est.value, exact)


# --------------------------------------------------------------------------- #
# hypothesis: convergence property                                             #
# --------------------------------------------------------------------------- #


@BACKENDS
def test_progressive_convergence_property(bk):
    pytest.importorskip(
        "hypothesis", reason="dev extra: pip install -r requirements-dev.txt"
    )
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(
        max_examples=10, deadline=None,
        suppress_health_check=[HealthCheck.too_slow],
    )
    @given(
        seed=st.integers(0, 50),
        nparts=st.sampled_from([2, 3, 8, 16]),
        step=st.integers(1, 5),
    )
    def run(seed, nparts, step):
        cat = _catalog(seed=seed, nrows=4_000)
        s = _session(cat, bk)
        pr = s.interact(_frame(s, nparts=nparts).describe(), progressive=True)
        covs = [pr.estimate().coverage]
        while not pr.estimate().exact:
            pr.refine(step)
            covs.append(pr.estimate().coverage)
        assert all(b >= a for a, b in zip(covs, covs[1:]))
        s2 = _session(cat, bk)
        exact = s2.show(_frame(s2, nparts=nparts).describe())
        assert _tables_equal(pr.estimate().value, exact)

    run()


# --------------------------------------------------------------------------- #
# scheduler memo persistence                                                   #
# --------------------------------------------------------------------------- #


def _program(s):
    df = _frame(s, nparts=8)
    flt = df[df["x"] > 5.0]
    flt.describe()
    flt.groupby("k").mean()
    df["k"].value_counts()
    return s


@BACKENDS
def test_scheduler_memos_roundtrip_with_pick_parity(bk, tmp_path):
    path = str(tmp_path / "memos.json")
    cat = _catalog()
    s1 = _session(cat, bk, scheduler_memo_path=path)
    _program(s1)
    # one pick populates descendant + delivery memos; save persists them
    s1.engine.scheduler.pick(set(), now=s1.engine.clock.now())
    s1.engine.save_scheduler_memos()
    assert os.path.exists(path)

    # identical program in a fresh session: load installs the memos...
    s2 = _session(cat, bk, scheduler_memo_path=path)
    _program(s2)
    assert s2.engine.load_scheduler_memos() is True

    # ...and the pick sequence stays identical to the memo-free oracle
    s3 = _session(cat, bk)
    _program(s3)
    done: set = set()
    for _ in range(50):
        p2 = s2.engine.scheduler.pick(set(done), now=0.0)
        p3 = s3.engine.scheduler.pick(set(done), now=0.0)
        ref = s2.engine.scheduler.reference_pick(set(done), now=0.0)
        assert (p2 is None) == (p3 is None) == (ref is None)
        if p2 is None:
            break
        assert p2.nid == p3.nid == ref.nid
        done.add(p2.nid)


@BACKENDS
def test_scheduler_memos_rejected_on_dag_mismatch(bk, tmp_path):
    path = str(tmp_path / "memos.json")
    cat = _catalog()
    s1 = _session(cat, bk, scheduler_memo_path=path)
    _program(s1)
    s1.engine.scheduler.pick(set(), now=0.0)
    s1.engine.save_scheduler_memos()

    # a different program (one extra node) → fingerprint mismatch → rejected
    s2 = _session(cat, bk, scheduler_memo_path=path)
    _program(s2)
    _frame(s2, nparts=8).dropna()
    assert s2.engine.load_scheduler_memos() is False

    # garbage file → rejected, not raised
    with open(path, "w") as f:
        f.write("{not json")
    assert s2.engine.load_scheduler_memos() is False


@BACKENDS
def test_scheduler_memos_survive_save_load_of_cost_model(bk, tmp_path):
    """Engine-level wiring: save_cost_model also persists scheduler memos to
    the derived sidecar path."""
    cm_path = str(tmp_path / "cm.json")
    cat = _catalog()
    s1 = _session(cat, bk, cost_model_path=cm_path)
    _program(s1)
    s1.engine.scheduler.pick(set(), now=0.0)
    s1.engine.save_cost_model()
    assert os.path.exists(cm_path + ".sched.json")
    s2 = _session(cat, bk, cost_model_path=cm_path)
    _program(s2)
    # structure memos load even though calibration changed the cost state
    assert s2.engine.load_scheduler_memos() is True


# --------------------------------------------------------------------------- #
# serving layers: multi-tenant attribution + request(progressive=True)         #
# --------------------------------------------------------------------------- #


def test_multitenant_progressive_attribution_and_log():
    from repro_torch.core import Engine
    from repro_torch.serve.multitenant import (
        MultiTenantServer,
        register_synthetic_op,
        synthetic_trace_program,
    )

    eng = Engine(mode="sim", budget_bytes=1 << 20, speculation=False)
    register_synthetic_op(eng)
    srv = MultiTenantServer(eng, record_schedule=True)
    _, r1 = synthetic_trace_program(3, 0)
    prog = srv.submit("alice", [r1])
    root = prog.roots[0]

    pr = srv.interact("alice", root, progressive=True)
    assert srv.schedule_log[-1] == ["interact_progressive", "alice", root.nid, "miss"]
    # synthetic has no running combine: coverage-only channel
    est = pr.estimate()
    assert est.value is None and est.coverage < 1.0
    before = dict(eng.executor.stats.units_by_tenant)
    pr.refine(1)
    after = eng.executor.stats.units_by_tenant
    assert after.get("alice", 0) > before.get("alice", 0)
    exact = pr.upgrade()
    # non-progressive entry keeps its historical shape (now a cache hit)
    assert srv.interact("alice", root) == exact
    assert srv.schedule_log[-1] == ["interact", "alice", root.nid, "hit"]


def test_serve_request_progressive_upgrades_to_exact():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_model
    from repro_torch.serve import OpportunisticServer

    cfg = get_smoke_config("smollm_360m")
    params = init_model(cfg, seed=0, device="cpu")
    prompt = tuple(range(1, 17))

    srv = OpportunisticServer(cfg, params, step_cost_s=0.05, prefill_cost_s=0.1,
                              device="cpu")
    exact = srv.request(prompt, n_tokens=4, tenant="a")

    srv2 = OpportunisticServer(cfg, params, step_cost_s=0.05, prefill_cost_s=0.1,
                               device="cpu")
    pr = srv2.request(prompt, n_tokens=4, tenant="a", progressive=True)
    assert pr.estimate().coverage < 1.0  # returned before decoding finished
    got = pr.upgrade()
    np.testing.assert_array_equal(got.tokens, exact.tokens)


def _close_to(got, want, label):
    """test_torch_session.py's tolerances: floats rtol 2e-3 / atol 1e-5,
    strings and counts exact."""
    assert list(got) == list(want), label
    for col in want:
        g, w = np.asarray(got[col]), np.asarray(want[col])
        assert g.shape == w.shape, (label, col)
        if w.dtype.kind in "OU":
            np.testing.assert_array_equal(g, w, err_msg=f"{label}/{col}")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=2e-3, atol=1e-5, err_msg=f"{label}/{col}")


@pytest.mark.parametrize("q", ["describe", "value_counts", "groupby_mean"])
def test_progressive_upgrade_matches_the_reference_package(q):
    """The port's progressive ``upgrade()`` (``torch``) against the JAX
    package's blocking answer (``xla``) on the same catalog spec."""
    import repro.frame as R
    from repro.frame.partitioner import uniform_partitions as r_uniform

    def build(df):
        if q == "value_counts":
            return df["k"].value_counts()
        if q == "groupby_mean":
            return df.groupby("k").mean()
        return df.describe()

    s = _session(_catalog(), "torch")
    pr = s.interact(build(_frame(s, nparts=16)), progressive=True)
    assert pr.estimate().coverage < 1.0
    got = pr.upgrade().to_pydict()
    rcat = R.Catalog()
    rcat.register(R.TableSpec("fact", nrows=40_000, io_seconds=2.0, seed=7, cols=(
        R.ColSpec("x", low=0.0, high=10.0), R.ColSpec("y", null_frac=0.2),
        R.ColSpec("k", kind="cat", n_categories=8))))
    rs = R.Session(catalog=rcat, mode="sim", kernel_backend="xla")
    rdf = rs.read_table("fact")
    rdf.node.kwargs["partition_bounds"] = r_uniform(40_000, 16)
    _close_to(got, rs.show(build(rdf)).to_pydict(), q)
