"""Concurrent MaterializedCache access under the engine-lock discipline, test
for test beside the JAX package's ``tests/test_cache_concurrency.py``.

The cache is not thread-safe; the engine serialises every touch under
``Engine._lock`` (interactive thread against the real-mode background
worker).  These tests hammer that discipline — ``on_evict`` firing during
GC in the middle of a background run included — and pin the accounting
invariants, per tenant too (cache fairness).  The tests that build a
``MaterializedCache`` alone are ``core``, byte-identical in both packages,
and run over both; the background run goes through the port's session on
its ``numpy`` and ``torch`` (``device="cpu"``) kernel backends.
"""
import threading
import time

import numpy as np
import pytest

import repro.core as RC
import repro_torch.core as TC
from repro_torch.frame import Catalog, ColSpec, Session, TableSpec

CORES = pytest.mark.parametrize("core", [RC, TC], ids=["repro", "repro_torch"])


def _mk_cache(core, budget=10_000, **kw):
    return core.MaterializedCache(budget_bytes=budget, cost_model=core.CostModel(), **kw)


def _nodes(core, n):
    dag = core.DAG()
    return [dag.add("synthetic", kwargs={"cost_s": 1.0, "tag": str(i)}) for i in range(n)]


@CORES
def test_concurrent_put_get_drop_under_lock(core):
    """Interleaved put/get/drop from four threads, engine-style (shared lock):
    no exceptions, and the byte accounting stays exact."""
    cache = _mk_cache(core, budget=50_000)
    nodes = _nodes(core, 32)
    lock = threading.RLock()
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(400):
                node = nodes[int(rng.integers(len(nodes)))]
                action = rng.random()
                with lock:
                    if action < 0.5:
                        cache.put(node, np.arange(int(rng.integers(1, 200))))
                    elif action < 0.8:
                        try:
                            cache.get(node)
                        except KeyError:
                            pass
                    else:
                        cache.drop(node.nid)
        except Exception as exc:  # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    with lock:
        expected = sum(e.m_bytes for e in cache._entries.values())
        assert cache.used_bytes == expected
        assert cache.used_bytes <= cache.budget_bytes


@CORES
def test_on_evict_fires_during_gc_and_may_reenter_reads(core):
    """GC triggered by a put invokes ``on_evict`` mid-operation; the callback
    reads back into the cache (peek / executed_ids), exactly like the
    engine's wiring into ``scheduler.evicted_once`` — must not corrupt
    accounting or deadlock."""
    evicted = []
    cache = _mk_cache(core, budget=2_000, gc_threshold=0.8)

    def on_evict(node):
        evicted.append(node.nid)
        assert cache.peek(node.nid) is None  # entry already removed
        cache.executed_ids()

    cache.on_evict = on_evict
    for node in _nodes(core, 10):
        cache.put(node, np.arange(100))  # 800 bytes each: forces GC
    assert evicted  # GC actually ran
    assert cache.used_bytes <= 0.8 * cache.budget_bytes
    assert cache.used_bytes == sum(e.m_bytes for e in cache._entries.values())
    for nid in evicted:
        assert nid not in cache


def _catalog():
    cat = Catalog()
    cat.register(TableSpec("small", nrows=5_000, io_seconds=1.0, seed=7, cols=(
        ColSpec("x", low=0.0, high=10.0), ColSpec("y", null_frac=0.2),
        ColSpec("k", kind="cat", n_categories=7))))
    return cat


@pytest.mark.parametrize("bk", ["numpy", "torch"])
def test_on_evict_during_gc_mid_background_run(bk):
    """Real-mode worker filling a tiny cache while the interactive thread
    displays: GC (and the engine's on_evict → scheduler.evicted_once hook)
    fires concurrently with interactions.  The worker must survive, results
    must stay correct, and the accounting must balance at the end."""
    s = Session(catalog=_catalog(), mode="real", budget_bytes=200_000, kernel_backend=bk,
                device="cpu" if bk == "torch" else None)
    eng = s.engine
    df = s.read_table("small")
    flt = df[df["x"] > 3.0]
    srt = flt.sort_values("x")
    desc = df.describe()
    eng.start_background()
    try:
        deadline = time.time() + 20
        while eng.cache.n_evictions == 0 and time.time() < deadline:
            eng.nudge_background()
            time.sleep(0.01)
        out = s.show(srt.head(5))  # interactions race the GC'ing worker
        assert out.nrows == 5
        x = np.asarray(out.to_pydict()["x"])
        assert np.all(np.diff(x) >= 0) and np.all(x > 3.0)
        out2 = s.show(desc)
        assert out2.nrows == 5
        assert eng._worker.alive
    finally:
        eng.stop_background()
    with eng._lock:
        assert eng.cache.used_bytes == sum(
            e.m_bytes for e in eng.cache._entries.values()
        )
    # eviction hook fed the scheduler's anti-thrash set for every eviction
    if eng.cache.n_evictions:
        assert eng.scheduler.evicted_once


@CORES
def test_gc_respects_pins_under_churn(core):
    cache = _mk_cache(core, budget=1_000, gc_threshold=0.8)
    nodes = _nodes(core, 6)
    cache.put(nodes[0], np.arange(50))  # 400 bytes
    cache.pin(nodes[0].nid)
    for node in nodes[1:]:
        cache.put(node, np.arange(50))
    assert nodes[0].nid in cache  # pinned entries survive any GC pressure
    cache.unpin(nodes[0].nid)
    cache.put(nodes[1], np.arange(80))
    # after unpinning it is evictable again (may or may not be chosen)
    assert cache.used_bytes == sum(e.m_bytes for e in cache._entries.values())


@CORES
def test_eviction_of_speculative_results_first(core):
    cache = _mk_cache(core, budget=1_000, gc_threshold=0.8)
    nodes = _nodes(core, 3)
    cache.put(nodes[0], np.arange(60), speculative=True)  # 480 bytes
    cache.put(nodes[1], np.arange(40))  # 320 bytes → total 800 = threshold
    cache.put(nodes[2], np.arange(20))  # 160 bytes → GC
    assert nodes[0].nid not in cache  # speculative victim goes first
    assert nodes[1].nid in cache


# ---------------------------------------------- multi-tenant fairness -----------
def _tenant_invariant(cache) -> None:
    """Each tenant's charged bytes equal the sum of entry sizes over the
    entries it subscribes to (full size per subscriber)."""
    for t in cache._tenant_bytes:
        expected = sum(
            e.m_bytes for e in cache._entries.values() if t in e.tenants
        )
        assert cache.tenant_bytes(t) == expected, t


@CORES
def test_tenant_byte_accounting_through_churn(core):
    cache = _mk_cache(core, budget=100_000)
    nodes = _nodes(core, 8)
    for i, node in enumerate(nodes):
        cache.subscribe(node.nid, f"t{i % 3}")
    # a deduped node every tenant subscribes to
    for t in ("t0", "t1", "t2"):
        cache.subscribe(nodes[0].nid, t)
    for node in nodes:
        cache.put(node, np.arange(50))  # 400 bytes
    _tenant_invariant(cache)
    # the shared entry charges its full size against every subscriber
    assert cache._entries[nodes[0].nid].tenants == {"t0", "t1", "t2"}
    # replacement keeps subscribers and re-charges the new size
    cache.put(nodes[0], np.arange(100))
    assert cache._entries[nodes[0].nid].tenants == {"t0", "t1", "t2"}
    _tenant_invariant(cache)
    # late subscription to an already-cached entry charges immediately
    before = cache.tenant_bytes("t2")
    cache.subscribe(nodes[1].nid, "t2")
    assert cache.tenant_bytes("t2") == before + cache._entries[nodes[1].nid].m_bytes
    _tenant_invariant(cache)
    cache.drop(nodes[0].nid)
    _tenant_invariant(cache)


@CORES
def test_n_tenant_concurrent_put_get_gc_accounting(core):
    """N tenants hammering a shared cache (engine-lock discipline) with GC
    pressure: the per-tenant accounting invariant must hold at the end, and
    no interleaving may corrupt the global byte count."""
    cache = _mk_cache(core, budget=20_000, gc_threshold=0.8)
    n_tenants = 4
    nodes = _nodes(core, 40)
    for i, node in enumerate(nodes):
        cache.subscribe(node.nid, f"t{i % n_tenants}")
    for t in range(n_tenants):
        cache.subscribe(nodes[0].nid, f"t{t}")
    lock = threading.RLock()
    errors = []

    def worker(tid):
        rng = np.random.default_rng(tid)
        mine = [n for i, n in enumerate(nodes) if i % n_tenants == tid]
        try:
            for _ in range(300):
                node = mine[int(rng.integers(len(mine)))]
                action = rng.random()
                with lock:
                    if action < 0.55:  # puts force regular GC at this budget
                        cache.put(node, np.arange(int(rng.integers(1, 300))))
                    elif action < 0.85:
                        try:
                            cache.get(node)
                        except KeyError:
                            pass
                    else:
                        cache.drop(node.nid)
        except Exception as exc:  # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    with lock:
        assert cache.used_bytes == sum(e.m_bytes for e in cache._entries.values())
        _tenant_invariant(cache)
        assert cache.n_evictions > 0  # GC actually exercised


@CORES
def test_gc_does_not_evict_under_share_tenant_for_over_share_one(core):
    """Fair-share rule: while one tenant is over its equal slice of the
    budget, the under-share tenant's entries are never the victim."""
    cache = _mk_cache(core, budget=2_000, gc_threshold=0.8)  # fair share: 1000
    nodes = _nodes(core, 10)
    poor = nodes[0]
    cache.subscribe(poor.nid, "poor")
    for n in nodes[1:]:
        cache.subscribe(n.nid, "rich")
    cache.put(poor, np.arange(25))  # 200 bytes: well under share
    for n in nodes[1:]:
        cache.put(n, np.arange(50))  # rich keeps blowing the budget → GC
    assert poor.nid in cache  # never sacrificed for the over-share tenant
    assert cache.tenant_bytes("poor") == 200
    assert cache.tenant_bytes("rich") <= cache.budget_bytes
    assert cache.n_fairness_evictions > 0  # the fair-share rule chose victims
    _tenant_invariant(cache)


@CORES
def test_gc_falls_back_to_global_score_when_fairness_would_wedge(core):
    """Starvation freedom: if every unpinned entry belongs to an under-share
    tenant, GC must still make progress via the global score."""
    cache = _mk_cache(core, budget=1_000, gc_threshold=0.8)
    nodes = _nodes(core, 6)
    cache.subscribe(nodes[0].nid, "a")
    cache.subscribe(nodes[1].nid, "b")
    cache.put(nodes[0], np.arange(40))  # 320: a under share
    cache.put(nodes[1], np.arange(40))  # 320: b under share → total 640
    cache.put(nodes[2], np.arange(40))  # untenanted → 960 > 800: GC must act
    assert cache.used_bytes <= 0.8 * cache.budget_bytes
    _tenant_invariant(cache)


@CORES
def test_fair_share_denominator_counts_registered_tenants(core):
    cache = _mk_cache(core, budget=9_000)
    assert cache.fair_share() == 9_000  # no tenants: whole budget
    cache.register_tenant("a")
    cache.register_tenant("b")
    cache.register_tenant("c")
    assert cache.fair_share() == 3_000
    nodes = _nodes(core, 1)
    cache.subscribe(nodes[0].nid, "a")
    cache.put(nodes[0], np.arange(500))  # 4000 bytes: a over its 3000 share
    assert cache.over_share() == {"a"}
    stats = cache.tenant_stats()
    assert stats["tenant_bytes"] == {"a": 4000, "b": 0, "c": 0}


def test_device_cache_keys_one_copy_per_card():
    """The frame backend keys its device copies by the indexed device: a
    session's ``cuda`` and a data mesh's ``cuda:0`` name one slot (no card
    needed: the key is built from a ``torch.device`` alone)."""
    import torch

    from repro_torch.frame import backend as BK

    assert BK.device_key("cuda") == BK.device_key(torch.device("cuda", 0)) == "cuda:0"
    assert BK.device_key(torch.device("cuda")) == "cuda:0"
    assert BK.device_key("cuda:1") == "cuda:1"
    assert BK.device_key("cpu") == BK.device_key(torch.device("cpu")) == "cpu"


# ------------------------------------------------ the frame's device cache -----
def _warm_table():
    from repro_torch.frame import from_pydict

    rng = np.random.default_rng(5)
    n = 6_000
    y = rng.uniform(0, 10, n)
    y[rng.random(n) < 0.3] = np.nan  # a masked column
    return from_pydict({"x": rng.normal(5, 2, n), "y": y,
                        "k": rng.choice(np.array(list("abcdef")), n),
                        "i": rng.integers(0, 50, n)}, npartitions=4)


def _partials(table):
    from repro_torch.frame import backend as BK

    cpu = dict(backend="torch", device="cpu")
    out = []
    for p in table.partitions:
        out.append(BK.partial_stats(p, **cpu))
        out.append(BK.partial_groupby(p, "k", (("s", "x", "sum"), ("m", "y", "mean"),
                                                ("c", "y", "count")), **cpu))
        out.append(BK.partial_value_counts(p, "k", **cpu))
        for by, asc in (("x", True), ("y", False), ("i", True)):
            part, samples = BK.partial_sort(p, by, asc, 16, **cpu)
            out.append(({c: part.columns[c].to_numpy() for c in part.order}, samples))
    plans = [BK.plan_stats_batch(table.partitions, **cpu),
             BK.plan_sort_batch(table.partitions, "y", True, 16, **cpu)]
    for dispatch, finalize in plans:
        out.append(finalize(dispatch()))
    return out


def test_warm_device_cache_serves_partials_without_uploads(monkeypatch):
    """A warmed table serves describe, groupby, value_counts and sort with a
    limit (per partition and batched) with no host→device upload, and the
    same answers as an unwarmed table."""
    from repro_torch.frame import backend as BK

    BK.reset_breakers()
    cold = _partials(_warm_table())
    table = _warm_table()
    BK.warm_device_cache(table, device="cpu")
    calls = []
    upload = BK._upload
    monkeypatch.setattr(BK, "_upload", lambda arr, dev: calls.append(arr.shape) or upload(arr, dev))
    warm = _partials(table)
    assert calls == []
    assert repr(warm) == repr(cold)
    snap = BK.breaker_board().snapshot()  # served by the plain versions, not numpy
    assert snap and all(st["failures"] == 0 and st["fallbacks"] == 0 for st in snap.values())


def test_warm_device_cache_makes_each_copy_the_partials_read():
    from repro_torch.frame import backend as BK

    table = _warm_table()
    BK.warm_device_cache(table, device="cpu")
    for p in table.partitions:
        assert set(p.__dict__) >= {"_dev_stats@cpu"}
        for name in p.order:
            slots = {k for k in p.columns[name].__dict__ if k.startswith("_dev_")}
            want = {"_dev_native@cpu", "_dev_valid@cpu" if p.columns[name].mask is None
                    else "_dev_mask@cpu"}
            want.add("_dev_i32@cpu" if name == "k" else "_dev_f32@cpu")
            assert slots == want, (name, slots)


def test_warm_device_cache_needs_a_card_unless_asked_for_the_cpu():
    import torch

    from repro_torch.frame import backend as BK

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: warm_device_cache(table) warms it")
    with pytest.raises(RuntimeError, match="CUDA device"):
        BK.warm_device_cache(_warm_table())


@pytest.mark.parametrize("dtype", ["float64", "float32", "int64", "int32", "uint64", "bool"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ascending", [True, False])
def test_device_sort_keys_are_the_host_keys(dtype, masked, ascending):
    """The sort keys made on the device from the cached copies equal the
    host's ``_sort_keys`` bit for bit, in float64 (negated when descending,
    as the full sort takes them) and in float32 (top-k)."""
    import torch

    from repro_torch.frame import backend as BK
    from repro_torch.frame.table import Column

    rng = np.random.default_rng(3)
    data = (rng.normal(0, 1e6, 257) if dtype.startswith("float") else
            rng.integers(0, 2, 257) if dtype == "bool" else
            rng.integers(0, 2 ** 40, 257)).astype(dtype)
    if dtype == "int64":
        data[:2] = [2 ** 53 + 1, -(2 ** 62) + 3]  # past float64's exact integers
    col = Column(data=data, mask=rng.random(257) > 0.3 if masked else None)
    keys = BK._sort_keys(col, ascending)
    f64 = BK._dev_sort_keys(col, ascending, torch.device("cpu"), torch.float64).numpy()
    f32 = BK._dev_sort_keys(col, ascending, torch.device("cpu"), torch.float32).numpy()
    np.testing.assert_array_equal(f64.view(np.uint64), (keys if ascending else -keys).view(np.uint64))
    np.testing.assert_array_equal(f32.view(np.uint32), keys.astype(np.float32).view(np.uint32))
