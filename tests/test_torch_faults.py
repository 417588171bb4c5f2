"""Fault-tolerant opportunistic execution in the port, test for test beside
the JAX package's ``tests/test_faults.py``: the injection harness, crash
isolation, quarantine backoff, circuit breakers and graceful degradation.

The invariant everywhere: injected background faults may cost throughput,
never correctness — every user-visible result stays bit-identical to a
fault-free run, and the background worker survives any fault rate.

``core`` (``FaultPlan``, the scheduler's quarantine, the cost model) is
byte-identical in both packages, so its tests run over both, one
parametrised case each.  Sessions run on the port's ``numpy`` and ``torch``
(``device="cpu"``) kernel backends.  On the CPU every runtime error of a
kernel dispatch is contained (``backend._contained``), so the guarded
dispatch, its numpy fallback and the breaker are held on the ``torch``
backend; the card's rule (only injected faults are contained) is pinned by
``tests/test_torch_session.py``.
"""
import importlib
import json
import os
import time

import numpy as np
import pytest

import repro.core as RC
import repro_torch.core as TC
from repro_torch.core import FaultPlan, FaultSpec, InjectedFault
from repro_torch.core import faults
from repro_torch.frame import Catalog, ColSpec, Session, TableSpec
from repro_torch.frame import backend as BK
from repro_torch.frame import blocking as B

CORES = pytest.mark.parametrize("core", [RC, TC], ids=["repro", "repro_torch"])
BACKENDS = pytest.mark.parametrize("bk", ["numpy", "torch"])


@pytest.fixture(autouse=True)
def _clean_breakers():
    BK.reset_breakers()
    yield
    BK.reset_breakers()


@pytest.fixture()
def catalog() -> Catalog:
    cat = Catalog()
    cat.register(
        TableSpec(
            "small",
            nrows=5_000,
            cols=(
                ColSpec("x", low=0.0, high=10.0),
                ColSpec("y", null_frac=0.2),
                ColSpec("k", kind="cat", n_categories=7),
                ColSpec("i", kind="int", low=0, high=100),
                ColSpec("j", kind="int", low=0, high=7),
            ),
            io_seconds=1.0,
            seed=7,
        )
    )
    return cat


def _session(catalog, bk, **kw):
    device = "cpu" if bk == "torch" else None
    return Session(catalog=catalog, kernel_backend=bk, device=device, **kw)


def _synth(engine, cost, parents=(), n_units=1, tag=""):
    return engine.add(
        "synthetic",
        parents=parents,
        kwargs={"cost_s": float(cost), "n_units": int(n_units), "tag": tag},
    )


# --------------------------------------------------------------------------- #
# FaultPlan unit behaviour (core: both packages)                               #
# --------------------------------------------------------------------------- #


@CORES
def test_spec_validation(core):
    with pytest.raises(ValueError):
        core.FaultSpec("nonsense")
    with pytest.raises(ValueError):
        core.FaultSpec("kernel", mode="explode")
    with pytest.raises(ValueError):
        core.FaultSpec("kernel", rate=1.5)


@CORES
def test_plan_parse_and_env(core, monkeypatch):
    plan = core.FaultPlan.parse("kernel:raise:0.25, exec.unit:corrupt:0.5", seed=3)
    assert [(s.site, s.mode, s.rate) for s in plan.specs] == [
        ("kernel", "raise", 0.25),
        ("exec.unit", "corrupt", 0.5),
    ]
    with pytest.raises(ValueError):
        core.FaultPlan.parse("kernel:raise")  # missing rate
    monkeypatch.delenv(core.faults.ENV_VAR, raising=False)
    assert core.FaultPlan.from_env() is None
    monkeypatch.setenv(core.faults.ENV_VAR, "cache.put:oom:0.1")
    monkeypatch.setenv(core.faults.ENV_SEED_VAR, "9")
    plan = core.FaultPlan.from_env()
    assert plan.seed == 9 and plan.specs[0].site == "cache.put"


@CORES
def test_engine_picks_up_env_plan(core, monkeypatch):
    monkeypatch.setenv(core.faults.ENV_VAR, "kernel:raise:0.01")
    eng = core.Engine(mode="sim")
    assert eng.faults is not None
    assert eng.faults.specs[0].site == "kernel"
    monkeypatch.delenv(core.faults.ENV_VAR)
    assert core.Engine(mode="sim").faults is None


@CORES
def test_plan_is_deterministic_under_seed(core):
    def run(seed):
        plan = core.FaultPlan([core.FaultSpec("kernel", rate=0.3)], seed=seed)
        outcomes = []
        for _ in range(200):
            try:
                plan.fire("kernel")
                outcomes.append(0)
            except core.InjectedFault:
                outcomes.append(1)
        return outcomes

    a, b, c = run(5), run(5), run(6)
    assert a == b
    assert a != c  # different seed, different sequence
    assert 20 < sum(a) < 120  # rate≈0.3 actually fires


@CORES
def test_background_only_gating_and_max_fires(core):
    plan = core.FaultPlan(
        [core.FaultSpec("exec.unit", rate=1.0, max_fires=2)], seed=0
    )
    # exec.unit defaults to background-only: foreground never fires
    assert plan.fire("exec.unit") is None
    with core.faults.background():
        with pytest.raises(core.InjectedFault):
            plan.fire("exec.unit")
        with pytest.raises(core.InjectedFault):
            plan.fire("exec.unit")
        assert plan.fire("exec.unit") is None  # max_fires exhausted
    assert plan.total_fired() == 2
    assert plan.summary()["fired"] == {"exec.unit:raise": 2}


@CORES
def test_kernel_site_fires_foreground_and_ops_filter(core):
    plan = core.FaultPlan(
        [core.FaultSpec("kernel", rate=1.0, ops=("stats",), max_fires=1)], seed=0
    )
    assert plan.fire("kernel", op="join") is None  # ops filter
    with pytest.raises(core.InjectedFault):
        plan.fire("kernel", op="stats")  # foreground-safe site


@CORES
def test_corrupt_wrapper_and_hang_mode(core):
    wrapped = core.faults.corrupt([1, 2])
    assert core.faults.is_corrupt(wrapped)
    assert core.faults.corrupt(wrapped) is wrapped  # idempotent
    assert not core.faults.is_corrupt([1, 2])
    plan = core.FaultPlan(
        [core.FaultSpec("cache.get", mode="hang", rate=1.0, latency_s=0.01)], seed=0
    )
    with core.faults.background():
        t0 = time.monotonic()
        assert plan.fire("cache.get") == "hang"
        assert time.monotonic() - t0 >= 0.01  # latency injected, no error


@CORES
def test_module_fire_needs_scoped_plan(core):
    assert core.faults.fire("kernel") is None  # no active plan: no-op
    plan = core.FaultPlan([core.FaultSpec("kernel", rate=1.0)], seed=0)
    with core.faults.scope(plan):
        assert core.faults.current() is plan
        with pytest.raises(core.InjectedFault):
            core.faults.fire("kernel")
    assert core.faults.current() is None


# --------------------------------------------------------------------------- #
# circuit breakers                                                             #
# --------------------------------------------------------------------------- #


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_breaker_trips_after_threshold_and_recovers_via_half_open():
    clk = _FakeClock()
    board = BK.BreakerBoard(failure_threshold=3, backoff_s=5.0, clock=clk)
    # two failures: still closed
    board.record_failure("stats", "torch", "boom")
    board.record_failure("stats", "torch", "boom")
    assert board.allow("stats", "torch")
    # third consecutive failure trips it
    board.record_failure("stats", "torch", "boom")
    assert not board.allow("stats", "torch")
    assert board.snapshot()["stats|torch"]["state"] == "open"
    # backoff not elapsed: stays open, fallbacks counted
    clk.t = 4.9
    assert not board.allow("stats", "torch")
    # backoff elapsed: exactly one half-open probe is granted
    clk.t = 5.1
    assert board.allow("stats", "torch")
    assert board.snapshot()["stats|torch"]["state"] == "half_open"
    assert not board.allow("stats", "torch")  # no second probe
    # probe success closes the breaker
    board.record_success("stats", "torch")
    assert board.snapshot()["stats|torch"]["state"] == "closed"
    assert board.allow("stats", "torch")


def test_breaker_probe_failure_doubles_backoff():
    clk = _FakeClock()
    board = BK.BreakerBoard(failure_threshold=2, backoff_s=1.0, clock=clk)
    board.record_failure("join", "torch")
    board.record_failure("join", "torch")  # trip #1: backoff 1s
    clk.t = 1.5
    assert board.allow("join", "torch")  # half-open probe
    board.record_failure("join", "torch")  # probe fails: re-open, backoff 2s
    clk.t = 3.0
    assert not board.allow("join", "torch")  # 1.5 + 2.0 = 3.5 not reached
    clk.t = 3.6
    assert board.allow("join", "torch")
    board.record_success("join", "torch")
    assert board.is_closed("join", "torch")


def test_breaker_success_resets_consecutive_count():
    board = BK.BreakerBoard(failure_threshold=3)
    for _ in range(2):
        board.record_failure("sort", "torch")
    board.record_success("sort", "torch")
    for _ in range(2):
        board.record_failure("sort", "torch")
    assert board.is_closed("sort", "torch")  # never 3 *consecutive*


def _part(catalog, name="small"):
    spec = catalog.spec(name)
    return catalog.generate(name, 0, spec.nrows)


def test_guarded_dispatch_falls_back_to_numpy_and_trips_breaker(catalog):
    """Injected kernel failures: each dispatch individually falls back to the
    numpy reference (identical result, no exception), and after the breaker's
    threshold the kernel is skipped entirely (breaker_open fallbacks)."""
    part = _part(catalog)
    ref = B.partial_stats(part)
    plan = FaultPlan([FaultSpec("kernel", rate=1.0, ops=("stats",))], seed=0)
    with faults.scope(plan):
        for _ in range(5):
            out = BK.partial_stats(part, backend="torch", device="cpu")
            assert out == ref  # numpy-served: bit-identical to the reference
    snap = BK.breaker_board().snapshot()["stats|torch"]
    assert snap["state"] == "open"
    assert snap["failures"] == BK.breaker_board().failure_threshold
    assert snap["fallbacks"] >= 1  # post-trip dispatches skipped the kernel
    assert plan.total_fired() == snap["failures"]  # open breaker stops firing


def test_guarded_dispatch_recovers_after_faults_stop(catalog):
    part = _part(catalog)
    ref = B.partial_stats(part)
    board = BK.breaker_board()
    board.backoff_s = 0.0  # immediate half-open eligibility
    try:
        plan = FaultPlan(
            [FaultSpec("kernel", rate=1.0, ops=("stats",), max_fires=3)], seed=0
        )
        with faults.scope(plan):
            for _ in range(3):
                assert BK.partial_stats(part, backend="torch", device="cpu") == ref
            # faults exhausted: the next dispatch is the half-open probe, which
            # succeeds on the real kernel and closes the breaker
            out = BK.partial_stats(part, backend="torch", device="cpu")
        assert board.is_closed("stats", "torch")
        for k in ref:
            assert out[k].n == ref[k].n
            assert out[k].mean == pytest.approx(ref[k].mean, rel=1e-4)
    finally:
        board.backoff_s = 5.0


def test_contained_runtime_error_on_cpu_falls_back_and_trips(catalog, monkeypatch):
    """On the CPU a dispatch error that is no injected fault is contained
    too: the dispatch is served by numpy, scored, and trips the breaker."""
    part = _part(catalog)
    ref = B.partial_stats(part)

    def broken(*a, **k):
        raise RuntimeError("kernel bug")

    monkeypatch.setattr(BK.ops, "masked_stats_batch", broken)
    for _ in range(4):
        BK.note_reset()
        assert BK.partial_stats(part, backend="torch", device="cpu") == ref
    assert BK.served_backend("torch") == ("numpy", "breaker_open")
    snap = BK.breaker_board().snapshot()["stats|torch"]
    assert snap["state"] == "open" and snap["failures"] == 3 and snap["fallbacks"] == 1
    assert "kernel bug" in snap["last_error"]


def test_batch_planner_declines_when_breaker_open(catalog):
    part = _part(catalog)
    board = BK.breaker_board()
    for _ in range(board.failure_threshold):
        board.record_failure("stats", "torch")
    assert BK.plan_stats_batch([part, part], backend="torch", device="cpu") is None
    BK.reset_breakers()
    assert BK.plan_stats_batch([part, part], backend="torch", device="cpu") is not None


def test_served_backend_labels_fallback(catalog):
    part = _part(catalog)
    plan = FaultPlan([FaultSpec("kernel", rate=1.0, max_fires=1)], seed=0)
    with faults.scope(plan):
        BK.note_reset()
        BK.partial_stats(part, backend="torch", device="cpu")
        assert BK.served_backend("torch") == ("numpy", "runtime_error")
        BK.note_reset()
        BK.partial_stats(part, backend="torch", device="cpu")  # fault exhausted
        assert BK.served_backend("torch") == ("torch", None)


# --------------------------------------------------------------------------- #
# engine crash isolation + quarantine (simulation mode: deterministic)         #
# --------------------------------------------------------------------------- #


@BACKENDS
def test_background_fault_is_absorbed_and_quarantined(catalog, bk):
    plan = FaultPlan([FaultSpec("exec.unit", rate=1.0, max_fires=1)], seed=0)
    s = _session(catalog, bk, mode="sim", fault_plan=plan)
    eng = s.engine
    b = _synth(eng, 2.0, tag="b")
    eng.think(5.0)
    assert b.nid not in eng.cache
    assert eng.metrics.n_background_faults == 1
    assert eng.metrics.quarantines == 1
    rec = eng.metrics.background_faults[0]
    assert rec.nid == b.nid and rec.kind == "InjectedFault"
    # quarantined for the backoff window (the fault fired at t=0)
    assert eng.scheduler.is_quarantined(b.nid, now=0.25)
    assert not eng.scheduler.is_quarantined(b.nid, now=eng.clock.now())
    # the clock is now past the backoff and the plan is exhausted: the retry
    # succeeds and clears the quarantine
    eng.think(5.0)
    assert b.nid in eng.cache
    assert not eng.scheduler.is_quarantined(b.nid)
    assert eng.scheduler.quarantine_summary() == {}


@CORES
def test_quarantine_backoff_is_exponential_then_permanent(core):
    eng = core.Engine(mode="sim")
    sched = eng.scheduler
    e1 = sched.quarantine(7, now=100.0)
    assert e1.until == pytest.approx(100.0 + sched.quarantine_base_s)
    e2 = sched.quarantine(7, now=101.0)
    assert e2.until == pytest.approx(101.0 + 2 * sched.quarantine_base_s)
    for _ in range(sched.quarantine_max_failures):
        entry = sched.quarantine(7, now=102.0)
    assert entry.until == float("inf")
    assert sched.is_quarantined(7)  # permanent: holds without a clock
    sched.clear_quarantine(7)
    assert not sched.is_quarantined(7)


@BACKENDS
def test_pick_skips_quarantined_and_matches_reference_oracle(catalog, bk):
    s = _session(catalog, bk, mode="sim")
    eng = s.engine
    a = _synth(eng, 3.0, tag="a")
    _synth(eng, 1.0, tag="b")
    _synth(eng, 2.0, parents=[a], tag="c")
    now = eng.clock.now()
    baseline = eng.scheduler.pick(eng.cache.executed_ids(), now=now)
    eng.scheduler.quarantine(baseline.nid, now, error="test")
    for t in (now, now + 10.0):
        got = eng.scheduler.pick(eng.cache.executed_ids(), now=t)
        oracle = eng.scheduler.reference_pick(eng.cache.executed_ids(), now=t)
        assert (got is None) == (oracle is None)
        if got is not None:
            assert got.nid == oracle.nid
    # inside the backoff window a different node is served
    inside = eng.scheduler.pick(eng.cache.executed_ids(), now=now)
    assert inside is not None and inside.nid != baseline.nid
    # after the backoff expires the original choice returns
    after = eng.scheduler.pick(eng.cache.executed_ids(), now=now + 10.0)
    assert after.nid == baseline.nid


@BACKENDS
def test_drain_returns_with_quarantined_nodes_unexecuted(catalog, bk):
    plan = FaultPlan([FaultSpec("exec.unit", rate=1.0)], seed=0)  # always fail
    s = _session(catalog, bk, mode="sim", fault_plan=plan)
    eng = s.engine
    b = _synth(eng, 1.0, tag="b")
    n = eng.drain_background()  # must terminate, not spin on the fault domain
    assert n == 0
    assert b.nid not in eng.cache
    assert eng.metrics.n_background_faults >= 1


def _drive(s):
    df = s.read_table("small")
    flt = df[df["x"] > 3.0]
    s.think(4.0)
    srt = flt.sort_values("x")
    s.think(4.0)
    out1 = s.show(srt.head(10))
    out2 = s.show(df["k"].value_counts())
    out3 = s.show(df.groupby("k").agg({"x": "mean", "y": "sum"}))
    return out1.concat(), out2.concat(), out3.concat()


def _same_partitions(got, ref):
    for fp, cp in zip(got, ref):
        assert fp.order == cp.order
        for name in fp.order:
            fa = fp.columns[name].to_numpy()
            ca = cp.columns[name].to_numpy()
            equal_nan = fa.dtype.kind == "f"  # nulls render as NaN
            assert np.array_equal(fa, ca, equal_nan=equal_nan), name


@BACKENDS
def test_interactive_results_identical_under_background_faults(catalog, bk):
    """Graceful degradation at a 100% background unit-failure rate: every
    user-visible result is bit-identical to the fault-free session."""
    plan = FaultPlan([FaultSpec("exec.unit", rate=1.0)], seed=1)
    faulty = _session(catalog, bk, mode="sim", fault_plan=plan)
    clean = _session(catalog, bk, mode="sim")
    _same_partitions(_drive(faulty), _drive(clean))
    assert faulty.engine.metrics.n_background_faults >= 1  # faults did fire


def test_background_kernel_faults_stay_within_parity(catalog):
    """Kernel faults on half the torch dispatches in think time: the faulted
    dispatches are served by numpy (float64), so the answers are held to the
    parity tolerances of a numpy session's (rtol 2e-3, atol 1e-5; exact on
    rows and counts), and the breaker board shows the failures."""
    plan = FaultPlan([FaultSpec("kernel", mode="raise", rate=0.5, background_only=True)],
                     seed=3)
    faulty = _session(catalog, "torch", mode="sim", fault_plan=plan)
    ref = _session(catalog, "numpy", mode="sim")
    got, want = _drive(faulty), _drive(ref)
    for fp, cp in zip(got, want):
        assert fp.order == cp.order
        for name in fp.order:
            fa, ca = fp.columns[name].to_numpy(), cp.columns[name].to_numpy()
            if fa.dtype.kind in "OU":
                np.testing.assert_array_equal(fa, ca, err_msg=name)
            else:
                np.testing.assert_allclose(fa.astype(np.float64), ca.astype(np.float64),
                                           rtol=2e-3, atol=1e-5, err_msg=name)
    snap = BK.breaker_board().snapshot()
    assert plan.total_fired() >= 1
    assert sum(st["failures"] for k, st in snap.items() if k.endswith("|torch")) >= 1


@BACKENDS
def test_corrupted_cache_put_never_reaches_user(catalog, bk):
    plan = FaultPlan([FaultSpec("cache.put", mode="corrupt", rate=1.0, max_fires=1)], seed=0)
    s = _session(catalog, bk, mode="sim", fault_plan=plan)
    clean = _session(catalog, bk, mode="sim")
    df = s.read_table("small")
    s.think(5.0)  # background materialises the read; the put is poisoned
    assert s.engine.cache.drop  # cache reachable (sanity)
    out = s.show(df.describe())
    dfc = clean.read_table("small")
    ref = clean.show(dfc.describe())
    assert s.engine.metrics.corrupt_results_dropped >= 1
    a, b = out.concat(), ref.concat()
    for name in a.order:
        assert np.array_equal(
            a.columns[name].to_numpy(), b.columns[name].to_numpy()
        ), name


@BACKENDS
def test_corrupted_background_input_is_dropped_for_recompute(catalog, bk):
    plan = FaultPlan(
        [FaultSpec("cache.get", mode="corrupt", rate=1.0, max_fires=1)], seed=0
    )
    s = _session(catalog, bk, mode="sim", fault_plan=plan)
    eng = s.engine
    df = s.read_table("small")
    flt = df[df["x"] > 3.0]
    s.think(60.0)  # read materialises; the filter's input fetch hits the
    # corrupt read, drops the parent, and both eventually recompute
    out = s.show(flt.head(5))
    assert out.nrows == 5
    assert eng.metrics.corrupt_results_dropped >= 1


# --------------------------------------------------------------------------- #
# real-mode worker: survival + stall watchdog                                  #
# --------------------------------------------------------------------------- #


@BACKENDS
def test_worker_survives_injected_faults(catalog, bk):
    plan = FaultPlan([FaultSpec("exec.unit", rate=1.0, max_fires=2)], seed=0)
    s = _session(catalog, bk, mode="real", fault_plan=plan)
    eng = s.engine
    eng.scheduler.quarantine_base_s = 0.01  # fast retries for the test
    df = s.read_table("small")
    desc = df.describe()
    eng.start_background()
    try:
        deadline = time.time() + 30
        while desc.node.nid not in eng.cache and time.time() < deadline:
            eng.nudge_background()
            time.sleep(0.02)
        assert eng._worker.alive  # the loop survived the faults
        assert desc.node.nid in eng.cache  # and finished the work
        assert eng.metrics.n_background_faults >= 1
    finally:
        eng.stop_background()


@BACKENDS
def test_pause_ack_timeout_records_worker_stall(catalog, bk):
    from repro_torch.core.engine import _BackgroundWorker

    s = _session(catalog, bk, mode="real", worker_ack_timeout_s=0.05)
    eng = s.engine
    worker = _BackgroundWorker(eng)  # never started: the ack cannot arrive
    t0 = time.monotonic()
    assert worker.pause() is False
    assert time.monotonic() - t0 < 5.0  # bounded wait, not forever
    assert eng.metrics.worker_stalls == 1


@BACKENDS
def test_stop_join_timeout_records_worker_stall(catalog, bk, monkeypatch):
    from repro_torch.core.engine import _BackgroundWorker

    monkeypatch.setattr(_BackgroundWorker, "STOP_JOIN_TIMEOUT_S", 0.05)
    plan = FaultPlan(
        [FaultSpec("exec.unit", mode="hang", rate=1.0, latency_s=1.5, max_fires=1)],
        seed=0,
    )
    s = _session(catalog, bk, mode="real", fault_plan=plan)
    eng = s.engine
    s.read_table("small").describe()  # background work for the worker
    eng.start_background()
    try:
        deadline = time.time() + 10
        while plan.total_fired() < 1 and time.time() < deadline:
            eng.nudge_background()
            time.sleep(0.01)
        assert plan.total_fired() >= 1  # a unit is mid-hang right now
        worker = eng._worker
        assert worker.stop() is False  # join timed out on the stalled unit
        assert eng.metrics.worker_stalls >= 1
    finally:
        eng._worker = None  # the daemon thread drains on its own


# --------------------------------------------------------------------------- #
# cost model persistence hardening (core: both packages)                       #
# --------------------------------------------------------------------------- #


@CORES
def test_costmodel_load_tolerates_corruption(core, tmp_path):
    cm = core.CostModel()
    path = tmp_path / "costs.json"
    path.write_text("{ not json !!!")
    assert cm.load(str(path)) is False
    path.write_text(json.dumps({"unit_costs": {"stats|torch": "NaN-ish"}}))
    assert cm.load(str(path)) is False  # bad value type
    assert cm.load(str(tmp_path / "missing.json")) is False


@CORES
def test_costmodel_save_is_atomic_and_cleans_up(core, tmp_path, monkeypatch):
    cm = core.CostModel()
    cm.add_sample("stats", "torch", 1000, 0.01)
    cm.calibrate()
    path = str(tmp_path / "costs.json")
    cm.save(path)
    cm2 = core.CostModel()
    assert cm2.load(path) is True
    assert cm2.unit_cost("stats", "torch") == pytest.approx(
        cm.unit_cost("stats", "torch")
    )
    # a failed save must leave no temp litter and must not clobber the file
    cmod = importlib.import_module(core.__name__ + ".costmodel")

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(cmod.json, "dump", boom)
    with pytest.raises(OSError):
        cm.save(path)
    assert os.path.exists(path)  # previous good file intact
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []
    monkeypatch.undo()
    cm3 = core.CostModel()
    assert cm3.load(path) is True  # still loadable
