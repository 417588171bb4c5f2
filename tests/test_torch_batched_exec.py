"""Batched background execution in the port, test for test beside the JAX
package's ``tests/test_batched_exec.py``: UnitBatch preemption / resume
semantics, batched == unbatched bit for bit through the port's frame
runtime (``torch`` on the CPU, and ``numpy``), the incremental scheduler
against its brute-force oracle, and cost-model persistence.

The executor, scheduler and cost model are ``core``, byte-identical in both
packages, so their tests run over both, one parametrised case each.
"""
import importlib
import random

import pytest

import repro.core as RC
import repro_torch.core as TC
from repro_torch.frame import Catalog, ColSpec, Session, TableSpec
from repro_torch.frame.partitioner import uniform_partitions
from repro_torch.frame.table import pydict_equal

CORES = pytest.mark.parametrize("core", [RC, TC], ids=["repro", "repro_torch"])


def _mod(core, name):
    return importlib.import_module(f"{core.__name__}.{name}")


# --------------------------------------------------------------------------- #
# a fully controllable batched operator                                        #
# --------------------------------------------------------------------------- #


def _install_batched_op(core, engine, n_units=10, unit_cost=1.0, calls=None,
                        on_dispatch=None):
    ex = _mod(core, "executor")
    calls = calls if calls is not None else {}
    calls.setdefault("unit", 0)
    calls.setdefault("dispatch", 0)

    def units(node, inputs):
        def run_unit(i):
            calls["unit"] += 1
            return i * 10

        return [
            ex.Unit(fn=(lambda i=i: run_unit(i)), cost_s=unit_cost, tag=f"u{i}")
            for i in range(n_units)
        ]

    def make_batches(node, inputs, units_, indices, k):
        batches = []
        for a in range(0, len(indices), k):
            chunk = list(indices[a:a + k])

            def disp(c=chunk):
                calls["dispatch"] += 1
                if on_dispatch is not None:
                    on_dispatch(calls["dispatch"])
                return [j * 10 for j in c]

            batches.append(
                ex.UnitBatch(
                    indices=chunk, dispatch=disp, finalize=lambda h: h,
                    cost_s=unit_cost * len(chunk), tag=f"b{a}",
                )
            )
        return batches

    engine.register_op(
        "batched_synth",
        ex.OpRuntime(units=units, combine=lambda n, i, r: sum(r),
                     make_batches=make_batches),
    )
    return calls


@CORES
def test_batch_size_from_budget(core):
    ex = _mod(core, "executor")
    units = [ex.Unit(fn=lambda: None, cost_s=0.5) for _ in range(10)]
    missing = list(range(10))
    assert ex.Executor._batch_size(units, missing, 2.0) == 4
    assert ex.Executor._batch_size(units, missing, 0.1) == 1  # never below 1
    # capped at len(missing), then floored to a power of two (shape reuse)
    assert ex.Executor._batch_size(units, missing, 100.0) == 8
    assert ex.Executor._batch_size(units, missing, 3.5) == 4  # 7 → pow2 floor
    zero = [ex.Unit(fn=lambda: None, cost_s=0.0) for _ in range(4)]
    assert ex.Executor._batch_size(zero, [0, 1, 2, 3], 1.0) == 4


@CORES
def test_midbatch_preemption_loses_at_most_one_batch_and_resumes(core):
    eng = core.Engine(mode="sim", batch_loss_frac=0.5)  # budget 3s → k = 3 → pow2 2
    calls = _install_batched_op(core, eng, n_units=10, unit_cost=1.0)
    node = eng.add("batched_synth", kwargs={"cost_s": 10.0})
    eng.think(5.0)
    # batches [0,1] and [2,3] fit (spent 4); batch [4,5] would straddle the
    # arrival: exactly that one batch is lost, completed slots checkpointed
    assert eng.executor.stats.units_preempted_lost == 2
    prog = eng.partials[node.nid]
    assert sorted(prog.results) == [0, 1, 2, 3]
    assert eng.executor.stats.units_run == 4
    # resume: the remaining units complete without recomputing a slot
    eng.think(20.0)
    assert node.nid in eng.cache
    assert eng.cache.get(node) == sum(i * 10 for i in range(10))
    assert eng.executor.stats.units_run == 10  # no slot ran twice
    assert calls["unit"] == 0  # everything rode batches


@CORES
def test_real_mode_preempt_harvests_inflight_batch(core):
    eng = core.Engine(mode="real", batch_loss_frac=0.5)
    flag = {"stop": False}

    def stop_after_first(dispatch_no):
        if dispatch_no == 1:
            flag["stop"] = True

    _install_batched_op(core, eng, n_units=9, unit_cost=1.0, on_dispatch=stop_after_first)
    node = eng.add("batched_synth", kwargs={"cost_s": 9.0})
    with pytest.raises(core.Preempted):
        eng.executor.execute(
            node, [], eng.partials, preempt_check=lambda: flag["stop"],
            batch_budget_s=3.0,  # k = 3 → pow2-quantised to 2
        )
    # the dispatched batch was harvested, not thrown away
    prog = eng.partials[node.nid]
    assert sorted(prog.results) == [0, 1]
    assert eng.executor.stats.units_run == 2
    flag["stop"] = False
    value = eng.executor.execute(
        node, [], eng.partials, preempt_check=lambda: flag["stop"],
        batch_budget_s=3.0,
    )
    assert value == sum(i * 10 for i in range(9))
    assert eng.executor.stats.units_run == 9  # resumed, never recomputed


@pytest.mark.parametrize("bk", ["numpy", "torch"])
def test_unbatchable_op_unchanged_unit_semantics(bk):
    """Ops without make_batches keep the paper's one-unit preemption, with
    the port's frame runtime installed."""
    from repro_torch.core import Engine
    from repro_torch.frame.runtime import install

    eng = Engine(mode="sim", kernel_backend=bk)
    node = eng.add(
        "synthetic", kwargs={"cost_s": 10.0, "n_units": 10, "tag": "b"}
    )
    install(eng, Catalog(), device="cpu" if bk == "torch" else None)
    eng.think(3.5)
    assert eng.executor.stats.units_preempted_lost == 1
    assert len(eng.partials[node.nid].results) == 3


# --------------------------------------------------------------------------- #
# frame-layer parity: batched == unbatched, bit for bit                        #
# --------------------------------------------------------------------------- #


def _batch_session(batching: bool, bk: str = "torch"):
    cat = Catalog()
    cat.register(
        TableSpec(
            "t", nrows=32_000,
            cols=(
                ColSpec("x", low=0.0, high=10.0),
                ColSpec("y", null_frac=0.2),
                ColSpec("k", kind="cat", n_categories=7),
            ),
            io_seconds=2.0, seed=7,
        )
    )
    s = Session(catalog=cat, mode="sim", kernel_backend=bk,
                device="cpu" if bk == "torch" else None, batching=batching)
    df = s.read_table("t")
    df.node.kwargs = dict(df.node.kwargs)
    df.node.kwargs["partition_bounds"] = uniform_partitions(32_000, 8)
    nodes = [
        df.describe().node,
        df.groupby("k").agg({"x": "mean", "y": "sum"}).node,
        df["k"].value_counts().node,
        df[df["x"] > 5.0].node,
        df.dropna().node,
        df.sort_values("x").node,
        df.sort_values("y", ascending=False).node,
        s.engine.add(
            "sort_values", parents=[df.node],
            kwargs={"by": "x", "ascending": False, "limit": 16},
            est_rows=df.node.est_rows,
        ),
    ]
    s.think(1000.0)
    s.drain()
    return s, nodes


@pytest.mark.parametrize("bk", ["numpy", "torch"])
def test_batched_results_bit_for_bit_across_partitionwise_ops(bk):
    s_b, nodes_b = _batch_session(batching=True, bk=bk)
    s_u, nodes_u = _batch_session(batching=False, bk=bk)
    stats = s_b.engine.executor.stats
    if bk == "torch":  # numpy dispatches have no batched lowering
        assert stats.batches_run > 0 and stats.units_batched > 0
    assert s_u.engine.executor.stats.units_batched == 0
    # identical unit accounting and virtual-clock time either way
    assert stats.units_run == s_u.engine.executor.stats.units_run
    assert s_b.engine.clock.now() == pytest.approx(s_u.engine.clock.now())
    for nb, nu in zip(nodes_b, nodes_u):
        vb = s_b.engine.value_of(nb)
        vu = s_u.engine.value_of(nu)
        assert pydict_equal(vb.to_pydict(), vu.to_pydict()), nb.label


# --------------------------------------------------------------------------- #
# incremental scheduler ≡ brute force                                          #
# --------------------------------------------------------------------------- #


@CORES
def test_incremental_scheduler_matches_bruteforce_under_evictions(core):
    """Delta-maintained memos vs the memo-free oracle, with eviction events
    and cost-model drift (EWMA observations between picks) interleaved."""
    rng = random.Random(3)
    for trial in range(3):
        d = core.DAG()
        nodes = []
        for i in range(40):
            k = rng.randint(0, min(3, len(nodes)))
            parents = rng.sample(nodes, k) if k else []
            nodes.append(
                d.add("synthetic", parents,
                      kwargs={"cost_s": rng.uniform(0.1, 5.0),
                              "tag": f"n{trial}_{i}"})
            )
        # some nodes carry no explicit cost: their estimates drift as the
        # EWMA observes executions, which must invalidate the memos too
        drifty = [
            d.add("synthetic", [nodes[j]], kwargs={"tag": f"drift{trial}_{j}"})
            for j in range(0, 40, 8)
        ]
        cm = core.CostModel()
        sched = core.Scheduler(dag=d, cost_model=cm, policy="utility")
        done: set = set()
        for _ in range(300):
            p_new = sched.pick(done)
            p_ref = sched.reference_pick(done)
            assert (p_new is None) == (p_ref is None)
            if p_new is None:
                break
            assert p_new.nid == p_ref.nid
            done.add(p_new.nid)
            if rng.random() < 0.3 and done:  # eviction event
                victim = rng.choice(sorted(done))
                done.discard(victim)
                sched.evicted_once.add(victim)
            if rng.random() < 0.4:  # cost-model drift between picks
                cm.observe(rng.choice(drifty), rng.uniform(0.01, 2.0))


@CORES
def test_evicted_source_demand_memo_tracks_new_descendants(core):
    d = core.DAG()
    r = d.add("synthetic", kwargs={"cost_s": 1.0, "tag": "r"})
    a = d.add("synthetic", [r], kwargs={"cost_s": 1.0, "tag": "a"})
    s = core.Scheduler(dag=d, cost_model=core.CostModel())
    done = {r.nid, a.nid}
    # r evicted with every descendant executed: no demand, skipped (twice, so
    # the second call hits the memo)
    done.discard(r.nid)
    s.evicted_once.add(r.nid)
    assert s.pick(done) is None
    assert s.pick(done) is None
    # a new unexecuted descendant restores demand (structure change clears)
    d.add("synthetic", [r], kwargs={"cost_s": 1.0, "tag": "b"})
    assert s.pick(done).nid == r.nid


@CORES
def test_plan_matches_repeated_pick(core):
    d = core.DAG()
    r = d.add("synthetic", kwargs={"cost_s": 1.0, "tag": "pr"})
    a = d.add("synthetic", [r], kwargs={"cost_s": 10.0, "tag": "pa"})
    b = d.add("synthetic", [a], kwargs={"cost_s": 1.0, "tag": "pb"})
    c = d.add("synthetic", [r], kwargs={"cost_s": 2.0, "tag": "pc"})
    s = core.Scheduler(dag=d, cost_model=core.CostModel())
    order = [n.nid for n in s.plan(set())]
    # r first (only source); then a (U=21 beats c's 2); then c (U=2 beats b's 1)
    assert order == [r.nid, a.nid, c.nid, b.nid]


# --------------------------------------------------------------------------- #
# cost model persistence + auto recalibration                                  #
# --------------------------------------------------------------------------- #


@CORES
def test_cost_model_save_load_roundtrip(core, tmp_path):
    cm = core.CostModel()
    cm.add_sample("describe", "torch", 1000, 0.002)
    cm.add_sample("describe", "torch", 2000, 0.004)
    cm.add_sample("groupby_agg", "numpy", 1000, 0.01)
    fitted = cm.calibrate()
    path = str(tmp_path / "costs.json")
    cm.save(path)
    fresh = core.CostModel()
    assert fresh.load(path)
    for key, cost in fitted.items():
        assert fresh.unit_cost(key[0], key[1]) == pytest.approx(cost)
    assert not core.CostModel().load(str(tmp_path / "missing.json"))


@CORES
def test_cost_model_auto_recalibrates_every_n_samples(core):
    cm = core.CostModel(auto_calibrate_every=3)
    for _ in range(2):
        cm.add_sample("describe", "torch", 1000, 0.002)
    assert ("describe", "torch") not in cm._backend_unit_cost
    cm.add_sample("describe", "torch", 1000, 0.002)  # 3rd sample triggers refit
    assert cm.unit_cost("describe", "torch") == pytest.approx(2e-6)


@CORES
def test_engine_persists_costs_across_sessions(core, tmp_path):
    path = str(tmp_path / "engine_costs.json")
    eng = core.Engine(mode="real", cost_model_path=path)
    assert eng.cost_model.auto_calibrate_every > 0  # real mode auto-refit
    eng.cost_model.add_sample("describe", "torch", 1000, 0.002)
    eng.save_cost_model()
    eng2 = core.Engine(mode="real", cost_model_path=path)
    assert eng2.cost_model.unit_cost("describe", "torch") == pytest.approx(2e-6)


def test_session_costs_persist_across_port_sessions(tmp_path):
    """The same persistence through the port's frame runtime: a torch
    session's measured samples, saved, calibrate the next session."""
    path = str(tmp_path / "costs.json")
    s, _ = _batch_session(batching=True)
    s.engine.cost_model_path = path
    s.engine.save_cost_model()
    cm = s.engine.cost_model
    assert cm.has_calibration("describe", "torch")
    s2 = Session(catalog=Catalog(), mode="sim", kernel_backend="torch", device="cpu",
                 cost_model_path=path)
    assert s2.engine.cost_model.unit_cost("describe", "torch") == pytest.approx(
        cm.unit_cost("describe", "torch"))


def _ref_batch_session(batching: bool):
    """The same program through the JAX package (``xla``)."""
    import repro.frame as R
    from repro.frame.partitioner import uniform_partitions as r_uniform

    cat = R.Catalog()
    cat.register(R.TableSpec("t", nrows=32_000, io_seconds=2.0, seed=7, cols=(
        R.ColSpec("x", low=0.0, high=10.0), R.ColSpec("y", null_frac=0.2),
        R.ColSpec("k", kind="cat", n_categories=7))))
    s = R.Session(catalog=cat, mode="sim", kernel_backend="xla", batching=batching)
    df = s.read_table("t")
    df.node.kwargs = dict(df.node.kwargs)
    df.node.kwargs["partition_bounds"] = r_uniform(32_000, 8)
    nodes = [
        df.describe().node,
        df.groupby("k").agg({"x": "mean", "y": "sum"}).node,
        df["k"].value_counts().node,
        df[df["x"] > 5.0].node,
        df.dropna().node,
        df.sort_values("x").node,
        df.sort_values("y", ascending=False).node,
        s.engine.add("sort_values", parents=[df.node],
                     kwargs={"by": "x", "ascending": False, "limit": 16},
                     est_rows=df.node.est_rows),
    ]
    s.think(1000.0)
    s.drain()
    return s, nodes


def test_batched_results_match_the_reference_package():
    """The batched port (``torch``) against the batched JAX package
    (``xla``) on the same program: floats within rtol 2e-3 / atol 1e-5,
    strings, row selections and orders exact; the same plan order."""
    import numpy as np

    s_t, nodes_t = _batch_session(batching=True)
    s_r, nodes_r = _ref_batch_session(batching=True)
    assert s_t.engine.executor.stats.units_run == s_r.engine.executor.stats.units_run
    for nt, nr in zip(nodes_t, nodes_r):
        got = s_t.engine.value_of(nt).to_pydict()
        want = s_r.engine.value_of(nr).to_pydict()
        assert list(got) == list(want), nt.label
        for col in want:
            g, w = np.asarray(got[col]), np.asarray(want[col])
            assert g.shape == w.shape, (nt.label, col)
            if w.dtype.kind in "OU":
                np.testing.assert_array_equal(g, w, err_msg=f"{nt.label}/{col}")
            else:
                np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                           rtol=2e-3, atol=1e-5, err_msg=f"{nt.label}/{col}")
        if nt.op in ("filter_cmp", "dropna", "sort_values"):  # rows moved, not summed
            assert pydict_equal(got, want), nt.label


def test_plan_order_matches_the_reference_package():
    """The same DAG in both packages: the same ``reference_pick`` order."""
    def order(s):
        sched, done, out = s.engine.scheduler, set(), []
        while (nxt := sched.reference_pick(done)) is not None:
            out.append((nxt.op, nxt.label))
            done.add(nxt.nid)
        return out

    import repro.frame as R
    import repro_torch.frame as T
    from repro.frame.partitioner import uniform_partitions as r_uniform

    def program(pkg, uni, **kw):
        cat = pkg.Catalog()
        cat.register(pkg.TableSpec("t", nrows=32_000, io_seconds=2.0, seed=7, cols=(
            pkg.ColSpec("x", low=0.0, high=10.0), pkg.ColSpec("y", null_frac=0.2),
            pkg.ColSpec("k", kind="cat", n_categories=7))))
        s = pkg.Session(catalog=cat, mode="sim", **kw)
        df = s.read_table("t")
        df.node.kwargs = dict(df.node.kwargs)
        df.node.kwargs["partition_bounds"] = uni(32_000, 8)
        df.describe()
        df.groupby("k").agg({"x": "mean", "y": "sum"})
        df["k"].value_counts()
        df[df["x"] > 5.0].describe()
        df.sort_values("x").head(5)
        return s

    ref = order(program(R, r_uniform, kernel_backend="xla"))
    got = order(program(T, uniform_partitions, kernel_backend="torch", device="cpu"))
    assert got == ref and len(ref) > 5
