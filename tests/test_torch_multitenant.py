"""Multi-tenant serving through both packages: ``repro_torch.serve.multitenant``
is the reference module carried over as it is, over the port's ``core``.
The programs of ``tests/test_multitenant.py`` run through each package, and
the dedup counts, schedule logs, ``stats()`` and tenant-scoped quarantine
must agree; the same seeded trace must give the same
``schedule_fingerprint`` in both."""
import importlib
import json
from types import SimpleNamespace

import pytest

PACKAGES = ("repro", "repro_torch")


def _pkg(name: str) -> SimpleNamespace:
    mods = {m: importlib.import_module(f"{name}.{m}") for m in (
        "core", "core.costmodel", "core.executor", "core.predictor", "core.scheduler",
        "data.synth", "serve", "serve.multitenant")}
    mt = mods["serve.multitenant"]
    return SimpleNamespace(
        DAG=mods["core"].DAG, Engine=mods["core"].Engine,
        intern_program=mods["core"].intern_program, CostModel=mods["core.costmodel"].CostModel,
        OpRuntime=mods["core.executor"].OpRuntime, Unit=mods["core.executor"].Unit,
        InteractionPredictor=mods["core.predictor"].InteractionPredictor,
        Scheduler=mods["core.scheduler"].Scheduler,
        TraceSpec=mods["data.synth"].TraceSpec, poisson_trace=mods["data.synth"].poisson_trace,
        MultiTenantServer=mods["serve"].MultiTenantServer,
        TenantProgram=mods["serve"].TenantProgram,
        register_synthetic_op=mt.register_synthetic_op,
        synthetic_trace_program=mt.synthetic_trace_program)


def _engine(p, **kw):
    eng = p.Engine(mode="sim", budget_bytes=1 << 20, speculation=False, **kw)
    p.register_synthetic_op(eng)
    return eng


def _both(fn, *args):
    """``fn`` run through each package → (reference's result, port's)."""
    return tuple(fn(_pkg(name), *args) for name in PACKAGES)


def test_port_serve_exports_multitenant():
    from repro_torch.serve import MultiTenantServer, TenantProgram
    from repro_torch.serve import multitenant

    assert MultiTenantServer is multitenant.MultiTenantServer
    assert TenantProgram is multitenant.TenantProgram
    assert multitenant.Engine.__module__ == "repro_torch.core.engine"


# --------------------------------------------------------------- cross-DAG CSE --
def _dedup(p):
    eng = _engine(p)
    srv = p.MultiTenantServer(eng)
    progs = []
    for tenant, (tpl, param, stages) in (("alice", (2, 0, 3)), ("bob", (2, 0, 3)),
                                         ("carol", (2, 1, 3)), ("alice", (5, 0, 4))):
        _, root = p.synthetic_trace_program(tpl, param, n_stages=stages)
        prog = srv.submit(tenant, [root])
        progs.append((prog.tenant, prog.roots[0].nid, prog.n_nodes, prog.n_new, prog.n_deduped))
    values = [srv.interact(t, eng.dag.nodes[nid]) for t, nid, *_ in progs]
    return progs, values, eng.executor.stats.nodes_completed, srv.dedup_rate(), len(eng.dag)


def test_dedup_counts_match_reference():
    ref, port = _both(_dedup)
    assert port == ref
    progs = port[0]
    assert progs[1][3] == 0 and progs[1][1] == progs[0][1]  # bob's program fully deduped
    assert 0 < progs[2][3] < progs[2][2]  # carol's shares only the source


@pytest.mark.parametrize("tpl,param,stages", [(0, 0, 1), (3, 2, 2), (7, 3, 4)])
def test_two_tenants_one_materialisation(tpl, param, stages):
    def run(p):
        eng = _engine(p)
        srv = p.MultiTenantServer(eng)
        _, r1 = p.synthetic_trace_program(tpl, param, n_stages=stages)
        _, r2 = p.synthetic_trace_program(tpl, param, n_stages=stages)
        p1, p2 = srv.submit("alice", [r1]), srv.submit("bob", [r2])
        va = srv.interact("alice", p1.roots[0])
        done = eng.executor.stats.nodes_completed
        vb = srv.interact("bob", p2.roots[0])
        assert eng.executor.stats.nodes_completed == done  # one materialisation
        iso = _engine(p)
        _, riso = p.synthetic_trace_program(tpl, param, n_stages=stages)
        miso, _ = p.intern_program(iso.dag, [riso])
        assert va == vb == iso.display(miso[riso.nid])
        return p2.n_new, p2.n_deduped, va, srv.dedup_rate()

    ref, port = _both(run)
    assert port == ref


# -------------------------------------------------------- cross-tenant Eq-1 --
def test_cross_tenant_pick_sequence_matches_reference():
    def run(p):
        eng = _engine(p)
        srv = p.MultiTenantServer(eng)
        for t, (tpl, param) in (("a", (0, 0)), ("b", (0, 0)), ("c", (5, 2))):
            _, r = p.synthetic_trace_program(tpl, param)
            srv.submit(t, [r])
        done, order = set(), []
        while True:
            nxt = eng.scheduler.pick(done, tenant="a")
            ref = eng.scheduler.reference_pick(done, tenant="a")
            assert (nxt is None) == (ref is None)
            if nxt is None:
                return order
            assert nxt.nid == ref.nid
            done.add(nxt.nid)
            order.append(nxt.nid)

    ref, port = _both(run)
    assert port == ref and port


def test_cross_tenant_utility_weights_shared_demand():
    def run(p):
        d = p.DAG()
        s = d.add("synthetic", kwargs={"cost_s": 3.0, "tag": "S"})
        x = d.add("synthetic", kwargs={"cost_s": 4.0, "tag": "X"})
        sched = p.Scheduler(dag=d, cost_model=p.CostModel())
        picks = [sched.pick(set()).nid]
        sched.set_tenant_demand("a", {s.nid, x.nid})
        sched.set_tenant_demand("b", {s.nid})
        picks.append(sched.pick(set()).nid)
        sched.tenant_weight["a"] = 10.0
        picks.append(sched.pick(set()).nid)
        assert picks == [x.nid, s.nid, x.nid]
        return picks

    ref, port = _both(run)
    assert port == ref


def test_think_window_serves_other_tenants_demand():
    def run(p):
        eng = _engine(p)
        srv = p.MultiTenantServer(eng)
        _, ra = p.synthetic_trace_program(1, 0)
        srv.submit("alice", [ra])
        _, rb = p.synthetic_trace_program(6, 3)
        pb = srv.submit("bob", [rb])
        report = srv.think("alice", 60.0)
        assert pb.roots[0].nid in eng.cache
        srv.interact("bob", pb.roots[0])
        rec = eng.metrics.interactions[-1]
        assert rec.tenant == "bob" and rec.latency_s == 0.0
        units = dict(eng.executor.stats.units_by_tenant)
        assert units.get("alice", 0) > 0 and "bob" not in units
        return units, sorted(report.items()) if isinstance(report, dict) else report

    ref, port = _both(run)
    assert port == ref


# ----------------------------------------------- (tenant, node) quarantine --
def test_quarantine_scoped_to_tenant():
    def run(p):
        d = p.DAG()
        s = d.add("synthetic", kwargs={"cost_s": 3.0, "tag": "S"})
        x = d.add("synthetic", kwargs={"cost_s": 4.0, "tag": "X"})
        sched = p.Scheduler(dag=d, cost_model=p.CostModel())
        sched.quarantine(x.nid, now=0.0, error="boom", tenant="a")
        seen = [sched.is_quarantined(x.nid, now=0.1, tenant="a"),
                sched.is_quarantined(x.nid, now=0.1, tenant="b"),
                sched.is_quarantined(x.nid, now=0.1),
                sched.pick(set(), now=0.1, tenant="a").nid,
                sched.pick(set(), now=0.1, tenant="b").nid]
        sched.quarantine(s.nid, now=0.0, error="boom")
        seen.append(sched.is_quarantined(s.nid, now=0.1, tenant="b"))
        summary = sched.quarantine_summary()
        sched.clear_quarantine(x.nid)
        seen.append(sched.is_quarantined(x.nid, now=0.1, tenant="a"))
        assert seen == [True, False, False, s.nid, x.nid, True, False]
        return seen, summary, sched.quarantine_summary()

    ref, port = _both(run)
    assert port == ref


def test_one_tenants_fault_does_not_block_deduped_node():
    def run(p):
        eng = _engine(p)

        def units(node, inputs):
            def fail():
                raise RuntimeError("injected kernel fault")
            return [p.Unit(fn=fail, cost_s=0.1, tag="boom")]

        eng.register_op("boom", p.OpRuntime(units=units, combine=lambda n, i, r: 0))
        srv = p.MultiTenantServer(eng)
        roots = []
        for tenant in ("a", "b"):
            private = p.DAG()
            roots.append(srv.submit(tenant, [private.add("boom", kwargs={"cost_s": 0.1})]))
        nid = roots[0].roots[0].nid
        assert roots[1].roots[0].nid == nid
        srv.think("a", 5.0)
        after_a = (eng.metrics.quarantines, sorted(map(tuple, eng.scheduler.quarantined)))
        assert after_a[0] == 1 and ("a", nid) in after_a[1] and ("b", nid) not in after_a[1]
        srv.think("b", 5.0)
        assert eng.metrics.quarantines == 2 and ("b", nid) in eng.scheduler.quarantined
        return after_a, srv.stats()["quarantines"]

    ref, port = _both(run)
    assert port == ref


# -------------------------------------------------- trace-replay determinism --
def _replay(p, seed: int):
    """The shared-mode trace replay of ``tests/test_multitenant.py`` →
    (schedule fingerprint, latencies, stats())."""
    spec = p.TraceSpec(n_sessions=6, n_events_per_session=3, mean_think_s=2.0,
                       n_templates=6, seed=seed)
    events = p.poisson_trace(spec)
    eng = _engine(p)
    srv = p.MultiTenantServer(eng, record_schedule=True)
    per: dict = {}
    for e in events:
        per.setdefault(e.session, []).append(e)
    roots, idx = {}, {}
    for s, evs in per.items():
        _, r = p.synthetic_trace_program(evs[0].template, evs[0].param)
        roots[(s, 0)] = srv.submit(f"s{s}", [r]).roots[0]
    prev_at, prev_s = 0.0, None
    for e in events:
        gap = e.at - prev_at
        if gap > 0 and prev_s is not None:
            srv.think(f"s{prev_s}", gap)
        k = idx.get(e.session, 0)
        srv.interact(f"s{e.session}", roots[(e.session, k)])
        idx[e.session] = k + 1
        evs = per[e.session]
        if k + 1 < len(evs):
            _, r = p.synthetic_trace_program(evs[k + 1].template, evs[k + 1].param)
            roots[(e.session, k + 1)] = srv.submit(f"s{e.session}", [r]).roots[0]
        prev_at, prev_s = e.at, e.session
    return (srv.schedule_fingerprint(), [r.latency_s for r in eng.metrics.interactions],
            srv.stats())


@pytest.mark.parametrize("seed", [3, 4, 11])
def test_schedule_fingerprint_matches_reference(seed):
    (fp_ref, lat_ref, st_ref), (fp, lat, st) = _both(_replay, seed)
    assert fp == fp_ref  # byte-identical schedule log
    assert lat == lat_ref
    assert st == st_ref
    log = json.loads(fp)
    assert any(isinstance(e, int) for e in log)  # background picks were logged
    assert any(isinstance(e, list) and e[0] == "interact" for e in log)


def test_port_replay_deterministic_and_seed_driven():
    p = _pkg("repro_torch")
    fp1, lat1, _ = _replay(p, 3)
    fp2, lat2, _ = _replay(p, 3)
    assert fp1 == fp2 and lat1 == lat2
    assert _replay(p, 4)[0] != fp1


def test_stats_match_reference():
    def run(p):
        eng = _engine(p)
        srv = p.MultiTenantServer(eng)
        srv.register("w", weight=2.0)
        for tenant, (tpl, param) in (("t0", (0, 0)), ("t1", (0, 0)), ("t1", (4, 1))):
            _, r = p.synthetic_trace_program(tpl, param)
            srv.interact(tenant, srv.submit(tenant, [r]).roots[0])
        srv.think("w", 3.0)
        st = srv.stats()
        assert st["tenants"] == ["t0", "t1", "w"] and st["n_programs"] == 3
        assert st["per_tenant_interactions"]["t1"]["n_interactions"] == 2
        assert st["cache"]["tenant_bytes"]["t0"] > 0
        return st

    ref, port = _both(run)
    assert port == ref


def test_submit_feeds_predictor_like_reference():
    def run(p):
        pred = p.InteractionPredictor()
        eng = _engine(p, predictor=pred)
        srv = p.MultiTenantServer(eng)
        counts = []
        for tenant, (tpl, param) in (("alice", (1, 0)), ("bob", (1, 0)), ("alice", (2, 1))):
            _, root = p.synthetic_trace_program(tpl, param)
            srv.submit(tenant, [root])
            counts.append(sum(sum(c.values()) for c in pred._next_counts.values()))
        assert counts == [3, 3, 6]
        return counts

    ref, port = _both(run)
    assert port == ref
