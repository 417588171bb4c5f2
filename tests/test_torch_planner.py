"""The port's cost-based backend planner (``repro_torch.frame.planner``),
test for test beside the JAX package's ``tests/test_planner.py``.

The port ships no cold-start priors (the JAX package's are CPU bench
verdicts, which say nothing about an H100): every uncalibrated planned key
answers ``no_estimate`` and keeps the precedence chain.  The choice logic —
the affine fit, the dispatch overhead, the open breaker, demotion only,
"never estimated slower than numpy" and the fusion decision — is held here
with priors injected (``COLD_START_PRIORS`` monkeypatched) or with samples
injected (``CostModel.add_sample`` + ``calibrate``), on the ``torch``
kernel backend.  The cost model is ``core``, byte-identical in both
packages: its round trips run over both, one parametrised case each.
"""
import random

import numpy as np
import pytest

import repro.core as RC
import repro_torch.core as TC
from repro_torch.core import DAG, CostModel
from repro_torch.frame import Catalog, ColSpec, Session, TableSpec
from repro_torch.frame import backend as BK
from repro_torch.frame import planner as PL
from repro_torch.frame.planner import PLANNED_KEYS, Planner, planner_key

CORES = pytest.mark.parametrize("core", [RC, TC], ids=["repro", "repro_torch"])

# Priors for the tests that need them: the verdicts the JAX package's CPU
# bench encodes (value_counts, full sort, filter and join demoted; describe,
# groupby and top-k kept on the kernel backend at 1M rows), in the port's
# backend name, with a 5e-5 s dispatch overhead on the kernel side.
_OVH = 5e-5
PRIORS = {
    ("describe", "numpy"): (6e-8, 0.0), ("describe", "torch"): (2.5e-8, _OVH),
    ("groupby_agg", "numpy"): (2.2e-7, 0.0), ("groupby_agg", "torch"): (1.2e-7, _OVH),
    ("value_counts", "numpy"): (4.5e-9, 0.0), ("value_counts", "torch"): (4.8e-8, _OVH),
    ("filter", "numpy"): (4.9e-8, 0.0), ("filter", "torch"): (6.2e-7, _OVH),
    ("join", "numpy"): (1.2e-7, 0.0), ("join", "torch"): (1.45e-7, _OVH),
    ("sort_values:topk", "numpy"): (1.9e-7, 0.0), ("sort_values:topk", "torch"): (1.5e-8, _OVH),
    ("sort_values:full", "numpy"): (3.0e-7, 0.0), ("sort_values:full", "torch"): (1.5e-6, _OVH),
    ("fused:filter|describe", "torch"): (2.0e-8, _OVH),
    ("fused:filter|groupby_agg", "torch"): (5.3e-8, _OVH),
    ("fused:filter|sort_values:topk", "torch"): (1.6e-8, _OVH),
}


@pytest.fixture()
def priors(monkeypatch):
    monkeypatch.setattr(PL, "COLD_START_PRIORS", dict(PRIORS))
    return PRIORS


def _cat():
    cat = Catalog()
    cat.register(
        TableSpec(
            "t",
            nrows=5_000,
            cols=(
                ColSpec("x", low=0.0, high=10.0),
                ColSpec("k", kind="cat", n_categories=5),
            ),
            io_seconds=1.0,
            seed=3,
        )
    )
    return cat


def _session(**kw):
    return Session(catalog=_cat(), mode="sim", kernel_backend="torch", device="cpu", **kw)


# ------------------------------------------------------------- planning keys --
def test_planner_key_mapping():
    d = DAG()
    src = d.add("read_table", literals=["t"])
    assert planner_key(d.add("sort_values", parents=[src],
                             kwargs={"by": "x", "limit": 16})) == "sort_values:topk"
    assert planner_key(d.add("sort_values", parents=[src],
                             kwargs={"by": "x"})) == "sort_values:full"
    for op in ("filter", "filter_cmp", "isin", "between", "dropna"):
        assert planner_key(d.add(op, parents=[src], kwargs={"tag": op})) == "filter"
    assert planner_key(d.add("mean", parents=[src])) == "describe"
    assert planner_key(d.add("mean_scalar", parents=[src])) == "describe"
    assert planner_key(d.add("describe", parents=[src])) == "describe"
    assert planner_key(d.add("join", parents=[src], kwargs={"on": "k"})) == "join"


# ------------------------------------------------------------ affine fitting --
@CORES
def test_affine_fit_recovers_unit_cost_and_overhead(core):
    cm = core.CostModel()
    a_true, b_true = 1e-7, 5e-4
    for rows in (1e3, 1e4, 1e5, 1e6):
        cm.add_sample("describe", "torch", rows, a_true * rows + b_true)
    cm.calibrate()
    assert cm.has_calibration("describe", "torch")
    assert cm.unit_cost("describe", backend="torch") == pytest.approx(a_true, rel=1e-6)
    assert cm.overhead("describe", "torch") == pytest.approx(b_true, rel=1e-6)
    est = cm.estimate("describe", "torch", 50_000)
    assert est == pytest.approx(a_true * 50_000 + b_true, rel=1e-6)
    # uncalibrated keys estimate as None, never as free
    assert cm.estimate("describe", "numpy", 50_000) is None


@CORES
def test_affine_fit_degenerate_spread_goes_through_origin(core):
    cm = core.CostModel()
    for _ in range(5):  # one row count only: the affine system is singular
        cm.add_sample("filter", "numpy", 10_000, 1e-3)
    cm.calibrate()
    assert cm.unit_cost("filter", backend="numpy") == pytest.approx(1e-7, rel=1e-6)
    assert cm.overhead("filter", "numpy") == 0.0


# --------------------------------------------------------- cold-start default --
def test_cold_start_priors_are_empty_and_defer_to_precedence():
    """The port's default: no priors, so with zero samples every planned key
    answers ``no_estimate`` and keeps the precedence chain's backend (the
    JAX package's replaced test pinned its CPU bench verdicts here)."""
    assert PL.COLD_START_PRIORS == {}
    p = Planner(CostModel())
    for key in sorted(PLANNED_KEYS):
        assert p.estimate(key, "torch", 1e6) is None
        assert p.choose(key, 1_000_000, "torch") == "torch"
        assert p.choose(key, 1_000_000, "cuda") == "cuda"
    rep = p.cost_model.planner_report()
    assert rep == {f"{k}|{bk}|no_estimate": 1 for k in PLANNED_KEYS for bk in ("torch", "cuda")}
    # and nothing is fused blind
    assert p.choose_fusion("fused:filter|describe", "torch", 1e6, ["filter", "describe"]) is False
    # a session at the engine tier keeps its kernel backend for every key
    rt = _session().runtime
    for key in sorted(PLANNED_KEYS):
        assert rt._planned_backend(key, 1_000_000) == "torch"


def test_injected_priors_encode_their_verdicts(priors):
    """The choice logic on injected priors: the verdicts they encode at 1M
    rows come back, each recorded as an estimated decision."""
    p = Planner(CostModel())
    rows = 1_000_000
    assert p.choose("value_counts", rows, "torch") == "numpy"
    assert p.choose("sort_values:full", rows, "torch") == "numpy"
    assert p.choose("filter", rows, "torch") == "numpy"
    assert p.choose("describe", rows, "torch") == "torch"
    assert p.choose("groupby_agg", rows, "torch") == "torch"
    assert p.choose("sort_values:topk", rows, "torch") == "torch"
    assert p.choose("join", rows, "torch") == "numpy"
    rep = p.cost_model.planner_report()
    assert rep["value_counts|numpy|estimated"] == 1
    assert rep["describe|torch|estimated"] == 1


def test_calibration_overrides_priors(priors):
    """Measured samples beat the prior: if torch *measures* faster on
    value_counts, the planner stops demoting it."""
    cm = CostModel()
    for rows in (1e4, 1e5, 1e6):
        cm.add_sample("value_counts", "torch", rows, 1e-9 * rows)
        cm.add_sample("value_counts", "numpy", rows, 1e-7 * rows)
    cm.calibrate()
    assert Planner(cm).choose("value_counts", 1_000_000, "torch") == "torch"


def test_samples_alone_demote_without_priors():
    """No priors at all: injected samples are enough for the planner to
    demote a key the kernel backend measures slower on."""
    cm = CostModel()
    for rows in (1e4, 1e5, 1e6):
        cm.add_sample("value_counts", "torch", rows, 1e-7 * rows + 1e-4)
        cm.add_sample("value_counts", "numpy", rows, 1e-9 * rows)
    cm.calibrate()
    p = Planner(cm)
    assert p.choose("value_counts", 1_000_000, "torch") == "numpy"
    assert p.choose("describe", 1_000_000, "torch") == "torch"  # still uncalibrated
    rep = cm.planner_report()
    assert rep == {"value_counts|numpy|estimated": 1, "describe|torch|no_estimate": 1}


@pytest.mark.parametrize("source", ["priors", "samples"])
def test_small_dispatch_pays_overhead(source, monkeypatch):
    """The intercept is the point of the affine fit: a backend that wins
    per-row can still lose a tiny dispatch to its fixed overhead."""
    cm = CostModel()
    if source == "priors":
        cm.install_prior("describe", "torch", 1e-8, overhead=5e-5)
        cm.install_prior("describe", "numpy", 6e-8, overhead=0.0)
    else:
        for rows in (1e2, 1e4, 1e6):
            cm.add_sample("describe", "torch", rows, 1e-8 * rows + 5e-5)
            cm.add_sample("describe", "numpy", rows, 6e-8 * rows)
        cm.calibrate()
    p = Planner(cm)
    assert p.choose("describe", 1_000_000, "torch") == "torch"  # rows dominate
    assert p.choose("describe", 100, "torch") == "numpy"  # overhead dominates


# ------------------------------------------------------------- planner gating --
def test_unplanned_keys_pass_through():
    p = Planner(CostModel())
    assert "join" in PLANNED_KEYS
    assert "head" not in PLANNED_KEYS
    assert p.choose("head", 1_000_000, "torch") == "torch"
    assert p.cost_model.planner_report() == {}  # pass-through is not a decision


def test_disabled_planner_is_identity(priors):
    p = Planner(CostModel(), enabled=False)
    assert p.choose("value_counts", 1_000_000, "torch") == "torch"
    assert p.choose_fusion("fused:filter|describe", "torch", 1_000_000,
                           ["filter", "describe"]) is False


class _OpenBoard:
    def is_closed(self, op, bk):
        return False


def test_open_breaker_demotes_to_numpy(priors):
    p = Planner(CostModel(), board=_OpenBoard())
    assert p.choose("describe", 1_000_000, "torch") == "numpy"
    assert p.cost_model.planner_report()["describe|numpy|breaker_open"] == 1
    # fusion through an open breaker is refused outright
    assert p.choose_fusion("fused:filter|describe", "torch", 1_000_000,
                           ["filter", "describe"]) is False


def test_open_breaker_on_the_board_demotes_uncalibrated_keys():
    """With no estimate at all, the real breaker board still demotes: an open
    ``stats|torch`` breaker sends describe to numpy."""
    BK.reset_breakers()
    board = BK.breaker_board()
    try:
        for _ in range(board.failure_threshold):
            board.record_failure("stats", "torch")
        p = Planner(CostModel(), board=board)
        assert p.choose("describe", 1_000_000, "torch") == "numpy"
        assert p.choose("groupby_agg", 1_000_000, "torch") == "torch"
    finally:
        BK.reset_breakers()


def test_no_estimate_defers_to_precedence(priors):
    p = Planner(CostModel(), use_priors=False)
    assert p.choose("describe", 1_000_000, "torch") == "torch"
    assert p.cost_model.planner_report()["describe|torch|no_estimate"] == 1


# --------------------------------------------------------- precedence interplay --
def test_precedence_overrides_bypass_planner(monkeypatch, priors):
    """An explicit per-call / global / env backend is an override ABOVE the
    planner: value_counts at 1M rows would demote to numpy at the engine
    tier, but never against an explicit request."""
    monkeypatch.delenv(BK.ENV_VAR, raising=False)
    s = _session()
    rt = s.runtime
    rows = 1_000_000
    # engine tier: planner demotes per the injected priors
    assert rt._planned_backend("value_counts", rows) == "numpy"
    # global override: absolute
    with BK.use_backend("torch"):
        assert rt._planned_backend("value_counts", rows) == "torch"
    # env override: absolute
    monkeypatch.setenv(BK.ENV_VAR, "torch")
    assert rt._planned_backend("value_counts", rows) == "torch"
    monkeypatch.delenv(BK.ENV_VAR, raising=False)
    # planner=False restores pure precedence at the engine tier
    s2 = _session(planner=False)
    assert s2.runtime._planned_backend("value_counts", rows) == "torch"
    assert s2.engine.cost_model.planner_report() == {}


def test_numpy_default_never_promoted(priors):
    """The planner demotes only: a numpy engine default stays numpy even
    where the priors say torch would win."""
    s = Session(catalog=_cat(), mode="sim", kernel_backend="numpy")
    assert s.runtime._planned_backend("describe", 1_000_000) == "numpy"


# ------------------------------------------------------------------ persistence --
@CORES
def test_decisions_and_fused_keys_survive_save_load(core, tmp_path):
    """The fused op key contains ``|``: a load must split on the LAST
    separator.  Decisions are recorded by the port's planner on the
    package's cost model and survive its save / load."""
    cm = core.CostModel()
    a_true, b_true = 4.5e-8, 6e-5
    for rows in (1e4, 1e5, 1e6):
        cm.add_sample("fused:filter|describe", "torch", rows, a_true * rows + b_true)
        cm.add_sample("describe", "numpy", rows, 6e-8 * rows)
        cm.add_sample("filter", "numpy", rows, 4.9e-8 * rows)
        cm.add_sample("value_counts", "numpy", rows, 4.5e-9 * rows)
        cm.add_sample("value_counts", "torch", rows, 4.8e-8 * rows + _OVH)
    cm.calibrate()
    p = Planner(cm)
    assert p.choose("value_counts", 1_000_000, "torch") == "numpy"
    assert p.choose_fusion("fused:filter|describe", "torch", 1_000_000,
                           ["filter", "describe"]) is True
    path = str(tmp_path / "cm.json")
    cm.save(path)

    cm2 = core.CostModel()
    assert cm2.load(path)
    assert cm2.has_calibration("fused:filter|describe", "torch")
    assert cm2.estimate("fused:filter|describe", "torch", 2e5) == pytest.approx(
        cm.estimate("fused:filter|describe", "torch", 2e5)
    )
    assert cm2.overhead("fused:filter|describe", "torch") == pytest.approx(
        cm.overhead("fused:filter|describe", "torch")
    )
    assert cm2.planner_report() == cm.planner_report()
    assert any(k.startswith("fused:filter|describe|torch|") for k in cm2.planner_report())
    # a fresh planner over the loaded model plans from the fitted estimates
    assert Planner(cm2).choose("value_counts", 1_000_000, "torch") == "numpy"


@CORES
def test_load_rejects_garbage(core, tmp_path):
    path = tmp_path / "cm.json"
    path.write_text("{not json")
    assert core.CostModel().load(str(path)) is False
    assert core.CostModel().load(str(tmp_path / "missing.json")) is False


# ------------------------------------------------------------------- property --
def _never_slower_than_numpy(p: Planner, key: str, rows: float) -> None:
    chosen = p.choose(key, rows, "torch")
    e_chosen = p.estimate(key, chosen, rows)
    e_numpy = p.estimate(key, "numpy", rows)
    if e_chosen is None or e_numpy is None:
        return  # no estimates: planner deferred to precedence, nothing to check
    assert e_chosen <= e_numpy * (1 + 1e-9), (key, rows, chosen)


def _calibrated_planner() -> Planner:
    cm = CostModel()
    rng = np.random.default_rng(0)
    for key in ("describe", "value_counts", "sort_values:topk"):
        (an, bn) = PRIORS[(key, "numpy")]
        (ax, bx) = PRIORS[(key, "torch")]
        for rows in (1e3, 1e4, 1e5, 1e6):
            noise = 1.0 + 0.05 * rng.standard_normal()
            cm.add_sample(key, "numpy", rows, max(an * rows + bn, 0) * noise)
            cm.add_sample(key, "torch", rows, max(ax * rows + bx, 0) * noise)
    cm.calibrate()
    return Planner(cm)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=80, deadline=None)
    @given(
        key=st.sampled_from(sorted(PLANNED_KEYS)),
        log_rows=st.floats(min_value=0.0, max_value=7.5),
        with_priors=st.booleans(),
    )
    def test_planner_never_estimated_slower_than_numpy(key, log_rows, with_priors):
        """On every key it knows (calibrated, or from injected priors), the
        planner's choice is never estimated slower than the numpy reference
        — demotion can only help, by construction."""
        saved = PL.COLD_START_PRIORS
        PL.COLD_START_PRIORS = dict(PRIORS) if with_priors else {}
        try:
            _never_slower_than_numpy(_calibrated_planner(), key, 10.0 ** log_rows)
        finally:
            PL.COLD_START_PRIORS = saved

except ImportError:  # hypothesis not installed: seeded sweep, same property

    def test_planner_never_estimated_slower_than_numpy(priors):
        p = _calibrated_planner()
        rnd = random.Random(1234)
        for _ in range(400):
            key = rnd.choice(sorted(PLANNED_KEYS))
            rows = 10.0 ** rnd.uniform(0.0, 7.5)
            _never_slower_than_numpy(p, key, rows)


FUSED_KEYS = ("fused:filter|describe", "fused:filter|groupby_agg",
              "fused:filter|sort_values:topk")


def _fusion_consistent(p: Planner, rows: float) -> None:
    for key in FUSED_KEYS:
        op2 = key.split("|", 1)[1]
        fused = p.estimate(key, "torch", rows)
        unfused = sum(
            min(e for e in (p.estimate(k, "torch", rows), p.estimate(k, "numpy", rows))
                if e is not None)
            for k in ("filter", op2)
        )
        assert p.choose_fusion(key, "torch", rows, ["filter", op2]) == (fused < unfused)
    # never fuse blind: a key with no estimate refuses
    assert p.choose_fusion("fused:filter|value_counts", "torch", rows,
                           ["filter", "value_counts"]) is False


def test_fusion_decision_consistent_with_estimates(priors):
    """choose_fusion fuses iff the fused estimate beats the summed best
    per-stage estimates — pinned against a hand-computed comparison."""
    _fusion_consistent(Planner(CostModel()), 1_000_000.0)


def test_fusion_decision_from_samples_alone():
    """The same decision from injected samples, no priors: the fused key
    wins at 1M rows and loses at 100 rows to its overhead."""
    cm = CostModel()
    for rows in (1e2, 1e4, 1e6):
        for (key, bk), (a, b) in PRIORS.items():
            cm.add_sample(key, bk, rows, a * rows + b)
    cm.calibrate()
    p = Planner(cm)
    _fusion_consistent(p, 1_000_000.0)
    assert p.choose_fusion("fused:filter|describe", "torch", 1e6, ["filter", "describe"])
    assert not p.choose_fusion("fused:filter|describe", "torch", 100, ["filter", "describe"])
