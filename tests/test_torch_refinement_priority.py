"""Scheduler-aware progressive refinement in the port, test for test beside
the JAX package's ``tests/test_refinement_priority.py`` (``unit_priority``
of ``frame/blocking.py``'s running combines and
``ProgressiveResult.refinement_order`` of ``core/progressive.py``).

The running combine ranks the missing partitions by the expected shrink of
the widest live confidence interval, and ``refinement_order`` falls back to
the bit-reversal lattice whenever the combine has no estimator, raises, or
returns a non-permutation.  Exact completion never depends on the order:
a priority-ordered refinement ends bit for bit on the blocking answer.
``core`` is byte-identical in both packages, so the ``refinement_order``
tests run over both; sessions run on the port's ``numpy`` and ``torch``
(``device="cpu"``) kernel backends.
"""
import numpy as np
import pytest

import repro.core.progressive as r_prog
import repro.core.scheduler as r_sched
import repro_torch.core.progressive as t_prog
import repro_torch.core.scheduler as t_sched
from repro_torch.frame import Catalog, ColSpec, Session, TableSpec
from repro_torch.frame import backend as BK
from repro_torch.frame import blocking as B
from repro_torch.frame.blocking import (
    RunningGroupby,
    RunningStats,
    RunningValueCounts,
    _ci_priority_order,
)
from repro_torch.frame.partitioner import uniform_partitions
from repro_torch.frame.table import from_pydict, pydict_equal

CORES = pytest.mark.parametrize("prog,sched", [(r_prog, r_sched), (t_prog, t_sched)],
                                ids=["repro", "repro_torch"])
BACKENDS = pytest.mark.parametrize("bk", ["numpy", "torch"])


# --------------------------------------------------------------------------- #
# _ci_priority_order                                                           #
# --------------------------------------------------------------------------- #


def test_ci_priority_empty_contrib_declines():
    assert _ci_priority_order([1, 2, 3], 8, {}) is None


def test_ci_priority_is_permutation():
    order = _ci_priority_order([2, 4, 9, 11, 20], 32, {3: 100.0, 10: 1.0})
    assert sorted(order) == [2, 4, 9, 11, 20]


def test_ci_priority_prefers_neighbours_of_heavy_contributor():
    # partition 3 carries the mass: its neighbours 2 and 4 outrank the
    # neighbours of the light contributor at 10, which outrank far partition 20
    order = _ci_priority_order([2, 4, 9, 11, 20], 32, {3: 100.0, 10: 1.0})
    assert set(order[:2]) == {2, 4}
    assert order[-1] == 20


def test_ci_priority_distance_decay():
    order = _ci_priority_order([1, 2, 3], 8, {0: 5.0})
    assert order == [1, 2, 3]


def test_ci_priority_flat_contrib_ties_fall_back_to_lattice():
    missing = list(range(8))
    # one contributor, equidistant pairs tie -> lattice rank decides inside ties
    order = _ci_priority_order(missing, 8, {4: 1.0})
    assert sorted(order) == missing
    assert order[0] == 4 - 1 or order[0] == 4 + 1 or order[0] == 4  # nearest first


# --------------------------------------------------------------------------- #
# RunningValueCounts.unit_priority                                             #
# --------------------------------------------------------------------------- #


def _vc_partial(counts):
    vals = np.arange(len(counts))
    return vals, np.asarray(counts, np.int64)


def test_vc_priority_needs_two_partials():
    rc = RunningValueCounts(8, "k", None)
    assert rc.unit_priority([1, 2], 8) is None
    rc.update(0, _vc_partial([10, 10]))
    assert rc.unit_priority([1, 2], 8) is None


def test_vc_priority_targets_highest_variance_value():
    rc = RunningValueCounts(8, "k", None)
    # value 0 is flat (20, 20); value 1 swings (5, 90) -> widest CI is value 1
    # and partition 6 carries its mass, so 5 and 7 lead the refinement
    rc.update(0, _vc_partial([20, 5]))
    rc.update(6, _vc_partial([20, 90]))
    order = rc.unit_priority([1, 2, 3, 4, 5, 7], 8)
    assert sorted(order) == [1, 2, 3, 4, 5, 7]
    assert set(order[:2]) == {5, 7}


# --------------------------------------------------------------------------- #
# RunningGroupby.unit_priority                                                 #
# --------------------------------------------------------------------------- #


def _gb_state(aggs, nparts=8, seen=(0, 5), bk="numpy"):
    rng = np.random.default_rng(2)
    cats = np.array(["a", "b", "c"])
    t = from_pydict(
        {
            "k": cats[rng.integers(0, 3, 4000)],
            "x": rng.uniform(0.0, 10.0, 4000),
        },
        npartitions=nparts,
    )
    rg = RunningGroupby(nparts, "k", aggs, t.partitions[0].columns["k"].dictionary)
    for i in seen:
        if bk == "numpy":
            rg.update(i, B.partial_groupby(t.partitions[i], "k", aggs))
        else:
            rg.update(i, BK.partial_groupby(t.partitions[i], "k", aggs,
                                            backend="torch", device="cpu"))
    return rg


@BACKENDS
def test_gb_priority_needs_two_partials(bk):
    rg = _gb_state((("x", "x", "sum"),), seen=(0,), bk=bk)
    assert rg.unit_priority([1, 2, 3], 8) is None


@BACKENDS
@pytest.mark.parametrize("fn", ["sum", "count", "mean"])
def test_gb_priority_is_permutation(bk, fn):
    rg = _gb_state((("x", "x", fn),), bk=bk)
    missing = [1, 2, 3, 4, 6, 7]
    order = rg.unit_priority(missing, 8)
    assert order is not None and sorted(order) == missing


@BACKENDS
def test_gb_priority_nonadditive_aggs_decline(bk):
    rg = _gb_state((("x", "x", "min"), ("x2", "x", "max")), bk=bk)
    assert rg.unit_priority([1, 2, 3], 8) is None


# --------------------------------------------------------------------------- #
# ProgressiveResult.refinement_order fallbacks (core: both packages)           #
# --------------------------------------------------------------------------- #


def _pr(prog, combine, total=16):
    return prog.ProgressiveResult(
        engine=None, node=None, inputs=[], combine=combine, total_units=total
    )


@CORES
def test_refinement_order_stats_falls_back_to_lattice(prog, sched):
    # RunningStats has no unit_priority: pure sample-first order
    pr = _pr(prog, RunningStats(16))
    missing = list(range(16))
    assert pr.refinement_order(missing) == sched.sample_first_order(missing, 16)


@CORES
def test_refinement_order_no_combine_falls_back(prog, sched):
    pr = _pr(prog, None)
    missing = [3, 7, 11]
    assert pr.refinement_order(missing) == sched.sample_first_order(missing, 16)


@CORES
def test_refinement_order_estimator_failure_falls_back(prog, sched):
    class Broken:
        def unit_priority(self, missing, total):
            raise RuntimeError("boom")

    missing = list(range(8))
    assert _pr(prog, Broken()).refinement_order(missing) == sched.sample_first_order(
        missing, 16
    )


@CORES
def test_refinement_order_non_permutation_falls_back(prog, sched):
    class Wrong:
        def unit_priority(self, missing, total):
            return missing[:-1]  # drops a partition

    missing = [1, 2, 3, 4]
    assert _pr(prog, Wrong()).refinement_order(missing) == sched.sample_first_order(
        missing, 16
    )


@CORES
def test_refinement_order_valid_priority_is_used(prog, sched):
    class Reversed:
        def unit_priority(self, missing, total):
            return sorted(missing, reverse=True)

    missing = [1, 2, 3, 4]
    assert _pr(prog, Reversed()).refinement_order(missing) == [4, 3, 2, 1]


# --------------------------------------------------------------------------- #
# end to end: priority-ordered refinement still completes exactly              #
# --------------------------------------------------------------------------- #


def _catalog(nrows=40_000):
    cat = Catalog()
    cat.register(
        TableSpec(
            "fact",
            nrows=nrows,
            cols=(
                ColSpec("x", low=0.0, high=10.0),
                ColSpec("k", kind="cat", n_categories=8),
            ),
            io_seconds=2.0,
            seed=7,
        )
    )
    return cat


def _frame(session, nparts):
    df = session.read_table("fact")
    spec = session.catalog.spec("fact")
    df.node.kwargs["partition_bounds"] = uniform_partitions(spec.nrows, nparts)
    return df


def _session(bk):
    return Session(catalog=_catalog(), mode="sim", kernel_backend=bk,
                   device="cpu" if bk == "torch" else None)


@BACKENDS
@pytest.mark.parametrize(
    "build",
    [
        lambda df: df["k"].value_counts(),
        lambda df: df.groupby("k").agg({"x": "mean"}),
    ],
    ids=["value_counts", "groupby"],
)
def test_priority_refinement_completes_bit_for_bit(bk, build):
    s = _session(bk)
    pr = s.interact(build(_frame(s, 16)), progressive=True)
    covs = [pr.estimate().coverage]
    while True:
        est = pr.refine(3)
        covs.append(est.coverage)
        if est.exact:
            break
    assert covs == sorted(covs)  # refinement only adds coverage
    s2 = _session(bk)
    exact = s2.interact(build(_frame(s2, 16)))
    assert pydict_equal(est.value.to_pydict(), exact.to_pydict())
