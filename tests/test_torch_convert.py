"""State carried across packages: identical generated tables, and a JAX
package table and fitted cost model brought over through
``repro_torch.frame.convert`` give the same answers."""
import json

import numpy as np
import pytest

import repro.frame as R
import repro_torch.frame as T
from repro.core import CostModel as RCostModel
from repro.frame import backend as RBK
from repro.frame import blocking as RB
from repro_torch.frame import backend as TBK
from repro_torch.frame import blocking as TB
from repro_torch.frame import convert
from repro_torch.frame.table import pydict_equal

from test_torch_session import _catalog


@pytest.mark.parametrize("name", ["small", "large", "dim"])
@pytest.mark.parametrize("bounds", [(0, None), (1234, 4321)])
def test_catalog_generate_identical_bytes(name, bounds):
    rc, tc = _catalog(R), _catalog(T)
    a, b = bounds[0], bounds[1] or rc.spec(name).nrows
    b = min(b, rc.spec(name).nrows)
    a = min(a, b)
    rp, tp = rc.generate(name, a, b), tc.generate(name, a, b)
    assert rp.order == tp.order
    for col in rp.order:
        x, y = rp.columns[col], tp.columns[col]
        assert x.data.dtype == y.data.dtype and x.data.tobytes() == y.data.tobytes()
        assert (x.mask is None) == (y.mask is None)
        if x.mask is not None:
            assert x.mask.tobytes() == y.mask.tobytes()
        if x.dictionary is not None:
            assert list(x.dictionary) == list(y.dictionary)


def _reference_table():
    rng = np.random.default_rng(5)
    n = 6_000
    y = rng.uniform(0, 10, n)
    y[rng.random(n) < 0.3] = np.nan
    return R.from_pydict(
        {
            "x": rng.normal(5, 2, n),
            "y": y,
            "k": rng.choice(np.array(["a", "b", "c", "d", "e"]), n),
            "i": rng.integers(0, 50, n),
        },
        npartitions=4,
    )


def _carry(table):
    """A JAX-package table → plain numpy arrays → the port's table."""
    columns, bounds, start = {}, [], 0
    for p in table.partitions:
        bounds.append((start, start + p.nrows))
        start += p.nrows
    merged = table.concat()
    for name in merged.order:
        c = merged.columns[name]
        columns[name] = {"data": c.data, "mask": c.mask, "dictionary": c.dictionary}
    return convert.table_from_numpy(columns, bounds)


def test_table_carries_over_exactly():
    ref = _reference_table()
    port = _carry(ref)
    assert [p.nrows for p in port.partitions] == [p.nrows for p in ref.partitions]
    assert pydict_equal(port.to_pydict(), ref.to_pydict())
    for rp, tp in zip(ref.partitions, port.partitions):
        for name in rp.order:
            assert tp.columns[name].data.tobytes() == rp.columns[name].data.tobytes()


def test_carried_table_same_answers():
    TBK.reset_breakers()
    ref = _reference_table()
    port = _carry(ref)
    aggs = (("s", "x", "sum"), ("m", "y", "mean"), ("c", "y", "count"), ("mx", "i", "max"))
    dic = ref.partitions[0].columns["k"].dictionary
    r_stats = RB.merge_stats([RBK.partial_stats(p, backend="xla") for p in ref.partitions])
    t_stats = TB.merge_stats([TBK.partial_stats(p, backend="torch", device="cpu")
                              for p in port.partitions])
    for name in r_stats:
        assert t_stats[name].n == r_stats[name].n
        np.testing.assert_allclose(t_stats[name].mean, r_stats[name].mean, rtol=1e-4)
        np.testing.assert_allclose(t_stats[name].std, r_stats[name].std, rtol=1e-3)
    r_gb = RB.merge_groupby([RBK.partial_groupby(p, "k", aggs, backend="xla")
                             for p in ref.partitions], "k", aggs, dic, None).to_pydict()
    t_gb = TB.merge_groupby([TBK.partial_groupby(p, "k", aggs, backend="torch", device="cpu")
                             for p in port.partitions], "k", aggs, dic, None).to_pydict()
    assert list(t_gb["k"]) == list(r_gb["k"])
    for col in ("s", "m", "c", "mx"):
        np.testing.assert_allclose(t_gb[col], r_gb[col], rtol=2e-3, atol=1e-5)
    r_sel = [RBK.select_rows(p, p.columns["x"].data > 5, backend="xla") for p in ref.partitions]
    t_sel = [TBK.select_rows(p, p.columns["x"].data > 5, backend="torch", device="cpu")
             for p in port.partitions]
    assert pydict_equal(T.PTable(t_sel).to_pydict(), R.PTable(r_sel).to_pydict())
    snap = TBK.breaker_board().snapshot()  # the torch path served every call
    assert snap and all(st["failures"] == 0 and st["successes"] > 0 for st in snap.values())


def test_cost_model_carries_over(tmp_path):
    rcm = RCostModel()
    for rows in (1e4, 1e5, 1e6):
        rcm.add_sample("describe", "numpy", rows, rows * 6e-8)
        rcm.add_sample("describe", "xla", rows, rows * 2e-8 + 5e-5)
    rcm.calibrate()
    path = tmp_path / "costs.json"
    rcm.save(str(path))
    payload = json.loads(path.read_text())
    assert any(k.endswith("|xla") for k in payload["unit_costs"])

    tcm = convert.load_cost_model(str(path))
    assert tcm.estimate("describe", "numpy", 5e5) == pytest.approx(
        rcm.estimate("describe", "numpy", 5e5))
    assert tcm.estimate("describe", "xla", 5e5) is None  # another package's backend
    for op in ("describe", "groupby_agg", "filter"):
        assert tcm.unit_cost(op) == rcm.unit_cost(op)


def test_cost_model_drives_same_plan(tmp_path):
    """Both engines, loaded with the same fitted costs, pick the same order."""
    rcm = RCostModel()
    for op, c in (("describe", 3e-7), ("value_counts", 9e-8), ("groupby_agg", 5e-6)):
        for rows in (1e3, 1e4):
            rcm.add_sample(op, "numpy", rows, c * rows)
    rcm.calibrate()
    path = str(tmp_path / "costs.json")
    rcm.save(path)

    def order(pkg, sess):
        cm = sess.engine.cost_model
        if pkg is R:
            cm.load(path)
        else:
            convert.load_cost_model(path, cm)
        df = sess.read_table("small")
        df.describe()
        df["k"].value_counts()
        df.groupby("k").agg({"x": "mean"})
        done, out = set(), []
        while (nxt := sess.engine.scheduler.reference_pick(done)) is not None:
            out.append(nxt.label)
            done.add(nxt.nid)
        return out

    ref = order(R, R.Session(catalog=_catalog(R), mode="sim", kernel_backend="numpy"))
    got = order(T, T.Session(catalog=_catalog(T), mode="sim", kernel_backend="numpy"))
    assert got == ref
