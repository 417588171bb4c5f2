"""The traffic and the data repeat exactly for a seed and change with it:
the notebooks (fixed by the mix's own stream seed), the TPC-H tables (by
the run's seed), the assistant's turns and the token streams."""
import itertools
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import lm, notebook, small, spec, tpch  # noqa: E402


def _cells(cell, stream_seed, n=40):
    t = dict(cell.traffic, stream_seed=stream_seed)
    return list(itertools.islice(notebook.cells(cell.config, t), n))


def test_notebooks_repeat_for_their_seed_and_change_with_it():
    cell = small.small_cell("tpch_sf1.run_all", "explore")
    a, b = _cells(cell, 1), _cells(cell, 1)
    assert a == b
    assert a != _cells(cell, 2)
    # every cell: a plan that starts from a base, one interaction, a think time
    for c in a:
        assert c["plan"][0][0] == "base" and c["think"] > 0
        assert 0 <= c["cell"] < cell.traffic["cells_per_notebook"]
    assert a[0]["new_frames"], "the notebook's first frame is specified in its first cell"


def test_run_all_plays_the_notebooks_of_explore():
    ex = small.small_cell("tpch_sf1.run_all", "explore")
    ra = small.small_cell("tpch_sf1.run_all")
    take = lambda c: list(itertools.islice(notebook.cells(c.config, c.traffic), 30))  # noqa
    assert take(ex) == take(ra)
    assert ex.traffic["think"] and not ra.traffic["think"]


def test_tables_repeat_for_a_seed_change_with_it_and_keep_their_sizes():
    cfg = small.small_cell("tpch_sf1.run_all").config
    a, b, c = (tpch.generate(cfg, s, "cpu") for s in (11, 11, 12))
    for name in ("lineitem", "orders"):
        assert a[name].nrows == b[name].nrows == c[name].nrows == cfg["tables"][name]["rows"]
        for col in a[name].columns:
            assert np.array_equal(a[name].columns[col], b[name].columns[col])
    assert not np.array_equal(a["lineitem"].columns["l_partkey"],
                              c["lineitem"].columns["l_partkey"])
    li, od = a["lineitem"].columns, a["orders"].columns
    # dbgen's rules: 8 of every 32 order keys, 1-7 lines an order, dates in order
    assert np.all(od["o_orderkey"][:8] == np.arange(1, 9))
    assert od["o_orderkey"][8] == 33
    _, per_order = np.unique(li["l_orderkey"], return_counts=True)
    assert per_order.min() >= 1 and per_order.max() <= 7
    assert np.all(li["l_receiptdate"] > li["l_shipdate"])
    assert np.all((li["l_discount"] >= 0) & (li["l_discount"] <= 0.1))
    assert set(np.unique(li["l_quantity"])) <= set(range(1, 51))


def test_a_large_seed_is_taken():
    cfg = small.small_cell("tpch_sf1.run_all").config
    big = tpch.generate(cfg, 2**31 + 12345, "cpu")
    assert big["orders"].nrows == cfg["tables"]["orders"]["rows"]
    assert lm.tokens(2**33 + 1, 0, 8, 100, "cpu").shape == (8,)


def test_assistant_turns_repeat_and_hold_the_same_work_every_cycle():
    t = spec.cell("mamba2_2p7b.assist", spec.load_benchmark()).traffic
    n = int(t["turns_per_cycle"])
    a = list(itertools.islice(kind("assist").turns(t), 3 * n))
    assert a == list(itertools.islice(kind("assist").turns(t), 3 * n))
    assert a != list(itertools.islice(kind("assist").turns(dict(t, stream_seed=1)), 3 * n))
    lo, hi = t["prompt_len"]
    for cyc in range(3):
        turns = a[cyc * n:(cyc + 1) * n]
        assert sorted(x["length"] for x in turns) == sorted(x["length"] for x in a[:n])
        assert sum(x["request"] is not None for x in turns) == round(t["p_anticipated"] * n)
        assert all(lo <= x["length"] <= hi for x in turns)
        for x in turns:
            if x["request"] is not None:
                assert x["anticipated"][x["request"]] == x["length"]


def test_token_streams_repeat_for_a_seed_and_change_with_it():
    a = lm.tokens(5, 0, 64, 1000, "cpu")
    assert torch.equal(a, lm.tokens(5, 0, 64, 1000, "cpu"))
    assert not torch.equal(a, lm.tokens(6, 0, 64, 1000, "cpu"))
    assert not torch.equal(a, lm.tokens(5, 1, 64, 1000, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 1000


def kind(name):
    return spec.kind_module(name)


def test_the_checked_answers_cover_every_kind_and_base_frame_and_repeat_for_a_seed():
    cell = small.small_cell("tpch_sf1.run_all")
    cells = _cells(cell, int(cell.traffic["stream_seed"]), n=300)
    pick = notebook.sample_checked(cells, 12, 7)
    assert pick == notebook.sample_checked(cells, 12, 7) == sorted(set(pick))
    assert pick != notebook.sample_checked(cells, 12, 8)
    for key in (lambda c: c["interaction"][0], lambda c: c["plan"][0][1]):
        assert {key(cells[i]) for i in pick} == {key(c) for c in cells}
    assert len(pick) == 12
    assert notebook.sample_checked(cells[:5], 12, 7) == list(range(5))
