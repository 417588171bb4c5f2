"""TPC-H's LINEITEM and ORDERS, generated from the seed by dbgen's rules
(TPC-H v3, section 4.2.3), on the device in a few large calls.

Sizes come from the configuration file: ``scale_factor`` and each table's
``rows``.  What the specification leaves to dbgen's own random streams is
drawn here from a ``torch.Generator`` on the device; the row counts are
held exact (the per-order line counts, uniform on 1-7, are nudged by one
on a few orders until they sum to LINEITEM's rows), so that every seed
gives tables of the same sizes.  Text columns are dictionary-encoded, as
the port stores strings; free-text comments draw from a dictionary of
``comment_dictionary`` generated comments.

The tables come back on the host as numpy arrays: the port's tables live
there, and set-up warms the device copies as the notebook's first cell
would (``repro_torch.frame.backend.warm_device_cache``).
"""
from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

EPOCH = _dt.date(1970, 1, 1)


def day(y: int, m: int, d: int) -> int:
    return (_dt.date(y, m, d) - EPOCH).days


STARTDATE = day(1992, 1, 1)
ENDDATE = day(1998, 12, 31)
CURRENTDATE = day(1995, 6, 17)

PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTIONS = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]
ORDERSTATUS = ["F", "O", "P"]
# dbgen's comment grammar draws from this vocabulary (a subset of its
# word lists: nouns, verbs, adjectives, adverbs, prepositions)
WORDS = ("foxes ideas theodolites pinto beans instructions dependencies excuses platelets "
         "asymptotes courts dolphins multipliers sauternes warthogs frets dinos attainments "
         "somas Tiresias patterns forges braids hockey players frays warhorses dugouts notornis "
         "epitaphs pearls tithes waters orbits gifts sheaves depths sentiments decoys realms "
         "pains grouches escapades sleep wake are cajole haggle nag use boost affix detect "
         "integrate maintain nod was lose sublate solve thrash promise engage hinder print x-ray "
         "breach eat grow impress mold poach serve run dazzle snooze doze unwind kindle play "
         "hang believe doubt furious sly careful blithe quick fluffy slow quiet ruthless thin "
         "close dogged daring brave stealthy permanent enticing idle busy regular final ironic "
         "even bold silent sometimes always never furiously slyly carefully blithely quickly "
         "fluffily slowly quietly ruthlessly thinly closely doggedly daringly bravely about "
         "above according to across after against along alongside of among around at atop "
         "before behind beneath beside besides between beyond by despite during except for "
         "from in place of inside instead of into near of on outside over past since through "
         "throughout to toward under until up upon without with within").split()


@dataclass
class Table:
    """A generated table: columns in order, each a host numpy array; a
    dictionary column is int32 codes with its dictionary (code -> str)."""

    name: str
    columns: Dict[str, np.ndarray]
    dictionaries: Dict[str, np.ndarray]

    @property
    def nrows(self) -> int:
        return len(next(iter(self.columns.values())))


def comments(rng: np.random.Generator, n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` distinct-looking comments of lo-hi characters, sorted (a
    dictionary's codes follow the strings' order)."""
    words = np.array(WORDS, dtype=object)
    out = set()
    while len(out) < n:
        k = int(rng.integers(2, 9))
        text = " ".join(words[rng.integers(0, len(words), k)])
        length = int(rng.integers(lo, hi + 1))
        text = (text + " " + text)[:length].strip()
        if len(text) >= lo:
            out.add(text)
    return np.array(sorted(out), dtype=object)


def _uniform_int(gen, lo: int, hi: int, n: int, device) -> torch.Tensor:
    """n integers uniform on [lo, hi], int64."""
    return torch.randint(lo, hi + 1, (n,), generator=gen, device=device, dtype=torch.int64)


def generate(config: dict, seed: int, device) -> Dict[str, Table]:
    """LINEITEM and ORDERS at the configuration's scale, from ``seed``."""
    sf = config["scale_factor"]
    n_o = int(config["tables"]["orders"]["rows"])
    n_l = int(config["tables"]["lineitem"]["rows"])
    n_dict = int(config["comment_dictionary"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    host_rng = np.random.default_rng(seed)
    dev = torch.device(device)

    # ---- ORDERS -------------------------------------------------------------
    i = torch.arange(n_o, device=dev, dtype=torch.int64)
    o_orderkey = (i // 8) * 32 + (i % 8) + 1  # dbgen: 8 of every 32 keys
    r = _uniform_int(gen, 0, (sf * 150_000 * 2) // 3 - 1, n_o, dev)
    o_custkey = 3 * (r // 2) + (r % 2) + 1  # never a multiple of 3
    o_orderdate = _uniform_int(gen, STARTDATE, ENDDATE - 151, n_o, dev)
    o_priority = _uniform_int(gen, 0, len(PRIORITIES) - 1, n_o, dev)
    o_clerk = _uniform_int(gen, 0, sf * 1000 - 1, n_o, dev)
    o_comment = _uniform_int(gen, 0, n_dict - 1, n_o, dev)

    # ---- lines per order: uniform 1-7, held to exactly n_l in all ------------
    counts = _uniform_int(gen, 1, 7, n_o, dev)
    diff = n_l - int(counts.sum())
    order = torch.randperm(n_o, generator=gen, device=dev)
    step = 1 if diff > 0 else -1
    while diff:
        room = (counts[order] < 7) if step > 0 else (counts[order] > 1)
        pick = order[room][: abs(diff)]
        counts[pick] += step
        diff -= step * len(pick)
    starts = torch.cumsum(counts, 0) - counts

    # ---- LINEITEM -------------------------------------------------------------
    owner = torch.repeat_interleave(torch.arange(n_o, device=dev), counts)
    l_orderkey = o_orderkey[owner]
    l_linenumber = torch.arange(n_l, device=dev, dtype=torch.int64) - starts[owner] + 1
    l_partkey = _uniform_int(gen, 1, sf * 200_000, n_l, dev)
    S = sf * 10_000
    supp_i = _uniform_int(gen, 0, 3, n_l, dev)
    l_suppkey = (l_partkey + supp_i * (S // 4 + (l_partkey - 1) // S)) % S + 1
    qty = _uniform_int(gen, 1, 50, n_l, dev)
    cents = 90_000 + (l_partkey // 10) % 20_001 + 100 * (l_partkey % 1000)  # retail price
    ext_cents = qty * cents
    disc = _uniform_int(gen, 0, 10, n_l, dev)
    tax = _uniform_int(gen, 0, 8, n_l, dev)
    odate = o_orderdate[owner]
    l_shipdate = odate + _uniform_int(gen, 1, 121, n_l, dev)
    l_commitdate = odate + _uniform_int(gen, 30, 90, n_l, dev)
    l_receiptdate = l_shipdate + _uniform_int(gen, 1, 30, n_l, dev)
    ra = _uniform_int(gen, 0, 1, n_l, dev)  # R or A once received
    l_returnflag = torch.where(l_receiptdate <= CURRENTDATE, torch.where(ra == 0, 0, 2), 1)
    l_linestatus = (l_shipdate > CURRENTDATE).to(torch.int64)  # O after today, else F
    l_shipinstruct = _uniform_int(gen, 0, len(INSTRUCTIONS) - 1, n_l, dev)
    l_shipmode = _uniform_int(gen, 0, len(MODES) - 1, n_l, dev)
    l_comment = _uniform_int(gen, 0, n_dict - 1, n_l, dev)

    # ORDERS' derived columns, in integer arithmetic (exact, any add order):
    # the total is sum(ext * (1 + tax) * (1 - disc)) in 1e-6 cents
    line_total = ext_cents * (100 + tax) * (100 - disc)
    total = torch.zeros(n_o, dtype=torch.int64, device=dev).index_add_(0, owner, line_total)
    n_open = torch.zeros(n_o, dtype=torch.int64, device=dev).index_add_(0, owner, l_linestatus)
    o_status = torch.where(n_open == 0, 0, torch.where(n_open == counts, 1, 2))
    o_totalprice = torch.round(total.double() / 10_000) / 100

    def host(t, dt):
        return t.to(dt).cpu().numpy()

    d = lambda xs: np.array(xs, dtype=object)  # noqa: E731
    clerks = d([f"Clerk#{k:09d}" for k in range(1, sf * 1000 + 1)])
    lineitem = Table("lineitem", {
        "l_orderkey": host(l_orderkey, torch.int64),
        "l_partkey": host(l_partkey, torch.int64),
        "l_suppkey": host(l_suppkey, torch.int64),
        "l_linenumber": host(l_linenumber, torch.int64),
        "l_quantity": host(qty, torch.float64),
        "l_extendedprice": host(ext_cents.double() / 100, torch.float64),
        "l_discount": host(disc.double() / 100, torch.float64),
        "l_tax": host(tax.double() / 100, torch.float64),
        "l_returnflag": host(l_returnflag, torch.int32),
        "l_linestatus": host(l_linestatus, torch.int32),
        "l_shipdate": host(l_shipdate, torch.int32),
        "l_commitdate": host(l_commitdate, torch.int32),
        "l_receiptdate": host(l_receiptdate, torch.int32),
        "l_shipinstruct": host(l_shipinstruct, torch.int32),
        "l_shipmode": host(l_shipmode, torch.int32),
        "l_comment": host(l_comment, torch.int32),
    }, {
        "l_returnflag": d(RETURNFLAGS), "l_linestatus": d(LINESTATUS),
        "l_shipinstruct": d(INSTRUCTIONS), "l_shipmode": d(MODES),
        "l_comment": comments(host_rng, n_dict, 10, 43),
    })
    orders = Table("orders", {
        "o_orderkey": host(o_orderkey, torch.int64),
        "o_custkey": host(o_custkey, torch.int64),
        "o_orderstatus": host(o_status, torch.int32),
        "o_totalprice": host(o_totalprice, torch.float64),
        "o_orderdate": host(o_orderdate, torch.int32),
        "o_orderpriority": host(o_priority, torch.int32),
        "o_clerk": host(o_clerk, torch.int32),
        "o_shippriority": np.zeros(n_o, dtype=np.int32),
        "o_comment": host(o_comment, torch.int32),
    }, {
        "o_orderstatus": d(ORDERSTATUS), "o_orderpriority": d(PRIORITIES),
        "o_clerk": clerks, "o_comment": comments(host_rng, n_dict, 19, 78),
    })
    return {"lineitem": lineitem, "orders": orders}
