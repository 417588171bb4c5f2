"""The port's join against the JAX package's, on the CPU.

``join_probe_plain`` (what the ``join_probe`` wrapper runs on a CPU tensor)
and ``ops.join_probe_padded`` are held bit for bit against the JAX Pallas
kernel in interpret mode and the JAX ``ops`` entry, on float32 and int32
keys within 2^24 and on the edge cases of the counting formulation (NaN on
either side, ±inf, -0.0 against +0.0, duplicate left keys).  Native float64
and int64 keys beyond 2^24, which the reference cannot compare exactly,
are held against ``np.searchsorted``.  The card's two-level search
(a sample of the right keys, then the segment between two sample points
down to one sector), emulated in torch ops, is held bit for bit against the
Pallas kernel at the sample's edges.  Join programs with misses, null keys
and ``how="left"`` run through both packages' sessions; joins move rows, so
their answers must be equal.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.frame as R
import repro_torch.frame as T
from repro.kernels import ops as jops
from repro.kernels.join_probe import join_probe as j_join_probe
from repro_torch.frame import backend as TBK
from repro_torch.frame import blocking as TB
from repro_torch.frame.table import Column, Partition, PTable, pydict_equal
from repro_torch.kernels import join_probe as JP
from repro_torch.kernels import ops as tops


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _right(rng, m, span):
    return np.sort(rng.choice(span, m, replace=False)).astype(np.float64) - span // 3


# ------------------------------------------------------------- the kernel ----
@pytest.mark.parametrize("n,m", [(100, 1), (1000, 37), (5000, 300), (3000, 2000)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_join_probe_vs_pallas(n, m, dtype):
    rng = _rng("jp", n, m, np.dtype(dtype).name)
    r = _right(rng, m, 4 * m)
    lk = rng.integers(-2 * m, 4 * m, n).astype(np.float64)
    lk[: min(n, 10)] = r[: min(n, 10)][::-1]  # duplicate / exact hits
    jpos, jhit = j_join_probe(jnp.asarray(lk, jnp.float32), jnp.asarray(r, jnp.float32),
                              interpret=True)
    pos, hit = JP.join_probe_plain(_t(lk.astype(dtype)), _t(r.astype(dtype)))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    for bk in ("interpret", "xla"):
        with jops.local_backend(bk):
            wpos, whit = jops.join_probe_padded(jnp.asarray(r), jnp.asarray(lk))
        with tops.local_backend("torch"):
            gpos, ghit = tops.join_probe_padded(_t(r.astype(dtype)), _t(lk.astype(dtype)))
        np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
        np.testing.assert_array_equal(ghit.numpy(), np.asarray(whit))


def test_join_probe_edge_cases_vs_pallas():
    """NaN left keys: pos 0, no hit; NaN right keys (sorted last) never
    count or match; ±inf exact; -0.0 matches +0.0; duplicate left keys."""
    r = np.array([-np.inf, -3.0, -0.0, 2.0, 5.0, np.inf, np.nan, np.nan], np.float32)
    lk = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 2.0, 2.0, 3.0, 9.0, -5.0, np.nan],
                  np.float32)
    jpos, jhit = j_join_probe(jnp.asarray(lk), jnp.asarray(r), interpret=True)
    pos, hit = JP.join_probe_plain(_t(lk), _t(r))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert pos[0] == 0 and not hit[0] and hit[3] and hit[4] and hit[1] and hit[2]
    with tops.local_backend("torch"):
        gpos, ghit = tops.join_probe_padded(_t(r), _t(lk))
    with jops.local_backend("interpret"):
        wpos, whit = jops.join_probe_padded(jnp.asarray(r), jnp.asarray(lk))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    np.testing.assert_array_equal(ghit.numpy(), np.asarray(whit))


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_join_probe_native_wide_keys(dtype):
    """Keys beyond f32's 2^24 integer range, compared natively."""
    rng = _rng("wide", np.dtype(dtype).name)
    base = float(2**40) if dtype == np.int64 else 2.0**30 + 0.25
    step = 1 if dtype == np.int64 else 0.5
    r = (base + step * np.sort(rng.choice(100_000, 20_000, replace=False))).astype(dtype)
    lk = (base + step * rng.integers(-10, 100_010, 30_000)).astype(dtype)
    pos, hit = JP.join_probe_plain(_t(lk), _t(r))
    want = np.searchsorted(r, lk, side="left")
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(hit.numpy(), r[np.clip(want, 0, len(r) - 1)] == lk)
    assert hit.numpy().any() and not hit.numpy().all()
    with tops.local_backend("torch"):
        cpos, _ = tops.join_probe_padded(_t(r), _t(lk))
    np.testing.assert_array_equal(cpos.numpy(), np.clip(want, 0, len(r) - 1))


# ------------------------------------------- the card's search, emulated ----
def _two_level(lk, r, log_s):
    """``csrc/join_probe.cu:probe_sampled`` step by step in torch ops: the
    branch-free lower bound over the sample (every 2^log_s-th right key, or
    the whole side at log_s = 0), then the binary levels inside the segment
    down to one 32-byte sector, which is counted whole; ``hv`` is the value
    at the segment's right end for the hit test."""
    m, W = r.shape[0], 32 // r.element_size()
    sample = r[:: 1 << log_s]
    ns = sample.shape[0]
    base, ln = torch.zeros(lk.shape, dtype=torch.long), ns
    while ln > 1:
        half = ln >> 1
        base = torch.where(sample[base + half] < lk, base + half, base)
        ln -= half
    c = base + (sample[base] < lk).long()
    at_c = sample[c.clamp(max=ns - 1)]
    if log_s == 0:
        return c.int(), (c < ns) & (at_c == lk)
    idx, hv = torch.where(c > 0, (c - 1) << log_s, 0), at_c
    step = (1 << log_s) >> 1
    while step >= W:
        j = idx + step
        ok = (c > 0) & (j < m)
        v = r[j.clamp(max=m - 1)]
        less = ok & (v < lk)
        idx, hv = torch.where(less, j, idx), torch.where(ok & ~less, v, hv)
        step >>= 1
    jj = idx[:, None] + torch.arange(W)
    sec = r[jj.clamp(max=m - 1)]
    cnt = ((jj < m) & (sec < lk[:, None])).sum(1)
    at = torch.where(cnt < W, sec.gather(1, cnt.clamp(max=W - 1)[:, None])[:, 0], hv)
    p = idx + cnt
    pos = torch.where(c == 0, 0, p)
    hit = torch.where(c == 0, sample[0] == lk, (p < m) & (at == lk))
    return pos.int(), hit


# (m, log_s, kind): the sample's edges at the sizes the chip check forces
# them (chip_smoke.JOIN_SAMPLE_EDGES), and a side staged whole
SAMPLE_EDGES = [(3, 3, "m < s"), (1001, 4, "m % s != 0"), (100, 4, "NaN tail"),
                (4099, 5, "keys at sample points"), (700, 0, "staged whole"),
                (2000, 8, "deep device levels")]


@pytest.mark.parametrize("m,log_s,kind", SAMPLE_EDGES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_two_level_search_vs_pallas(m, log_s, kind, dtype):
    """The card's two-level search, emulated, bit for bit against the Pallas
    kernel in interpret mode, at the step given and the next one."""
    rng = _rng("two-level", m, log_s, np.dtype(dtype).name)
    r = _right(rng, m, 4 * m)
    s = 1 << log_s
    if kind == "NaN tail" and dtype == np.float32:
        r[s * 3 + s // 2:] = np.nan  # from mid-step 3 past sample point 4
    live = r[~np.isnan(r)]
    lk = np.concatenate([r[::s], r[::s] + 1, r[::s] - 1, live[-1:] + 1, live[:1] - 1,
                         rng.integers(-2 * m, 4 * m, 500).astype(np.float64)])
    if dtype == np.float32:
        lk[:4] = [np.nan, np.inf, -np.inf, -0.0]
    jpos, jhit = j_join_probe(jnp.asarray(lk, jnp.float32), jnp.asarray(r, jnp.float32),
                              interpret=True)
    for k in ((0,) if log_s == 0 else (log_s, log_s + 1)):
        pos, hit = _two_level(_t(lk.astype(dtype)), _t(r.astype(dtype)), k)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_two_level_search_native_wide_keys(dtype):
    """Keys beyond 2^24 through the emulated search at the wrapper's own
    step for a 900,000-key side scaled down (the step the rule gives a
    30,000-key side), against np.searchsorted."""
    rng = _rng("two-level wide", np.dtype(dtype).name)
    m = 30_000
    r = (2.0**40 + np.sort(rng.choice(4 * m, m, replace=False))).astype(dtype)
    lk = np.concatenate([r[::7], 2.0**40 + rng.integers(-10, 4 * m + 10, 5000)]).astype(dtype)
    k = JP.sample_log2(m, 8)
    assert k == 2  # 30,000 x 8 bytes: beyond 227 KB; 7,500 sampled keys fit 64 KB
    pos, hit = _two_level(_t(lk), _t(r), k)
    want = np.searchsorted(r, lk, side="left")
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(hit.numpy(), r[np.clip(want, 0, m - 1)] == lk)


@pytest.mark.parametrize("m,itemsize,log_s", [
    (1, 8, 0), (29_056, 8, 0), (29_057, 8, 2), (58_112, 4, 0), (58_113, 4, 3),
    (900_000, 8, 7), (900_000, 4, 6), (2**31 - 1, 8, 18), (2**31 - 1, 4, 17)])
def test_sample_rule(m, itemsize, log_s):
    """Staged whole up to 227 KB; else the least step of at least one
    32-byte sector whose sample fits 64 KB."""
    assert JP.sample_log2(m, itemsize) == log_s
    if log_s:
        assert (1 << log_s) * itemsize >= 32
        assert -(-m >> log_s) * itemsize <= JP.SAMPLE_MAX


def test_join_probe_padded_rejects_mixed_types_and_empty_right():
    with pytest.raises(TypeError):
        tops.join_probe_padded(_t(np.arange(3.0)), _t(np.arange(3)))
    with pytest.raises(ValueError):
        tops.join_probe_padded(_t(np.zeros(0)), _t(np.arange(3.0)))


# ------------------------------------------------------------ the backend ----
def _part(cols):
    return Partition({k: Column(data=d, mask=m) for k, (d, m) in cols.items()})


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("ltype,rtype", [
    (np.int64, np.int64), (np.float64, np.float64), (np.int32, np.int64),
    (np.float32, np.int64), (np.float32, np.float32), (np.int32, np.int32),
    (np.uint64, np.uint64), (np.uint32, np.uint64), (np.bool_, np.int16)])
def test_join_partition_matches_numpy_reference(how, ltype, rtype):
    """Every numeric key pairing takes the probe and assembles the numpy
    reference's partition bit for bit (misses, null keys on both sides);
    uint64 keys straddle 2^63."""
    rng = _rng("bk", how, np.dtype(ltype).name, np.dtype(rtype).name)
    wide = np.dtype(ltype).itemsize == np.dtype(rtype).itemsize == 8
    big = (2**63 - 150 if ltype == np.uint64 else 2**40) if wide else 0
    rkeys = (np.uint64(big) + rng.permutation(300).astype(np.uint64)).astype(rtype)
    rmask = rng.random(300) > 0.05
    right = PTable([_part({"i": (rkeys, rmask), "w": (rng.normal(size=300), None)})])
    lkeys = (np.uint64(big) + rng.integers(0, 360, 2000).astype(np.uint64)).astype(ltype)
    if np.dtype(ltype).kind == "f":
        lkeys[:5] += 0.5  # fractional keys never match
    left = _part({"i": (lkeys, rng.random(2000) > 0.1), "x": (rng.normal(size=2000), None)})
    TBK.reset_breakers()
    got = TBK.join_partition(left, right, "i", how, backend="torch", device="cpu")
    want = TB.join_partition(left, right, "i", how)
    assert pydict_equal(PTable([got]).to_pydict(), PTable([want]).to_pydict())
    snap = TBK.breaker_board().snapshot()["join|torch"]
    assert snap["successes"] == 1 and snap["failures"] == 0


# ------------------------------------------------------------ the sessions ----
def _catalog(pkg):
    C, S = pkg.ColSpec, pkg.TableSpec
    cat = pkg.Catalog()
    cat.register(S("facts", nrows=6_000, io_seconds=1.0, seed=5, cols=(
        C("x", low=0.0, high=10.0), C("i", kind="int", low=0, high=120, null_frac=0.1),
        C("k", kind="cat", n_categories=9))))
    cat.register(S("dim", nrows=80, io_seconds=0.01, seed=9, cols=(
        C("i", kind="key"), C("w", null_frac=0.2), C("seg", kind="cat", n_categories=5))))
    return cat


def p_join_left(s):
    return s.read_table("facts").join(s.read_table("dim"), on="i", how="left")


def p_join_inner(s):
    return s.read_table("facts").join(s.read_table("dim"), on="i")


def p_join_left_head(s):
    return s.read_table("facts").join(s.read_table("dim"), on="i", how="left").head(100)


def p_join_groupby(s):
    df = s.read_table("facts").join(s.read_table("dim"), on="i")
    return df.groupby("seg").agg({"x": "mean", "w": "sum"})


PROGRAMS = {f.__name__[2:]: f for f in (p_join_left, p_join_inner, p_join_left_head,
                                        p_join_groupby)}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_join_program_matches_reference(name):
    prog = PROGRAMS[name]
    ref_s = R.Session(catalog=_catalog(R), mode="sim", kernel_backend="xla")
    TBK.reset_breakers()
    got_s = T.Session(catalog=_catalog(T), mode="sim", kernel_backend="torch", device="cpu")
    ref, got = ref_s.show(prog(ref_s)).to_pydict(), got_s.show(prog(got_s)).to_pydict()
    snap = TBK.breaker_board().snapshot()["join|torch"]
    assert snap["successes"] > 0 and snap["failures"] == snap["fallbacks"] == 0
    if name == "join_groupby":
        assert list(got) == list(ref)
        for col in ref:
            r, g = np.asarray(ref[col]), np.asarray(got[col])
            if r.dtype.kind in "OU":
                np.testing.assert_array_equal(g, r)
            else:
                np.testing.assert_allclose(g.astype(float), r.astype(float), rtol=2e-3, atol=1e-5)
    else:
        assert pydict_equal(ref, got)
        if name == "join_left":
            w = np.asarray(got["w"], dtype=float)
            i = np.asarray(got["i"], dtype=float)
            assert np.isnan(w[i >= 80]).all() and len(w) == 6_000
