"""The port's join against the JAX package's, on the CPU.

``join_probe_plain`` (what the ``join_probe`` wrapper runs on a CPU tensor)
and ``ops.join_probe_padded`` are held bit for bit against the JAX Pallas
kernel in interpret mode and the JAX ``ops`` entry, on float32 and int32
keys within 2^24 and on the edge cases of the counting formulation (NaN on
either side, ±inf, -0.0 against +0.0, duplicate left keys).  Native float64
and int64 keys beyond 2^24, which the reference cannot compare exactly,
are held against ``np.searchsorted``.  Join programs with misses, null keys
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
