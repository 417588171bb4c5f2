"""The port's frame kernels against the JAX package's, on the CPU.

For each of the four kernels the same numpy inputs (made from a seed) go
through the JAX Pallas kernel in interpret mode, the JAX ``ops`` entry on the
``xla`` backend, and the port's plain PyTorch version (what a kernel wrapper
runs on a CPU tensor).  Tolerances: counts, min, max, top-k values and
compacted bytes exact; float32 sums within 1e-5 of Σ|x| (per bucket for
segment sums) and m2 within 1e-4 relative, since the sums are taken in
another order.

The port's own bit-for-bit contracts are pinned on its ``torch`` backend:
pad invariance, ``*_parts`` == unbatched, and fused == unfused.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.filter_compact import filter_compact as j_filter_compact
from repro.kernels.masked_stats import masked_stats as j_masked_stats
from repro.kernels.segment_reduce import segment_reduce as j_segment_reduce
from repro.kernels.topk import topk as j_topk
from repro_torch.kernels import filter_compact as FC
from repro_torch.kernels import masked_stats as MS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_reduce as SR
from repro_torch.kernels import topk as TK


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stats_close(got, want, x, m):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got[0] == want[0]  # count
    assert got[3] == want[3] and got[4] == want[4]  # min, max
    scale = np.abs(np.where(m, x, 0)).sum() + 1e-30
    assert abs(got[1] - want[1]) <= 1e-5 * scale
    assert abs(got[2] - want[2]) <= 1e-4 * abs(want[2]) + 1e-6


def _sums_close(got, want, keys, vals, valid, nb):
    """Per-bucket f32 sums within 1e-5 of that bucket's own Σ|x|."""
    scale = np.bincount(keys[valid], weights=np.abs(vals[valid]), minlength=nb)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-5 * scale).all(), (err - 1e-5 * scale).max()


# ---------------------------------------------------------------- masked_stats --
@pytest.mark.parametrize("n", [10, 1000, 5001, 20_000])
@pytest.mark.parametrize("null_frac", [0.0, 0.3])
def test_masked_stats_vs_pallas(n, null_frac):
    rng = _rng("ms", n, null_frac)
    x = (rng.normal(size=n) * 10 + 100).astype(np.float32)
    m = rng.uniform(size=n) >= null_frac
    jp = np.asarray(j_masked_stats(jnp.asarray(x), jnp.asarray(m), interpret=True))
    got = MS.masked_stats_plain(_t(x)[None], _t(m)[None])[0].numpy()
    _stats_close(got, jp, x, m)


def test_masked_stats_batch_vs_xla_and_all_masked_row():
    rng = _rng("msb")
    xs = rng.normal(1e3, 3.0, (3, 40_000)).astype(np.float32)
    ms = rng.random((3, 40_000)) < 0.7
    ms[1] = False
    with jops.local_backend("xla"):
        want = np.asarray(jops.masked_stats_batch(jnp.asarray(xs), jnp.asarray(ms)))
    with tops.local_backend("torch"):
        got = tops.masked_stats_batch(_t(xs), _t(ms)).numpy()
    for i in range(3):
        _stats_close(got[i], want[i], xs[i], ms[i])
    assert got[1].tolist() == [0.0, 0.0, 0.0, np.inf, -np.inf]


# -------------------------------------------------------------- segment_reduce --
@pytest.mark.parametrize("n,nb", [(100, 7), (3000, 37), (5000, 200)])
@pytest.mark.parametrize("mode", ["sum", "min", "max"])
def test_segment_reduce_vs_pallas(n, nb, mode):
    rng = _rng("sr", n, nb, mode)
    keys = rng.integers(0, nb, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.25
    jout, jcnt = j_segment_reduce(jnp.asarray(keys), jnp.asarray(vals),
                                  jnp.asarray(valid), nb, mode=mode, interpret=True)
    reds, cnts = SR.segment_reduce_plain(_t(keys), _t(vals)[None], _t(valid)[None],
                                         nb, [mode], [0])
    np.testing.assert_array_equal(cnts[0].numpy(), np.asarray(jcnt).astype(np.int64))
    if mode == "sum":
        _sums_close(reds[0].numpy(), np.asarray(jout), keys, vals, valid, nb)
    else:
        np.testing.assert_array_equal(reds[0].numpy(), np.asarray(jout))


def test_segment_reduce_batch_vs_xla():
    rng = _rng("srb")
    n, nb = 30_000, 50
    keys = rng.integers(0, nb, n).astype(np.int32)
    vals = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    valids = [rng.random(n) < 0.8, rng.random(n) < 0.5]
    modes, vidx = ["sum", "min", "max"], [0, 1, 0]
    with jops.local_backend("xla"):
        jr, jc = jops.segment_reduce_batch(
            jnp.asarray(keys), [jnp.asarray(v) for v in vals],
            [jnp.asarray(m) for m in valids], nb, modes, vidx)
    with tops.local_backend("torch"):
        tr, tc = tops.segment_reduce_batch(
            _t(keys), [_t(v) for v in vals], [_t(m) for m in valids], nb, modes, vidx)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(tr[1:].numpy(), np.asarray(jr)[1:])
    _sums_close(tr[0].numpy(), np.asarray(jr)[0], keys, vals[0], valids[0], nb)


def test_segment_reduce_ref_and_shared_memory_gate():
    keys = _t(np.array([0, 0, 5], np.int32))
    vals = _t(np.array([1.0, 2.0, 3.0], np.float32))
    red, cnt = SR.segment_reduce_plain(keys, vals[None], torch.ones((1, 3), dtype=torch.bool),
                                       8, ["sum"], [0])
    assert red[0].tolist() == [3, 0, 0, 0, 0, 3, 0, 0]
    assert cnt[0].tolist() == [2, 0, 0, 0, 0, 1, 0, 0]
    assert SR.fits(3, 4, 1000) and not SR.fits(3, 4, 50_000)


# ------------------------------------------------------------------------ topk --
@pytest.mark.parametrize("n,k", [(100, 1), (4000, 7), (4000, 64), (999, 10), (9000, 128)])
@pytest.mark.parametrize("largest", [True, False])
def test_topk_vs_pallas(n, k, largest):
    x = _rng("tk", n, k).normal(size=n).astype(np.float32)
    jp = np.asarray(j_topk(jnp.asarray(x), k, largest=largest, interpret=True))
    got = TK.topk_plain(_t(x)[None], k, largest)[0].numpy()
    assert (got == jp).all()
    with tops.local_backend("torch"):
        assert (tops.topk_padded(_t(x), k, largest).numpy() == jp).all()


def test_topk_infinities_and_signed_zero():
    x = np.array([0.0, -0.0, np.inf, -np.inf, 1.5, -2.0] * 700, np.float32)
    for largest in (True, False):
        with jops.local_backend("xla"):
            want = np.asarray(jops.topk_padded(jnp.asarray(x), 20, largest))
        got = TK.topk_plain(_t(x)[None], 20, largest)[0].numpy()
        assert (got == want).all()


# -------------------------------------------------------------- filter_compact --
@pytest.mark.parametrize("n", [64, 1000, 4096, 10_000])
@pytest.mark.parametrize("sel", [0.0, 0.5, 1.0])
def test_filter_compact_vs_pallas(n, sel):
    rng = _rng("fc", n, sel)
    x = rng.normal(size=n).astype(np.float32)
    keep = rng.uniform(size=n) < sel
    jout, jcnt = j_filter_compact(jnp.asarray(x), jnp.asarray(keep), interpret=True)
    out, cnt = FC.filter_compact_plain(_t(x)[None], _t(keep))
    assert int(cnt[0]) == int(jcnt)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout))
    with jops.local_backend("xla"):
        xout, xcnt = jops.filter_compact_padded(jnp.asarray(x), jnp.asarray(keep))
    with tops.local_backend("torch"):
        tout, tcnt = tops.filter_compact_padded(_t(x), _t(keep))
    assert int(tcnt) == int(xcnt)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(xout))


@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.int32, np.float32, np.bool_])
def test_filter_compact_moves_every_width_exactly(dtype):
    rng = _rng("fcw", np.dtype(dtype).name)
    x = rng.normal(0, 1e6, (2, 7000)).astype(dtype)
    keep = rng.random(7000) < 0.4
    out, cnt = FC.filter_compact_plain(_t(x), _t(keep), 0)
    for r in range(2):
        np.testing.assert_array_equal(out[r, : int(cnt[r])].numpy(), x[r][keep])
        assert not out[r, int(cnt[r]):].numpy().any()


# -------------------------------------------------------------------- argsort --
def test_argsort_f64_matches_numpy_stable():
    rng = _rng("sort")
    keys = np.concatenate([rng.integers(0, 50, 3000).astype(np.float64),
                           [np.inf, -np.inf, -0.0, 0.0, 1e-300, -1e-300, 2.0**60 + 1]])
    rng.shuffle(keys)
    got = tops.argsort_f64(_t(keys)).numpy()
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


# ------------------------------------------------ the port's bit-for-bit contracts --
def test_pad_invariance_bitforbit():
    rng = _rng("pad")
    n = 40_000
    xs = _t(rng.normal(5, 3, (2, n)).astype(np.float32))
    ms = _t(rng.random((2, n)) < 0.8)
    keys = _t(rng.integers(0, 9, n).astype(np.int32))
    with tops.local_backend("torch"):
        a = tops.masked_stats_batch(xs, ms)
        b = tops.masked_stats_batch(tops._pad_last(xs, 2 * n, 0.0), tops._pad_last(ms, 2 * n, False))
        assert torch.equal(a, b)
        r1, c1 = tops.segment_reduce_batch(keys, [xs[0]], [ms[0]], 9, ["sum"], [0])
        r2, c2 = tops.segment_reduce_batch(
            tops._pad_last(keys, 2 * n, 0), [tops._pad_last(xs[0], 2 * n, 0.0)],
            [tops._pad_last(ms[0], 2 * n, False)], 9, ["sum"], [0])
        assert torch.equal(r1, r2) and torch.equal(c1, c2)


def test_parts_equal_unbatched_bitforbit():
    rng = _rng("parts")
    lens = [20_000, 25_000, 30_000]  # one shape bucket (32768)
    xs = [_t(rng.normal(0, 1, n).astype(np.float32)) for n in lens]
    ms = [_t(rng.random(n) < 0.9) for n in lens]
    ks = [_t(rng.integers(0, 5, n).astype(np.int32)) for n in lens]
    with tops.local_backend("torch"):
        stk = [tops._pad_last(x[None], 32768, 0.0) for x in xs]
        smk = [tops._pad_last(m[None], 32768, False) for m in ms]
        parts = tops.masked_stats_batch_parts(stk, smk)
        for i in range(3):
            assert torch.equal(parts[i], tops.masked_stats_batch(stk[i], smk[i])[0])
        rp, cp = tops.segment_reduce_batch_parts(
            ks, [[x] for x in xs], [[m] for m in ms], 5, ["max"], [0])
        tp = tops.topk_padded_parts(xs, 16, largest=False)
        fp, fcnt = tops.filter_compact_padded_parts(xs, ms)
        sp = tops.argsort_f64_parts([x.double() for x in xs])
        for i in range(3):
            r, c = tops.segment_reduce_batch(ks[i], [xs[i]], [ms[i]], 5, ["max"], [0])
            assert torch.equal(rp[i], r) and torch.equal(cp[i], c)
            assert torch.equal(tp[i], tops.topk_padded(xs[i], 16, largest=False))
            o, cnt = tops.filter_compact_padded(xs[i], ms[i])
            assert int(fcnt[i]) == int(cnt) and torch.equal(fp[i, : lens[i]], o)
            assert torch.equal(sp[i, : lens[i]], tops.argsort_f64(xs[i].double()))


def test_fused_equal_unfused_bitforbit():
    rng = _rng("fused")
    n = 30_000
    xs = _t(rng.normal(0, 1, (2, n)).astype(np.float32))
    ms = _t(rng.random((2, n)) < 0.85)
    keys = _t(rng.integers(0, 6, n).astype(np.int32))
    keep = _t(rng.random(n) < 0.4)
    cnt = int(keep.sum())
    with tops.local_backend("torch"):
        xc = torch.stack([xs[i][keep] for i in range(2)])
        mc = torch.stack([ms[i][keep] for i in range(2)])
        assert torch.equal(tops.filter_then_masked_stats(xs, ms, keep),
                           tops.masked_stats_batch(xc, mc))
        fr, fcnt = tops.filter_then_segment_reduce(
            keys, [xs[0], xs[1]], [ms[0], ms[1]], keep, 6, ["sum", "min"], [0, 1])
        ur, ucnt = tops.segment_reduce_batch(
            keys[keep], [xc[0], xc[1]], [mc[0], mc[1]], 6, ["sum", "min"], [0, 1])
        assert torch.equal(fr, ur) and torch.equal(fcnt, ucnt)
        assert torch.equal(tops.topk_masked_padded(xs[0], keep, 8),
                           tops.topk_padded(xc[0], 8))
    assert xc.shape[1] == cnt


def test_cuda_backend_on_cpu_tensors_runs_plain_version_without_launch():
    """A wrapper takes its plain version only because the tensor is on the
    CPU; no launch is counted."""
    tops.reset_launch_counts()
    x = _t(np.arange(600, dtype=np.float32))
    with tops.local_backend("cuda"):
        assert tops.topk_padded(x, 3).tolist() == [599.0, 598.0, 597.0]
        tops.masked_stats_batch(x[None], torch.ones((1, 600), dtype=torch.bool))
    assert tops.launch_counts() == {
        "masked_stats": 0, "segment_reduce": 0, "topk": 0, "filter_compact": 0}
