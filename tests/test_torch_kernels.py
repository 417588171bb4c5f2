"""The port's frame kernels against the JAX package's, on the CPU.

For each of the four frame kernels the same numpy inputs (made from a seed) go
through the JAX Pallas kernel in interpret mode, the JAX ``ops`` entry on the
``xla`` backend, and the port's plain PyTorch version (what a kernel wrapper
runs on a CPU tensor).  filter_compact's two-pass scheme on the card (tile
counts, each tile's offset summed from the tiles before it, in-tile ranks by
ballot in (item, warp) order) is emulated in numpy and held bit for bit
against the Pallas kernel and the plain version at the tile edges; so is
topk's threshold-filtered select (warp lists, ballot-ranked queues, bitonic
networks, the block's tree and the second launch; NaNs counted and put
first) against the Pallas kernel's values, NaN rows included, and masked_stats' merge (the chains without the live
gate) against the plain version's fold.  Tolerances: counts, min, max, top-k
values and compacted bytes exact; float32 sums within 1e-5 of Σ|x| (per bucket for
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
@pytest.mark.parametrize("n", [3, 10, 1000, 5001, 16_385, 20_000])
@pytest.mark.parametrize("null_frac", [0.0, 0.3])
def test_masked_stats_vs_pallas(n, null_frac):
    rng = _rng("ms", n, null_frac)
    x = (rng.normal(size=n) * 10 + 100).astype(np.float32)
    m = rng.uniform(size=n) >= null_frac
    jp = np.asarray(j_masked_stats(jnp.asarray(x), jnp.asarray(m), interpret=True))
    got = MS.masked_stats_plain(_t(x)[None], _t(m)[None])[0].numpy()
    _stats_close(got, jp, x, m)


@pytest.mark.parametrize("kind", ["one live value in the last tile", "inf and NaN in masked lanes"])
def test_masked_stats_edge_rows_vs_pallas(kind):
    """A row whose one live value sits in its last tile, and a row whose
    masked lanes hold ±inf and NaN.  The plain version drops masked lanes
    (ROADMAP C2), so it gives the answer of the same row with finite values
    there, bit for bit; that row is the one held against the reference,
    which multiplies by the mask and so turns a masked inf into NaN."""
    rng = _rng("ms edge", kind)
    n = 16_384 * 2 + 100
    x = rng.normal(-4.0, 2.0, n).astype(np.float32)
    if kind.startswith("one"):
        m = np.zeros(n, bool)
        m[n - 1] = True
        clean = x
    else:
        m = rng.random(n) < 0.6
        clean = np.where(m, x, 0.0).astype(np.float32)
        x = np.where(m, x, np.where(rng.random(n) < 0.5, np.inf, -np.inf)).astype(np.float32)
        x[~m & (rng.random(n) < 0.3)] = np.nan
    got = MS.masked_stats_plain(_t(x)[None], _t(m)[None])[0]
    assert torch.isfinite(got).all()
    assert torch.equal(got, MS.masked_stats_plain(_t(clean)[None], _t(m)[None])[0])
    jp = np.asarray(j_masked_stats(jnp.asarray(clean), jnp.asarray(m), interpret=True))
    _stats_close(got.numpy(), jp, clean, m)
    if kind.startswith("one"):
        assert got.tolist() == [1.0, float(x[-1]), 0.0, float(x[-1]), float(x[-1])]


def _merge_like_the_kernel(tcnt, tsum, tm2):
    """stats_merge's fold in float32: the count before each tile by an
    integer scan, the sum and m2 chains with the live gate taken off (an
    all-masked tile adds -0.0), the cross terms from the sums before."""
    f = np.float32
    live = tcnt > 0
    fc = np.concatenate([[0], np.cumsum(tcnt)[:-1]]).astype(np.float32)
    s, s_before = f(0.0), np.empty(len(tsum), np.float32)
    for i, x in enumerate(np.where(live, tsum, f(-0.0))):
        s_before[i] = s
        s = f(s + x)
    ftc = tcnt.astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        delta = tsum / np.maximum(ftc, f(1)) - s_before / np.maximum(fc, f(1))
        cross = delta * delta * fc * ftc / np.maximum(fc + ftc, f(1))
    m2 = f(0.0)
    for y, z in zip(np.where(live, tm2, f(-0.0)), np.where(live, cross, f(-0.0))):
        m2 = f(f(m2 + y) + z)
    return np.float32(tcnt.sum()), s, m2


@pytest.mark.parametrize("kind", ["random", "signed zeros", "dead tiles"])
def test_masked_stats_merge_chains_equal_the_plain_fold_bit_for_bit(kind):
    """The kernel's merge (an integer scan, chains without the live gate,
    cross terms apart) gives the plain version's fold bit for bit on the
    same tile partials."""
    rng = _rng("ms merge", kind)
    n = MS.TILE * 40 + 17
    x = rng.normal(3.0, 2.0, (1, n)).astype(np.float32)
    m = rng.random((1, n)) < 0.5
    if kind == "signed zeros":
        x[:] = -0.0
    if kind != "random":
        m[:, MS.TILE * 3: MS.TILE * 20] = False  # whole tiles masked
    want = MS.masked_stats_plain(_t(x), _t(m))[0].numpy()
    nt = -(-n // MS.TILE)
    xs = _t(np.pad(x, ((0, 0), (0, nt * MS.TILE - n)))).reshape(nt, MS.TILE)
    ms = _t(np.pad(m, ((0, 0), (0, nt * MS.TILE - n)))).reshape(nt, MS.TILE)
    zero = torch.zeros(())
    tcnt = ms.sum(-1)
    tsum = torch.where(ms, xs, zero).sum(-1)
    tmean = tsum / tcnt.float().clamp(min=1.0)
    d = torch.where(ms, xs - tmean[:, None], zero)
    got = _merge_like_the_kernel(tcnt.numpy(), tsum.numpy(), (d * d).sum(-1).numpy())
    assert np.array(got, np.float32).tobytes() == want[:3].tobytes()


def test_kernel_buffers_put_the_scratch_where_the_kernels_need_it():
    """masked_stats and topk make one allocation a call, the result's rows
    first: masked_stats' partials start on 16 bytes, one row of five a
    tile; topk's winners follow the result, blocks * k a row."""
    for rows, n in ((1, 1), (3, 16_385), (4, 4_194_304), (7, 100)):
        size, head = MS.buffer_rows(rows, n)
        assert head * 20 % 16 == 0 and head >= rows
        assert size - head == rows * -(-n // MS.TILE)
    for rows, n in ((1, 4_194_304), (3, 4097), (2, 129), (1, 1), (8, 600_000)):
        blocks, size = TK.buffer_rows(rows, n)
        assert blocks == TK.topk_blocks(rows, n) >= 1
        assert size == rows * (1 + blocks if blocks > 1 else 1)
    assert TK.topk_blocks(1, 4_194_304) == TK.GRID
    assert TK.topk_blocks(8, 600_000) == -(-TK.GRID // 8)
    assert TK.topk_blocks(1, TK.SPAN) == 1


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
    # no shared-memory gate: the sort's passes come from B alone (one 0-bit
    # pass, a stable compaction, for B = 1; at most three below 2^24), and
    # the scratch grows with the rows, not with B
    assert [SR.sort_plan(1000, b, 1).passes for b in (1, 1000, 100_000, (1 << 24) - 1)] == \
        [1, 1, 2, 3]
    assert [SR.sort_plan(1000, b, 1).digit_bits for b in (1, 1000, 100_000, (1 << 24) - 1)] == \
        [0, 10, 9, 8]
    n = 2_204_249
    plan = SR.sort_plan(n, 100_000, 1)
    assert plan.scratch_bytes <= 24 * n
    assert SR.FOLD_CHUNK ** plan.fold_levels >= n > SR.FOLD_CHUNK ** (plan.fold_levels - 1)
    assert SR.sort_plan(n, (1 << 24) - 1, 3).scratch_bytes <= 24 * n
    assert SR.sort_plan(n, 1000, 0).scratch_bytes == 0  # counts alone: no sort


@pytest.mark.parametrize("mode", ["sum", "min", "max"])
def test_segment_reduce_high_cardinality_vs_xla(mode):
    """B = 100,000: beyond one block's shared memory, now one kernel call
    with wider tiles.  Plain version and the ops entry against the JAX xla
    path: counts exact, min / max exact, sums within 1e-5 of each bucket's
    Σ|x|."""
    rng = _rng("srhc", mode)
    n, nb = 30_000, 100_000
    keys = rng.integers(0, nb, n).astype(np.int32)
    keys[:500] = 7  # one heavy bucket
    vals = rng.normal(size=n).astype(np.float32)
    valid = rng.random(n) < 0.8
    with jops.local_backend("xla"):
        jr, jc = jops.segment_reduce(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid),
                                     nb, mode)
    jr, jc = np.asarray(jr), np.asarray(jc).astype(np.int64)
    red, cnt = SR.segment_reduce_plain(_t(keys), _t(vals)[None], _t(valid)[None], nb, [mode], [0])
    with tops.local_backend("torch"):
        ored, ocnt = tops.segment_reduce_batch(_t(keys), [_t(vals)], [_t(valid)], nb, [mode], [0])
    for r, c in ((red, cnt), (ored, ocnt)):
        np.testing.assert_array_equal(c[0].numpy(), jc)
        if mode == "sum":
            _sums_close(r[0].numpy(), jr, keys, vals, valid, nb)
        else:
            np.testing.assert_array_equal(r[0].numpy(), jr)


def _skewed_keys(kind, n):
    """Keys that pile up: every row in one bucket, or Zipf(1.1) frequencies
    over 100,000 buckets with the heavy ones scattered."""
    rng = _rng("skew", kind, n)
    if kind == "one bucket of 1":
        return np.zeros(n, np.int32), 1
    if kind == "one bucket of 64":
        return np.full(n, 17, np.int32), 64
    nb = 100_000
    p = 1.0 / np.arange(1, nb + 1, dtype=np.float64) ** 1.1
    return rng.permutation(nb).astype(np.int32)[rng.choice(nb, n, p=p / p.sum())], nb


@pytest.mark.parametrize("kind", ["one bucket of 1", "one bucket of 64", "zipf over 100,000"])
@pytest.mark.parametrize("route", ["plain", "ops batch"])
def test_segment_reduce_skewed_keys_vs_xla(kind, route):
    """Skewed keys (the longest runs of the kernel's fold) through the plain
    version and the torch ops entry, against the JAX xla path: counts, min
    and max exact, sums within 1e-5 of each bucket's Σ|x|."""
    n = 40_000
    keys, nb = _skewed_keys(kind, n)
    rng = _rng("skewv", kind)
    vals = [rng.normal(0, 10, n).astype(np.float32) for _ in range(3)]
    valids = [rng.random(n) < 0.9, rng.random(n) < 0.6]
    modes, vidx = ["sum", "min", "max"], [0, 1, 1]
    with jops.local_backend("xla"):
        jr, jc = jops.segment_reduce_batch(
            jnp.asarray(keys), [jnp.asarray(v) for v in vals],
            [jnp.asarray(m) for m in valids], nb, modes, vidx)
    jr, jc = np.asarray(jr), np.asarray(jc).astype(np.int64)
    if route == "plain":
        tr, tc = SR.segment_reduce_plain(_t(keys), _t(np.stack(vals)), _t(np.stack(valids)),
                                         nb, modes, vidx)
    else:
        with tops.local_backend("torch"):
            tr, tc = tops.segment_reduce_batch(
                _t(keys), [_t(v) for v in vals], [_t(m) for m in valids], nb, modes, vidx)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tr[1:].numpy(), jr[1:])
    _sums_close(tr[0].numpy(), jr[0], keys, vals[0], valids[0], nb)


def test_high_cardinality_groupby_and_value_counts_take_the_kernel_route():
    """No shared-memory gate: a 100,000-category groupby and value_counts
    run segment_reduce (the torch backend here), not numpy, and agree with
    the numpy partials."""
    from repro_torch.frame import backend as TBK
    from repro_torch.frame import blocking as TB
    from repro_torch.frame.table import Column, Partition

    rng = _rng("route")
    n, nb = 20_000, 100_000
    part = Partition({
        "g": Column(data=rng.integers(0, nb, n).astype(np.int32),
                    dictionary=np.array([f"g{i}" for i in range(nb)], dtype=object)),
        "x": Column(data=rng.normal(size=n), mask=rng.random(n) < 0.9),
    })
    aggs = [("x", "x", "mean"), ("n", "x", "count")]
    TBK.reset_breakers()
    got = TBK.partial_groupby(part, "g", aggs, backend="torch", device="cpu")
    want = TB.partial_groupby(part, "g", aggs)
    np.testing.assert_array_equal(got["keys"], want["keys"])
    vals, cnts = TBK.partial_value_counts(part, "g", backend="torch", device="cpu")
    wv, wc = TB.partial_value_counts(part, "g")
    np.testing.assert_array_equal(vals, wv)
    np.testing.assert_array_equal(cnts, wc)
    snap = TBK.breaker_board().snapshot()
    for op in ("groupby", "value_counts"):
        assert snap[f"{op}|torch"]["successes"] == 1 and snap[f"{op}|torch"]["failures"] == 0


# ------------------------------------------------------------------------ topk --
def _topk_row(kind, n):
    """One row of the kind named: random, sorted either way, one value
    repeated, 7 finite values among -inf, or NaN rows: the smallest one
    ([1, NaN, 3, 2, -1]), one NaN, 30 NaNs (more than k), and NaNs beside
    +inf and -inf."""
    rng = _rng("tk", kind, n)
    x = rng.normal(size=n).astype(np.float32)
    if kind == "nan smallest":
        x = np.array([1.0, np.nan, 3.0, 2.0, -1.0], np.float32)
    elif kind == "one nan":
        x[rng.integers(n)] = np.nan
    elif kind == "many nan":
        x[rng.choice(n, 30, replace=False)] = np.nan
    elif kind == "nan inf":
        at = rng.choice(n, 6, replace=False)
        x[at] = [np.nan, np.inf, -np.inf, np.nan, np.inf, -np.inf]
    elif kind == "ascending":
        x = np.sort(x)
    elif kind == "descending":
        x = np.sort(x)[::-1].copy()
    elif kind == "repeated":
        x = np.full(n, 2.5, np.float32)
    elif kind == "few finite":
        x = np.full(n, -np.inf, np.float32)
        x[rng.choice(n, 7, replace=False)] = rng.normal(size=7)
    return x


_TOPK_CASES = [("random", 100, 1), ("random", 4000, 7), ("random", 4000, 64),
               ("random", 999, 10), ("random", 9000, 128), ("random", 129, 128),
               ("ascending", 3000, 20), ("descending", 3000, 20), ("repeated", 2000, 20),
               ("few finite", 3000, 20), ("nan smallest", 5, 2), ("one nan", 4000, 20),
               ("many nan", 4000, 20), ("many nan", 999, 128), ("nan inf", 3000, 20)]


def _same(got, want):
    """Equal values, NaN equal to NaN (and +0.0 to -0.0)."""
    return got.shape == want.shape and np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("kind,n,k", _TOPK_CASES)
@pytest.mark.parametrize("largest", [True, False])
def test_topk_vs_pallas(kind, n, k, largest):
    if kind == "random":
        x = _rng("tk", n, k).normal(size=n).astype(np.float32)
    else:
        x = _topk_row(kind, n)
    jp = np.asarray(j_topk(jnp.asarray(x), k, largest=largest, interpret=True))
    got = TK.topk_plain(_t(x)[None], k, largest)[0].numpy()
    assert _same(got, jp)
    if kind == "nan smallest":  # NaN ranks first, for largest either way
        assert _same(jp, np.array([np.nan, 3.0 if largest else -1.0], np.float32))
    with tops.local_backend("torch"):
        assert _same(tops.topk_padded(_t(x), k, largest).numpy(), jp)


# The kernel's select (csrc/topk.cu), emulated in numpy: element e = r * 32
# + lane of a warp's list is register r of lane `lane`; the same bitonic
# networks, ballot-ranked queue, flushes and block fold, the same spans and
# 16-byte head / tail split for a row that starts `off` floats past a
# 16-byte boundary.
_THREADS, _WARPS, _UNROLL, _BATCH = 256, 8, 8, 32


def _sort_asc(v):
    R = v.shape[0]
    e = np.arange(32 * R).reshape(R, 32)
    lane = np.arange(32)
    size = 2
    while size <= 32 * R:
        j = size // 2
        while j:
            up = (e & size) == 0
            if j < 32:
                o = v[:, lane ^ j]
                keep_min = ((e & j) == 0) == up
                v = np.where(keep_min, np.minimum(v, o), np.maximum(v, o))
            else:
                v = v.copy()
                for r in range(R):
                    if r & (j >> 5) == 0:
                        p = r | (j >> 5)
                        a, b = v[r].copy(), v[p].copy()
                        lo, hi = np.minimum(a, b), np.maximum(a, b)
                        v[r], v[p] = np.where(up[r], lo, hi), np.where(up[r], hi, lo)
            j //= 2
        size *= 2
    return v


def _merge_desc(v):
    R = v.shape[0]
    e = np.arange(32 * R).reshape(R, 32)
    lane = np.arange(32)
    j = 16 * R
    while j:
        if j < 32:
            o = v[:, lane ^ j]
            v = np.where((e & j) == 0, np.maximum(v, o), np.minimum(v, o))
        else:
            v = v.copy()
            for r in range(R):
                if r & (j >> 5) == 0:
                    p = r | (j >> 5)
                    a, b = v[r].copy(), v[p].copy()
                    v[r], v[p] = np.maximum(a, b), np.minimum(a, b)
        j //= 2
    return v


class _Warp:
    def __init__(self, k):
        self.R = 1 if k <= 32 else 2 if k <= 64 else 4
        self.K = 32 * self.R
        self.k = k
        self.lst = np.full((self.R, 32), -np.inf, np.float32)
        self.th = np.float32(-np.inf)
        self.q = np.empty(self.K + 32 * _BATCH, np.float32)
        self.qn = 0

    def fold_ascending(self, c):
        self.lst = _merge_desc(np.maximum(self.lst, c))
        self.th = self.lst.reshape(-1)[self.k - 1]

    def fold_queue(self, start):
        c = np.full(self.K, -np.inf, np.float32)
        live = self.q[start: min(self.qn, start + self.K)]
        c[: live.size] = live
        self.fold_ascending(_sort_asc(c.reshape(self.R, 32)))

    def seed(self, c):
        """c: (STEP, 32), each lane's loaded values; takes out each lane's R
        largest (the first of equal ones) and folds them into the list."""
        top = np.full((self.R, 32), -np.inf, np.float32)
        for r in range(self.R):
            for lane in range(32):
                best, at = np.float32(-np.inf), -1
                for i in range(c.shape[0]):
                    if c[i, lane] > best:
                        best, at = c[i, lane], i
                if at >= 0:
                    c[at, lane] = -np.inf
                top[r, lane] = best
        self.fold_ascending(_sort_asc(top))

    def push(self, v):
        p = v > self.th
        cnt = int(p.sum())
        self.q[self.qn: self.qn + cnt] = v[p]  # ballot rank: lane order
        self.qn += cnt

    def drain(self):
        while self.qn >= self.K:
            self.fold_queue(self.qn - self.K)
            self.qn -= self.K

    def finish(self):
        if self.qn:
            self.fold_queue(0)
        self.qn = 0


def _select_emulated(x, k, blocks, off):
    """topk_spans / topk_merge over one row: (blocks, k) winners, each
    descending, min(NaNs loaded, k) NaNs first (absent values are -inf, and
    a NaN never enters a warp's queue)."""
    n = x.shape[0]
    span = (-(-n // blocks) + 3) & ~3
    out = np.empty((blocks, k), np.float32)
    absent = np.float32(-np.inf)
    lane = np.arange(32)
    for blk in range(blocks):
        s0 = min(n, blk * span)
        s1 = min(n, s0 + span)
        head = min(s1 - s0, (4 - (off + s0) % 4) & 3)
        a = s0 + head
        nvec = (s1 - a) >> 2
        b = a + 4 * nvec
        warps = [_Warp(k) for _ in range(_WARPS)]
        i = np.where(lane < 3, s0 + lane, b + lane - 3)
        inside = np.where(lane < 3, i < a, (lane < 6) & (i < s1))
        single = np.where(inside, x[np.clip(i, 0, n - 1)], absent)
        nans = [int(np.isnan(single).sum())]
        warps[0].push(single)

        def load(v0, w):
            vec = v0 + np.arange(_UNROLL)[:, None] * _THREADS + w * 32 + lane  # (u, lane)
            idx = a + 4 * vec[:, None, :] + np.arange(4)[None, :, None]  # (u, c, lane)
            vals = np.where(vec[:, None, :] < nvec, x[np.clip(idx, 0, n - 1)], absent)
            nans.append(int(np.isnan(vals).sum()))
            return vals.reshape(4 * _UNROLL, 32)

        for w, warp in enumerate(warps):
            if nvec > 0:
                warp.seed(first := load(0, w))
            for v0 in range(0, nvec, _THREADS * _UNROLL):
                c = first if v0 == 0 else load(v0, w)
                for b in range(0, len(c), _BATCH):
                    for v in c[b: b + _BATCH]:
                        warp.push(v)
                    warp.drain()
            warp.finish()
        h = 1
        while h < _WARPS:
            for w in range(0, _WARPS, 2 * h):
                other = warps[w + h].lst.reshape(-1)[::-1].reshape(warps[w].R, 32)
                warps[w].fold_ascending(other)
            h *= 2
        m = min(sum(nans), k)
        out[blk, :m] = np.nan
        out[blk, m:] = warps[0].lst.reshape(-1)[: k - m]
    return out


@pytest.mark.parametrize("kind,n,k", [("random", 5001, 20), ("ascending", 3001, 20),
                                      ("descending", 3001, 20), ("repeated", 2000, 20),
                                      ("few finite", 3000, 20), ("random", 129, 128),
                                      ("random", 4097, 64), ("nan smallest", 5, 2),
                                      ("one nan", 5001, 20), ("many nan", 3001, 20),
                                      ("nan inf", 3001, 20)])
@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("blocks", [1, 3])
def test_topk_select_scheme_vs_pallas(kind, n, k, largest, blocks):
    """The kernel's two launches, emulated, equal the Pallas kernel's
    values: the spans' winners, then one block over them (the first row of
    the winners starts on a 16-byte boundary)."""
    x = _topk_row(kind, n)
    jp = np.asarray(j_topk(jnp.asarray(x), k, largest=largest, interpret=True))
    sign = np.float32(1.0 if largest else -1.0)
    off = zlib.crc32(repr((kind, n, k)).encode()) % 4
    win = _select_emulated(sign * x, k, blocks, off)
    if blocks > 1:
        win = _select_emulated(win.reshape(-1), k, 1, 0)
    got = sign * win[0]
    assert _same(got, jp)
    assert _same(got, TK.topk_plain(_t(x)[None], k, largest)[0].numpy())


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


# ------------------------------------------- the card's compaction, emulated ----
_ITEMS = 8  # == ITEMS in csrc/filter_compact.cu: elements a thread of the scatter loads


def _compact_emulated(x, keep, fill):
    """``csrc/filter_compact.cu``'s scheme in numpy → (out, counts): pass 1
    counts each (keep row, tile of FC_TILE elements); pass 2 gives a tile
    the sum of the counts of the tiles before it as its offset and the sum
    of all as the row's total, and ranks its elements as the block does:
    element base + q THREADS + 32 w + lane is item q of lane ``lane`` in
    warp w; the (item, warp) kept counts are scanned in that order, and a
    lane's rank in its warp is the kept lanes below it in the ballot."""
    tile = FC.FC_TILE
    warps = tile // _ITEMS // 32
    r, n = x.shape
    k2 = keep if keep.ndim == 2 else keep[None]
    nt = -(-n // tile)
    kpad = np.zeros((k2.shape[0], nt * tile), bool)
    kpad[:, :n] = k2
    counts = kpad.reshape(-1, nt, tile).sum(-1)  # pass 1
    out = np.empty_like(x)
    for row in range(r):
        kr = 0 if k2.shape[0] == 1 else row
        before = np.array([counts[kr, :t].sum() for t in range(nt)])
        total = counts[kr].sum()
        kt = kpad[kr].reshape(nt, _ITEMS, warps, 32)
        wc = kt.sum(-1).reshape(nt, -1)  # (tile, item-major (item, warp))
        slots = before[:, None] + np.cumsum(wc, 1) - wc
        dest = slots.reshape(nt, _ITEMS, warps, 1) + np.cumsum(kt, -1) - kt
        xpad = np.zeros(nt * tile, x.dtype)
        xpad[:n] = x[row]
        o = np.full(n + nt * tile, np.array(fill, x.dtype))
        o[dest[kt]] = xpad.reshape(nt, _ITEMS, warps, 32)[kt]
        o[total:] = np.array(fill, x.dtype)
        out[row] = o[:n]
    return out, counts.sum(-1) if k2.shape[0] > 1 else np.repeat(counts.sum(-1), r)


def _tile_edges():
    t = FC.FC_TILE
    return [1, t - 1, t, t + 1, 3 * t + 5]


@pytest.mark.parametrize("n", _tile_edges())
@pytest.mark.parametrize("kind", ["random", "all", "none"])
def test_compact_scheme_vs_pallas(n, kind):
    """The card's scheme, float32, bit for bit against the Pallas kernel in
    interpret mode at the tile edges, keeping some, all and none."""
    rng = _rng("fc-scheme", n, kind)
    x = rng.normal(size=n).astype(np.float32)
    keep = {"random": rng.random(n) < 0.5, "all": np.ones(n, bool),
            "none": np.zeros(n, bool)}[kind]
    out, cnt = _compact_emulated(x[None], keep, 0.0)
    jout, jcnt = j_filter_compact(jnp.asarray(x), jnp.asarray(keep), interpret=True)
    assert int(cnt[0]) == int(jcnt)
    np.testing.assert_array_equal(out[0].view(np.int32), np.asarray(jout).view(np.int32))


@pytest.mark.parametrize("n", _tile_edges())
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.int32, np.float32, np.bool_])
def test_compact_scheme_every_width_vs_plain(n, shared, dtype):
    """The card's scheme, bit for bit against ``filter_compact_plain`` for
    every element width, with one mask shared by the rows and one a row,
    at the tile edges."""
    rng = _rng("fc-scheme-w", n, shared, np.dtype(dtype).name)
    x = rng.normal(0, 1e6, (3, n)).astype(dtype)
    keep = rng.random(n if shared else (3, n)) < 0.4
    out, cnt = _compact_emulated(x, keep, 0)
    pout, pcnt = FC.filter_compact_plain(_t(x), _t(keep), 0)
    bits = {8: np.int64, 4: np.int32, 1: np.uint8}[x.itemsize]
    np.testing.assert_array_equal(out.view(bits), pout.numpy().view(bits))
    np.testing.assert_array_equal(cnt, pcnt.numpy())


@pytest.mark.parametrize("fill,dtype,bits", [
    (0.0, torch.float64, 0), (-0.0, torch.float64, 1 << 63), (1.5, torch.float32, 0x3FC00000),
    (-0.0, torch.float32, 1 << 31), (0, torch.int32, 0), (-1, torch.int32, 0xFFFFFFFF),
    (-1, torch.int64, (1 << 64) - 1), (False, torch.bool, 0), (True, torch.bool, 1)])
def test_fill_bits_cached_per_dtype_and_exact_value(fill, dtype, bits):
    """The fill element's bytes the kernel writes, cached by dtype and value:
    0.0 and -0.0 (equal as keys of a plain cache) keep their own bits."""
    size = torch.empty(0, dtype=dtype).element_size()
    for _ in range(2):  # computed, then cached
        assert FC._fill_bits(fill, dtype, size) == bits
    assert FC._fill_bits(0.0, torch.float64, 8) == 0


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
        "masked_stats": 0, "segment_reduce": 0, "topk": 0, "filter_compact": 0,
        "join_probe": 0, "ssd_chunk_scan": 0, "flash_attention": 0,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
        "flash_attention_wgmma": 0, "flash_attention_bwd_dq_wgmma": 0,
        "flash_attention_bwd_dkdv_wgmma": 0, "ssd_chunk_scan_wgmma": 0,
        "ssd_chunk_scan_short": 0, "ssd_chunk_scan_cells": 0, "ssd_chunk_scan_inter": 0,
        "ssd_chunk_scan_recur": 0, "ssd_chunk_scan_bwd_state": 0,
        "ssd_chunk_scan_bwd_chunk": 0, "ssd_chunk_scan_bwd_sum": 0,
        "ssd_chunk_scan_bwd_state_wgmma": 0, "ssd_chunk_scan_bwd_chunk_wgmma": 0}
