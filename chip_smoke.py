#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card (an H100) and
``nvcc``::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. build  — compiles every kernel of ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and prints the build seconds and the
   card's ``nvidia-smi`` name and power limit;
2. parity — each kernel against its plain PyTorch version on the card, at
   edge-case shapes: exact where the reference is exact (counts, min, max,
   top-k values, compacted bytes), float32 sums within 1e-5 of Σ|x| (per
   row for masked_stats, per bucket for segment_reduce) and m2 within 1e-4
   relative, plus bit equality for pad invariance, batched == per-row and
   fused == unfused;
3. main path — a 10M-row table through a five-cell notebook in a ``cuda``
   session and a ``numpy`` session; answers must agree, every kernel must
   have launched, and no kernel may have failed or fallen back to numpy;
   The notebook then runs once more under torch.profiler, which prints per
   cell the wall time beside the device time in kernels and in copies;
4. real mode — the first two cells with the background worker running;
5. main-path shapes — each kernel against its plain version, by the rules
   of phase 2, at every shape the main path gave it; then the kernel, its
   plain version and one PyTorch library call timed at the largest of them,
   beside the card's bound.

The last two lines are a JSON object per kernel and the result line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
ROWS = 10_000_000

REPLACES = {
    "masked_stats": "src/repro/kernels/masked_stats.py:84",
    "segment_reduce": "src/repro/kernels/segment_reduce.py:103",
    "topk": "src/repro/kernels/topk.py:56",
    "filter_compact": "src/repro/kernels/filter_compact.py:67",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------- #
# phase 2: kernel vs plain version                                             #
# --------------------------------------------------------------------------- #


def check_stats(torch, got, want, xs, ms, label):
    """masked_stats rows: count, min, max exact; sum within 1e-5 of the row's
    Σ|x|; m2 within 1e-4 relative.  Returns max |err| over finite entries."""
    g, w = got.double(), want.double()
    scale = torch.where(ms, xs.abs(), 0.0).double().sum(1) + 1e-30
    check(torch.equal(g[:, [0, 3, 4]], w[:, [0, 3, 4]]), f"masked_stats count/min/max {label}")
    check(bool(((g[:, 1] - w[:, 1]).abs() <= 1e-5 * scale).all()), f"masked_stats sum {label}")
    check(bool(((g[:, 2] - w[:, 2]).abs() <= 1e-4 * w[:, 2].abs() + 1e-6).all()),
          f"masked_stats m2 {label}")
    fin = torch.isfinite(g) & torch.isfinite(w)
    return float((g - w)[fin].abs().max()) if bool(fin.any()) else 0.0


def check_segment(torch, got, want, keys, vals, valid, nbk, modes, vidx, label):
    """segment_reduce: counts, min, max exact; each bucket's sum within 1e-5
    of that bucket's own Σ|x|.  Returns max |err| of the sums."""
    (gr, gc), (wr, wc) = got, want
    check(torch.equal(gc, wc), f"segment_reduce counts {label}")
    err = 0.0
    for s, mode in enumerate(modes):
        if mode != "sum":
            check(torch.equal(gr[s], wr[s]), f"segment_reduce {mode} {label}")
            continue
        scale = torch.zeros(nbk, dtype=torch.float64, device=keys.device).index_add_(
            0, keys.long(), torch.where(valid[vidx[s]], vals[s].abs(), 0.0).double())
        e = (gr[s].double() - wr[s].double()).abs()
        check(bool((e <= 1e-5 * scale).all()),
              f"segment_reduce sum {label}: excess {float((e - 1e-5 * scale).max())}")
        err = max(err, float(e.max()))
    return err


def check_topk(torch, got, want, label):
    """topk values exact (== so that +0.0 / -0.0 may trade places)."""
    check(got.shape == want.shape and bool((got == want).all()), f"topk {label}")
    return 0.0


def check_compact(torch, got, want, label):
    """filter_compact: the compacted bytes and the counts exact."""
    (g, gc), (w, wc) = got, want
    bits = {8: torch.int64, 4: torch.int32, 1: torch.uint8}[g.element_size()]
    check(torch.equal(g.view(bits), w.view(bits)) and torch.equal(gc, wc),
          f"filter_compact {label}")
    return 0.0


def kernel_vs_plain(torch, K, name, args, label):
    """One kernel against its plain version on the same inputs."""
    mod = K[name]
    got = getattr(mod, name)(*args)
    want = getattr(mod, f"{name}_plain")(*args)
    if name == "masked_stats":
        return check_stats(torch, got, want, args[0], args[1], label)
    if name == "segment_reduce":
        keys, vals, valid, nbk, modes, vidx = args
        return check_segment(torch, got, want, keys, vals, valid, nbk, modes, vidx, label)
    if name == "topk":
        return check_topk(torch, got, want, label)
    return check_compact(torch, got, want, label)


def parity(torch, K, rng, dev):
    """Hold each kernel against its plain version; returns max |err| per kernel."""
    import numpy as np

    errs = {name: 0.0 for name in K}
    ms_k, sr_k, tk_k, fc_k = K["masked_stats"], K["segment_reduce"], K["topk"], K["filter_compact"]

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def note(name, e):
        errs[name] = max(errs[name], e)

    # -- masked_stats
    for n in (1, 512, 20_000, 16_384 * 3 + 5, 1 << 20):
        x = rng.normal(1e3, 5.0, (4, n)).astype(np.float32)
        x[0, : min(n, 8)] = -0.0
        m = rng.random((4, n)) < 0.8
        m[1] = False  # all-masked row
        xs, ms = t(x), t(m)
        note("masked_stats", kernel_vs_plain(torch, K, "masked_stats", (xs, ms), f"n={n}"))
        got = ms_k.masked_stats(xs, ms)
        pad = torch.zeros((4, n), dtype=torch.float32, device=dev)
        padded = ms_k.masked_stats(torch.cat([xs, pad], 1), torch.cat([ms, pad.bool()], 1))
        check(torch.equal(padded, got), f"masked_stats pad invariance n={n}")
        rows = torch.cat([ms_k.masked_stats(xs[i:i + 1].contiguous(), ms[i:i + 1].contiguous())
                          for i in range(4)])
        check(torch.equal(rows, got), f"masked_stats batched == per-row n={n}")

    # -- segment_reduce
    for n, nbk in ((1, 1), (2048, 64), (100_003, 1000), (1 << 20, 64)):
        keys = t(rng.integers(0, nbk, n).astype(np.int32))
        vals = t(rng.normal(0.0, 10.0, (3, n)).astype(np.float32))
        valid = t(rng.random((2, n)) < 0.9)
        modes, vidx = ["sum", "min", "max"], [0, 1, 1]
        args = (keys, vals, valid, nbk, modes, vidx)
        note("segment_reduce", kernel_vs_plain(torch, K, "segment_reduce", args, f"n={n} B={nbk}"))
        gr, gc = sr_k.segment_reduce(*args)
        kp = torch.cat([keys, torch.zeros(n + 5000, dtype=torch.int32, device=dev)])
        vp = torch.cat([vals, torch.ones((3, n + 5000), device=dev)], 1)
        mp = torch.cat([valid, torch.zeros((2, n + 5000), dtype=torch.bool, device=dev)], 1)
        pr, pc = sr_k.segment_reduce(kp, vp, mp, nbk, modes, vidx)
        check(torch.equal(pr, gr) and torch.equal(pc, gc), f"segment_reduce pad invariance n={n}")

    # -- topk
    for n, k in ((1, 1), (512, 128), (5000, 20), (1 << 20, 128), (1 << 20, 1)):
        x = rng.normal(0.0, 1.0, (3, n)).astype(np.float32)
        x[0, : min(n, 3)] = [np.inf, -np.inf, -0.0][: min(n, 3)]
        x[1, : min(n, 2)] = 0.0
        xs = t(x)
        for largest in (True, False):
            kk = min(k, n)
            label = f"n={n} k={kk} largest={largest}"
            note("topk", kernel_vs_plain(torch, K, "topk", (xs, kk, largest), label))
            got = tk_k.topk(xs, kk, largest)
            sent = float("-inf") if largest else float("inf")
            pad = torch.full((3, n), sent, device=dev)
            check(bool((tk_k.topk(torch.cat([xs, pad], 1), kk, largest) == got).all()),
                  f"topk pad invariance {label}")
            rows = torch.cat([tk_k.topk(xs[i:i + 1].contiguous(), kk, largest) for i in range(3)])
            check(bool((rows == got).all()), f"topk batched == per-row {label}")

    # -- filter_compact: every element width
    for n in (1, 4097, 1 << 20, 4_500_001):  # the last: > 1024 tiles to scan
        for dtype in (torch.float64, torch.int64, torch.int32, torch.float32, torch.bool):
            base = rng.normal(0.0, 1e6, (2, n))
            x = t(base).to(dtype)
            bits = {8: torch.int64, 4: torch.int32, 1: torch.uint8}[x.element_size()]
            for kind in ("empty", "full", "random"):
                keep = {"empty": np.zeros(n, bool), "full": np.ones(n, bool),
                        "random": rng.random(n) < 0.5}[kind]
                note("filter_compact", kernel_vs_plain(
                    torch, K, "filter_compact", (x, t(keep), 0), f"{dtype} n={n} keep={kind}"))
                per = torch.stack([t(rng.random(n) < 0.3) for _ in range(2)])
                g2, c2 = fc_k.filter_compact(x, per, 0)
                r0, c0 = fc_k.filter_compact(x[:1].contiguous(), per[0], 0)
                check(torch.equal(g2[:1].view(bits), r0.view(bits)) and int(c2[0]) == int(c0[0]),
                      f"filter_compact batched == per-row {dtype} n={n}")
    return errs


def fused_parity(torch, ops, rng, dev):
    """Fused filter→reduce == compact-then-reduce, bit for bit, on the card."""
    import numpy as np

    n = 300_001
    xs = torch.as_tensor(rng.normal(0, 1, (3, n)).astype(np.float32), device=dev)
    ms = torch.as_tensor(rng.random((3, n)) < 0.9, device=dev)
    keep = torch.as_tensor(rng.random(n) < 0.4, device=dev)
    cnt = int(keep.sum())
    with ops.local_backend("cuda"):
        fused = ops.filter_then_masked_stats(xs, ms, keep)
        xc = torch.stack([ops.filter_compact_padded(xs[i], keep)[0][:cnt] for i in range(3)])
        mc = torch.stack([ops.filter_compact_padded(ms[i], keep, False)[0][:cnt] for i in range(3)])
        unfused = ops.masked_stats_batch(xc, mc)
        check(torch.equal(fused, unfused), "fused filter→stats == unfused")
        keys = torch.as_tensor(rng.integers(0, 64, n).astype(np.int32), device=dev)
        fr, fc = ops.filter_then_segment_reduce(keys, [xs[0], xs[1]], [ms[0], ms[1]], keep,
                                                64, ["sum", "max"], [0, 1])
        kc = ops.filter_compact_padded(keys, keep)[0][:cnt]
        ur, uc = ops.segment_reduce_batch(kc, [xc[0], xc[1]], [mc[0], mc[1]], 64,
                                          ["sum", "max"], [0, 1])
        check(torch.equal(fr, ur) and torch.equal(fc, uc), "fused filter→groupby == unfused")


# --------------------------------------------------------------------------- #
# phase 3-4: the main path                                                     #
# --------------------------------------------------------------------------- #

CELLS = [
    'df = pd.read_csv("events")\ndf.describe()',
    'f = df[df["x"] > 50]\nf.groupby("k").agg({"y": "mean", "z": "min", "x": "max"})',
    'df["g"].value_counts()',
    'df.sort_values("z", ascending=False).head(20)',
    "f.head(100)",
]
THINK_S = 5.0


def catalog():
    from repro_torch.frame import Catalog, ColSpec, TableSpec

    cat = Catalog()
    cat.register(TableSpec(
        "events", nrows=ROWS, io_seconds=8.0, seed=2021,
        cols=(
            ColSpec("x", low=0.0, high=100.0),
            ColSpec("y", null_frac=0.2),
            ColSpec("z", low=-1e3, high=1e3, null_frac=0.05),
            ColSpec("k", kind="cat", n_categories=64),
            ColSpec("g", kind="cat", n_categories=1000),
            ColSpec("i", kind="int", low=0, high=1_000_000),
        ),
    ))
    return cat


def run_notebook(torch, session, cells, sync):
    outs, lat = [], []
    for i, code in enumerate(cells):
        t0 = time.perf_counter()
        res = session.cell(code)
        d = res.to_pydict()
        if sync:
            torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        outs.append(d)
        if i < len(cells) - 1 and session.engine.mode == "sim":
            session.think(THINK_S)
    return outs, lat


def compare(ref, got, label):
    import numpy as np

    exact = label.startswith(("cell3", "cell4", "cell5"))
    check(set(ref) == set(got), f"{label}: columns {sorted(got)} != {sorted(ref)}")
    for col in ref:
        r, g = np.asarray(ref[col]), np.asarray(got[col])
        check(r.shape == g.shape, f"{label}/{col}: shape {g.shape} != {r.shape}")
        if r.dtype.kind in "OU" or exact:
            same = np.array_equal(r, g) if r.dtype.kind in "OU" else np.array_equal(
                r.astype(np.float64), g.astype(np.float64), equal_nan=True)
            check(same, f"{label}/{col}: not equal")
        else:
            # tests/test_backend_parity.py:390-395 (end-to-end session parity)
            np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64),
                                       rtol=2e-3, atol=1e-5, err_msg=f"{label}/{col}")


def main_path(torch, ops, BK, K, record):
    from repro_torch.frame import Session

    cat = catalog()
    print(f"[main] table events: {ROWS} rows x 6 columns, numpy session first", flush=True)
    ref_s = Session(catalog=cat, mode="sim", kernel_backend="numpy")
    ref, ref_lat = run_notebook(torch, ref_s, CELLS, sync=False)
    print("[main] numpy session latencies ms: " + json.dumps(ref_lat))

    cuda_s = Session(catalog=cat, mode="sim", kernel_backend="cuda")
    BK.reset_breakers()
    ops.reset_launch_counts()  # counts start at 0 just before the main path
    with record():
        got, lat = run_notebook(torch, cuda_s, CELLS, sync=True)
    launches = ops.launch_counts()
    snap = BK.breaker_board().snapshot()
    for i, (r, g) in enumerate(zip(ref, got)):
        compare(r, g, f"cell{i + 1}")
    print("[main] 10M-row notebook matched the numpy session (5 cells)")
    print("[main] cuda session latencies ms: " + json.dumps(lat))
    print("[main] launches: " + json.dumps(launches))
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    cuda_keys = {k: v for k, v in snap.items() if k.endswith("|cuda")}
    for key, st in cuda_keys.items():
        check(st["failures"] == 0 and st["fallbacks"] == 0, f"breaker {key}: {st}")
    check(cuda_keys, "no cuda dispatch reached the breaker board")
    print("[main] breakers: zero failures and fallbacks on cuda for "
          + ", ".join(sorted(k.split("|")[0] for k in cuda_keys)))
    return ref, launches, lat


def trace_notebook(torch):
    """The cuda notebook once more, each cell under torch.profiler: wall ms,
    device ms in kernels and in copies, and the top kernels by device time.
    Measurement only; launch counts were read before this run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.frame import Session

    s = Session(catalog=catalog(), mode="sim", kernel_backend="cuda")
    for i, code in enumerate(CELLS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.cell(code).to_pydict()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        copy = sum(e.self_device_time_total for e in dev if e.key.startswith("Mem")) / 1e3
        kern = sorted(((e.self_device_time_total / 1e3, e.key) for e in dev
                       if not e.key.startswith("Mem")), reverse=True)
        busy = sum(t for t, _ in kern)
        print(f"[trace] cell{i + 1}: wall {wall} ms, device kernels {busy} ms, "
              f"device copies {copy} ms, device idle {100 * (1 - (busy + copy) / wall)}%; "
              "top: " + ", ".join(f"{k[:60]} {t}" for t, k in kern[:3]))
        if i < len(CELLS) - 1:
            s.think(THINK_S)


def real_mode(torch, ref):
    from repro_torch.frame import Session

    s = Session(catalog=catalog(), mode="real", kernel_backend="cuda")
    s.engine.start_background()
    try:
        lat = []
        outs = []
        for i, code in enumerate(CELLS[:2]):
            t0 = time.perf_counter()
            outs.append(s.cell(code).to_pydict())
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                time.sleep(2.0)  # think time: the background worker runs
    finally:
        s.engine.stop_background()
    for i, (r, g) in enumerate(zip(ref, outs)):
        compare(r, g, f"cell{i + 1}-real")
    print("[real] latencies ms (describe, filter+groupby): "
          + json.dumps(lat))


# --------------------------------------------------------------------------- #
# phase 5: timing at the main path's shapes                                    #
# --------------------------------------------------------------------------- #


def timed(torch, fn, iters, flush):
    """Mean ms per call with cold L2: a 128 MB write evicts it before each
    timed call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bound(nbytes, nops):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main_path_inputs(torch, name, shape, rng, dev):
    """Random inputs of one shape the main path gave a kernel (the shape
    tuples are those :func:`recorder` keeps)."""
    import numpy as np

    if name == "masked_stats":
        r, n = shape
        return (torch.as_tensor(rng.normal(50, 20, (r, n)).astype(np.float32), device=dev),
                torch.as_tensor(rng.random((r, n)) < 0.9, device=dev))
    if name == "segment_reduce":
        n, s, v, nbk, modes, vidx = shape
        return (torch.as_tensor(rng.integers(0, nbk, n).astype(np.int32), device=dev),
                torch.as_tensor(rng.normal(0, 1, (s, n)).astype(np.float32), device=dev),
                torch.as_tensor(rng.random((v, n)) < 0.9, device=dev),
                nbk, list(modes), list(vidx))
    if name == "topk":
        r, n, k, top = shape
        return (torch.as_tensor(rng.normal(0, 1, (r, n)).astype(np.float32), device=dev), k, top)
    r, n, esize, shared, fill = shape
    dt = {1: torch.bool, 4: torch.int32, 8: torch.float64}[esize]
    return (torch.as_tensor(rng.normal(0, 1, (r, n)), device=dev).to(dt),
            torch.as_tensor(rng.random(n if shared else (r, n)) < 0.5, device=dev), fill)


def main_path_parity(torch, K, shapes, rng, dev):
    """Each kernel against its plain version at every distinct shape the main
    path gave it; returns (max |err|, number of shapes) per kernel."""
    out = {}
    for name in K:
        check(shapes[name], f"no main-path shape recorded for {name}")
        err = 0.0
        distinct = sorted(set(shapes[name]))
        for shape in distinct:
            args = main_path_inputs(torch, name, shape, rng, dev)
            err = max(err, kernel_vs_plain(torch, K, name, args, f"main-path shape {shape}"))
        out[name] = (err, len(distinct))
    return out


def timings(torch, K, shapes, rng, dev):
    """Kernel, plain version and library call at the largest shape the main
    path gave each kernel (its dominant cost), beside the card's bound."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    sizes = {
        "masked_stats": lambda sh: sh[0] * sh[1],
        "segment_reduce": lambda sh: (sh[0], sh[1] + sh[2], sh[3]),
        "topk": lambda sh: (sh[0] * sh[1], sh[2]),
        "filter_compact": lambda sh: sh[0] * sh[1] * sh[2],
    }
    big = {name: max(shapes[name], key=sizes[name]) for name in K}
    args = {name: main_path_inputs(torch, name, big[name], rng, dev) for name in K}
    out = {}

    def run(name, which):
        fn = getattr(K[name], name if which == "kernel" else f"{name}_plain")
        return lambda: fn(*args[name])

    # masked_stats: (R, n) f32 + bool
    xs, ms = args["masked_stats"]
    r, n = big["masked_stats"]

    def lib_stats():
        for i in range(r):
            v = xs[i][ms[i]]
            torch.var_mean(v)
            torch.aminmax(v)

    out["masked_stats"] = dict(
        shape=[r, n],
        ms=timed(torch, run("masked_stats", "kernel"), 20, flush),
        plain_ms=timed(torch, run("masked_stats", "plain"), 3, flush),
        library_ms=timed(torch, lib_stats, 5, flush),
        bound=bound(r * n * 5 + r * 20, 8 * int(ms.sum())),
    )

    # segment_reduce: keys (n,), values (S, n), valids (V, n), B buckets
    keys, vals, vm, nbk, _, _ = args["segment_reduce"]
    n, s, v = big["segment_reduce"][:3]

    def lib_seg():
        torch.zeros(nbk, device=dev).index_add_(
            0, keys, torch.where(vm[0], vals[0] if s else vm[0].float(), 0.0))

    out["segment_reduce"] = dict(
        shape=[n, s, v, nbk],
        ms=timed(torch, run("segment_reduce", "kernel"), 10, flush),
        plain_ms=timed(torch, run("segment_reduce", "plain"), 2, flush),
        library_ms=timed(torch, lib_seg, 10, flush),
        bound=bound(n * (4 + 4 * s + v) + (s + v) * nbk * 4, n * (s + v)),
    )

    # topk: (R, n) f32, k
    xt, k, top = args["topk"]
    r, n = big["topk"][:2]
    out["topk"] = dict(
        shape=[r, n, k],
        ms=timed(torch, run("topk", "kernel"), 20, flush),
        plain_ms=timed(torch, run("topk", "plain"), 3, flush),
        library_ms=timed(torch, lambda: torch.topk(xt, k, dim=-1, largest=top), 20, flush),
        bound=bound(r * n * 4 + r * k * 4, r * n),
    )

    # filter_compact: (R, n) of one element width, keep (n,) or (R, n)
    xf, kf, _ = args["filter_compact"]
    r, n, esize, shared = big["filter_compact"][:4]
    out["filter_compact"] = dict(
        shape=[r, n, esize],
        ms=timed(torch, run("filter_compact", "kernel"), 20, flush),
        plain_ms=timed(torch, run("filter_compact", "plain"), 3, flush),
        library_ms=timed(torch, lambda: torch.masked_select(xf, kf), 20, flush),
        bound=bound(r * n * esize * 2 + (1 if shared else r) * n, 0),
    )
    return out


def recorder(K):
    """Context manager that records the shapes each kernel wrapper is given
    (calls pass straight through, so launch counts are the wrappers' own)."""
    from contextlib import contextmanager

    shapes = {name: [] for name in K}
    originals = {
        "masked_stats": K["masked_stats"].masked_stats,
        "segment_reduce": K["segment_reduce"].segment_reduce,
        "topk": K["topk"].topk,
        "filter_compact": K["filter_compact"].filter_compact,
    }

    def ms(xs, m):
        shapes["masked_stats"].append(tuple(xs.shape))
        return originals["masked_stats"](xs, m)

    def sr(keys, values, valids, nb, modes, vidx):
        shapes["segment_reduce"].append(
            (keys.shape[0], values.shape[0], valids.shape[0], int(nb), tuple(modes),
             tuple(int(i) for i in vidx)))
        return originals["segment_reduce"](keys, values, valids, nb, modes, vidx)

    def tk(xs, k, largest=True):
        shapes["topk"].append((xs.shape[0], xs.shape[1], int(k), bool(largest)))
        return originals["topk"](xs, k, largest)

    def fc(xs, keep, fill=0):
        shapes["filter_compact"].append(
            (xs.shape[0], xs.shape[1], xs.element_size(), keep.dim() == 1, fill))
        return originals["filter_compact"](xs, keep, fill)

    @contextmanager
    def record():
        K["masked_stats"].masked_stats = ms
        K["segment_reduce"].segment_reduce = sr
        K["topk"].topk = tk
        K["filter_compact"].filter_compact = fc
        try:
            yield
        finally:
            for name, fn in originals.items():
                setattr(K[name], name, fn)

    return shapes, record


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.frame import backend as BK
        from repro_torch.kernels import _build, ops
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    check("jax" not in sys.modules, "jax was imported")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: IEEE f32 products
    torch.backends.cudnn.allow_tf32 = False
    K = dict(ops.KERNELS)

    # -- phase 1: build
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[build] {len(built)} kernel libraries compiled in {build_s} s "
          f"({', '.join(built) or 'cached'})")
    print(f"[card] {smi}", flush=True)

    # -- phase 2: parity on the card
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    errs = parity(torch, K, rng, dev)
    fused_parity(torch, ops, rng, dev)
    torch.cuda.synchronize()
    print(f"[parity] kernel vs plain passed for all four kernels in "
          f"{time.perf_counter() - t0} s; max |err|: " + json.dumps(errs), flush=True)

    # -- phase 3: main path
    shapes, record = recorder(K)
    t0 = time.perf_counter()
    ref, launches, _ = main_path(torch, ops, BK, K, record)
    print(f"[main] phase took {time.perf_counter() - t0} s", flush=True)

    trace_notebook(torch)

    # -- phase 4: real mode
    real_mode(torch, ref)

    # -- phase 5: kernel vs plain, then timing, at the main path's shapes
    t0 = time.perf_counter()
    mp = main_path_parity(torch, K, shapes, rng, dev)
    for name in K:
        errs[name] = max(errs[name], mp[name][0])
    print(f"[shapes] kernel vs plain passed at every main-path shape in "
          f"{time.perf_counter() - t0} s: "
          + json.dumps({name: {"shapes": mp[name][1], "max_abs_err": mp[name][0]} for name in K}),
          flush=True)
    tm = timings(torch, K, shapes, rng, dev)
    for name in K:
        print(f"[time] {name} shape {tm[name]['shape']}: kernel {tm[name]['ms']} ms, "
              f"plain {tm[name]['plain_ms']} ms, library {tm[name]['library_ms']} ms, "
              f"bound {tm[name]['bound'][0]} ms ({tm[name]['bound'][1]})")
    rows = [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": tm[name]["ms"],
            "plain_ms": tm[name]["plain_ms"],
            "bound_ms": tm[name]["bound"][0],
            "bound_by": tm[name]["bound"][1],
            "library_ms": tm[name]["library_ms"],
        }
        for name in K
    ]
    print(f"{smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
