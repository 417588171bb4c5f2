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
3. main path — a 10M-row table and a 900,000-row dimension table through a
   seven-cell notebook (describe, filter + groupby, value_counts, sort +
   head, head, a left join + head, and an inner join + a groupby over
   100,000 segments) in a ``cuda`` session and a ``numpy`` session; answers
   must agree, every dataframe kernel must have launched, and no kernel may
   have failed or fallen back to numpy.  The notebook then runs once more
   under torch.profiler, which prints per cell the wall time beside the
   device time in kernels and in copies;
4. real mode — the first two cells with the background worker running;
4b. serving — ``mamba2_2p7b`` at full width (random weights from a seed)
   behind an ``OpportunisticServer``: a cold 1,024-token request, an
   anticipated prompt prefilled in think time and then requested, its
   resubmission (a cache hit), and a 1,000-token request (the one-token-
   chunk rule).  Every prefill must launch ``ssd_chunk_scan`` once per
   layer; the warm answer must equal a cold recompute, and the prefill
   logits must agree with the same model on the plain SSD within two bf16
   ulps of the largest, a limit that two faulty plain SSDs (one dropping
   the chunk states, one rounding its intermediates to bf16) must fail.  The 1,000- and
   1,024-token prefills are timed alone, and a profiled prefill and decode
   split the time by kernel;
5. main-path shapes — each kernel against its plain version, by the rules
   of phase 2, at every shape the main path (or the serving phase) gave it;
   then the kernel, its plain version and one PyTorch library call timed at
   the largest of them, beside the card's bound.

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
BF16_OPS_PER_S = 989e12  # H100 SXM bfloat16 on the tensor cores, dense (data sheet)
ROWS = 10_000_000

REPLACES = {
    "masked_stats": "src/repro/kernels/masked_stats.py:84",
    "segment_reduce": "src/repro/kernels/segment_reduce.py:103",
    "topk": "src/repro/kernels/topk.py:56",
    "filter_compact": "src/repro/kernels/filter_compact.py:67",
    "join_probe": "src/repro/kernels/join_probe.py:89",
    "ssd_chunk_scan": "src/repro/kernels/ssd_chunk.py:103",
}
SOURCES = {name: name for name in REPLACES} | {"ssd_chunk_scan": "ssd_chunk"}
DATAFRAME = ("masked_stats", "segment_reduce", "topk", "filter_compact", "join_probe")
SERVING = ("ssd_chunk_scan",)
BF16_ULP = 2.0 ** -7  # one bfloat16 ulp, relative


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


def check_join(torch, got, want, label):
    """join_probe: positions and hits exact."""
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"join_probe {label}")
    return 0.0


def check_ssd(torch, got, want, label):
    """ssd_chunk_scan: y within two ulps of its type (bf16: 2^-6; f32: 1e-5
    relative) of the call's largest |y| (both versions round y_intra and y at
    the same two places, from float32 sums taken in another order); h_final
    (float32) within 1e-5 of its largest |h|.  Returns max |err| of y."""
    (gy, gh), (wy, wh) = got, want
    check(gy.dtype == wy.dtype and gy.shape == wy.shape and gh.shape == wh.shape,
          f"ssd_chunk_scan types / shapes {label}")
    rel = 2 * BF16_ULP if wy.dtype == torch.bfloat16 else 1e-5
    ey = float((gy.float() - wy.float()).abs().max())
    eh = float((gh - wh).abs().max())
    check(bool(torch.isfinite(gy.float()).all()) and ey <= rel * float(wy.float().abs().max()),
          f"ssd_chunk_scan y {label}: err {ey}")
    check(eh <= 1e-5 * float(wh.abs().max()), f"ssd_chunk_scan h {label}: err {eh}")
    return ey


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
    if name == "join_probe":
        return check_join(torch, got, want, label)
    if name == "ssd_chunk_scan":
        return check_ssd(torch, got, want, label)
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

    # -- segment_reduce (the last two: beyond one block's shared memory)
    for n, nbk in ((1, 1), (2048, 64), (100_003, 1000), (1 << 20, 64), (300_001, 100_000),
                   (5000, (1 << 24) - 1)):
        keys = t(rng.integers(0, nbk, n).astype(np.int32))
        vals = t(rng.normal(0.0, 10.0, (3, n)).astype(np.float32))
        valid = t(rng.random((2, n)) < 0.9)
        modes, vidx = ["sum", "min", "max"], [0, 1, 1]
        args = (keys, vals, valid, nbk, modes, vidx)
        note("segment_reduce", kernel_vs_plain(torch, K, "segment_reduce", args, f"n={n} B={nbk}"))
        gr, gc = sr_k.segment_reduce(*args)
        for s, (mode, v) in enumerate(zip(modes, vidx)):
            rr, rc = sr_k.segment_reduce(keys, vals[s:s + 1], valid[v:v + 1], nbk, [mode], [0])
            check(torch.equal(rr[0], gr[s]) and torch.equal(rc[0], gc[v]),
                  f"segment_reduce batched == per-row n={n} B={nbk} row {s}")
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

    # -- join_probe: every key type; right sides in and beyond shared memory
    for dtype in (torch.float64, torch.float32, torch.int64, torch.int32):
        for n, m in ((1, 1), (5000, 7), (100_000, 1000), (1 << 20, 30_000), (1 << 20, 900_000)):
            r = np.sort(rng.choice(4 * m, m, replace=False)).astype(np.float64) - m
            lk = rng.integers(-2 * m, 4 * m, n).astype(np.float64)
            lk[: min(n, 3)] = r[: min(n, 3)]  # duplicate left keys, exact hits
            if dtype.is_floating_point:
                r = np.concatenate([[-np.inf], r, [np.inf, np.nan]])
                edge = [np.nan, np.inf, -np.inf, -0.0, 0.0]
                lk[: min(n, 5)] = edge[: min(n, 5)]
            note("join_probe", kernel_vs_plain(torch, K, "join_probe",
                                               (t(lk).to(dtype), t(r).to(dtype)),
                                               f"{dtype} n={n} m={m}"))

    # -- ssd_chunk_scan: full width, f32, one-token chunks, the smoke width, odd dims
    for bt, S, H, Pd, N, L, dtype in ((1, 256, 80, 64, 128, 128, torch.bfloat16),
                                      (2, 256, 8, 64, 128, 128, torch.float32),
                                      (1, 37, 4, 16, 16, 1, torch.bfloat16),
                                      (2, 96, 8, 16, 16, 32, torch.bfloat16),
                                      (1, 128, 3, 24, 40, 64, torch.float32)):
        note("ssd_chunk_scan", kernel_vs_plain(torch, K, "ssd_chunk_scan",
                                               ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, dtype)
                                               + (L,), f"{(bt, S, H, Pd, N, L, dtype)}"))
    return errs


def ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, dtype):
    """x, log_a, b, c of one SSD call, in the ranges the model gives them
    (log decays in (-0.5, 0))."""
    import numpy as np

    def t(a, dt=dtype):
        return torch.as_tensor(a, device=dev).to(dt).contiguous()

    return (t(rng.normal(0, 1, (bt, S, H, Pd))),
            t(-rng.uniform(1e-3, 0.5, (bt, S, H)), torch.float32),
            t(rng.normal(0, 0.3, (bt, S, N))), t(rng.normal(0, 0.3, (bt, S, N))))


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
    'u = pd.read_csv("users")\ndf.join(u, on="i", how="left").head(100)',
    'df.join(u, on="i").groupby("segment").agg({"x": "mean"})',
]
USERS = 900_000  # the dimension table's rows; segment has 100,000 categories
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
    cat.register(TableSpec(
        "users", nrows=USERS, io_seconds=1.0, seed=2103,
        cols=(
            ColSpec("i", kind="key"),  # 0 .. 899,999: about 10% of events.i miss
            ColSpec("segment", kind="cat", n_categories=100_000),
            ColSpec("score"),
        ),
    ))
    return cat


def run_notebook(torch, session, cells, sync, counts=None):
    """Run the cells with think time between them → (answers, ms per cell,
    and, given ``counts``, the launch counts after each cell)."""
    outs, lat, after = [], [], []
    for i, code in enumerate(cells):
        t0 = time.perf_counter()
        res = session.cell(code)
        d = res.to_pydict()
        if sync:
            torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        outs.append(d)
        if counts is not None:
            after.append(counts())
        if i < len(cells) - 1 and session.engine.mode == "sim":
            session.think(THINK_S)
    return (outs, lat, after) if counts is not None else (outs, lat)


def compare(ref, got, label):
    import numpy as np

    exact = label.startswith(("cell3", "cell4", "cell5", "cell6"))
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
    print(f"[main] table events: {ROWS} rows x 6 columns, users: {USERS} rows x 3 columns; "
          "numpy session first", flush=True)
    ref_s = Session(catalog=cat, mode="sim", kernel_backend="numpy")
    ref, ref_lat = run_notebook(torch, ref_s, CELLS, sync=False)
    print("[main] numpy session latencies ms: " + json.dumps(ref_lat))

    cuda_s = Session(catalog=cat, mode="sim", kernel_backend="cuda")
    BK.reset_breakers()
    ops.reset_launch_counts()  # counts start at 0 just before the main path
    with record():
        got, lat, after = run_notebook(torch, cuda_s, CELLS, sync=True,
                                       counts=ops.launch_counts)
    launches = ops.launch_counts()
    for cell, names in ((6, ("join_probe",)), (7, ("join_probe", "segment_reduce"))):
        for name in names:
            n = after[cell - 1][name] - after[cell - 2][name]
            check(n > 0, f"cell {cell}: {name} did not launch")
    print("[main] launches in the join cells 6 and 7: " + json.dumps(
        {name: after[6][name] - after[4][name] for name in DATAFRAME}))
    snap = BK.breaker_board().snapshot()
    for i, (r, g) in enumerate(zip(ref, got)):
        compare(r, g, f"cell{i + 1}")
    print(f"[main] 10M-row notebook matched the numpy session ({len(CELLS)} cells)")
    print("[main] cuda session latencies ms: " + json.dumps(lat))
    print("[main] launches: " + json.dumps(launches))
    for name in DATAFRAME:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")
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


def bound(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    """The least time (ms) and what bounds it: bytes over the memory rate, or
    operations over the peak rate of the operands' type."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
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
    if name == "join_probe":
        n, m, dtype = shape  # unique right keys 0 .. m-1, about 10% of left keys miss
        dt = getattr(torch, dtype)
        return (torch.as_tensor(rng.integers(0, m * 10 // 9, n), device=dev).to(dt),
                torch.arange(m, device=dev).to(dt))
    if name == "ssd_chunk_scan":
        bt, S, H, Pd, N, L, dtype = shape
        return ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, getattr(torch, dtype)) + (L,)
    r, n, esize, shared, fill = shape
    dt = {1: torch.bool, 4: torch.int32, 8: torch.float64}[esize]
    return (torch.as_tensor(rng.normal(0, 1, (r, n)), device=dev).to(dt),
            torch.as_tensor(rng.random(n if shared else (r, n)) < 0.5, device=dev), fill)


def main_path_parity(torch, K, shapes, rng, dev):
    """Each kernel against its plain version at every distinct shape the main
    path (or the serving phase) gave it; returns (max |err|, number of
    shapes) per kernel."""
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


def ssd_work(bt, S, H, Pd, N, L, esize):
    """(bytes, flops) of one intra-chunk launch: each input read once, each
    output written once; per cell, C·Bᵀ and M·X over the causal triangle
    (T = L (L + 1) / 2 entries, the rest is masked to 0) and the chunk
    state in full: 2 (T N + T P + N L P) flops."""
    nc, tri = S // L, L * (L + 1) // 2
    nbytes = bt * (esize * (2 * S * H * Pd + 2 * S * N) + 4 * S * H + 4 * nc * H * N * Pd)
    return nbytes, bt * nc * H * 2 * (tri * N + tri * Pd + N * L * Pd)


def timings(torch, K, shapes, rng, dev):
    """Kernel, plain version and library call at the largest shape the main
    path gave each kernel (its dominant cost), beside the card's bound."""
    import math

    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    sizes = {
        "masked_stats": lambda sh: sh[0] * sh[1],
        "segment_reduce": lambda sh: (sh[0], sh[1] + sh[2], sh[3]),
        "topk": lambda sh: (sh[0] * sh[1], sh[2]),
        "filter_compact": lambda sh: sh[0] * sh[1] * sh[2],
        "join_probe": lambda sh: (sh[0], sh[1]),
        "ssd_chunk_scan": lambda sh: (sh[0] * sh[1], sh[5]),
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

    # segment_reduce: keys (n,), values (S, n), valids (V, n), B buckets; at
    # the largest shape, and at the largest with B = 100,000 (cell 7)
    def seg_row(shape, a):
        keys, vals, vm, nbk, _, _ = a
        n, s, v = shape[:3]

        def lib_seg():
            torch.zeros(nbk, device=dev).index_add_(
                0, keys, torch.where(vm[0], vals[0] if s else vm[0].float(), 0.0))

        return dict(
            shape=[n, s, v, nbk],
            ms=timed(torch, lambda: K["segment_reduce"].segment_reduce(*a), 10, flush),
            plain_ms=timed(torch, lambda: K["segment_reduce"].segment_reduce_plain(*a), 2, flush),
            library_ms=timed(torch, lib_seg, 10, flush),
            bound=bound(n * (4 + 4 * s + v) + (s + v) * nbk * 4, n * (s + v)),
        )

    out["segment_reduce"] = seg_row(big["segment_reduce"], args["segment_reduce"])
    wide = [sh for sh in shapes["segment_reduce"] if sh[3] == 100_000]
    check(wide, "no segment_reduce launch at B = 100,000 on the main path")
    wide = max(wide, key=sizes["segment_reduce"])
    out["segment_reduce B=100000"] = seg_row(
        wide, main_path_inputs(torch, "segment_reduce", wide, rng, dev))

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

    # join_probe: left keys (n,), sorted right keys (m,); searchsorted is the
    # library call; the search does ceil(log2(m + 1)) comparisons a key
    lk, rk = args["join_probe"]
    n, m, _ = big["join_probe"]
    out["join_probe"] = dict(
        shape=[n, m, str(lk.dtype)],
        ms=timed(torch, run("join_probe", "kernel"), 20, flush),
        plain_ms=timed(torch, run("join_probe", "plain"), 5, flush),
        library_ms=timed(torch, lambda: torch.searchsorted(rk, lk), 20, flush),
        bound=bound(n * (lk.element_size() + 4 + 1) + m * rk.element_size(),
                    n * math.ceil(math.log2(m + 1))),
    )

    # ssd_chunk_scan: the intra-chunk launch alone (the inter-chunk scan is
    # torch ops outside it, as outside the pallas_call); no library call
    x, la, b, c, L = args["ssd_chunk_scan"]
    bt, S, H, Pd, N = big["ssd_chunk_scan"][:5]
    mod = K["ssd_chunk_scan"]
    out["ssd_chunk_scan"] = dict(
        shape=[bt, S, H, Pd, N, L, str(x.dtype)],
        ms=timed(torch, lambda: mod.ssd_chunk_intra(x, la, b, c, L), 20, flush),
        plain_ms=timed(torch, lambda: mod.ssd_chunk_intra_plain(x, la, b, c, L), 5, flush),
        library_ms=None,
        bound=bound(*ssd_work(bt, S, H, Pd, N, L, x.element_size()),
                    BF16_OPS_PER_S if x.dtype == torch.bfloat16 else F32_OPS_PER_S),
    )
    return out


def recorder(K):
    """Context manager that records the shapes each kernel wrapper is given
    (calls pass straight through, so launch counts are the wrappers' own)."""
    from contextlib import contextmanager

    shapes = {name: [] for name in K}
    originals = {name: getattr(K[name], name) for name in K}

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

    def jp(lk, rk):
        shapes["join_probe"].append((lk.shape[0], rk.shape[0], str(lk.dtype).split(".")[1]))
        return originals["join_probe"](lk, rk)

    def sc(x, log_a, b, c, chunk):
        shapes["ssd_chunk_scan"].append(
            (*x.shape, b.shape[-1], int(chunk), str(x.dtype).split(".")[1]))
        return originals["ssd_chunk_scan"](x, log_a, b, c, chunk)

    wrapped = {"masked_stats": ms, "segment_reduce": sr, "topk": tk, "filter_compact": fc,
               "join_probe": jp, "ssd_chunk_scan": sc}

    @contextmanager
    def record():
        for name, fn in wrapped.items():
            setattr(K[name], name, fn)
        try:
            yield
        finally:
            for name, fn in originals.items():
                setattr(K[name], name, fn)

    return shapes, record


# --------------------------------------------------------------------------- #
# phase 4b: opportunistic serving of mamba2_2p7b at full width                  #
# --------------------------------------------------------------------------- #

SERVE_SEED = 12
N_TOKENS = 16
# The kernel and the plain SSD round y to bf16 from float32 sums taken in
# another order, so a layer's output may differ by a bf16 ulp and move every
# later layer's input.  The last-token logits (bf16) are held to two bf16
# ulps of their largest magnitude.  Two controls show what the limit sees: a
# plain SSD that drops the inbound chunk states, and one whose intermediates
# (C·Bᵀ, M, y_intra, the chunk states) are rounded to bf16.
LOGITS_TOL = 2 * BF16_ULP


def profiled(torch, fn):
    """Run ``fn`` under torch.profiler → (wall ms, device kernel ms, device
    copy ms, [(device ms, kernel name)] by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    copy = sum(e.self_device_time_total for e in dev if e.key.startswith("Mem")) / 1e3
    kern = sorted(((e.self_device_time_total / 1e3, e.key) for e in dev
                   if not e.key.startswith("Mem")), reverse=True)
    return wall, sum(t for t, _ in kern), copy, kern


def control_scans(torch, mod):
    """The faulty plain SSDs of the logits check's controls, by name."""

    def r(t):
        return t.to(torch.bfloat16).float()

    def bf16_intermediates(x, log_a, b, c, chunk):
        bt, S, H, Pd = x.shape
        N, L = b.shape[-1], int(chunk)
        nc = S // L
        xf = x.float().reshape(bt, nc, L, H, Pd)
        bf, cf = b.float().reshape(bt, nc, L, N), c.float().reshape(bt, nc, L, N)
        cum = log_a.float().reshape(bt, nc, L, H).cumsum(2)
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[..., None]
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        lmask = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
        m = r(r(torch.einsum("bnik,bnjk->bnij", cf, bf))[..., None] * lmask)
        y = torch.einsum("bnijh,bnjhp->bnihp", m, xf).reshape(bt, S, H, Pd).to(x.dtype)
        bw = bf[:, :, :, None, :] * torch.exp(cum[:, :, -1:, :] - cum)[..., None]
        state = r(torch.einsum("bnlhk,bnlhp->bnhkp", bw, xf))
        return mod._inter_chunk(y, state, log_a, c, x.dtype)

    def no_chunk_state(x, log_a, b, c, chunk):
        y, state = mod.ssd_chunk_intra_plain(x, log_a, b, c, chunk)
        return mod._inter_chunk(y, torch.zeros_like(state), log_a, c, x.dtype)

    return {"bf16 intermediates": bf16_intermediates, "no chunk state": no_chunk_state}


def serving(torch, ops, cfg, dev, record):
    """``cfg`` (mamba2_2p7b) behind an OpportunisticServer on ``dev``;
    returns the launch counts of the requests."""
    import numpy as np

    from repro_torch.models import init_model
    from repro_torch.serve import OpportunisticServer, greedy_generate, make_serve_fns

    t0 = time.perf_counter()
    model = init_model(cfg, seed=SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    params = list(model.parameters())
    print(f"[serve] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sum(p.numel() for p in params)} parameters, "
          f"{sum(p.numel() * p.element_size() for p in params)} bytes on the card, "
          f"made in {time.perf_counter() - t0} s", flush=True)
    srv = OpportunisticServer(cfg, model, capacity=2048, device=dev)
    rng = np.random.default_rng(SERVE_SEED)
    cold_p, warm_p = (tuple(int(t) for t in rng.integers(0, cfg.vocab, 1024)) for _ in range(2))
    odd_p = tuple(int(t) for t in rng.integers(0, cfg.vocab, 1000))

    def request(label, prompt):
        t0 = time.perf_counter()
        out = srv.request(prompt, n_tokens=N_TOKENS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rec = srv.metrics.interactions[-1]
        print(f"[serve] {label}: {len(prompt)}-token prompt, {N_TOKENS} tokens: wall {wall} ms, "
              f"sim latency {rec.latency_s * 1e3} ms, ops executed {rec.ops_executed}", flush=True)
        return out, rec

    ops.reset_launch_counts()  # counts start at 0 just before the serving path
    with record():
        cold = request("cold request", cold_p)
        srv.anticipate(warm_p)
        t0 = time.perf_counter()
        srv.think(10.0)
        torch.cuda.synchronize()
        print(f"[serve] think(10): anticipated 1024-token prefill, wall "
              f"{(time.perf_counter() - t0) * 1e3} ms", flush=True)
        warm = request("warm request", warm_p)
        again = request("resubmission", warm_p)
        odd = request("one-token-chunk request", odd_p)
    launches = ops.launch_counts()
    print("[serve] launches: " + json.dumps(launches))
    check(launches["ssd_chunk_scan"] == 3 * cfg.n_layers,
          f"3 prefills launched ssd_chunk_scan {launches['ssd_chunk_scan']} times, "
          f"not {3 * cfg.n_layers}")
    check(warm[1].latency_s < cold[1].latency_s, "the warm request was not faster (sim)")
    check(again[1].ops_executed == 0 and again[1].latency_s == 0.0,
          "the resubmission was not a cache hit")
    check(np.array_equal(again[0].tokens, warm[0].tokens), "resubmission tokens differ")
    check(odd[0].tokens.shape == (N_TOKENS,), "one-token-chunk request tokens")

    pre, dec, _ = make_serve_fns(cfg, srv.ctx, capacity=2048)
    warm_t = torch.tensor([warm_p], device=dev)
    recomputed = greedy_generate(cfg, model, pre, dec, warm_t, N_TOKENS)[0].cpu().numpy()
    check(np.array_equal(recomputed, warm[0].tokens), "warm tokens != a cold recompute")

    cold_t = torch.tensor([cold_p], device=dev)
    with ops.local_backend("cuda"):
        lk, _ = pre(model, cold_t)
    with ops.local_backend("torch"):  # the plain SSD, same params, on the card
        lp, _ = pre(model, cold_t)
    lk, lp = lk.float(), lp.float()
    err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
    check(bool(torch.isfinite(lk).all()) and err <= LOGITS_TOL * scale,
          f"prefill logits vs the plain SSD: max |err| {err} over the limit "
          f"{LOGITS_TOL * scale}")
    print(f"[serve] warm tokens == cold recompute; prefill logits vs plain SSD: max |err| "
          f"{err}, limit {LOGITS_TOL * scale} (max |logit| {scale}), top token equal "
          f"{int(lk.argmax()) == int(lp.argmax())}", flush=True)
    mod = ops.KERNELS["ssd_chunk_scan"]
    plain = mod.ssd_chunk_scan_plain
    for label, faulty in control_scans(torch, mod).items():
        mod.ssd_chunk_scan_plain = faulty
        try:
            with ops.local_backend("torch"):
                lc, _ = pre(model, cold_t)
        finally:
            mod.ssd_chunk_scan_plain = plain
        ce = float((lc.float() - lp).abs().max())
        check(ce > LOGITS_TOL * scale, f"control, plain SSD with {label}: logits max |err| "
              f"{ce} is within the limit {LOGITS_TOL * scale}, which cannot see it")
        print(f"[serve] control, plain SSD with {label}: logits max |err| {ce}, above the "
              "limit", flush=True)

    # the one-token-chunk rule's cost: both prefills alone, synchronized
    odd_t = torch.tensor([odd_p], device=dev)
    walls = {}
    for label, prompt_t in (("1024", cold_t), ("1000", odd_t)):
        t0 = time.perf_counter()
        pre(model, prompt_t)
        torch.cuda.synchronize()
        walls[label] = (time.perf_counter() - t0) * 1e3
    print(f"[serve] prefill wall: 1,024 tokens (chunks of 128) {walls['1024']} ms, 1,000 tokens "
          f"(one-token chunks) {walls['1000']} ms, factor {walls['1000'] / walls['1024']}",
          flush=True)

    # where a request's time goes: a 1,024-token prefill, then decode steps
    for label, fn in (("prefill 1024 tokens", lambda: pre(model, cold_t)),
                      (f"prefill 1024 + {N_TOKENS} decode steps",
                       lambda: greedy_generate(cfg, model, pre, dec, cold_t, N_TOKENS))):
        wall, busy, copy, kern = profiled(torch, fn)
        ssd = sum(t for t, k in kern if "ssd_cells" in k)
        gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                      "cutlass")))
        print(f"[serve-trace] {label}: wall {wall} ms, device kernels {busy} ms "
              f"(ssd_chunk_scan {ssd} ms, GEMMs {gemm} ms, other {busy - ssd - gemm} ms), "
              f"device copies {copy} ms, device idle {100 * (1 - (busy + copy) / wall)}%; top: "
              + ", ".join(f"{k[:50]} {t}" for t, k in kern[:4]), flush=True)
    del srv, model
    torch.cuda.empty_cache()
    return launches


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
    print(f"[parity] kernel vs plain passed for all {len(K)} kernels in "
          f"{time.perf_counter() - t0} s; max |err|: " + json.dumps(errs), flush=True)

    # -- phase 3: main path
    shapes, record = recorder(K)
    t0 = time.perf_counter()
    ref, launches, _ = main_path(torch, ops, BK, K, record)
    print(f"[main] phase took {time.perf_counter() - t0} s", flush=True)

    trace_notebook(torch)

    # -- phase 4: real mode
    real_mode(torch, ref)

    # -- phase 4b: serving
    t0 = time.perf_counter()
    from repro_torch.configs import get_config

    served = serving(torch, ops, get_config("mamba2_2p7b"), dev, record)
    launches.update({name: served[name] for name in SERVING})
    print(f"[serve] phase took {time.perf_counter() - t0} s", flush=True)

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
    for name, t in tm.items():
        print(f"[time] {name} shape {t['shape']}: kernel {t['ms']} ms, "
              f"plain {t['plain_ms']} ms, library {t['library_ms']} ms, "
              f"bound {t['bound'][0]} ms ({t['bound'][1]})")
    rows = [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES[name]}.cu",
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
