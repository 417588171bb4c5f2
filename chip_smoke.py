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
   fused == unfused (masked_stats also: batched == per-row copies at other
   alignments, at n = 3, five rows of 16,385 (each starting at another
   16-byte offset), one live value in the last tile, ±inf and NaN in
   masked lanes, and slices 4 bytes past a boundary, alone and through
   ``masked_stats_batch_parts``; topk also: sorted rows both ways at k 20
   and 128, one value repeated, fewer than k finite values, k 128 at n 129,
   three rows of 4,097, an unaligned slice, and rows with NaN (NaN equal
   to NaN: [1, NaN, 3, 2, -1] at k 2, one NaN, k + 1 NaNs, NaNs beside
   +inf and -inf, on one launch and on two); every call must launch its
   kernel; segment_reduce also: two calls equal, and bucket
   independence, at shapes that include one bucket of 2^21 rows, Zipf keys
   at cell 7's size, no valid row, keys out of range and B = 2^24 - 1);
   join_probe exact for every key type with right sides staged whole and
   sampled, and at the sample's edges with the step forced (fewer keys than
   a step, a count no multiple of it, a NaN tail over a sample point, keys
   at sample points); ssd_chunk_scan at its shapes (full width, f32, one-
   token chunks, the tensor-core route's edges: L 64, P 128, N 64, batch
   2, P 16, a head count its group size does not divide; and the short
   route's: f32 at L 1, L 2 and 16 (its threshold), P 24 and 40, N 17 with
   P 7, batch 2, a head count its group does not divide, L 17 past it; at
   one-token chunks also N 256 (``ssd_recur``'s limit), N 17 with P 7 in
   batches of 2 over 3 heads, and S = 1): each call at one-token chunks on
   ``ssd_recur`` once and no other kernel, h_final bit for bit, each other
   call on the kernel ``ssd_route`` names and on the inter-chunk scan kernel
   ``ssd_scan`` once; then at each shape the intra-chunk kernel alone
   (``ssd_short`` at L 1-16, its one-token chunk states equal to the plain
   version's bit for bit) and ``ssd_scan`` alone on its outputs against the
   plain inter-chunk pass: h_final bit for bit, y by check_ssd; then
   the flash_attention forward (bf16 on the tensor-core kernel
   ``attn_fwd_wgmma``, float32 on the FMA kernel ``attn_fwd``; each launch
   must take the kernel ``forward_route`` names) and its backward (bf16 on
   ``attn_bwd_dq_wgmma`` and ``attn_bwd_dkdv_wgmma``, float32 on the FMA
   kernels; each launch must take the kernels ``backward_route`` names)
   against the plain attention (output and all three gradients) at
   edge shapes (GQA groups 1, 3, 4, 8; D 64, 120, 128; bf16 and f32; causal
   or not; windows 32 and 4,096; q_offset > 0 with Sq < Skv, down to one
   128-row q tile with only 64 rows live; one tile; danube's heads over
   4,096 keys; B 1 to 4; and at D 256 and 192: MQA group 16 with a window
   of 2,048 over 4,096 keys in both types, window 32, not causal, q_offset
   > 0, a ragged 96-row sequence), two backward runs equal bit for bit, and two
   faulty plain attentions (no alpha rescale; a dK/dV that drops a head)
   over the limits; a forward and backward in a new thread equal the same
   call in the main one;
3. main path — a 10M-row table and a 900,000-row dimension table through a
   seven-cell notebook (describe, filter + groupby, value_counts, sort +
   head, head, a left join + head, and an inner join + a groupby over
   100,000 segments) in a ``cuda`` session and a ``numpy`` session; answers
   must agree, every dataframe kernel must have launched, and no kernel may
   have failed or fallen back to numpy.  The notebook then runs once more
   under torch.profiler, which prints per cell the wall time beside the
   device time in kernels and in copies;
3b. examples — ``examples/torch_quickstart.py`` and
   ``torch_interactive_session.py`` called in-process (``main()``) in a
   cuda session and in a numpy session: answers within the parity
   tolerances of tests/test_backend_parity.py:51-54, the simulated
   latencies equal, the first dispatch of each planner key on the kernels,
   masked_stats (both), segment_reduce and filter_compact (the second)
   launched, no breaker failure; the planner's decisions and the launches
   printed.  ``torch_serve_opportunistic.py``, ``repro_torch.launch.serve``
   and ``torch_train_lm.py`` (200 steps) at smoke width, each twice: tokens,
   latencies and losses equal bit for bit;
4. real mode — the first two cells with the background worker running;
4b. serving — ``mamba2_2p7b`` at full width (random weights from a seed)
   behind an ``OpportunisticServer``: a cold 1,024-token request, an
   anticipated prompt prefilled in think time and then requested, its
   resubmission (a cache hit), and a 1,000-token request (the one-token-
   chunk rule).  Every prefill must launch ``ssd_chunk_scan`` once per
   layer: the two 1,024-token ones on the tensor-core kernel ``ssd_wgmma``
   and the inter-chunk scan kernel ``ssd_scan``, the 1,000-token one on
   ``ssd_recur`` alone; none on ``ssd_short`` or ``ssd_cells``, and the
   plain inter-chunk pass (a loop over the chunks) never; the
   warm answer must equal a cold recompute.  At both prompt lengths every
   layer's SSD, on the model's own inputs (those of the plain prefill),
   must pass check_ssd's limits against the plain SSD, which two faulty
   plain SSDs (one dropping the chunk states, one rounding its
   intermediates to bf16) must fail at every layer; the logits at every position of the model cut to one layer
   must lie within two bf16 ulps of the plain SSD's and within a distance
   that two plain SSDs differing in rounding alone (float64; the time axis
   summed in reverse) must keep and both faulty ones must cross (see
   LOGITS_LINE); at 1,024 tokens and full depth the top token must agree.
   The 1,000- and 1,024-token prefills are timed alone, the 1,000-token
   one also with the pair ``ssd_short`` + ``ssd_scan`` forced, in turns
   with ``ssd_recur``; profiled
   prefills of both lengths and a decode split the time by kernel, with
   the inter-chunk scan's wrapper as a profiler range (its host and device
   time);
4c. training — ``smollm_360m`` at full width (random weights from seed 12,
   float32 master weights) trained by ``train_loop`` for 4 steps of 8 x
   4,096 tokens (microbatch 4, remat full, a checkpoint every 2 steps):
   finite losses and gradient norms, 128 forward launches a step, every one
   of them on ``attn_fwd_wgmma``, and 64 + 64 backward attention launches,
   every one of them on ``attn_bwd_dq_wgmma`` and ``attn_bwd_dkdv_wgmma``,
   one profiled step split by kernel; the same
   step twice from the same state equal bit for bit; one microbatch's loss,
   gradient norm and gradients against the plain attention's (and a faulty
   plain attention over the limit); a run killed by ``fail_at_step=3``
   resumes and ends bit for bit where the uninterrupted run ended;
4d. hybrid serving — ``granite_moe_3b_a800m`` (32 layers, 40 experts, top
   8) and ``recurrentgemma_9b`` (38 layers) at full width and depth, random
   weights from a seed, behind an ``OpportunisticServer``: the requests of
   4b at 1,024 tokens (cold, anticipated and prefilled in think time, its
   resubmission), RecurrentGemma also a 2,048-token prompt (it fills the
   local-attention ring; its decode steps wrap it); no attention kernel may
   launch (the cached branch is the plain path); warm equal to a cold
   recompute, and the same requests in a fresh server equal in tokens and
   last logits bit for bit.  granite: layer 0's ``moe_ffn`` on the model's
   own inputs within 2^-5 of the largest |y| of float64 on the CPU at the
   tokens whose experts agree (any other token a near tie), the assignments
   dropped at capacity the same on the card and by the CPU's dispatch.
   RecurrentGemma cut to one pattern group: 2,176 decode steps from
   position 0 against one cache-free forward (the D 256 forward kernel),
   every position within 2^-5 of the largest |logit|.  Request walls, and
   profiled prefills and decodes split by kernel;
4e. hybrid training — ``recurrentgemma_9b`` at full width cut to one
   pattern group (2.69e9 parameters, float32 master weights, AdamW in
   place) trained by ``train_loop`` for 4 steps of 1 x 4,096 tokens (remat
   full): finite losses and gradient norms, 2 forward launches a step on
   ``attn_fwd_wgmma`` and 1 of each backward kernel on the tensor-core
   kernels (D 256), the peak device memory; the same step twice from one
   state equal bit for bit (the first state kept on the host), one step
   profiled; one microbatch's loss, gradient norm and gradients against the
   plain attention's (and the faulty plain attention over the limit);
4f. MoE training — ``granite_moe_3b_a800m`` at full width and depth
   (3.37e9 parameters, float32 master weights) trained through
   ``repro_torch.launch.train.main`` for 4 steps of 8 x 4,096 tokens
   (microbatch 4, remat full, seed 12): finite losses, step times, tokens/s
   and the peak device memory beside its prediction; 128 forward and 64 +
   64 backward attention launches a step, every one on the tensor-core
   kernels; the assignments dropped at capacity counted; a run killed at
   step 2 resumed from its step-2 checkpoint with the uninterrupted run's
   losses and end-state fingerprint (every leaf's two 64-bit checksums);
   the same step twice from one state equal bit for bit (the first state
   kept on the host), one step profiled (attention, GEMMs, the MoE layer's
   sort / gather / scatter / index kernels, other, idle share); one
   microbatch with the kernels against the plain attention, the experts of
   tokens whose top-k set moved (and the router) printed, every other leaf
   held, and the faulty plain attention over the limit;
5. main-path shapes — each kernel against its plain version, by the rules
   of phase 2 (segment_reduce with all its contracts), at every shape the
   main path (or the serving phase) gave it;
   then the kernel, its plain version and one PyTorch library call timed at
   the largest of them, beside the card's bound (attention: at the training
   shape, against ``scaled_dot_product_attention`` and its backward, with
   the FMA backward kernels on the same bf16 inputs beside the tensor-core
   ones, the forward and backward also at qwen3_8b's heads, D 128, at
   phase 4e's shape, 16 heads over one kv head of 256, window 2,048 (SDPA
   with the window as a mask), and at phase 4f's, 4 x 24 (8) x 4,096 x 64;
   segment_reduce also at B = 100,000 and at B = 1,000 with one sum row;
   join_probe's wrapper beside its bare C entry point, against
   ``torch.searchsorted``; masked_stats, topk and filter_compact each
   beside its bare C entry point, with each of its kernels' device time
   from torch.profiler; topk also on its rows sorted ascending, beside
   ``torch.topk`` on them;
   ssd_chunk_scan's ``ssd_wgmma`` at the 1,024-token prefill's shape and
   ``ssd_short`` at the one-token-chunk prompt's, each beside ``ssd_cells``
   on the same inputs; the inter-chunk scan ``ssd_scan`` at both prompts'
   shapes, its wrapper beside its bare C entry, the plain loop and its
   bound; ``ssd_recur`` at the one-token-chunk prompt's shape, its wrapper
   beside its bare C entry, the pair ``ssd_short`` + ``ssd_scan`` on the
   same inputs, the plain version and its bound).

The last two lines are a JSON object per kernel and the result line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
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
    # the three routes of one pass: ssd_cells (float32 FMA), ssd_short (short
    # chunks, float32 FMA) and ssd_wgmma (bf16 on the tensor cores)
    "ssd_chunk_scan_cells": "src/repro/kernels/ssd_chunk.py:103",
    "ssd_chunk_scan_short": "src/repro/kernels/ssd_chunk.py:103",
    "ssd_chunk_scan_wgmma": "src/repro/kernels/ssd_chunk.py:103",
    # the inter-chunk scan and correction after that pallas_call (ssd_scan)
    "ssd_chunk_scan_inter": "src/repro/kernels/ssd_chunk.py:128-150",
    # the whole function at one-token chunks: the pallas_call and the scan
    # after it (ssd_recur)
    "ssd_chunk_scan_recur": "src/repro/kernels/ssd_chunk.py:103-150 (at one-token chunks)",
    "flash_attention": "src/repro/kernels/flash_attention.py:133",
    # the bf16 route of the same forward, on the tensor cores
    "flash_attention_wgmma": "src/repro/kernels/flash_attention.py:133",
    # no TPU counterpart: the reference's Pallas call has no backward
    "flash_attention_bwd_dq": "none (no TPU kernel: the reference differentiates "
                              "ref.attention_xla_chunked with XLA)",
    "flash_attention_bwd_dkdv": "none (no TPU kernel: the reference differentiates "
                                "ref.attention_xla_chunked with XLA)",
    # the bf16 route of the same backward, on the tensor cores
    "flash_attention_bwd_dq_wgmma": "none (no TPU kernel: the reference differentiates "
                                    "ref.attention_xla_chunked with XLA)",
    "flash_attention_bwd_dkdv_wgmma": "none (no TPU kernel: the reference differentiates "
                                      "ref.attention_xla_chunked with XLA)",
}
SOURCES = {name: name for name in REPLACES} | {
    name: "ssd_chunk" for name in REPLACES if name.startswith("ssd_chunk_scan")} | {
    name: "flash_attention" for name in REPLACES if name.startswith("flash_attention")}
DATAFRAME = ("masked_stats", "segment_reduce", "topk", "filter_compact", "join_probe")
SERVING = ("ssd_chunk_scan_cells", "ssd_chunk_scan_short", "ssd_chunk_scan_wgmma",
           "ssd_chunk_scan_inter", "ssd_chunk_scan_recur")
TRAINING = ("flash_attention", "flash_attention_wgmma", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkdv", "flash_attention_bwd_dq_wgmma",
            "flash_attention_bwd_dkdv_wgmma")
BF16_ULP = 2.0 ** -7  # one bfloat16 ulp, relative


def ptxas_report(log: str):
    """[(kernel<template arguments>, registers, spill store bytes, spill load
    bytes)] of the attention kernels in an nvcc ``-Xptxas -v`` log."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d+(attn_[a-z_]+)I(\S*?)EEv", line)
        if m:
            kind = ("bf16," if "bfloat16" in m.group(2) else
                    "f32," if m.group(2).startswith("f") else "")
            name = f"{m.group(1)}<{kind}{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
            spills = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1))) + spills)
            name = None
    return out


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
    live = (keys >= 0) & (keys < nbk)
    for s, mode in enumerate(modes):
        if mode != "sum":
            check(torch.equal(gr[s], wr[s]), f"segment_reduce {mode} {label}")
            continue
        scale = torch.zeros(nbk, dtype=torch.float64, device=keys.device).index_add_(
            0, keys[live].long(), torch.where(valid[vidx[s]], vals[s].abs(), 0.0)[live].double())
        e = (gr[s].double() - wr[s].double()).abs()
        check(bool((e <= 1e-5 * scale).all()),
              f"segment_reduce sum {label}: excess {float((e - 1e-5 * scale).max())}")
        err = max(err, float(e.max()))
    return err


def same_values(torch, a, b) -> bool:
    """Equal shapes and values, NaN equal to NaN (== otherwise, so that +0.0
    and -0.0 may trade places)."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_topk(torch, got, want, label):
    """topk values exact (NaN equal to NaN; +0.0 / -0.0 may trade places)."""
    check(same_values(torch, got, want), f"topk {label}")
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


def ssd_ratios(torch, got, want):
    """(max |err| of y, of h_final), each over its limit: y within two ulps
    of its type (bf16: 2^-6; f32: 1e-5 relative) of the call's largest |y|
    (both versions round y_intra and y at the same two places, from float32
    sums taken in another order); h_final (float32) within 1e-5 of its
    largest |h|.  A non-finite y is over its limit."""
    (gy, gh), (wy, wh) = got, want
    rel = 2 * BF16_ULP if wy.dtype == torch.bfloat16 else 1e-5
    ey = float((gy.float() - wy.float()).abs().max())
    if not bool(torch.isfinite(gy.float()).all()):
        ey = math.inf
    return (ey / (rel * float(wy.float().abs().max())),
            float((gh - wh).abs().max()) / (1e-5 * float(wh.abs().max())))


def check_ssd(torch, got, want, label):
    """ssd_chunk_scan within :func:`ssd_ratios`' limits.  Returns max |err|
    of y."""
    (gy, gh), (wy, wh) = got, want
    check(gy.dtype == wy.dtype and gy.shape == wy.shape and gh.shape == wh.shape,
          f"ssd_chunk_scan types / shapes {label}")
    ry, rh = ssd_ratios(torch, got, want)
    check(ry <= 1.0, f"ssd_chunk_scan y {label}: err / limit {ry}")
    check(rh <= 1.0, f"ssd_chunk_scan h {label}: err / limit {rh}")
    return float((gy.float() - wy.float()).abs().max())


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

    from repro_torch.kernels import ops

    errs = {name: 0.0 for name in DATAFRAME + SERVING}
    ms_k, tk_k, fc_k = K["masked_stats"], K["topk"], K["filter_compact"]

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def note(name, e):
        errs[name] = max(errs[name], e)

    # -- masked_stats: each case against the plain version, padded, row by
    # row at the batch's own addresses, and row by row from fresh copies
    # (other alignments), all bit for bit
    def stats_case(x, m, label):
        xs, ms = t(x), t(m)
        before = ms_k.launches.value
        note("masked_stats", kernel_vs_plain(torch, K, "masked_stats", (xs, ms), label))
        got = ms_k.masked_stats(xs, ms)
        r, n = xs.shape
        pad = torch.zeros((r, n), dtype=torch.float32, device=dev)
        padded = ms_k.masked_stats(torch.cat([xs, pad], 1), torch.cat([ms, pad.bool()], 1))
        check(bits_equal(torch, padded, got), f"masked_stats pad invariance {label}")
        rows = torch.cat([ms_k.masked_stats(xs[i:i + 1], ms[i:i + 1]) for i in range(r)])
        check(bits_equal(torch, rows, got), f"masked_stats batched == per-row {label}")
        copies = torch.cat([ms_k.masked_stats(xs[i:i + 1].clone(), ms[i:i + 1].clone())
                            for i in range(r)])
        check(bits_equal(torch, copies, got), f"masked_stats batched == per-row copy {label}")
        check(ms_k.launches.value - before == 3 + 2 * r,
              f"masked_stats {label}: the wrapper did not launch its kernel every call")
        return got

    for n in (1, 3, 512, 20_000, 16_384 * 3 + 5, 1 << 20):
        x = rng.normal(1e3, 5.0, (4, n)).astype(np.float32)
        x[0, : min(n, 8)] = -0.0
        m = rng.random((4, n)) < 0.8
        m[1] = False  # all-masked row
        stats_case(x, m, f"n={n}")
    # five rows of 16,385: each row's values start at another 16-byte offset
    n = 16_384 + 1
    stats_case(rng.normal(-3.0, 2.0, (5, n)).astype(np.float32), rng.random((5, n)) < 0.5,
               "5 rows of n=16385")
    # one live value a row, in the last tile: at its end, at its start
    n = 16_384 * 3 + 100
    x = rng.normal(7.0, 1.0, (2, n)).astype(np.float32)
    m = np.zeros((2, n), bool)
    m[0, n - 1] = m[1, 16_384 * 3] = True
    got = stats_case(x, m, "one live value in the last tile")
    check(got[:, 0].tolist() == [1.0, 1.0] and got[:, 2].tolist() == [0.0, 0.0],
          "masked_stats: one live value must give count 1 and m2 0")
    # ROADMAP C2: +inf, -inf and NaN in masked lanes contribute nothing
    n = 40_000
    x = rng.normal(0.0, 3.0, (3, n)).astype(np.float32)
    m = rng.random((3, n)) < 0.6
    junk = np.where(rng.random((3, n)) < 0.5, np.inf, -np.inf).astype(np.float32)
    junk[rng.random((3, n)) < 0.3] = np.nan
    x = np.where(m, x, junk)
    got = stats_case(x, m, "inf and NaN in masked lanes")
    check(bool(torch.isfinite(got).all()), "masked_stats: a masked inf or NaN reached the result")
    # a row slice whose pointers are not 16-byte aligned (values 4 bytes and
    # mask 1 byte past an allocation), alone and through the parts batch
    n = 16_384 * 2 + 7
    flat = t(rng.normal(5.0, 2.0, 2 * n + 1).astype(np.float32))
    mflat = t(rng.random(2 * n + 1) < 0.7)
    xs, ms = flat[1:].view(2, n), mflat[1:].view(2, n)
    check(xs.data_ptr() % 16 != 0, "masked_stats: the slice is aligned")
    got = ms_k.masked_stats(xs, ms)
    note("masked_stats", check_stats(torch, got, ms_k.masked_stats_plain(xs, ms), xs, ms,
                                     "unaligned slice"))
    check(bits_equal(torch, got, ms_k.masked_stats(xs.clone(), ms.clone())),
          "masked_stats: unaligned slice != its aligned copy")
    parts = ops.masked_stats_batch_parts([xs[:1], flat[:n].view(1, n), xs[1:]],
                                         [ms[:1], mflat[:n].view(1, n), ms[1:]])
    check(bits_equal(torch, parts[[0, 2]], got),
          "masked_stats_batch_parts of unaligned slices != the slices alone")

    # -- segment_reduce
    segment_parity(torch, K, rng, dev, note)

    # -- topk: each case for largest and smallest, against the plain version,
    # padded with the losing sentinel, and row by row
    def topk_case(xs, k, label):
        for largest in (True, False):
            lab = f"{label} k={k} largest={largest}"
            before = tk_k.launches.value
            note("topk", kernel_vs_plain(torch, K, "topk", (xs, k, largest), lab))
            got = tk_k.topk(xs, k, largest)
            r, n = xs.shape
            sent = float("-inf") if largest else float("inf")
            pad = torch.full((r, n), sent, device=dev)
            check(same_values(torch, tk_k.topk(torch.cat([xs, pad], 1), k, largest), got),
                  f"topk pad invariance {lab}")
            rows = torch.cat([tk_k.topk(xs[i:i + 1], k, largest) for i in range(r)])
            check(same_values(torch, rows, got), f"topk batched == per-row {lab}")
            check(tk_k.launches.value - before == 3 + r,
                  f"topk {lab}: the wrapper did not launch its kernel every call")

    for n, k in ((1, 1), (512, 128), (5000, 20), (1 << 20, 128), (1 << 20, 1)):
        x = rng.normal(0.0, 1.0, (3, n)).astype(np.float32)
        x[0, : min(n, 3)] = [np.inf, -np.inf, -0.0][: min(n, 3)]
        x[1, : min(n, 2)] = 0.0
        topk_case(t(x), min(k, n), f"n={n}")
    n = 300_001  # sorted rows: the running threshold's worst case, and its best
    x = np.sort(rng.normal(0.0, 1.0, (2, n)).astype(np.float32), axis=1)
    x[1] = x[1, ::-1].copy()
    for k in (20, 128):
        topk_case(t(x), k, "ascending and descending rows")
    topk_case(torch.full((1, 100_000), 2.5, device=dev), 20, "one value repeated")
    x = np.full((2, 50_000), -np.inf, np.float32)  # 7 finite values a row
    x[:, rng.choice(50_000, 7, replace=False)] = rng.normal(0.0, 1.0, (2, 7))
    topk_case(t(x), 20, "fewer than k finite values")
    topk_case(t(rng.normal(0.0, 1.0, (2, 129)).astype(np.float32)), 128, "n=129")
    topk_case(t(rng.normal(0.0, 1.0, (3, 4097)).astype(np.float32)), 20, "3 rows of n=4097")
    n = 70_001  # rows that start 4 bytes past a 16-byte boundary
    flat = t(rng.normal(0.0, 1.0, 2 * n + 1).astype(np.float32))
    xs = flat[1:].view(2, n)
    check(xs.data_ptr() % 16 != 0, "topk: the slice is aligned")
    topk_case(xs, 20, "unaligned slice")
    # NaN ranks above every value, for largest either way (the reference's
    # rounds of max / argmax): the smallest row, then one NaN, more NaNs than
    # k, and NaNs beside +inf and -inf, on one launch and on two
    topk_case(t(np.array([[1.0, np.nan, 3.0, 2.0, -1.0]], np.float32)), 2, "NaN, smallest row")
    for n, k in ((5000, 20), (300_001, 20), (1 << 20, 128), (129, 128)):
        x = rng.normal(0.0, 1.0, (3, n)).astype(np.float32)
        x[0, rng.integers(n)] = np.nan
        x[1, rng.choice(n, k + 1, replace=False)] = np.nan
        x[2, rng.choice(n, 6, replace=False)] = [np.nan, np.inf, -np.inf, np.nan, np.inf, -np.inf]
        topk_case(t(x), k, f"NaN rows n={n}")

    # -- filter_compact: every element width, shared and per-row masks, at
    # each tile edge (odd n: the second per-row mask starts off a 16-byte
    # boundary, so its counts take single bytes) and past 2,048 tiles
    from repro_torch.kernels import _build

    ft = fc_k.FC_TILE
    check(_build.load("filter_compact").repro_filter_compact_tile() == ft,
          "filter_compact: FC_TILE is not the kernel's tile")
    for n in (1, ft - 1, ft, ft + 1, 4097, 1 << 20, 4_500_001):
        for dtype in (torch.float64, torch.int64, torch.int32, torch.float32, torch.bool):
            base = rng.normal(0.0, 1e6, (2, n))
            x = t(base).to(dtype)
            bits = {8: torch.int64, 4: torch.int32, 1: torch.uint8}[x.element_size()]
            for kind in ("empty", "full", "random"):
                keep = {"empty": np.zeros(n, bool), "full": np.ones(n, bool),
                        "random": rng.random(n) < 0.5}[kind]
                note("filter_compact", kernel_vs_plain(
                    torch, K, "filter_compact", (x, t(keep), 0), f"{dtype} n={n} keep={kind}"))
                per = {"empty": np.zeros((2, n), bool), "full": np.ones((2, n), bool),
                       "random": rng.random((2, n)) < 0.3}[kind]
                note("filter_compact", kernel_vs_plain(
                    torch, K, "filter_compact", (x, t(per), 0),
                    f"{dtype} n={n} per-row keep={kind}"))
                g2, c2 = fc_k.filter_compact(x, t(per), 0)
                r0, c0 = fc_k.filter_compact(x[:1].contiguous(), t(per[0]), 0)
                check(torch.equal(g2[:1].view(bits), r0.view(bits)) and int(c2[0]) == int(c0[0]),
                      f"filter_compact batched == per-row {dtype} n={n} keep={kind}")

    # -- join_probe
    join_parity(torch, K, rng, dev, note)

    # -- ssd_chunk_scan
    ssd_parity(torch, K, rng, dev, note)
    return errs


def bits_equal(torch, a, b) -> bool:
    """Equal bit for bit (so +0.0 and -0.0 differ, and NaN equals itself)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def zipf_keys(rng, n, nbk, a=1.1):
    """n keys over nbk buckets with Zipf(a) frequencies, the heavy buckets
    scattered over the key range."""
    import numpy as np

    p = 1.0 / np.arange(1, nbk + 1, dtype=np.float64) ** a
    return rng.permutation(nbk).astype(np.int32)[rng.choice(nbk, n, p=p / p.sum())]


def segment_contracts(torch, K, rng, dev, args, label):
    """segment_reduce against its plain version, then its bit-for-bit
    contracts: batched == per-row, pad invariance (key 0, valid False),
    two calls equal, and bucket independence (rows of other keys, in range
    and out of it, inserted between the rows change no other bucket).
    Returns max |err| of the sums."""
    import numpy as np

    sr = K["segment_reduce"]
    keys, vals, valid, nbk, modes, vidx = args
    n, S, V = keys.shape[0], vals.shape[0], valid.shape[0]
    err = kernel_vs_plain(torch, K, "segment_reduce", args, label)
    gr, gc = sr.segment_reduce(*args)
    again = sr.segment_reduce(*args)
    check(bits_equal(torch, again[0], gr) and bits_equal(torch, again[1], gc),
          f"segment_reduce two calls differ {label}")
    for s, (mode, v) in enumerate(zip(modes, vidx)):
        rr, rc = sr.segment_reduce(keys, vals[s:s + 1], valid[v:v + 1], nbk, [mode], [0])
        check(bits_equal(torch, rr[0], gr[s]) and bits_equal(torch, rc[0], gc[v]),
              f"segment_reduce batched == per-row {label} row {s}")
    pad = n + 5000
    kp = torch.cat([keys, torch.zeros(pad, dtype=torch.int32, device=dev)])
    vp = torch.cat([vals, torch.ones((S, pad), device=dev)], 1)
    mp = torch.cat([valid, torch.zeros((V, pad), dtype=torch.bool, device=dev)], 1)
    pr, pc = sr.segment_reduce(kp, vp, mp, nbk, modes, vidx)
    check(bits_equal(torch, pr, gr) and bits_equal(torch, pc, gc),
          f"segment_reduce pad invariance {label}")
    # bucket independence: extra rows of three in-range keys and of keys out
    # of range, at random places among the rows
    extra = max(1, n // 4)
    others = rng.choice(nbk, min(3, nbk - 1), replace=False).astype(np.int64)
    pool = np.concatenate([others, [-1, nbk, 2 ** 31 - 1]]).astype(np.int64)
    ek = pool[rng.integers(0, len(pool), extra)]
    at = np.sort(rng.integers(0, n + 1, extra))
    order = np.argsort(np.concatenate([np.arange(n) * 2 + 1, at * 2]), kind="stable")
    idx = torch.as_tensor(order, device=dev)
    ki = torch.cat([keys, torch.as_tensor(ek.astype(np.int32), device=dev)])[idx].contiguous()
    vi = torch.cat([vals, torch.as_tensor(rng.normal(0, 1e3, (S, extra)).astype(np.float32),
                                          device=dev)], 1)[:, idx].contiguous()
    mi = torch.cat([valid, torch.as_tensor(rng.random((V, extra)) < 0.9, device=dev)],
                   1)[:, idx].contiguous()
    ir, ic = sr.segment_reduce(ki, vi, mi, nbk, modes, vidx)
    keep = torch.ones(nbk, dtype=torch.bool, device=dev)
    keep[torch.as_tensor(others, device=dev)] = False
    check(bits_equal(torch, ir[:, keep], gr[:, keep]) and bits_equal(torch, ic[:, keep], gc[:, keep]),
          f"segment_reduce bucket independence {label}")
    return err


# segment_reduce's edge shapes, (n, B, kind): uniform keys at every width of
# the old tiling (the last two beyond one block's shared memory), then one
# bucket holding every row (the longest run, the deepest fold), Zipf keys at
# cell 7's size, a call with no valid row, keys out of range mixed in, and
# the widest B at the widest main-path row count.
SEGMENT_SHAPES = ((1, 1, "uniform"), (2048, 64, "uniform"), (100_003, 1000, "uniform"),
                  (1 << 20, 64, "uniform"), (300_001, 100_000, "uniform"),
                  (5000, (1 << 24) - 1, "uniform"), (1 << 21, 1, "uniform"),
                  (2_204_249, 100_000, "zipf"), (100_003, 1000, "none valid"),
                  (100_003, 1000, "out of range"), (300_001, (1 << 24) - 1, "uniform"))


def segment_parity(torch, K, rng, dev, note):
    import numpy as np

    for n, nbk, kind in SEGMENT_SHAPES:
        keys = zipf_keys(rng, n, nbk) if kind == "zipf" else rng.integers(0, nbk, n).astype(np.int32)
        if kind == "out of range":
            bad = rng.random(n) < 0.1
            keys[bad] = rng.choice(np.array([-1, nbk, 2 ** 31 - 1], np.int32), int(bad.sum()))
        valid = rng.random((2, n)) < (0.0 if kind == "none valid" else 0.9)
        args = (torch.as_tensor(keys, device=dev),
                torch.as_tensor(rng.normal(0.0, 10.0, (3, n)).astype(np.float32), device=dev),
                torch.as_tensor(valid, device=dev), nbk, ["sum", "min", "max"], [0, 1, 1])
        note("segment_reduce", segment_contracts(torch, K, rng, dev, args,
                                                 f"n={n} B={nbk} {kind}"))


# join_probe's right sides beyond the sample rule, (m, log_s, kind): the
# sample step forced so that small sides reach its edges: fewer keys than one
# step, a count that is not a multiple of the step, a NaN tail that starts
# inside one step and runs past the next sample point, and left keys equal
# to the sampled keys (and their neighbours).
JOIN_SAMPLE_EDGES = ((3, 3, "m < s"), (1001, 4, "m % s != 0"),
                     (100, 4, "NaN tail over a sample point"),
                     (4099, 5, "keys at sample points"), (70_001, 9, "deep device levels"))


def join_parity(torch, K, rng, dev, note):
    """join_probe against its plain version, exact: every key type; right
    sides staged whole and sampled by the wrapper's rule; then the sample's
    edges with the step forced (JOIN_SAMPLE_EDGES)."""
    import numpy as np

    jp = K["join_probe"]

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def forced(lk, r, log_s):
        """the kernel through its C entry point with the sample step 2^log_s"""
        n, m, size = lk.shape[0], r.shape[0], lk.element_size()
        scratch = torch.empty(-(-m >> log_s) * size, dtype=torch.uint8, device=dev)
        pos = torch.empty(n, dtype=torch.int32, device=dev)
        hit = torch.empty(n, dtype=torch.bool, device=dev)
        err = jp._fns()(lk.data_ptr(), n, r.data_ptr(), m, jp.DTYPES[lk.dtype], log_s,
                           scratch.data_ptr(), scratch.numel(), pos.data_ptr(), hit.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"join_probe with log_s {log_s} failed with cudaError_t {err}")
        return pos, hit

    def against_plain(lk, r, label, log_s=None):
        got = jp.join_probe(lk, r) if log_s is None else forced(lk, r, log_s)
        note("join_probe", check_join(torch, got, jp.join_probe_plain(lk, r), label))

    for dtype in (torch.float64, torch.float32, torch.int64, torch.int32):
        for n, m in ((1, 1), (5000, 7), (100_000, 1000), (1 << 20, 30_000), (1 << 20, 900_000)):
            r = np.sort(rng.choice(4 * m, m, replace=False)).astype(np.float64) - m
            lk = rng.integers(-2 * m, 4 * m, n).astype(np.float64)
            lk[: min(n, 3)] = r[: min(n, 3)]  # duplicate left keys, exact hits
            if dtype.is_floating_point:
                r = np.concatenate([[-np.inf], r, [np.inf, np.nan]])
                edge = [np.nan, np.inf, -np.inf, -0.0, 0.0]
                lk[: min(n, 5)] = edge[: min(n, 5)]
            against_plain(t(lk, dtype), t(r, dtype), f"{dtype} n={n} m={m}")
        for m, log_s, kind in JOIN_SAMPLE_EDGES:
            r = np.sort(rng.choice(4 * m, m, replace=False)).astype(np.float64) - m
            s = 1 << log_s
            if kind.startswith("NaN") and dtype.is_floating_point:
                r[s * 3 + s // 2:] = np.nan  # from mid-step 3 past sample point 4
            live = r[~np.isnan(r)]
            lk = np.concatenate([r[::s], r[::s] + 1, r[::s] - 1, live[-1:] + 1, live[:1] - 1,
                                 rng.integers(-2 * m, 4 * m, 3000).astype(np.float64)])
            if dtype.is_floating_point:
                lk[:4] = [np.nan, np.inf, -np.inf, -0.0]
            for k in (log_s, log_s + 1):  # 2^k >= 8 keys: a whole sector at either width
                against_plain(t(lk, dtype), t(r, dtype), f"{dtype} m={m} log_s={k} {kind}", k)


# ssd_chunk_scan's shapes, (batch, S, H, P, N, L, dtype): full width; f32;
# one-token chunks; the smoke width; odd dims; then the edges of the
# tensor-core route: L 64 in batches of 2, P 128, N 64, all three at once,
# P 16 (columns zero-filled past P), and 7 heads in blocks of 2 (the last
# block of one head: 26 chunks on 132 SMs give heads_per_block 2); then the
# edges of the short route: f32 at L 1; L 2 and 16 (the threshold, in f32
# and bf16); P 24 and 40; N 17 with P 7 (N P and P no multiple of 4: state
# rows cross float4s); batches of 2; 10 heads in groups of 3 (700 chunks:
# short_heads 3, the last group of one head); L 17, just past the
# threshold, on ssd_cells; and at one-token chunks (ssd_recur) N 256, its
# register limit, N 17 with P 7 in bf16 in batches of 2 over 3 heads, and
# one token.
SSD_SHAPES = ((1, 256, 80, 64, 128, 128, "bfloat16"), (2, 256, 8, 64, 128, 128, "float32"),
              (1, 37, 4, 16, 16, 1, "bfloat16"), (2, 96, 8, 16, 16, 32, "bfloat16"),
              (1, 128, 3, 24, 40, 64, "float32"), (2, 256, 8, 64, 128, 64, "bfloat16"),
              (1, 256, 6, 128, 128, 128, "bfloat16"), (1, 256, 8, 64, 64, 128, "bfloat16"),
              (2, 128, 5, 128, 64, 64, "bfloat16"), (1, 128, 4, 16, 64, 64, "bfloat16"),
              (2, 1664, 7, 64, 128, 128, "bfloat16"),
              (1, 37, 4, 16, 16, 1, "float32"), (2, 64, 5, 24, 128, 2, "bfloat16"),
              (1, 256, 6, 40, 64, 16, "float32"), (1, 96, 3, 40, 128, 16, "bfloat16"),
              (2, 50, 3, 7, 17, 1, "float32"), (1, 64, 5, 7, 17, 16, "bfloat16"),
              (2, 350, 10, 24, 64, 1, "bfloat16"), (1, 68, 4, 64, 128, 17, "float32"),
              (1, 40, 3, 64, 256, 1, "bfloat16"), (2, 30, 3, 7, 17, 1, "bfloat16"),
              (1, 1, 3, 64, 128, 1, "float32"))


def ssd_parity(torch, K, rng, dev, note, shapes=SSD_SHAPES):
    """ssd_chunk_scan against its plain version (check_ssd) at ``shapes``: a
    call that ``scan_route`` sends to ``ssd_recur`` must launch it once and
    no other kernel, with h_final bit for bit; any other must launch the
    kernel ``ssd_route`` names and the scan kernel once each.  Its error is
    noted under the kernel's name.  Then the intra-chunk kernel alone
    (``ssd_chunk_intra``; at one-token chunks its states must equal the
    plain version's bit for bit, each being the one rounding of b_n x_p) and
    the inter-chunk scan kernel alone on its outputs (``ssd_chunk_inter``,
    one launch) against the plain inter-chunk pass: h_final bit for bit, y
    within check_ssd's limits; at one-token chunks the pair's y and h also
    against the plain function, noted under the intra-chunk kernel."""
    sc = K["ssd_chunk_scan"]
    counters = {"cells": sc.launches_cells, "short": sc.launches_short,
                "wgmma": sc.launches_wgmma, "scan": sc.launches_scan,
                "recur": sc.launches_recur}
    for bt, S, H, Pd, N, L, dtype in shapes:
        label = f"{(bt, S, H, Pd, N, L, dtype)}"
        dt = getattr(torch, dtype)
        intra = sc.ssd_route(dt, L, N, Pd)
        recur = sc.scan_route(L, N) == "recur"
        args = ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, dt) + (L,)
        want = sc.ssd_chunk_scan_plain(*args)
        before = {r: c.value for r, c in counters.items()}
        got = sc.ssd_chunk_scan(*args)
        took = {r: c.value - before[r] for r, c in counters.items()}
        check(took == {r: int(r in (("recur",) if recur else (intra, "scan"))) for r in counters},
              f"ssd_chunk_scan {label} launched {took}, not "
              f"{'ssd_recur once' if recur else f'the {intra} kernel and the scan kernel once each'}")
        err = check_ssd(torch, got, want, label)
        if recur:
            check(torch.equal(got[1], want[1]),
                  f"ssd_recur {label}: h_final differs from the plain version's bit for bit")
        note(f"ssd_chunk_scan_{'recur' if recur else intra}", err)
        before = {r: c.value for r, c in counters.items()}
        y_intra, state = sc.ssd_chunk_intra(*args)
        if L == 1:
            check(torch.equal(state, sc.ssd_chunk_intra_plain(*args)[1]),
                  f"ssd_chunk_scan {label}: one-token chunk states differ from the plain "
                  f"version's")
        _, log_a, _, cm, _ = args
        pair = sc.ssd_chunk_inter(y_intra, state, log_a, cm)
        took = {r: c.value - before[r] for r, c in counters.items()}
        check(took == {r: int(r in (intra, "scan")) for r in counters},
              f"ssd_chunk_intra + ssd_chunk_inter {label} launched {took}, not the {intra} "
              f"kernel and the scan kernel once each")
        inter = sc.ssd_chunk_inter_plain(y_intra, state, log_a, cm)
        check(torch.equal(pair[1], inter[1]),
              f"ssd_chunk_inter {label}: h_final differs from the plain version's bit for bit")
        note("ssd_chunk_scan_inter", check_ssd(torch, pair, inter, f"inter-chunk scan {label}"))
        if recur:
            note(f"ssd_chunk_scan_{intra}",
                 check_ssd(torch, pair, want, f"{intra} + inter-chunk scan {label}"))


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
# phase 2b: attention, forward and backward, kernel vs plain                   #
# --------------------------------------------------------------------------- #

# (B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, q_offset): GQA groups 1, 3
# and 8; D 64, 120 and 128; both types; causal and not; windows 32 and 4,096;
# q_offset > 0 with Sq < Skv (alone and with a window, so that a row's first
# kv tiles are all hidden); one 64-row tile; a 96-row sequence (ragged tiles);
# B from 1 to 4; and the training shape's heads.  The last three rows reach
# the tensor-core kernel's edges: D 128 without a mask in groups of 4; D 120
# (two swizzle atoms, the second zero-filled past column 120) with danube's
# heads over 4,096 keys and a window of 4,096; and one 128-row q tile with
# only 64 live rows (Sq 64 < Skv 384, q_offset 320), whose rows past Sq read
# zeros and are never written.
ATTN_SHAPES = (
    (1, 2, 2, 128, 128, 64, "bfloat16", True, None, 0),
    (2, 6, 2, 256, 256, 64, "float32", True, None, 0),
    (4, 8, 1, 128, 128, 128, "bfloat16", True, None, 0),
    (1, 8, 1, 256, 256, 128, "float32", False, None, 0),
    (2, 3, 1, 256, 256, 64, "bfloat16", True, 32, 0),
    (1, 15, 5, 512, 512, 64, "bfloat16", True, 4096, 0),
    (2, 4, 2, 128, 384, 64, "float32", True, None, 256),
    (1, 4, 2, 128, 384, 64, "bfloat16", True, 32, 256),
    (3, 3, 3, 64, 64, 64, "float32", True, None, 0),
    (1, 6, 2, 96, 96, 120, "bfloat16", False, 32, 0),
    (2, 15, 5, 1024, 1024, 64, "bfloat16", True, None, 0),
    (2, 8, 2, 256, 256, 128, "bfloat16", False, None, 0),
    (1, 32, 8, 4096, 4096, 120, "bfloat16", True, 4096, 0),
    (1, 4, 2, 64, 384, 64, "bfloat16", True, None, 320),
) + (
    # head dim 256 (RecurrentGemma's local attention; DP 256: four swizzle
    # atoms, the backward's column halves, the FMA backward's 32-key tiles):
    # MQA group 16 with a window of 2,048 over 4,096 keys in both types; a
    # window of 32 in batches of 2; not causal; q_offset > 0 with Sq < Skv;
    # D 192 (the fourth atom zero-filled); a ragged 96-row sequence
    (1, 16, 1, 4096, 4096, 256, "bfloat16", True, 2048, 0),
    (1, 16, 1, 4096, 4096, 256, "float32", True, 2048, 0),
    (2, 16, 1, 256, 256, 256, "bfloat16", True, 32, 0),
    (2, 16, 1, 256, 256, 256, "float32", True, 32, 0),
    (1, 4, 2, 256, 256, 256, "bfloat16", False, None, 0),
    (2, 16, 1, 128, 384, 256, "bfloat16", True, 32, 256),
    (1, 4, 1, 128, 384, 256, "float32", True, None, 256),
    (1, 4, 2, 128, 128, 192, "bfloat16", True, None, 0),
    (1, 2, 1, 96, 96, 256, "bfloat16", True, None, 0),
)
# Limits, relative to the largest |value| of the plain version's tensor: the
# kernel and the plain version sum in float32 in another order and round to
# the inputs' type once, so a bf16 value may differ by one bf16 ulp of
# itself, and a float32 value by float32 rounding over S-long sums.  The
# tensor-core forward also rounds P to bf16 before P·V; a CPU emulation of
# that rounding stays within the bf16 limit (tests/test_torch_attention.py).
ATTN_TOL = {"bfloat16": 2 * BF16_ULP, "float32": 1e-5}


def attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype):
    """q, k, v and an output cotangent, N(0, 1) (q and k scaled so that the
    logits spread over several units, as in a trained model)."""
    dt = getattr(torch, dtype)

    def t(shape, sd=1.0):
        return torch.as_tensor(rng.normal(0, sd, shape), device=dev).to(dt).contiguous()

    return (t((B, Hq, Sq, D), 1.5), t((B, Hkv, Skv, D), 1.5), t((B, Hkv, Skv, D)),
            t((B, Hq, Sq, D)))


def attn_grads(torch, fn, q, k, v, g, mask):
    """→ (o, dq, dk, dv) of ``fn`` with the cotangent ``g``."""
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v, *mask)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
    return o.detach(), dq, dk, dv


def attn_controls(torch, fa):
    """Faulty plain attentions that the limits must catch, by name, with the
    tensor each must spoil."""
    plain = fa.flash_attention_plain

    def no_alpha(q, k, v, causal, window, scale, q_offset):
        # online softmax over 64-key blocks that never rescales what it has
        # summed when the running max grows
        B, Hq, Sq, D = q.shape
        group = Hq // k.shape[1]
        scale = scale if scale is not None else D ** -0.5
        kf = k.float().repeat_interleave(group, 1)
        vf = v.float().repeat_interleave(group, 1)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kf)
        s = s.masked_fill(~fa._mask(Sq, k.shape[2], causal, window, q_offset, q.device),
                          float("-inf"))
        m = torch.full(s.shape[:3] + (1,), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, device=q.device)
        for j in range(0, s.shape[-1], 64):
            blk = s[..., j:j + 64]
            m = torch.maximum(m, blk.amax(-1, keepdim=True))
            p = torch.exp(blk - m).nan_to_num(0.0)
            l = l + p.sum(-1, keepdim=True)
            acc = acc + p @ vf[:, :, j:j + 64]
        return (acc / l.clamp_min(1e-30)).to(q.dtype)

    def dkdv_skips_a_head(q, k, v, causal, window, scale, q_offset):
        # the plain attention with the kv gradient of each group's last
        # q-head dropped
        group = q.shape[1] // k.shape[1]
        return _SkipHead.apply(q, k, v, (causal, window, scale, q_offset), group)

    class _SkipHead(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, group):
            ctx.save_for_backward(q, k, v)
            ctx.mask, ctx.group = mask, group
            return plain(q, k, v, *mask)

        @staticmethod
        def backward(ctx, g):
            q, k, v = ctx.saved_tensors
            with torch.enable_grad():
                qq = q.detach().requires_grad_(True)
                kr = k.detach().repeat_interleave(ctx.group, 1).requires_grad_(True)
                vr = v.detach().repeat_interleave(ctx.group, 1).requires_grad_(True)
                o = plain(qq, kr, vr, *ctx.mask)
                dq, dkr, dvr = torch.autograd.grad(o, (qq, kr, vr), g)
            B, Hq, Skv, D = dkr.shape
            shape = (B, Hq // ctx.group, ctx.group, Skv, D)
            keep = torch.ones(ctx.group, device=q.device)
            keep[-1] = 0.0
            dk = (dkr.float().reshape(shape) * keep[:, None, None]).sum(2).to(k.dtype)
            dv = (dvr.float().reshape(shape) * keep[:, None, None]).sum(2).to(v.dtype)
            return dq, dk, dv, None, None

    return {"forward without the alpha rescale": (no_alpha, "o"),
            "dK/dV that skips one head of each group": (dkdv_skips_a_head, "dk")}


def attn_errs(got, want):
    """max |err| and the plain tensor's max |value|, for o, dq, dk, dv."""
    return {name: (float((g.float() - w.float()).abs().max()), float(w.float().abs().max()))
            for name, g, w in zip(("o", "dq", "dk", "dv"), got, want)}


def attention_parity(torch, rng, dev, shapes=ATTN_SHAPES, label="edge"):
    """The kernels (through their autograd Function) against the plain
    version at ``shapes``: each forward on the kernel ``forward_route``
    names and each backward on those ``backward_route`` names, the output
    and the three gradients within ATTN_TOL, two backward
    runs equal bit for bit, and each faulty control over the limit at one
    shape at least.  Returns the max |err| per kernel."""
    from repro_torch.kernels import flash_attention as fa

    errs = {name: 0.0 for name in TRAINING}
    rows = {"o": "flash_attention", "dq": "flash_attention_bwd_dq",
            "dk": "flash_attention_bwd_dkdv", "dv": "flash_attention_bwd_dkdv"}
    tc_rows = {"o": "flash_attention_wgmma", "dq": "flash_attention_bwd_dq_wgmma",
               "dk": "flash_attention_bwd_dkdv_wgmma", "dv": "flash_attention_bwd_dkdv_wgmma"}
    controls = attn_controls(torch, fa)
    caught = {label: 0.0 for label in controls}
    worst = {}
    for B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off in shapes:
        where = f"{(B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off)}"
        q, k, v, g = attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype)
        mask = (causal, window, None, off)
        route = {"o": fa.forward_route(q.dtype, D)}
        route["dq"] = route["dk"] = route["dv"] = fa.backward_route(q.dtype, D)
        counters = {"o": fa.launches_wgmma, "dq": fa.launches_dq_wgmma,
                    "dk": fa.launches_dkdv_wgmma}
        before = {name: c.value for name, c in counters.items()}
        got = attn_grads(torch, fa.flash_attention, q, k, v, g, mask)
        again = attn_grads(torch, fa.flash_attention, q, k, v, g, mask)
        for name, c in counters.items():
            check(c.value - before[name] == (2 if route[name] == "wgmma" else 0),
                  f"attention {name} {where} did not take the {route[name]} kernel")
        want = attn_grads(torch, fa.flash_attention_plain, q, k, v, g, mask)
        for name, a, b in zip(("o", "dq", "dk", "dv"), got, again):
            check(torch.equal(a, b), f"attention {name} differs between two runs {where}")
        tol = ATTN_TOL[dtype]
        for name, (e, scale) in attn_errs(got, want).items():
            check(got[0].dtype == q.dtype, f"attention output type {where}")
            check(e <= tol * scale and e == e,
                  f"attention {name} {where}: max |err| {e} over the limit {tol * scale}")
            errs[rows[name]] = max(errs[rows[name]], e)
            if route[name] == "wgmma":
                errs[tc_rows[name]] = max(errs[tc_rows[name]], e)
            key = f"{name} {dtype}"
            worst[key] = max(worst.get(key, 0.0), e / max(scale, 1e-30))
        for clabel, (faulty, name) in controls.items():
            bad = attn_grads(torch, faulty, q, k, v, g, mask)
            e = attn_errs(got, bad)[name][0]
            caught[clabel] = max(caught[clabel], e / (tol * attn_errs(got, want)[name][1]))
    for clabel, ratio in caught.items():
        check(ratio > 1.0, f"attention control, {clabel}: max |err| is {ratio} of the limit at "
              "every shape, which cannot see it")
    print(f"[parity] attention: kernel vs plain at {len(shapes)} {label} shapes; worst "
          "|err| / max |plain| per tensor and type (limits " + json.dumps(ATTN_TOL) + "): "
          + json.dumps(worst) + "; two backward runs equal "
          "bit for bit; controls, worst |err| over the limit: " + json.dumps(caught), flush=True)
    return errs


def attention_in_new_thread(torch, rng, dev):
    """A forward and backward started in a thread that has made no CUDA call
    yet, as autograd's backward thread may not have: the tensor-core
    kernels' map encoder needs the device's context bound in the calling
    thread.  Equal bit for bit to the same call in this thread."""
    import threading

    from repro_torch.kernels import flash_attention as fa

    q, k, v, g = attn_inputs(torch, rng, dev, 1, 2, 2, 128, 128, 64, "bfloat16")
    mask = (True, None, None, 0)
    out = {}

    def run():
        try:
            out["got"] = attn_grads(torch, fa.flash_attention, q, k, v, g, mask)
        except Exception as exc:  # reported below, in this thread
            out["err"] = exc

    th = threading.Thread(target=run)
    th.start()
    th.join()
    check("err" not in out, f"attention in a new thread raised: {out.get('err')}")
    here = attn_grads(torch, fa.flash_attention, q, k, v, g, mask)
    check(all(torch.equal(a, b) for a, b in zip(out["got"], here)),
          "attention in a new thread differs from the same call in this one")
    print("[parity] attention: a forward and backward in a new thread equal the same call "
          "here bit for bit", flush=True)


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


# the device functions of csrc/segment_reduce.cu, for the trace's split
SEGMENT_KERNELS = ("count_shared", "count_global", "fill_neutral", "sort_hist",
                   "sort_scan_tiles", "sort_scan_digits", "sort_scatter", "fold_first",
                   "fold_level")


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
        seg = sum(t for t, k in kern if any(f in k for f in SEGMENT_KERNELS))
        print(f"[trace] cell{i + 1}: wall {wall} ms, device kernels {busy} ms "
              f"(segment_reduce {seg} ms), device copies {copy} ms, device idle "
              f"{100 * (1 - (busy + copy) / wall)}%; "
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
# phase 3b: the examples and the serve launcher on the card                     #
# --------------------------------------------------------------------------- #

# The dataframe examples' answers against a numpy session's, under the
# parity tolerances of tests/test_backend_parity.py:51-54 (describe's count
# exact, mean rtol 1e-4 / atol 1e-5, std rtol 1e-3 / atol 1e-4, min and max
# rtol 1e-5; group means as means; everything else exact), and the kernels
# each example's cells reach.
STAT_TOL = {"count": (0.0, 0.0), "mean": (1e-4, 1e-5), "std": (1e-3, 1e-4),
            "min": (1e-5, 0.0), "max": (1e-5, 0.0)}
EXAMPLE_KERNELS = {"quickstart": ("masked_stats",),
                   "interactive_session": ("segment_reduce", "filter_compact", "masked_stats")}


def example(name):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *args, **kwargs):
    """``fn(...)`` with its standard output kept → (result, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def compare_answer(want, got, code):
    import numpy as np

    plain = [a.to_pydict() if hasattr(a, "to_pydict") else list(a) for a in (want, got)]
    want, got = plain
    if isinstance(want, list):
        check(got == want, f"{code}: {got} != {want}")
        return
    check(list(got) == list(want), f"{code}: columns {list(got)} != {list(want)}")
    stats = want.get("stat")
    for col, w in want.items():
        g = got[col]
        check(g.shape == w.shape, f"{code}/{col}: shape {g.shape} != {w.shape}")
        if w.dtype.kind in "OUS":
            check(np.array_equal(g, w), f"{code}/{col}: not equal")
        elif stats is not None:
            for i, stat in enumerate(stats):
                rtol, atol = STAT_TOL[stat]
                np.testing.assert_allclose(float(g[i]), float(w[i]), rtol=rtol, atol=atol,
                                           err_msg=f"{code}/{col}/{stat}")
        elif ".mean()" in code:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=STAT_TOL["mean"][0], atol=STAT_TOL["mean"][1],
                                       err_msg=f"{code}/{col}")
        else:
            check(np.array_equal(g, w, equal_nan=True), f"{code}/{col}: not equal")


def dataframe_example(torch, ops, BK, name):
    """One dataframe example in a cuda session against the same program in
    a numpy session → the kernels' launches in the cuda run."""
    from repro_torch.frame import api
    from repro_torch.frame.runtime import FrameRuntime

    mod = example(name)
    cells, first = [], {}
    cell, planned, kwargs = api.Session.cell, FrameRuntime._planned_backend, mod.session_kwargs

    def recording_cell(self, code):
        out = cell(self, code)
        cells.append((code, out))
        return out

    def recording_plan(self, key, rows):
        bk = planned(self, key, rows)
        first.setdefault(key, bk)
        return bk

    api.Session.cell = recording_cell
    try:
        mod.session_kwargs = lambda device: {"kernel_backend": "numpy", "device": "cpu"}
        ref, _ = quiet(mod.main, [])
        ref_cells, cells[:] = list(cells), []
        mod.session_kwargs = kwargs
        FrameRuntime._planned_backend = recording_plan
        BK.reset_breakers()
        ops.reset_launch_counts()  # counts start at 0 just before the example
        got, _ = quiet(mod.main, [])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        api.Session.cell, FrameRuntime._planned_backend = cell, planned
        mod.session_kwargs = kwargs
    check([c for c, _ in cells] == [c for c, _ in ref_cells], f"{name}: other cells ran")
    shown = [(c, a) for c, a in cells if a is not None]
    check(len(shown) == len(got["answers"]), f"{name}: answers and cells differ")
    for (code, g), (_, w) in zip(shown, [(c, a) for c, a in ref_cells if a is not None]):
        compare_answer(w, g, f"{name}: {code.strip()}")
    check(got["latencies"] == ref["latencies"], f"{name}: simulated latencies "
          f"{got['latencies']} != the numpy session's {ref['latencies']}")
    for kernel in EXAMPLE_KERNELS[name]:
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    check(first and all(bk == "cuda" for bk in first.values()),
          f"{name}: a first dispatch did not take the kernels: {first}")
    snap = {k: v for k, v in BK.breaker_board().snapshot().items() if k.endswith("|cuda")}
    check(snap and all(st["failures"] == 0 and st["fallbacks"] == 0 for st in snap.values()),
          f"{name}: breakers {snap}")
    planner = got["session"].engine.cost_model.planner_report()
    print(f"[examples] {name}: {len(shown)} answers equal the numpy session's; simulated "
          f"latencies s {json.dumps(got['latencies'])} (equal); first dispatch per key "
          f"{json.dumps(first)}; planner decisions {json.dumps(planner)}; launches "
          + json.dumps({k: v for k, v in launches.items() if v}) + "; breakers: zero "
          "failures and fallbacks on cuda for " + ", ".join(sorted(k.split("|")[0]
                                                               for k in snap)), flush=True)
    return launches


def examples_on_card(torch, ops, BK):
    """Phase 3b → the kernels' launches over its runs."""
    import shutil

    from repro_torch.launch import serve as launch_serve

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for name in EXAMPLE_KERNELS:
        add(dataframe_example(torch, ops, BK, name))

    # the LM examples and the serve launcher at smoke width, each twice
    ops.reset_launch_counts()
    serve = example("serve_opportunistic")
    (a, _), (b, _) = quiet(serve.main, []), quiet(serve.main, [])
    check(a["tokens"] == b["tokens"] and a["latencies"] == b["latencies"],
          "serve example: a fresh run gave other tokens or latencies")
    print(f"[examples] serve_opportunistic twice: tokens {json.dumps(a['tokens'])} and "
          f"simulated latencies s {json.dumps(a['latencies'])}, equal", flush=True)
    (a, _), (b, _) = quiet(launch_serve.main, []), quiet(launch_serve.main, [])
    check(a == b, "launch.serve: a fresh run gave other tokens or latencies")
    print("[examples] launch.serve twice: " + json.dumps(a) + ", equal", flush=True)
    train = example("train_lm")
    runs = []
    try:
        for i in range(2):
            ckpt = CKPT_ROOT / f"train_lm_{i}"
            shutil.rmtree(ckpt, ignore_errors=True)
            t0 = time.perf_counter()
            stats, _ = quiet(train.main, ["--ckpt-dir", str(ckpt)])
            runs.append((stats, time.perf_counter() - t0))
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    (s0, w0), (s1, w1) = runs
    check(s0.losses == s1.losses and s0.grad_norms == s1.grad_norms,
          "train example: a fresh run gave other losses")
    check(all(math.isfinite(x) for x in s0.losses) and s0.losses[-1] < s0.losses[0],
          f"train example: losses {s0.losses[0]} -> {s0.losses[-1]}")
    print(f"[examples] train_lm twice, {s0.steps} steps each in {w0} and {w1} s: losses "
          f"{s0.losses[0]} -> {s0.losses[-1]}, equal bit for bit; median step "
          f"{sorted(s0.step_times)[len(s0.step_times) // 2] * 1e3} ms", flush=True)
    torch.cuda.synchronize()
    add(ops.launch_counts())
    print("[examples] launches in phase 3b: " + json.dumps({k: v for k, v in total.items()
                                                            if v}), flush=True)
    return total


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
        if name == "ssd_chunk_scan":  # by route, each launch checked for its kernel
            errs = {n: 0.0 for n in SERVING}

            def note(n, e):
                errs[n] = max(errs[n], e)

            ssd_parity(torch, K, rng, dev, note, distinct)
            out.update({n: (e, len(distinct)) for n, e in errs.items()})
            continue
        for shape in distinct:
            args = main_path_inputs(torch, name, shape, rng, dev)
            label = f"main-path shape {shape}"
            err = max(err, segment_contracts(torch, K, rng, dev, args, label)
                      if name == "segment_reduce" else kernel_vs_plain(torch, K, name, args, label))
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
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    sizes = {
        "masked_stats": lambda sh: sh[0] * sh[1],
        "segment_reduce": lambda sh: (sh[0], sh[1] + sh[2], sh[3]),
        "topk": lambda sh: (sh[0] * sh[1], sh[2]),
        "filter_compact": lambda sh: sh[0] * sh[1] * sh[2],
        "join_probe": lambda sh: (sh[0], sh[1]),
        "ssd_chunk_scan": lambda sh: (sh[0] * sh[1], sh[5]),
    }
    big = {name: max(shapes[name], key=sizes[name]) for name in DATAFRAME}
    args = {name: main_path_inputs(torch, name, big[name], rng, dev) for name in DATAFRAME}
    out = {}
    out["masked_stats"] = stats_timing(torch, K["masked_stats"], args["masked_stats"], flush)

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
    # the sort path at small B: the largest B = 1,000 main-path row count with
    # one sum row (value_counts itself has none)
    narrow = [sh for sh in shapes["segment_reduce"] if sh[3] == 1000]
    check(narrow, "no segment_reduce launch at B = 1,000 on the main path")
    narrow = (max(narrow, key=sizes["segment_reduce"])[0], 1, 1, 1000, ("sum",), (0,))
    out["segment_reduce B=1000 S=1"] = seg_row(
        narrow, main_path_inputs(torch, "segment_reduce", narrow, rng, dev))

    out["topk"] = topk_timing(torch, K["topk"], args["topk"], flush)

    out["filter_compact"] = compact_timing(torch, K["filter_compact"], args["filter_compact"],
                                           flush)

    out["join_probe"] = join_timing(torch, K["join_probe"], args["join_probe"], flush)

    # ssd_chunk_scan: the intra-chunk launch alone (the inter-chunk scan and
    # ssd_recur are kernels of their own, timed below); no library call.
    # Each intra-chunk kernel at the largest shape of its route on the
    # serving path, beside ssd_cells on the same inputs: ssd_wgmma at the
    # 1,024-token prefill's, ssd_short at the one-token-chunk prompt's (which
    # ssd_recur now serves).  The serving path launches ssd_short and
    # ssd_cells no time: the cells row is its time at the one-token-chunk
    # shape
    sc = K["ssd_chunk_scan"]
    for route in ("wgmma", "short"):
        mine = [sh for sh in shapes["ssd_chunk_scan"]
                if sc.ssd_route(getattr(torch, sh[6]), sh[5], sh[4], sh[3]) == route]
        check(mine, f"no ssd_chunk_scan launch on the {route} kernel on the serving path")
        sh = max(mine, key=sizes["ssd_chunk_scan"])
        out[f"ssd_chunk_scan_{route}"] = ssd_timing(
            torch, sc, sh, main_path_inputs(torch, "ssd_chunk_scan", sh, rng, dev), flush)
    short = out["ssd_chunk_scan_short"]
    out["ssd_chunk_scan_cells"] = dict(short, route="cells", ms=short["earlier_ms"])
    out["ssd_chunk_scan_inter"] = scan_timing(torch, sc, shapes["ssd_chunk_scan"], rng, dev,
                                              flush)
    out["ssd_chunk_scan_recur"] = recur_timing(torch, sc, shapes["ssd_chunk_scan"], rng, dev,
                                               flush)
    return out


def scan_work(bt, S, H, Pd, N, L, esize):
    """(bytes, flops) of the inter-chunk pass: y_intra, the chunk states,
    log_a and c read once, y and h_final written once; C h_in (2 S H N P),
    the recurrence (2 nc H N P) and the correction (2 S H P)."""
    nc = S // L
    nbytes = bt * (esize * (2 * S * H * Pd + S * N) + 4 * (nc * H * N * Pd + S * H + H * N * Pd))
    return nbytes, bt * 2 * H * Pd * (S * N + nc * N + S)


def scan_timing(torch, mod, shapes, rng, dev, flush):
    """The inter-chunk scan at the serving path's two prompt shapes (the
    1,024-token prompt's chunks of 128, and the one-token-chunk prompt's,
    which ssd_recur now takes): the wrapper (the decays' torch ops, then one
    ssd_scan launch), its bare C entry on precomputed decays, the plain
    version (a loop over the chunks) and the bound.  → the row of the
    chunks of 128, with the other under ``L1``."""
    rows = {}
    for key, want_l in (("L1", 1), ("chunk128", 128)):
        mine = [sh for sh in shapes if sh[5] == want_l]
        check(mine, f"no ssd_chunk_scan launch at chunk {want_l} on the serving path")
        bt, S, H, Pd, N, L, dtype = max(mine, key=lambda sh: sh[0] * sh[1])
        x, la, b, c = ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, getattr(torch, dtype))
        y_intra, state = mod.ssd_chunk_intra(x, la, b, c, L)
        ecum = mod.chunk_decays(la, S // L)
        y = torch.empty_like(y_intra)
        hf = torch.empty((bt, H, N, Pd), device=dev)
        tin = mod.DTYPES[x.dtype]
        stream = torch.cuda.current_stream().cuda_stream

        cpb = mod.scan_chunks(bt, S // L, H, Pd, L, torch.cuda.get_device_properties(
            dev).multi_processor_count)

        def c_entry():
            check(mod._fns()["scan"](y_intra.data_ptr(), state.data_ptr(), ecum.data_ptr(),
                                     c.data_ptr(), bt, S, H, Pd, N, L, cpb, tin, y.data_ptr(),
                                     hf.data_ptr(), stream) == 0,
                  "ssd_scan C entry point")

        c_entry()
        want = mod.ssd_chunk_inter_plain(y_intra, state, la, c)
        check(torch.equal(hf, want[1]), f"ssd_scan C entry at {[bt, S, H, Pd, N, L]}: h_final "
              "differs from the plain version's")
        check_ssd(torch, (y, hf), want, "ssd_scan C entry at the timing shape")
        rows[key] = dict(
            shape=[bt, S, H, Pd, N, L, dtype],
            ms=timed(torch, lambda: mod.ssd_chunk_inter(y_intra, state, la, c), 10, flush),
            c_entry_ms=timed(torch, c_entry, 10, flush),
            plain_ms=timed(torch, lambda: mod.ssd_chunk_inter_plain(y_intra, state, la, c), 2,
                           flush),
            library_ms=None,
            bound=bound(*scan_work(bt, S, H, Pd, N, L, x.element_size())),
        )
        r = rows[key]
        print(f"[time] inter-chunk scan at {r['shape']}: wrapper {r['ms']} ms, C entry alone "
              f"{r['c_entry_ms']} ms, plain {r['plain_ms']} ms, bound {r['bound'][0]} ms "
              f"({r['bound'][1]})", flush=True)
    return dict(rows["chunk128"], L1=rows["L1"])


def recur_work(bt, S, H, Pd, N, esize):
    """(bytes, flops) of the whole function at one-token chunks: x, log_a,
    b and c read once, y and h_final written once; c·h (2 S H N P), the
    update d h + b xᵀ (3 S H N P), c·b (2 S N) and y's three operations a
    value (3 S H P)."""
    nbytes = bt * (esize * (2 * S * H * Pd + 2 * S * N) + 4 * (S * H + H * N * Pd))
    return nbytes, bt * (5 * S * H * N * Pd + 2 * S * N + 3 * S * H * Pd)


def recur_timing(torch, mod, shapes, rng, dev, flush):
    """ssd_recur at the serving path's one-token-chunk shape: the wrapper
    (the decays' torch ops, then one launch), its bare C entry on
    precomputed decays, the plain version (chunk 1), the bound, and the
    pair ssd_short + ssd_scan on the same inputs (wrappers, and C entries
    alone), the route these prompts took before ssd_recur."""
    mine = [sh for sh in shapes if mod.scan_route(sh[5], sh[4]) == "recur"]
    check(mine, "no ssd_chunk_scan launch on ssd_recur on the serving path")
    bt, S, H, Pd, N, L, dtype = max(mine, key=lambda sh: sh[0] * sh[1])
    x, la, b, c = ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, getattr(torch, dtype))
    ecum = mod.chunk_decays(la, S)
    y = torch.empty_like(x)
    hf = torch.empty((bt, H, N, Pd), device=dev)
    y_intra = torch.empty_like(x)
    state = torch.empty((bt, S, H, N, Pd), device=dev)
    yp, hp = torch.empty_like(x), torch.empty_like(hf)
    tin = mod.DTYPES[x.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fns = mod._fns()

    def c_entry():
        check(fns["recur"](x.data_ptr(), ecum.data_ptr(), b.data_ptr(), c.data_ptr(), bt, S, H,
                           Pd, N, tin, y.data_ptr(), hf.data_ptr(), stream) == 0,
              "ssd_recur C entry point")

    def pair_entries():
        check(fns["short"](x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(), bt, S, H, Pd,
                           N, 1, tin, mod.short_heads(bt, S, H, 1, N, Pd, sms),
                           y_intra.data_ptr(), state.data_ptr(), stream) == 0,
              "ssd_short C entry point")
        check(fns["scan"](y_intra.data_ptr(), state.data_ptr(), ecum.data_ptr(), c.data_ptr(),
                          bt, S, H, Pd, N, 1, mod.scan_chunks(bt, S, H, Pd, 1, sms), tin,
                          yp.data_ptr(), hp.data_ptr(), stream) == 0,
              "ssd_scan C entry point")

    c_entry()
    pair_entries()
    want = mod.ssd_chunk_scan_plain(x, la, b, c, 1)
    for got, label in (((y, hf), "ssd_recur C entry"), ((yp, hp), "ssd_short + ssd_scan")):
        check(torch.equal(got[1], want[1]), f"{label} at {[bt, S, H, Pd, N]}: h_final differs "
              "from the plain version's")
        check_ssd(torch, got, want, f"{label} at the timing shape")
    row = dict(
        shape=[bt, S, H, Pd, N, L, dtype],
        ms=timed(torch, lambda: mod.ssd_chunk_recur(x, la, b, c), 20, flush),
        c_entry_ms=timed(torch, c_entry, 20, flush),
        pair_ms=timed(torch, lambda: mod.ssd_chunk_inter(
            *mod.ssd_chunk_intra(x, la, b, c, 1), la, c), 10, flush),
        pair_c_entries_ms=timed(torch, pair_entries, 10, flush),
        plain_ms=timed(torch, lambda: mod.ssd_chunk_scan_plain(x, la, b, c, 1), 2, flush),
        library_ms=None,
        bound=bound(*recur_work(bt, S, H, Pd, N, x.element_size())),
    )
    print(f"[time] ssd_recur at {row['shape']}: wrapper {row['ms']} ms, C entry alone "
          f"{row['c_entry_ms']} ms; ssd_short + ssd_scan on the same inputs: wrappers "
          f"{row['pair_ms']} ms, C entries alone {row['pair_c_entries_ms']} ms; plain "
          f"{row['plain_ms']} ms, bound {row['bound'][0]} ms ({row['bound'][1]})", flush=True)
    return row


def ssd_timing(torch, mod, shape, args, flush):
    """The intra-chunk launch at ``shape``: the wrapper (on the kernel
    ``ssd_route`` names, ssd_wgmma or ssd_short), ``ssd_cells`` through its
    C entry point on the same inputs (the earlier kernel), the plain version
    and the bound."""
    x, la, b, c, L = args
    bt, S, H, Pd, N = shape[:5]
    route = mod.ssd_route(x.dtype, L, N, Pd)
    check(route != "cells", f"ssd_timing: {shape} is on ssd_cells itself")
    row = dict(
        shape=[bt, S, H, Pd, N, L, str(x.dtype)], route=route,
        ms=timed(torch, lambda: mod.ssd_chunk_intra(x, la, b, c, L), 20, flush),
        plain_ms=timed(torch, lambda: mod.ssd_chunk_intra_plain(x, la, b, c, L), 5, flush),
        library_ms=None,
        bound=bound(*ssd_work(bt, S, H, Pd, N, L, x.element_size()),
                    BF16_OPS_PER_S if x.dtype == torch.bfloat16 else F32_OPS_PER_S),
    )
    y, st = torch.empty_like(x), torch.empty((bt, S // L, H, N, Pd), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def cells():
        err = mod._fns()["cells"](x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
                                  bt, S, H, Pd, N, L, mod.DTYPES[x.dtype], y.data_ptr(),
                                  st.data_ptr(), stream)
        check(err == 0, f"ssd_cells failed with cudaError_t {err}")

    cells()
    check_ssd(torch, (y, st), mod.ssd_chunk_intra_plain(x, la, b, c, L),
              "ssd_cells at the timing shape")
    row["earlier_ms"] = timed(torch, cells, 20, flush)
    print(f"[time] ssd_chunk_scan detail at {row['shape']} ({route}): kernel {row['ms']} ms, "
          f"ssd_cells on the same inputs {row['earlier_ms']} ms, plain "
          f"{row['plain_ms']} ms, bound {row['bound'][0]} ms", flush=True)
    return row


# the device functions of csrc/filter_compact.cu, csrc/masked_stats.cu and
# csrc/topk.cu, for the profiler's split
COMPACT_KERNELS = ("tile_counts", "scatter_tiles")
STATS_KERNELS = ("stats_tiles", "stats_merge")
TOPK_KERNELS = ("topk_spans", "topk_merge")


def kernel_split(torch, fn, names, iters, flush):
    """Device ms a launch of each kernel named in ``names`` takes: the mean
    over the launches torch.profiler recorded in ``iters`` calls of ``fn``,
    each after an L2 flush.  Dividing by the launches recorded, not by
    ``iters``, keeps a trace that drops events from reading short; a trace
    that recorded no launch of a named kernel (one in four runs of
    topk's, on an H100) is taken again, three traces at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        mine = {name: [e for e in dev if name in e.key] for name in names}
        missing = [name for name in names if not sum(e.count for e in mine[name])]
        if not missing:
            break
        print(f"[time] kernel_split: trace {attempt + 1} recorded no launch of {missing}",
              flush=True)
    check(not missing, f"kernel_split: no launch of {missing} in three traces")
    return {name: sum(e.self_device_time_total for e in es) / 1e3 / sum(e.count for e in es)
            for name, es in mine.items()}


def compact_timing(torch, fc, args, flush):
    """filter_compact at the largest main-path shape: the wrapper, its bare C
    entry point on preallocated outputs and scratch (the wrapper's host work
    left out), each of its kernels' device time a call, the plain version,
    ``torch.masked_select`` and the bound (data read and written once, the
    mask read once)."""
    xs, keep, fill = args
    r, n = xs.shape
    size = xs.element_size()
    keep_rows = 1 if keep.dim() == 1 else r
    out = torch.empty_like(xs)
    scratch = torch.empty(fc.scratch_size(keep_rows, n), dtype=torch.int64, device=xs.device)
    totals = scratch[:keep_rows]
    stream = torch.cuda.current_stream().cuda_stream
    bits = fc._fill_bits(fill, xs.dtype, size)

    def c_entry():
        check(fc._fn()(xs.data_ptr(), out.data_ptr(), keep.data_ptr(), keep_rows, r, n, size,
                       bits, scratch.data_ptr(), stream) == 0, "filter_compact C entry point")

    c_entry()
    check_compact(torch, (out, totals.expand(r) if keep_rows == 1 else totals),
                  fc.filter_compact_plain(xs, keep, fill), "C entry point, timing inputs")
    row = dict(
        shape=[r, n, size],
        ms=timed(torch, lambda: fc.filter_compact(xs, keep, fill), 20, flush),
        bare_ms=timed(torch, c_entry, 20, flush),
        split=kernel_split(torch, c_entry, COMPACT_KERNELS, 20, flush),
        plain_ms=timed(torch, lambda: fc.filter_compact_plain(xs, keep, fill), 3, flush),
        library_ms=timed(torch, lambda: torch.masked_select(xs, keep), 20, flush),
        bound=bound(r * n * size * 2 + keep_rows * n, 0),
    )
    print(f"[time] filter_compact detail at {row['shape']}: wrapper {row['ms']} ms, C entry "
          f"alone {row['bare_ms']} ms, device ms a call by kernel {json.dumps(row['split'])}, "
          f"torch.masked_select {row['library_ms']} ms", flush=True)
    return row


def stats_timing(torch, mod, args, flush):
    """masked_stats at the largest main-path shape: the wrapper, its bare C
    entry point on a preallocated buffer (the wrapper's host work left out),
    each of its kernels' device time a call, the plain version, ``var_mean``
    + ``aminmax`` over each row's valid values, and the bound (values and
    mask read once, the rows of five written once)."""
    xs, ms = args
    r, n = xs.shape
    size, head = mod.buffer_rows(r, n)
    buf = torch.empty((size, 5), dtype=torch.float32, device=xs.device)
    stream = torch.cuda.current_stream().cuda_stream

    def c_entry():
        check(mod._fn()(xs.data_ptr(), ms.data_ptr(), r, n, buf.data_ptr() + 20 * head,
                        buf.data_ptr(), stream) == 0, "masked_stats C entry point")

    def lib_stats():
        for i in range(r):
            v = xs[i][ms[i]]
            torch.var_mean(v)
            torch.aminmax(v)

    c_entry()
    check_stats(torch, buf[:r], mod.masked_stats_plain(xs, ms), xs, ms,
                "C entry point, timing inputs")
    row = dict(
        shape=[r, n],
        ms=timed(torch, lambda: mod.masked_stats(xs, ms), 20, flush),
        bare_ms=timed(torch, c_entry, 20, flush),
        split=kernel_split(torch, c_entry, STATS_KERNELS, 20, flush),
        plain_ms=timed(torch, lambda: mod.masked_stats_plain(xs, ms), 3, flush),
        library_ms=timed(torch, lib_stats, 5, flush),
        bound=bound(r * n * 5 + r * 20, 8 * int(ms.sum())),
    )
    print(f"[time] masked_stats detail at {row['shape']}: wrapper {row['ms']} ms, C entry "
          f"alone {row['bare_ms']} ms, device ms a call by kernel {json.dumps(row['split'])}, "
          f"var_mean + aminmax {row['library_ms']} ms", flush=True)
    return row


def topk_timing(torch, mod, args, flush):
    """topk at the largest main-path shape: the wrapper, its bare C entry
    point on a preallocated buffer, each of its kernels' device time a call,
    the plain version, ``torch.topk`` and the bound (the rows read once, k
    values a row written once); then the wrapper and ``torch.topk`` on the
    same rows sorted the worst way for a running threshold (ascending when
    the largest are kept)."""
    xs, k, largest = args
    r, n = xs.shape
    blocks, size = mod.buffer_rows(r, n)
    buf = torch.empty((size, k), dtype=torch.float32, device=xs.device)
    stream = torch.cuda.current_stream().cuda_stream
    sign = 1.0 if largest else -1.0

    def c_entry():
        check(mod._fn()(xs.data_ptr(), r, n, k, blocks, sign, buf.data_ptr() + 4 * r * k,
                        buf.data_ptr(), stream) == 0, "topk C entry point")

    c_entry()
    check_topk(torch, buf[:r], mod.topk_plain(xs, k, largest),
               "C entry point, timing inputs")
    row = dict(
        shape=[r, n, k],
        ms=timed(torch, lambda: mod.topk(xs, k, largest), 20, flush),
        bare_ms=timed(torch, c_entry, 20, flush),
        split=kernel_split(torch, c_entry, TOPK_KERNELS, 20, flush),
        plain_ms=timed(torch, lambda: mod.topk_plain(xs, k, largest), 3, flush),
        library_ms=timed(torch, lambda: torch.topk(xs, k, dim=-1, largest=largest), 20, flush),
        bound=bound(r * n * 4 + r * k * 4, r * n),
    )
    asc = torch.sort(xs, dim=-1, descending=not largest).values
    check_topk(torch, mod.topk(asc, k, largest), mod.topk_plain(asc, k, largest),
               "sorted row, timing shape")
    row["sorted_ms"] = timed(torch, lambda: mod.topk(asc, k, largest), 20, flush)
    row["sorted_library_ms"] = timed(
        torch, lambda: torch.topk(asc, k, dim=-1, largest=largest), 20, flush)
    print(f"[time] topk detail at {row['shape']} ({blocks} blocks a row): wrapper {row['ms']} "
          f"ms, C entry alone {row['bare_ms']} ms, device ms a call by kernel "
          f"{json.dumps(row['split'])}, torch.topk {row['library_ms']} ms", flush=True)
    print(f"[time] topk on a row sorted the worst way (ascending when the largest are kept) "
          f"at {row['shape']}: wrapper {row['sorted_ms']} ms, torch.topk "
          f"{row['sorted_library_ms']} ms", flush=True)
    return row


def join_timing(torch, jp, args, flush):
    """join_probe at the largest main-path shape: the wrapper, its bare C
    entry point on preallocated outputs (the wrapper's host work left out),
    the same left keys against the first 20,000 right keys (staged whole:
    the search never leaves shared memory), the plain version,
    ``torch.searchsorted`` and the bound (the search does ceil(log2(m + 1))
    comparisons a key)."""
    import math

    lk, rk = args
    n, m = lk.shape[0], rk.shape[0]
    size = lk.element_size()
    k = jp.sample_log2(m, size)
    scratch = torch.empty(0 if k == 0 else -(-m >> k) * size, dtype=torch.uint8, device=lk.device)
    pos = torch.empty(n, dtype=torch.int32, device=lk.device)
    hit = torch.empty(n, dtype=torch.bool, device=lk.device)
    stream = torch.cuda.current_stream().cuda_stream
    bare = jp._fns()

    def c_entry():
        check(bare(lk.data_ptr(), n, rk.data_ptr(), m, jp.DTYPES[lk.dtype], k,
                   scratch.data_ptr(), scratch.numel(), pos.data_ptr(), hit.data_ptr(),
                   stream) == 0, "join_probe C entry point")

    want = jp.join_probe_plain(lk, rk)
    c_entry()
    check_join(torch, (pos, hit), want, "C entry point, timing inputs")
    row = dict(
        shape=[n, m, str(lk.dtype)],
        ms=timed(torch, lambda: jp.join_probe(lk, rk), 20, flush),
        bare_ms=timed(torch, c_entry, 20, flush),
        staged_ms=timed(torch, lambda: jp.join_probe(lk, rk[:20_000]), 20, flush),
        plain_ms=timed(torch, lambda: jp.join_probe_plain(lk, rk), 5, flush),
        library_ms=timed(torch, lambda: torch.searchsorted(rk, lk), 20, flush),
        bound=bound(n * (size + 4 + 1) + m * rk.element_size(),
                    n * math.ceil(math.log2(m + 1))),
    )
    print(f"[time] join_probe detail at {row['shape']} (sample step 2^{k}): wrapper {row['ms']} "
          f"ms, C entry alone {row['bare_ms']} ms, against 20,000 right keys staged whole "
          f"{row['staged_ms']} ms, torch.searchsorted {row['library_ms']} ms", flush=True)
    return row


# the attention shape of one training microbatch of smollm_360m at 4,096
# tokens: B 4 x Hq 15 (Hkv 5) x 4,096 x 64, bf16, causal
TRAIN_ATTN = (4, 15, 5, 4096, 4096, 64, "bfloat16", True, None, 0)
# the forward also at qwen3_8b's heads (32 / 8 x 128), one sequence of 4,096
WIDE_ATTN = (1, 32, 8, 4096, 4096, 128, "bfloat16", True, None, 0)
# phase 4e's shape: recurrentgemma_9b's local attention, one sequence of
# 4,096 tokens, 16 q-heads over one kv head of 256, window 2,048
RG_ATTN = (1, 16, 1, 4096, 4096, 256, "bfloat16", True, 2048, 0)
# phase 4f's shape: one microbatch of granite_moe_3b_a800m, 4 x 24 q-heads
# (8 kv heads) x 4,096 x 64, bf16, causal
MOE_ATTN = (4, 24, 8, 4096, 4096, 64, "bfloat16", True, None, 0)


def sdpa_call(torch, fa, q, k, v, causal, window, off):
    """``scaled_dot_product_attention`` of the same function: a boolean
    mask where a window or an offset makes one (the library yardstick)."""
    import torch.nn.functional as F

    if window is None and off == 0:
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    mask = fa._mask(q.shape[2], k.shape[2], causal, window, off, q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def visible_pairs(Sq, Skv, causal, window, q_offset):
    """The (query, key) pairs the mask lets through, per (batch, q-head)."""
    import numpy as np

    p = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(p, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, p - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_work(shape):
    """(bytes, flops) of the three kernels at ``shape``, each input read
    once and each output written once; flops over the visible pairs only:
    forward S and P V (4 D a pair), dQ S, dP and dS K (6 D), dK/dV S, dP,
    Pᵀ dO and dSᵀ Q (8 D)."""
    B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off = shape
    e = 2 if dtype == "bfloat16" else 4
    qn, kn, rows = B * Hq * Sq * D, B * Hkv * Skv * D, B * Hq * Sq
    pairs = B * Hq * visible_pairs(Sq, Skv, causal, window, off)
    return {
        "flash_attention": (e * (2 * qn + 2 * kn) + 4 * rows, 4 * D * pairs),
        "flash_attention_bwd_dq": (e * (3 * qn + 2 * kn) + 4 * qn + 8 * rows, 6 * D * pairs),
        "flash_attention_bwd_dkdv": (e * (2 * qn + 4 * kn) + 8 * rows, 8 * D * pairs),
    }


def forward_timing(torch, rng, dev, shape, flush):
    """The forward (through ``flash_forward``, on the kernel its route
    names), the plain forward and SDPA's forward at ``shape``, in ms, and
    the forward's bound."""
    from repro_torch.kernels import flash_attention as fa

    B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off = shape
    q, k, v, _ = attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype)
    mask = (causal, window, None, off)
    return dict(
        shape=[B, Hq, Hkv, Sq, Skv, D, dtype, "causal" if causal else "full"],
        ms=timed(torch, lambda: fa.flash_forward(q, k, v, *mask), 10, flush),
        plain_ms=timed(torch, lambda: fa.flash_attention_plain(q, k, v, *mask), 3, flush),
        library_ms=timed(torch, lambda: sdpa_call(torch, fa, q, k, v, causal, window, off), 10,
                         flush),
        bound=bound(*attention_work(shape)["flash_attention"], BF16_OPS_PER_S))


def backward_timing(torch, rng, dev, shape, flush, fma=False):
    """dQ and dK/dV (through ``backward_dq`` and ``backward_dkdv``, on the
    kernels their route names), the plain backward and SDPA's backward (all
    three gradients, one backward of a graph kept from one forward) at
    ``shape``, in ms, with each kernel's bound; ``fma`` also times the FMA
    kernels on the same bf16 inputs through their C entry points (the
    wrappers send bf16 at these widths to the tensor cores).  Returns (rows
    by kernel name, the ms printed)."""
    from repro_torch.kernels import flash_attention as fa

    B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off = shape
    q, k, v, g = attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype)
    mask = (causal, window, None, off)
    _, o32, lse = fa.flash_forward(q, k, v, *mask, keep_f32=True)
    _, delta = fa.backward_dq(q, k, v, o32, lse, g, *mask)

    def backward_of(fn):
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = fn(qq, kk, vv)
        return lambda: torch.autograd.grad(out, (qq, kk, vv), g, retain_graph=True)

    ms = {
        "kernel dq": timed(torch, lambda: fa.backward_dq(q, k, v, o32, lse, g, *mask), 10, flush),
        "kernel dkdv": timed(torch, lambda: fa.backward_dkdv(q, k, v, lse, delta, g, *mask),
                             10, flush),
        "plain bwd": timed(torch, backward_of(
            lambda qq, kk, vv: fa.flash_attention_plain(qq, kk, vv, *mask)), 3, flush),
        "sdpa bwd": timed(torch, backward_of(lambda qq, kk, vv: sdpa_call(
            torch, fa, qq, kk, vv, causal, window, off)), 10, flush),
    }
    if fma:
        args = fa._mask_args(q, k, causal, window, None, off)
        out = [torch.empty_like(t) for t in (delta, q, k, v)]
        st = torch.cuda.current_stream().cuda_stream

        def fma_dq():
            err = fa._fns()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
                               g.data_ptr(), lse.data_ptr(), *args, out[0].data_ptr(),
                               out[1].data_ptr(), st)
            check(err == 0, f"the FMA dQ kernel failed with cudaError_t {err}")

        def fma_dkdv():
            err = fa._fns()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                               lse.data_ptr(), delta.data_ptr(), *args, out[2].data_ptr(),
                               out[3].data_ptr(), st)
            check(err == 0, f"the FMA dK/dV kernel failed with cudaError_t {err}")

        ms["fma dq"] = timed(torch, fma_dq, 3, flush)
        ms["fma dkdv"] = timed(torch, fma_dkdv, 3, flush)
    work = attention_work(shape)
    row = dict(shape=[B, Hq, Hkv, Sq, Skv, D, dtype, "causal" if causal else "full"],
               plain_ms=ms["plain bwd"], library_ms=ms["sdpa bwd"])
    return {name: dict(row, ms=ms[f"kernel {which}"], bound=bound(*work[name], BF16_OPS_PER_S))
            for name, which in (("flash_attention_bwd_dq", "dq"),
                                ("flash_attention_bwd_dkdv", "dkdv"))}, ms


def attention_timings(torch, rng, dev):
    """The kernels, the plain version and SDPA at the training shape: mean
    of cold-L2 calls.  The forward row serves both ``flash_attention`` and
    ``flash_attention_wgmma``, each backward row its FMA and its tensor-core
    name (bf16 takes the tensor-core kernels); forward and backward also at
    WIDE_ATTN."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off = TRAIN_ATTN
    q, k, v, g = attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype)
    mask = (causal, window, None, off)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)

    def fwd_bwd(fn):
        def run():
            qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
            return torch.autograd.grad(fn(qq, kk, vv), (qq, kk, vv), g)
        return run

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, enable_gqa=True)

    check(fa.forward_route(q.dtype, D) == "wgmma" and fa.backward_route(q.dtype, D) == "wgmma",
          "the training shape is not on the wgmma route")
    fwd = forward_timing(torch, rng, dev, TRAIN_ATTN, flush)
    bwd, ms = backward_timing(torch, rng, dev, TRAIN_ATTN, flush, fma=True)
    ms["kernel fwd"], ms["plain fwd"], ms["sdpa fwd"] = (
        fwd["ms"], fwd["plain_ms"], fwd["library_ms"])
    ms["kernel fwd+bwd"] = timed(torch, fwd_bwd(
        lambda qq, kk, vv: fa.flash_attention(qq, kk, vv, *mask)), 5, flush)
    ms["sdpa fwd+bwd"] = timed(torch, fwd_bwd(sdpa), 10, flush)
    print("[time] attention at the training shape " + json.dumps(TRAIN_ATTN) + ", ms: "
          + json.dumps(ms), flush=True)
    wide, wide_ms = backward_timing(torch, rng, dev, WIDE_ATTN, flush)
    print("[time] attention backward at " + json.dumps(WIDE_ATTN) + ", ms: "
          + json.dumps(wide_ms), flush=True)
    out = {"flash_attention": fwd, "flash_attention_wgmma": fwd,
           "flash_attention D=128": forward_timing(torch, rng, dev, WIDE_ATTN, flush)}
    # phase 4e's shape (D 256): the forward and both backward kernels beside
    # the plain version, SDPA and its backward, and their bounds
    check(fa.forward_route(torch.bfloat16, 256) == "wgmma", "D 256 is not on the wgmma route")
    out["flash_attention D=256"] = forward_timing(torch, rng, dev, RG_ATTN, flush)
    rg, rg_ms = backward_timing(torch, rng, dev, RG_ATTN, flush)
    print("[time] attention at phase 4e's shape " + json.dumps(RG_ATTN) + ", ms: "
          + json.dumps(dict(rg_ms, **{"kernel fwd": out["flash_attention D=256"]["ms"]})),
          flush=True)
    # phase 4f's shape: 24 q-heads over 8 kv heads
    out["flash_attention 24/8 heads"] = forward_timing(torch, rng, dev, MOE_ATTN, flush)
    moe_rows, moe_ms = backward_timing(torch, rng, dev, MOE_ATTN, flush)
    print("[time] attention at phase 4f's shape " + json.dumps(MOE_ATTN) + ", ms: "
          + json.dumps(dict(moe_ms, **{"kernel fwd": out["flash_attention 24/8 heads"]["ms"],
                                       "sdpa fwd": out["flash_attention 24/8 heads"][
                                           "library_ms"]})), flush=True)
    for name in bwd:
        out[name] = out[name + "_wgmma"] = bwd[name]
        out[name + " D=128"] = wide[name]
        out[name + " D=256"] = rg[name]
        out[name + " 24/8 heads"] = moe_rows[name]
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
# The prefill logits, held against the plain SSD's at every position.
# Through all 64 layers of the random-weight model they cannot tell a sound
# SSD from one that rounds its intermediates to bf16: a one-ulp difference
# in a few y entries of one layer grows, layer by layer, about as far as
# that faulty SSD moves them (the distances at 1, 2, 8 and 64 layers are
# printed).  So the logits are held on the model cut to its first layer
# (full width), at both prompt lengths: the largest |err| within two bf16
# ulps of the largest |logit| (LOGITS_TOL), and the distance
# ||logits - plain SSD's|| / ||plain SSD's|| within LOGITS_LINE, a line the
# run itself shows to be sound: the two plain SSDs that differ in rounding
# alone (float64; the time axis summed in reverse) must stay within it and
# both faulty ones (chunk states dropped; bf16 intermediates) must cross
# it.  On an H100 (seed 12) at one layer the sound ones read at most 3.7e-4
# and the kernels 1.9e-4, the faulty ones at least 3.0e-3; at 64 layers the
# bf16 fault read 0.055 beside 0.029-0.045 for the sound ones.  At full
# depth the top token must agree at 1,024 tokens.
LOGITS_DEPTHS = (1, 2, 8)  # the first is held; these and the full depth printed
LOGITS_LINE = 2.0 ** -10
LOGITS_TOL = 2 * BF16_ULP


def rel_dist(torch, a, b) -> float:
    """||a - b|| / ||b|| over every entry, in float64."""
    return float(torch.linalg.vector_norm(a - b, dtype=torch.float64)
                 / torch.linalg.vector_norm(b, dtype=torch.float64))


def profiled(torch, fn, ranges=()):
    """Run ``fn`` under torch.profiler → (wall ms, device kernel ms, device
    copy ms, [(device ms, kernel name)] by time, {range: (host ms, device
    ms of the work launched in it)} for the ``record_function`` ranges
    named in ``ranges``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    dev = [e for e in avg if e.device_type == DeviceType.CUDA]
    copy = sum(e.self_device_time_total for e in dev if e.key.startswith("Mem")) / 1e3
    kern = sorted(((e.self_device_time_total / 1e3, e.key) for e in dev
                   if not e.key.startswith("Mem") and e.key not in ranges), reverse=True)
    spans = {e.key: (e.cpu_time_total / 1e3, e.device_time_total / 1e3) for e in avg
             if e.key in ranges and e.device_type == DeviceType.CPU}
    check(set(spans) == set(ranges), f"profiled: ranges {sorted(set(ranges) - set(spans))} "
          "not in the trace")
    return wall, sum(t for t, _ in kern), copy, kern, spans


def scan_variants(torch, mod):
    """Plain SSDs for the serving checks, by name → (scan, faulty): two
    faulty ones that the checks must catch (the inbound chunk states
    dropped; C·Bᵀ, M and the chunk states rounded to bf16), and two that
    differ from the plain version in rounding alone (the intra-chunk pass in
    float64; in float32 with the chunk's time axis summed in reverse)."""

    def bf16(t):
        return t.to(torch.bfloat16).float()

    def intra(x, log_a, b, c, chunk, dt=torch.float32, rnd=lambda t: t, reverse=False):
        bt, S, H, Pd = x.shape
        N, L = b.shape[-1], int(chunk)
        nc = S // L
        xf = x.to(dt).reshape(bt, nc, L, H, Pd)
        bf, cf = b.to(dt).reshape(bt, nc, L, N), c.to(dt).reshape(bt, nc, L, N)
        cum = log_a.to(dt).reshape(bt, nc, L, H).cumsum(2)
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[..., None]
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        lmask = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
        m = rnd(rnd(torch.einsum("bnik,bnjk->bnij", cf, bf))[..., None] * lmask)
        y = (torch.einsum("bnijh,bnjhp->bnihp", m.flip(3), xf.flip(2)) if reverse
             else torch.einsum("bnijh,bnjhp->bnihp", m, xf))
        bw = bf[:, :, :, None, :] * torch.exp(cum[:, :, -1:, :] - cum)[..., None]
        state = rnd(torch.einsum("bnlhk,bnlhp->bnhkp", bw, xf)).float()
        return mod.ssd_chunk_inter_plain(y.reshape(bt, S, H, Pd).to(x.dtype), state, log_a, c)

    def no_chunk_state(x, log_a, b, c, chunk):
        y, state = mod.ssd_chunk_intra_plain(x, log_a, b, c, chunk)
        return mod.ssd_chunk_inter_plain(y, torch.zeros_like(state), log_a, c)

    return {"bf16 intermediates": (lambda *a: intra(*a, rnd=bf16), True),
            "no chunk state": (no_chunk_state, True),
            "float64 intra-chunk pass": (lambda *a: intra(*a, dt=torch.float64), False),
            "time axis summed in reverse": (lambda *a: intra(*a, reverse=True), False)}


def serving(torch, ops, cfg, dev, record):
    """``cfg`` (mamba2_2p7b) behind an OpportunisticServer on ``dev``;
    returns the launch counts of the requests."""
    import numpy as np

    from repro_torch.models import init_model
    from repro_torch.models.lm import forward, init_cache
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

    mod = ops.KERNELS["ssd_chunk_scan"]
    plain_inter, plain_runs = mod.ssd_chunk_inter_plain, []

    def watched_inter(*args):  # the plain step 2's loop over chunks, on the card
        plain_runs.append(args[0].device.type)
        return plain_inter(*args)

    ops.reset_launch_counts()  # counts start at 0 just before the serving path
    mod.ssd_chunk_inter_plain = watched_inter
    try:
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
    finally:
        mod.ssd_chunk_inter_plain = plain_inter
    launches = ops.launch_counts()
    print("[serve] launches: " + json.dumps(launches))
    check(not plain_runs, f"the served prefills ran the plain inter-chunk scan {plain_runs}")
    check(launches["ssd_chunk_scan"] == 3 * cfg.n_layers,
          f"3 prefills launched ssd_chunk_scan {launches['ssd_chunk_scan']} times, "
          f"not {3 * cfg.n_layers}")
    # the two 1,024-token prefills (chunks of 128) on ssd_wgmma and ssd_scan,
    # the 1,000-token one (one-token chunks) on ssd_recur alone, none on
    # ssd_short or ssd_cells
    for name, want in (("wgmma", 2), ("inter", 2), ("recur", 1), ("short", 0), ("cells", 0)):
        got = launches[f"ssd_chunk_scan_{name}"]
        check(got == want * cfg.n_layers, f"3 prefills launched ssd_chunk_scan_{name} {got} "
              f"times, not {want * cfg.n_layers}")
    check(warm[1].latency_s < cold[1].latency_s, "the warm request was not faster (sim)")
    check(again[1].ops_executed == 0 and again[1].latency_s == 0.0,
          "the resubmission was not a cache hit")
    check(np.array_equal(again[0].tokens, warm[0].tokens), "resubmission tokens differ")
    check(odd[0].tokens.shape == (N_TOKENS,), "one-token-chunk request tokens")

    pre, dec, _ = make_serve_fns(cfg, srv.ctx, capacity=2048)
    warm_t = torch.tensor([warm_p], device=dev)
    recomputed = greedy_generate(cfg, model, pre, dec, warm_t, N_TOKENS)[0].cpu().numpy()
    check(np.array_equal(recomputed, warm[0].tokens), "warm tokens != a cold recompute")

    cold_t, odd_t = torch.tensor([cold_p], device=dev), torch.tensor([odd_p], device=dev)
    plain = mod.ssd_chunk_scan_plain
    variants = scan_variants(torch, mod)

    def logits(backend, prompt_t, depth, scan=plain, inputs=None):
        """prefill logits (float32) at every position of the model cut to its
        first ``depth`` layers, on ``backend``, ``scan`` as the plain SSD;
        ``inputs`` collects each layer's SSD arguments"""
        def hooked(*args):
            if inputs is not None:
                inputs.append(args)
            return scan(*args)

        cut = dataclasses.replace(cfg, n_layers=depth)
        mod.ssd_chunk_scan_plain = hooked
        try:
            with torch.no_grad(), ops.local_backend(backend):
                out, _, _ = forward(model, cut, prompt_t, srv.ctx,
                                    cache=init_cache(cut, 1, 2048, dev),
                                    start_pos=torch.zeros((), dtype=torch.int32, device=dev))
        finally:
            mod.ssd_chunk_scan_plain = plain
        return out[0].float()

    def hold_layers(prompt_t, label):
        """every layer's SSD on the model's own inputs (those of the plain
        prefill) within check_ssd's limits, each faulty plain SSD over them
        at every layer"""
        layers = []
        logits("torch", prompt_t, cfg.n_layers, inputs=layers)
        check(len(layers) == cfg.n_layers, f"{label}: {len(layers)} SSD calls")
        worst, moved = [0.0, 0.0], 0.0  # moved: the largest share of y entries that differ
        for i, args in enumerate(layers):
            want = plain(*args)
            got = mod.ssd_chunk_scan(*args)
            worst = [max(w, r) for w, r in zip(worst, ssd_ratios(torch, got, want))]
            moved = max(moved, float((got[0] != want[0]).float().mean()))
            check(max(worst) <= 1.0, f"ssd_chunk_scan at layer {i} of the {label}: "
                  f"|err| / limit (y, h) {worst}")
            for name, (fn, faulty) in variants.items():
                if faulty:
                    over = max(ssd_ratios(torch, fn(*args), want))
                    check(over > 1.0, f"control, plain SSD with {name}: within check_ssd's "
                          f"limits at layer {i} of the {label} ({over} of the limit)")
        print(f"[serve] {label}: all {cfg.n_layers} layers' SSD on the model's own inputs "
              f"within check_ssd's limits (worst |err| / limit: y {worst[0]}, h {worst[1]}; at "
              f"most {moved} of a layer's y entries differ); both faulty controls over them at "
              f"every layer", flush=True)

    def hold_logits(prompt_t, label):
        """the logits of the kernel and of every plain SSD variant against
        the plain SSD's at LOGITS_DEPTHS; held at the first depth, printed at
        the others → (kernel, plain) last-token logits at full depth"""
        for depth in LOGITS_DEPTHS + (cfg.n_layers,):
            lp = logits("torch", prompt_t, depth)
            lk = logits("cuda", prompt_t, depth)
            check(bool(torch.isfinite(lk).all()), f"{label}, {depth} layers: logits not finite")
            ulps = LOGITS_TOL * float(lp.abs().max())
            dist = {"kernel": rel_dist(torch, lk, lp)}
            for name, (fn, faulty) in variants.items():
                dist[name] = rel_dist(torch, logits("torch", prompt_t, depth, fn), lp)
            err = float((lk - lp).abs().max())
            if depth == LOGITS_DEPTHS[0]:
                check(err <= ulps, f"{label}, {depth} layer: logits max |err| {err} over two "
                      f"bf16 ulps of the largest, {ulps}")
                for name, d in dist.items():
                    faulty = name != "kernel" and variants[name][1]
                    check(d > LOGITS_LINE if faulty else d <= LOGITS_LINE,
                          f"{label}, {depth} layer: logits with {name} at {d} of the plain "
                          f"SSD's, {'within' if faulty else 'over'} the line {LOGITS_LINE}")
            print(f"[serve] {label}, {depth} of {cfg.n_layers} layers: logits max |err| {err} "
                  f"(two bf16 ulps: {ulps}); ||logits - plain SSD's|| / ||plain SSD's||, all "
                  f"positions (line {LOGITS_LINE}"
                  f"{', held' if depth == LOGITS_DEPTHS[0] else ', not held'}): "
                  + json.dumps(dist), flush=True)
        return lk[-1], lp[-1]

    for prompt_t, label in ((odd_t, "1,000-token prefill (ssd_recur)"),
                            (cold_t, "1,024-token prefill (ssd_wgmma)")):
        hold_layers(prompt_t, label)
        lk, lp = hold_logits(prompt_t, label)
    check(int(lk.argmax()) == int(lp.argmax()), "1,024-token prefill: the top token differs "
          "from the plain SSD's")

    # the one-token-chunk rule's cost: both prefills alone, synchronized
    walls = {}
    scans = mod.launches_scan.value
    mod.ssd_chunk_inter_plain = watched_inter
    try:
        for label, prompt_t in (("1024", cold_t), ("1000", odd_t)):
            t0 = time.perf_counter()
            pre(model, prompt_t)
            torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t0) * 1e3
    finally:
        mod.ssd_chunk_inter_plain = plain_inter
    check(not plain_runs and mod.launches_scan.value - scans == cfg.n_layers,
          "the timed 1,024-token prefill did not run the inter-chunk scan kernel once a layer")
    print(f"[serve] prefill wall: 1,024 tokens (chunks of 128) {walls['1024']} ms, 1,000 tokens "
          f"(one-token chunks) {walls['1000']} ms, factor {walls['1000'] / walls['1024']}",
          flush=True)
    # ssd_recur's share of it: the 1,000-token prefill on its route and with
    # scan_route made to answer "pair" (ssd_short, then ssd_scan), in turns
    # (the host's pace drifts between calls far more than 64 launches
    # change it)
    route, odd = mod.scan_route, {"recur": [], "pair": []}
    for kind in ("recur", "pair", "pair", "recur", "recur", "pair"):
        mod.scan_route = route if kind == "recur" else (lambda *args: "pair")
        try:
            t0 = time.perf_counter()
            pre(model, odd_t)
            torch.cuda.synchronize()
        finally:
            mod.scan_route = route
        odd[kind].append((time.perf_counter() - t0) * 1e3)
    print(f"[serve] 1,000-token prefill wall in turns, ms: on ssd_recur {odd['recur']}, with "
          f"ssd_short + ssd_scan forced {odd['pair']}", flush=True)

    # where a request's time goes: a 1,024- and a 1,000-token prefill, then
    # decode steps; the inter-chunk scan's wrapper (the decays' torch ops,
    # then one ssd_scan launch) and ssd_recur's (the same, then one
    # ssd_recur launch) are profiler ranges, read for their host and device
    # time
    inter, recur_fn = mod.ssd_chunk_inter, mod.ssd_chunk_recur

    def traced(name, fn):
        def run(*args):
            with torch.profiler.record_function(name):
                return fn(*args)
        return run

    mod.ssd_chunk_inter = traced("ssd_inter_chunk", inter)
    mod.ssd_chunk_recur = traced("ssd_recur_call", recur_fn)
    try:
        for label, fn, span in (
                ("prefill 1024 tokens", lambda: pre(model, cold_t), "ssd_inter_chunk"),
                ("prefill 1000 tokens", lambda: pre(model, odd_t), "ssd_recur_call"),
                (f"prefill 1024 + {N_TOKENS} decode steps",
                 lambda: greedy_generate(cfg, model, pre, dec, cold_t, N_TOKENS),
                 "ssd_inter_chunk")):
            wall, busy, copy, kern, ranges = profiled(torch, fn, (span,))
            ssd = sum(t for t, k in kern if any(f"ssd_{r}" in k for r in ("cells", "short",
                                                                          "wgmma")))
            scan = sum(t for t, k in kern if "ssd_scan" in k)
            recur = sum(t for t, k in kern if "ssd_recur" in k)
            gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                          "cutlass")))
            host, device = ranges[span]
            print(f"[serve-trace] {label}: wall {wall} ms, device kernels {busy} ms "
                  f"(intra-chunk SSD {ssd} ms, ssd_scan {scan} ms, ssd_recur {recur} ms, GEMMs "
                  f"{gemm} ms, other {busy - ssd - scan - recur - gemm} ms), device copies "
                  f"{copy} ms, device idle {100 * (1 - (busy + copy) / wall)}%; {span} range: "
                  f"host {host} ms, its device work {device} ms; top: "
                  + ", ".join(f"{k[:50]} {t}" for t, k in kern[:4]), flush=True)
    finally:
        mod.ssd_chunk_inter, mod.ssd_chunk_recur = inter, recur_fn
    del srv, model
    gc.collect()  # the server and its engine's closures form a cycle
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 4d: serving granite_moe_3b_a800m and recurrentgemma_9b at full width    #
# --------------------------------------------------------------------------- #

HYBRID_SERVED = ("granite_moe_3b_a800m", "recurrentgemma_9b")
# A serving step's attention is the cached branch, the reference's plain
# path in both packages: no attention kernel may launch while serving.
# The card's moe_ffn on layer 0's own inputs against the same layer in
# float64 on the CPU: within test_smoke_model_forward_vs_reference's bf16
# limit, 2^-5 of the largest |y|, at every token whose experts (its top k,
# and those of them kept at capacity) agree; a token whose top k differs
# must be a near tie, its swapped experts' float64 logits within 2^-7 of the
# token's largest |logit| (the card rounds x and the router's product to
# bf16).  Such a token can move the capacity cut of its experts, so other
# tokens may keep other experts: they are counted, not held.
MOE_TOL, MOE_TIE = 2.0 ** -5, 2.0 ** -7
# RecurrentGemma cut to one pattern group (rglru, rglru, local_attn),
# decoded token by token from position 0 (as the reference's
# test_decode_matches_full_forward does; a prefill of more than one token
# into the ring is not causal in either package, ROADMAP C7) past the
# 2,048-slot local-attention ring by DECODE_STEPS: every position's logits
# within 2^-5 of the largest |logit| of one cache-free forward over the
# whole sequence, which runs the head-dim-256 forward kernel.
DECODE_STEPS, DECODE_TOL = 128, 2.0 ** -5


def moe_layer0(torch, cfg, model, prompt_t, dev):
    """granite's layer-0 moe_ffn on the model's own inputs (captured during a
    prefill) on the card against float64 on the CPU; the assignments dropped
    at capacity counted on the card, by the CPU's dispatch of the card's
    routing, and by the float64 routing."""
    import dataclasses as dc

    from repro_torch.models import SINGLE, blocks, moe
    from repro_torch.serve import make_serve_fns

    seen = []
    ffn = blocks.moe_ffn

    def capture(params, cfg_, x, ctx):
        if not seen:
            seen.append((params, x.detach().clone()))
        return ffn(params, cfg_, x, ctx)

    pre, _, _ = make_serve_fns(cfg, SINGLE, capacity=2048)
    blocks.moe_ffn = capture
    try:
        pre(model, prompt_t)
    finally:
        blocks.moe_ffn = ffn
    params, x = seen[0]
    T, E = x.shape[0] * x.shape[1], cfg.moe.n_experts
    cap = moe.expert_capacity(cfg, T)
    with torch.no_grad():
        y_card, _ = moe.moe_ffn(params, cfg, x, SINGLE)
        _, e_card, _ = moe._route(params, cfg, x.reshape(T, -1), E)
        p64 = {k: v.detach().double().cpu() for k, v in params.items()}
        x64 = x.double().cpu()
        y64, _ = moe.moe_ffn(p64, dc.replace(cfg, dtype="float32"), x64, SINGLE)
        _, e64, _ = moe._route(p64, cfg, x64.reshape(T, -1), E)
        logit64 = x64.reshape(T, -1) @ p64["router"]
    y_card = y_card.double().cpu().reshape(T, -1)
    y64 = y64.reshape(T, -1)
    order, keep, _ = moe._dispatch(e_card, E, cap)
    c_order, c_keep, _ = moe._dispatch(e_card.cpu(), E, cap)
    o64, k64, _ = moe._dispatch(e64, E, cap)

    def kept_sets(e, order, keep):
        flat = torch.zeros(e.numel(), dtype=torch.bool)
        flat[order.cpu()] = keep.cpu()
        return torch.sort(torch.where(flat.view(e.shape), e.cpu(), -1), -1).values

    differ = (torch.sort(e_card.cpu(), -1).values != torch.sort(e64, -1).values).any(-1)
    moved = (kept_sets(e_card, order, keep) != kept_sets(e64, o64, k64)).any(-1) & ~differ
    err = (y_card - y64).abs().max(-1).values
    scale = float(y64.abs().max())
    agree = ~differ & ~moved
    held = float(err[agree].max()) if bool(agree.any()) else 0.0
    check(int(agree.sum()) >= T // 2, f"granite layer 0: only {int(agree.sum())} of {T} tokens "
          "keep the same experts on the card and in float64")
    check(held <= MOE_TOL * scale, f"granite layer-0 moe_ffn on the card vs float64: max |err| "
          f"{held} over {MOE_TOL} of the largest |y| {scale} at tokens whose experts agree")
    gaps = []
    for t in torch.nonzero(differ).flatten().tolist():
        a, b = set(e64[t].tolist()), set(e_card[t].cpu().tolist())
        lost, taken = sorted(a - b), sorted(b - a)
        gap = float(logit64[t, lost].max() - logit64[t, taken].min())
        gaps.append(gap / float(logit64[t].abs().max()))
    check(all(g <= MOE_TIE for g in gaps), f"granite layer 0: a token's experts differ from "
          f"float64's beyond a near tie (gaps / max |logit| {gaps})")
    d_card = set(order[~keep].cpu().tolist())
    d_cpu = set(c_order[~c_keep].tolist())
    d64 = set(o64[~k64].tolist())
    check(d_card == d_cpu, f"granite layer 0: {len(d_card)} assignments dropped on the card, "
          f"{len(d_cpu)} by the CPU's dispatch of the same routing (or other ones)")
    if not bool(differ.any()):
        check(d_card == d64, "granite layer 0: the dropped assignments differ from float64's")
    print(f"[serve-moe] granite layer 0, {T} tokens, capacity {cap}: moe_ffn on the card vs "
          f"float64 on the CPU, max |err| {float(err.max())} at all tokens, {held} at the "
          f"{int(agree.sum())} whose experts agree (limit {MOE_TOL * scale}); "
          f"{int(differ.sum())} tokens take other experts, swap gaps / max |logit| {gaps} "
          f"(limit {MOE_TIE}), {int(moved.sum())} others keep other experts at capacity; "
          f"dropped at capacity: {len(d_card)} on the card, {len(d_cpu)} by "
          f"the CPU's dispatch of the card's routing, {len(d64)} by the float64 routing",
          flush=True)


def decode_vs_forward(torch, ops, cfg, model, dev):
    """RecurrentGemma cut to one pattern group, decoded token by token over
    2,048 + DECODE_STEPS tokens, against one cache-free forward (the D 256
    forward kernel) over the same tokens."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import SINGLE
    from repro_torch.models.lm import forward, init_cache
    from repro_torch.serve import make_serve_fns

    cut = dc.replace(cfg, n_layers=len(cfg.block_pattern))
    S = cut.local_window + DECODE_STEPS
    tokens = torch.as_tensor(np.random.default_rng(SERVE_SEED + 1).integers(0, cfg.vocab, (1, S)),
                             device=dev)
    before = fa.launches_wgmma.value
    with torch.no_grad():
        full, _, _ = forward(model, cut, tokens, SINGLE)
    check(fa.launches_wgmma.value - before == 1,
          "the cut model's cache-free forward did not run the D 256 forward kernel once")
    _, dec, _ = make_serve_fns(cut, SINGLE, capacity=2048)
    steps = []
    t0 = time.perf_counter()
    with torch.no_grad():
        cache = init_cache(cut, 1, 2048, dev)
        for t in range(S):
            last, cache = dec(model, cache, tokens[:, t:t + 1],
                              torch.tensor(t, dtype=torch.int32, device=dev))
            steps.append(last.float())
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    want = full[0].float()
    got = torch.cat(steps, 0)
    check(got.shape[0] == S, f"decode logits cover {got.shape[0]} positions, not {S}")
    err = (got - want).abs().max(-1).values
    scale = float(want.abs().max())
    check(bool(torch.isfinite(got).all()), "decode logits not finite")
    check(float(err.max()) <= DECODE_TOL * scale, f"RecurrentGemma, one group: decode logits "
          f"max |err| {float(err.max())} over {DECODE_TOL} of the largest |logit| {scale}")
    P = cut.local_window
    print(f"[serve-rg] recurrentgemma_9b cut to one group ({cut.block_pattern}): {S} decode "
          f"steps from position 0 ({wall} ms; the ring wraps after {P}) against one cache-free "
          f"forward over {S} tokens (the D 256 forward kernel): max |err| {float(err.max())} "
          f"(first {P} positions {float(err[:P].max())}, after {float(err[P:].max())}; limit "
          f"{DECODE_TOL * scale}); top token equal at "
          f"{float((got.argmax(-1) == want.argmax(-1)).float().mean())} of the positions",
          flush=True)


def serving_hybrid(torch, ops, name, dev):
    """``name`` (granite-MoE or RecurrentGemma) at full width and depth
    behind an OpportunisticServer; returns the launch counts of its
    requests (every attention counter must read 0)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import OpportunisticServer, greedy_generate, make_serve_fns

    cfg = get_config(name)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    params = list(model.parameters())
    print(f"[serve-hybrid] {cfg.name} at full width: {cfg.n_layers} layers "
          f"({cfg.block_pattern}), d_model {cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, {sum(p.numel() for p in params)} parameters, "
          f"{sum(p.numel() * p.element_size() for p in params)} bytes on the card, made in "
          f"{time.perf_counter() - t0} s", flush=True)
    rng = np.random.default_rng(SERVE_SEED)
    cold_p, warm_p = (tuple(int(t) for t in rng.integers(0, cfg.vocab, 1024)) for _ in range(2))
    # RecurrentGemma: a prompt that fills the 2,048-slot local-attention
    # ring, whose decode steps then wrap it
    long_p = (tuple(int(t) for t in rng.integers(0, cfg.vocab, cfg.local_window))
              if cfg.rglru is not None else None)

    def request(srv, label, prompt):
        t0 = time.perf_counter()
        out = srv.request(prompt, n_tokens=N_TOKENS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rec = srv.metrics.interactions[-1]
        print(f"[serve-hybrid] {cfg.name} {label}: {len(prompt)}-token prompt, {N_TOKENS} tokens: "
              f"wall {wall} ms, sim latency {rec.latency_s * 1e3} ms, ops executed "
              f"{rec.ops_executed}", flush=True)
        return out, rec

    def last_logits(srv, prompt):
        return srv.engine.display(srv.anticipate(prompt)).logits

    srv = OpportunisticServer(cfg, model, capacity=2048, device=dev)
    ops.reset_launch_counts()  # counts start at 0 just before the serving path
    cold = request(srv, "cold request", cold_p)
    srv.anticipate(warm_p)
    t0 = time.perf_counter()
    srv.think(10.0)
    torch.cuda.synchronize()
    print(f"[serve-hybrid] {cfg.name} think(10): anticipated 1024-token prefill, wall "
          f"{(time.perf_counter() - t0) * 1e3} ms", flush=True)
    warm = request(srv, "warm request", warm_p)
    again = request(srv, "resubmission", warm_p)
    longer = request(srv, f"{len(long_p)}-token request", long_p) if long_p else None
    launches = ops.launch_counts()
    print(f"[serve-hybrid] {cfg.name} launches: " + json.dumps(launches), flush=True)
    attn = {k: v for k, v in launches.items() if k.startswith("flash_attention")}
    check(not any(attn.values()), f"{cfg.name}: the serving path launched attention kernels "
          f"{attn}; the cached branch is the plain path")
    check(warm[1].latency_s < cold[1].latency_s, f"{cfg.name}: the warm request was not faster "
          "(sim)")
    check(again[1].ops_executed == 0 and again[1].latency_s == 0.0,
          f"{cfg.name}: the resubmission was not a cache hit")
    check(np.array_equal(again[0].tokens, warm[0].tokens), f"{cfg.name}: resubmission tokens")

    pre, dec, _ = make_serve_fns(cfg, srv.ctx, capacity=2048)
    warm_t = torch.tensor([warm_p], device=dev)
    recomputed = greedy_generate(cfg, model, pre, dec, warm_t, N_TOKENS)[0].cpu().numpy()
    check(np.array_equal(recomputed, warm[0].tokens), f"{cfg.name}: warm tokens != a cold "
          "recompute")
    # the same requests in a fresh server: tokens and last logits bit for bit
    fresh = OpportunisticServer(cfg, model, capacity=2048, device=dev)
    served = [("cold", cold_p, cold), ("warm", warm_p, warm)] + (
        [("long", long_p, longer)] if long_p else [])
    for label, prompt, (out, _) in served:
        out2 = fresh.request(prompt, n_tokens=N_TOKENS)
        check(np.array_equal(out2.tokens, out.tokens), f"{cfg.name} {label}: a fresh server "
              "gave other tokens")
        check(torch.equal(last_logits(fresh, prompt), last_logits(srv, prompt)),
              f"{cfg.name} {label}: a fresh server gave other last logits")
    print(f"[serve-hybrid] {cfg.name}: warm tokens equal a cold recompute; a fresh server gave "
          f"the same tokens and last logits bit for bit for {len(served)} requests", flush=True)
    del fresh

    cold_t = torch.tensor([cold_p], device=dev)
    if cfg.moe is not None:
        moe_layer0(torch, cfg, model, cold_t, dev)
    else:
        decode_vs_forward(torch, ops, cfg, model, dev)

    # where a request's time goes: a prefill, then a prefill and decode steps
    runs = [("prefill 1024 tokens", lambda: pre(model, cold_t)),
            (f"prefill 1024 + {N_TOKENS} decode steps",
             lambda: greedy_generate(cfg, model, pre, dec, cold_t, N_TOKENS))]
    if long_p:
        long_t = torch.tensor([long_p], device=dev)
        runs.append((f"prefill {len(long_p)} + {N_TOKENS} decode steps (the ring wraps)",
                     lambda: greedy_generate(cfg, model, pre, dec, long_t, N_TOKENS)))
    for label, fn in runs:
        wall, busy, copy, kern, _ = profiled(torch, fn)
        gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                       "cutlass")))
        attn_k = sum(t for t, k in kern if "attn_" in k)
        print(f"[serve-trace] {cfg.name} {label}: wall {wall} ms, device kernels {busy} ms (GEMMs "
              f"{gemm} ms, attention kernels {attn_k} ms, other {busy - gemm - attn_k} ms), "
              f"device copies {copy} ms, device idle {100 * (1 - (busy + copy) / wall)}%; top: "
              + ", ".join(f"{k[:50]} {t}" for t, k in kern[:5]), flush=True)
    del srv, model
    gc.collect()  # the server and its engine's closures form a cycle
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 4c: training smollm_360m at full width                                 #
# --------------------------------------------------------------------------- #

TRAIN_SEED = 12
TRAIN_STEPS = 4
TRAIN_BATCH, TRAIN_MICRO = 8, 4  # the train_4k shape's global batch 256, cut to one card
CKPT_ROOT = ROOT / ".smoke_ckpt"  # checkpoints of this phase, removed at its end
# predicted launches per step: 32 layers x 2 microbatches x 2 forwards (remat)
# of the forward, and 32 x 2 of each backward kernel, every one of them bf16
# on the tensor-core kernels
PER_STEP = {"flash_attention": 128, "flash_attention_wgmma": 128,
            "flash_attention_bwd_dq": 64, "flash_attention_bwd_dkdv": 64,
            "flash_attention_bwd_dq_wgmma": 64, "flash_attention_bwd_dkdv_wgmma": 64}
# The step with the kernels against the same step with the plain attention
# (one microbatch of 2 x 1,024 tokens, remat off, the seed-12 weights): the
# attention outputs differ by up to a bf16 ulp and each layer moves the next
# one's input.  Sound readings on an H100 (seed 12): loss 3.8e-5 and
# gradient norm 3.9e-5 relative, worst leaf gradient 0.0203 of its largest
# |g|; the limits are 2e-4, 5e-4 and 2^-4.  A plain attention whose backward
# drops one head of each group's dK / dV read 0.93 and must fail the leaf
# limit.
STEP_LOSS_TOL, STEP_GNORM_TOL, STEP_GRAD_TOL = 2e-4, 5e-4, 2.0 ** -4


def leaf_errs(torch, got, want):
    """{leaf: (max |err|, max |want|)} over two gradient trees."""
    from repro_torch.models.base import keystr, tree_flatten

    return {keystr(p): (float((g - w).abs().max()), float(w.abs().max()))
            for (p, g), (_, w) in zip(tree_flatten(got), tree_flatten(want))}


def step_vs_plain(torch, ops, cfg, model, dev):
    """Check 2: one microbatch's loss, gradient norm and gradients with the
    kernels against the plain attention, and the faulty control."""
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import SINGLE
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.trainstep import value_and_grad

    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=1024, batch=2, seed=0), 0),
                      dev)

    def run(backend):
        with ops.local_backend(backend):
            loss, _, grads = value_and_grad(model, cfg, batch, SINGLE, remat=False)
        return float(loss), float(global_norm(grads)), grads

    kl, kn, kg = run("cuda")
    pl, pn, pg = run("torch")
    errs = leaf_errs(torch, kg, pg)
    worst = max(e / max(w, 1e-30) for e, w in errs.values())
    print(f"[train] check 2, 2 x 1,024 tokens, kernels vs plain attention: loss {kl} vs {pl}, "
          f"grad norm {kn} vs {pn}, worst leaf |err| / max |g| {worst}: "
          + json.dumps({k: e / max(w, 1e-30) for k, (e, w) in errs.items()}), flush=True)
    check(math.isfinite(kl) and abs(kl - pl) <= STEP_LOSS_TOL * abs(pl),
          f"training step loss {kl} vs plain {pl}")
    check(math.isfinite(kn) and abs(kn - pn) <= STEP_GNORM_TOL * pn,
          f"training step grad norm {kn} vs plain {pn}")
    check(worst <= STEP_GRAD_TOL, f"training step gradients vs plain: worst {worst}")
    del kg
    controls = attn_controls(torch, fa)
    faulty, _ = controls["dK/dV that skips one head of each group"]
    plain = fa.flash_attention_plain
    fa.flash_attention_plain = faulty
    try:
        _, _, cg = run("torch")
    finally:
        fa.flash_attention_plain = plain
    cworst = max(e / max(w, 1e-30) for e, w in leaf_errs(torch, cg, pg).values())
    check(cworst > STEP_GRAD_TOL, f"control, dK/dV without a head: worst leaf {cworst} is "
          f"within the limit {STEP_GRAD_TOL}, which cannot see it")
    print(f"[train] control, plain attention whose dK/dV drops a head: worst leaf |err| / "
          f"max |g| {cworst}, above the limit {STEP_GRAD_TOL}", flush=True)


def tree_bytes_equal(torch, a, b) -> bool:
    from repro_torch.models.base import tree_flatten

    return all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)))


def training(torch, ops, dev):
    """``smollm_360m`` at full width trained by ``train_loop`` on the card;
    returns the attention kernels' launch counts over the 4-step run."""
    import shutil

    import numpy as np

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.train import train_loop
    from repro_torch.train.trainstep import init_train_state, make_train_step

    cfg = get_config("smollm_360m")
    base = get_shape("train_4k")
    shape = ShapeConfig(base.name, base.kind, base.seq_len, TRAIN_BATCH)
    run = RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full", microbatch=TRAIN_MICRO)
    data = SynthSpec(vocab=cfg.vocab, seq_len=shape.seq_len, batch=TRAIN_BATCH, seed=0)
    tokens = shape.seq_len * TRAIN_BATCH
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir()
    free = shutil.disk_usage(CKPT_ROOT).free
    print(f"[train] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_q_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}; {TRAIN_STEPS} steps of {TRAIN_BATCH} x {shape.seq_len} tokens "
          f"(microbatch {TRAIN_MICRO}, remat full), seed {TRAIN_SEED}; {free} bytes free for "
          "checkpoints", flush=True)
    logs = []
    try:
        # the main path: 4 steps, a checkpoint every 2
        ops.reset_launch_counts()  # counts start at 0 just before the training path
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole = train_loop(cfg, run, data, TRAIN_STEPS, ckpt_dir=str(CKPT_ROOT / "whole"),
                           ckpt_every=2, seed=TRAIN_SEED, log_every=1, log_fn=logs.append,
                           device=dev)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"[train] {TRAIN_STEPS} steps in {wall} s (checkpoints included): step ms "
              + json.dumps([t * 1e3 for t in whole.step_times]) + ", tokens/s "
              + json.dumps([tokens / t for t in whole.step_times]) + ", losses "
              + json.dumps(whole.losses) + ", grad norms " + json.dumps(whole.grad_norms)
              + f", peak device memory {peak} bytes", flush=True)
        check(whole.steps == TRAIN_STEPS and all(math.isfinite(x) for x in
                                                 whole.losses + whole.grad_norms),
              "training: a loss or gradient norm is not finite")
        print("[train] launches in the run: " + json.dumps(
            {k: launches[k] for k in PER_STEP}) + "; per step "
            + json.dumps({k: launches[k] / TRAIN_STEPS for k in PER_STEP}), flush=True)
        for name, n in PER_STEP.items():
            check(launches[name] == n * TRAIN_STEPS,
                  f"{name} launched {launches[name]} times in {TRAIN_STEPS} steps, not "
                  f"{n * TRAIN_STEPS}")

        # check 3: the same step twice from the same state, bit for bit; the
        # second run is profiled
        step_fn, _ = make_train_step(cfg, run)
        batch = to_device(batch_at(data, 0), dev)
        states = []
        for i in range(2):
            model, opt_state = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
            if i == 0:
                model, opt_state, _ = step_fn(model, opt_state, batch)
            else:
                out = {}

                def one_step():
                    out["state"] = step_fn(model, opt_state, batch)

                pwall, busy, copy, kern, _ = profiled(torch, one_step)
                model, opt_state, _ = out["state"]
            states.append(({"params": model.tree(), "opt": opt_state}))
            del model, opt_state
        check(tree_bytes_equal(torch, states[0], states[1]),
              "the same step from the same state gave other params or optimizer state")
        del states
        torch.cuda.empty_cache()
        attn = sum(t for t, k in kern if "attn_" in k)
        gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                       "cutlass")))
        print("[train] check 3: a step repeated from the same state gave params and optimizer "
              "state equal bit for bit", flush=True)
        print(f"[train-trace] one step, profiled: wall {pwall} ms, device kernels {busy} ms "
              f"(attention kernels {attn} ms, GEMMs {gemm} ms, other {busy - attn - gemm} ms), "
              f"device copies {copy} ms, device idle {100 * (1 - (busy + copy) / pwall)}%; top: "
              + ", ".join(f"{k[:50]} {t}" for t, k in kern[:6]), flush=True)

        # check 2: kernels against the plain attention on one microbatch
        model, _ = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
        step_vs_plain(torch, ops, cfg, model, dev)
        del model
        torch.cuda.empty_cache()

        # check 4: a run killed at step 3 resumes and ends where the
        # uninterrupted run ended
        cut = str(CKPT_ROOT / "cut")
        try:
            train_loop(cfg, run, data, TRAIN_STEPS, ckpt_dir=cut, ckpt_every=2,
                       seed=TRAIN_SEED, fail_at_step=3, log_fn=logs.append, device=dev)
            fail("fail_at_step=3 did not stop the run")
        except RuntimeError as exc:
            if str(exc) != "injected node failure at step 3":
                raise
        latest = CheckpointManager(cut).latest_step()
        resumed = train_loop(cfg, run, data, TRAIN_STEPS, ckpt_dir=cut, ckpt_every=2,
                             seed=TRAIN_SEED, log_fn=logs.append, device=dev)
        check(resumed.resumed_from == latest and resumed.steps == TRAIN_STEPS - latest,
              f"the run resumed from {resumed.resumed_from}, not from its newest "
              f"checkpoint {latest}")
        a, b = (CKPT_ROOT / n / f"step_{TRAIN_STEPS:08d}" for n in ("whole", "cut"))
        manifest = json.loads((a / "manifest.json").read_text())
        check(manifest == json.loads((b / "manifest.json").read_text()), "manifests differ")
        for entry in manifest["leaves"]:
            check(np.load(a / entry["file"]).tobytes() == np.load(b / entry["file"]).tobytes(),
                  f"resumed run differs from the uninterrupted one at {entry['key']}")
        print(f"[train] check 4: the injected failure at step 3 raised; the rerun resumed from "
              f"step {latest} and its step-{TRAIN_STEPS} checkpoint ({len(manifest['leaves'])} "
              "leaves: params and optimizer state) equals the uninterrupted run's bit for bit; "
              f"losses {resumed.losses} against {whole.losses[latest:]}", flush=True)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        torch.cuda.empty_cache()
    print("[train] loop log: " + " | ".join(logs), flush=True)
    return {k: launches[k] for k in PER_STEP}


# --------------------------------------------------------------------------- #
# phase 4e: training recurrentgemma_9b at full width, one pattern group        #
# --------------------------------------------------------------------------- #

# The whole model (9.57e9 parameters) needs 153 GB of float32 weights,
# gradients and AdamW moments; one pattern group (rglru, rglru, local_attn)
# with the 256,000-token embedding and head has 2.69e9, 43 GB.  One
# sequence of 4,096 tokens a step (the train_4k shape's global batch 256,
# cut to one card and this state), remat full.
RG_STEPS, RG_BATCH = 4, 1
# predicted launches per step: 1 local_attn layer x 1 microbatch x 2
# forwards (remat) of the forward, 1 of each backward kernel, every one on
# the tensor-core kernels (bf16, D 256)
RG_PER_STEP = {"flash_attention": 2, "flash_attention_wgmma": 2,
               "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkdv": 1,
               "flash_attention_bwd_dq_wgmma": 1, "flash_attention_bwd_dkdv_wgmma": 1}


def training_rg(torch, ops, dev):
    """``recurrentgemma_9b`` cut to one pattern group, trained by
    ``train_loop`` on the card; returns the attention kernels' launch
    counts over the run."""
    import dataclasses as dc

    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_model
    from repro_torch.models.base import tree_flatten
    from repro_torch.train import train_loop
    from repro_torch.train.trainstep import init_train_state, make_train_step

    full = get_config("recurrentgemma_9b")
    cfg = dc.replace(full, n_layers=len(full.block_pattern))
    base = get_shape("train_4k")
    shape = ShapeConfig(base.name, base.kind, base.seq_len, RG_BATCH)
    run = RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full", microbatch=RG_BATCH)
    data = SynthSpec(vocab=cfg.vocab, seq_len=shape.seq_len, batch=RG_BATCH, seed=0)
    check(fa.forward_route(torch.bfloat16, cfg.head_dim) == "wgmma"
          and fa.backward_route(torch.bfloat16, cfg.head_dim) == "wgmma",
          "RecurrentGemma's head dim is not on the tensor-core route")
    print(f"[train-rg] {cfg.name} cut to {cfg.n_layers} layers ({cfg.block_pattern}) at full "
          f"width: d_model {cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, lru width {cfg.rglru.lru_width}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_count()} parameters; {RG_STEPS} steps of {RG_BATCH} x {shape.seq_len} "
          f"tokens (microbatch {RG_BATCH}, remat full), seed {TRAIN_SEED}", flush=True)
    logs = []
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train-rg] {torch.cuda.memory_allocated()} bytes held on the card before the run",
          flush=True)
    ops.reset_launch_counts()  # counts start at 0 just before the training path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole = train_loop(cfg, run, data, RG_STEPS, seed=TRAIN_SEED, log_every=1,
                       log_fn=logs.append, device=dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = shape.seq_len * RG_BATCH
    print(f"[train-rg] {RG_STEPS} steps in {wall} s: step ms "
          + json.dumps([t * 1e3 for t in whole.step_times]) + ", tokens/s "
          + json.dumps([tokens / t for t in whole.step_times]) + ", losses "
          + json.dumps(whole.losses) + ", grad norms " + json.dumps(whole.grad_norms)
          + f", peak device memory {peak} bytes", flush=True)
    check(whole.steps == RG_STEPS and all(math.isfinite(x) for x in
                                          whole.losses + whole.grad_norms),
          "RecurrentGemma training: a loss or gradient norm is not finite")
    print("[train-rg] launches in the run: " + json.dumps(
        {k: launches[k] for k in RG_PER_STEP}), flush=True)
    for name, n in RG_PER_STEP.items():
        check(launches[name] == n * RG_STEPS, f"RecurrentGemma training: {name} launched "
              f"{launches[name]} times in {RG_STEPS} steps, not {n * RG_STEPS}")
    torch.cuda.empty_cache()

    # the same step twice from the same state, bit for bit: the first
    # state waits on the host (two do not fit on the card beside a step)
    gc.collect()
    step_fn, _ = make_train_step(cfg, run)
    batch = to_device(batch_at(data, 0), dev)
    kept = None
    for i in range(2):
        model, opt_state = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
        if i == 0:
            model, opt_state, m0 = step_fn(model, opt_state, batch)
            kept = [t.detach().cpu() for _, t in tree_flatten({"params": model.tree(),
                                                               "opt": opt_state})]
        else:
            out = {}

            def one_step():
                out["state"] = step_fn(model, opt_state, batch)

            pwall, busy, copy, kern, _ = profiled(torch, one_step)
            model, opt_state, m1 = out["state"]
            leaves = [t for _, t in tree_flatten({"params": model.tree(), "opt": opt_state})]
            check(len(leaves) == len(kept) and all(
                torch.equal(a.detach().cpu(), b) for a, b in zip(leaves, kept)),
                "RecurrentGemma: the same step from the same state gave other params or "
                "optimizer state")
            check(float(m0["loss"]) == float(m1["loss"]), "RecurrentGemma: repeated step loss")
        del model, opt_state
    del kept
    torch.cuda.empty_cache()
    attn = sum(t for t, k in kern if "attn_" in k)
    gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                   "cutlass")))
    print("[train-rg] a step repeated from the same state gave params and optimizer state "
          "equal bit for bit", flush=True)
    print(f"[train-rg-trace] one step, profiled: wall {pwall} ms, device kernels {busy} ms "
          f"(attention kernels {attn} ms, GEMMs {gemm} ms, other {busy - attn - gemm} ms), "
          f"device copies {copy} ms, device idle {100 * (1 - (busy + copy) / pwall)}%; top: "
          + ", ".join(f"{k[:50]} {t}" for t, k in kern[:8]), flush=True)

    # kernels against the plain attention on one microbatch
    model = init_model(cfg, seed=TRAIN_SEED, device=dev, trainable=True)
    step_vs_plain(torch, ops, cfg, model, dev)
    del model
    torch.cuda.empty_cache()
    print("[train-rg] loop log: " + " | ".join(logs), flush=True)
    return {k: launches[k] for k in RG_PER_STEP}


# --------------------------------------------------------------------------- #
# phase 4f: granite-MoE trained at full width through the train launcher      #
# --------------------------------------------------------------------------- #

# granite_moe_3b_a800m at full width and depth (32 layers, d_model 1536, 24 /
# 8 heads x 64, 40 experts top 8, d_ff_expert 512, vocab 49,155): 3.37e9
# parameters, 54 GB of float32 weights, gradients and AdamW moments; phase
# 4c's shape (4 steps of 8 x 4,096 tokens, microbatch 4, remat full), so the
# attention launches a step are PER_STEP's (32 layers x 2 microbatches).
MOE_SEQ = 4096
MOE_FLAGS = ["--arch", "granite_moe_3b_a800m", "--full-config", "--steps", str(TRAIN_STEPS),
             "--batch", str(TRAIN_BATCH), "--seq", str(MOE_SEQ), "--microbatch",
             str(TRAIN_MICRO), "--remat", "full", "--seed", str(TRAIN_SEED)]
MOE_CUT = 2  # the interrupted run fails at step 2 and resumes from its step-2 checkpoint
# The peak, predicted before the first run on the card: weights, both
# moments and the accumulated gradients (4 x 13.5 GB), a second gradient
# tree while the second microbatch's backward fills it, and the loss head's
# float32 logits of 4 x 4,096 tokens.
MOE_PEAK_PREDICTED = (68e9, 76e9)
MASK64 = (1 << 64) - 1


def fingerprint(torch, tree):
    """{leaf: (the sum of its 32-bit words, the sum of each word times its
    index mod 65,521 plus 1), both mod 2^64}, computed on the card."""
    from repro_torch.models.base import keystr, tree_flatten

    out = {}
    for path, t in tree_flatten(tree):
        words = t.detach().reshape(-1).view(torch.uint8).view(torch.int32)
        s1 = s2 = 0
        for a in range(0, words.numel(), 1 << 26):
            w = words[a:a + (1 << 26)].long()
            pos = torch.arange(a, a + w.numel(), device=w.device) % 65521 + 1
            s1 += int(w.sum())
            s2 += int((w * pos).sum())
        out[keystr(path)] = (s1 & MASK64, s2 & MASK64)
    return out


def moe_step_vs_plain(torch, ops, cfg, model, dev):
    """Check 2 for the MoE model: one microbatch (2 x 1,024 tokens, remat
    off) with the kernels against the plain attention.  A token whose top-k
    set differs between the two runs (a near tie that the attention's
    rounding tips) sends other rows through other experts, so the experts
    such a token chose in either run, in its layer, and the router are
    printed and not held; every other leaf (attention, norms, embeddings, the
    untouched experts' slices) is held to phase 4c's leaf limit.  The
    control whose dK/dV drops a head must cross it."""
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import SINGLE, moe
    from repro_torch.models.base import keystr, tree_flatten
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.trainstep import value_and_grad

    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=1024, batch=2, seed=0), 0),
                      dev)
    route = moe._route

    def run(backend):
        routes = []

        def recording(params, cfg_, xf, e_pad):
            out = route(params, cfg_, xf, e_pad)
            routes.append(torch.sort(out[1], dim=-1).values)
            return out

        moe._route = recording
        try:
            with ops.local_backend(backend):
                loss, _, grads = value_and_grad(model, cfg, batch, SINGLE, remat=False)
        finally:
            moe._route = route
        return float(loss), float(global_norm(grads)), grads, routes

    def held_and_shown(got, got_routes, want, want_routes):
        """({leaf: worst |err| / max |g|} held, the same shown, tokens
        moved per layer, (layer, expert) slices untouched)."""
        moved, touched = [], []
        for a, b in zip(got_routes, want_routes):
            m = (a != b).any(-1)
            moved.append(int(m.sum()))
            t = torch.zeros(cfg.moe.n_experts, dtype=torch.bool, device=dev)
            t[torch.cat([a[m], b[m]]).reshape(-1)] = True
            touched.append(t)
        touched = torch.stack(touched)  # (layers, experts)
        held, shown = {}, {}
        for (path, g), (_, w) in zip(tree_flatten(got), tree_flatten(want)):
            key = keystr(path)
            if "moe" in path and path[-1] == "router":
                shown[key] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            elif "moe" in path:
                dims = tuple(range(2, g.dim()))
                err, big = (g - w).abs().amax(dim=dims), w.abs().amax(dim=dims)
                for mask, into, label in ((~touched, held, "untouched"),
                                          (touched, shown, "touched")):
                    if bool(mask.any()):
                        into[f"{key} {label}"] = float(err[mask].max()) / max(
                            float(big[mask].max()), 1e-30)
            else:
                held[key] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        return held, shown, moved, int((~touched).sum())

    kl, kn, kg, kr = run("cuda")
    pl, pn, pg, pr = run("torch")
    held, shown, moved, untouched = held_and_shown(kg, kr, pg, pr)
    del kg
    worst = max(held.values())
    print(f"[train-moe] check 2, 2 x 1,024 tokens, kernels vs plain attention: loss {kl} vs "
          f"{pl}, grad norm {kn} vs {pn}; tokens whose top-k set differs, per layer "
          f"{json.dumps(moved)} ({sum(moved)} of {len(moved) * 2048}); expert slices no such "
          f"token reaches: {untouched} of {len(moved) * cfg.moe.n_experts}; held leaves, "
          f"worst |err| / max |g| {worst}: {json.dumps(held)}; not held: {json.dumps(shown)}",
          flush=True)
    check(math.isfinite(kl) and math.isfinite(kn), "MoE training step: loss or norm not finite")
    check(worst <= STEP_GRAD_TOL, f"MoE training step gradients vs plain: worst held {worst}")
    controls = attn_controls(torch, fa)
    faulty, _ = controls["dK/dV that skips one head of each group"]
    plain = fa.flash_attention_plain
    fa.flash_attention_plain = faulty
    try:
        _, _, cg, cr = run("torch")
    finally:
        fa.flash_attention_plain = plain
    cheld, _, cmoved, _ = held_and_shown(cg, cr, pg, pr)
    cworst = max(cheld.values())
    check(cworst > STEP_GRAD_TOL, f"MoE control, dK/dV without a head: worst held leaf "
          f"{cworst} is within the limit {STEP_GRAD_TOL}, which cannot see it")
    print(f"[train-moe] control, plain attention whose dK/dV drops a head: worst held leaf "
          f"|err| / max |g| {cworst}, above the limit {STEP_GRAD_TOL} (tokens moved "
          f"{sum(cmoved)})", flush=True)


def training_moe(torch, ops, dev):
    """``granite_moe_3b_a800m`` at full width trained through
    ``repro_torch.launch.train.main``; returns the attention kernels'
    launch counts over the main run."""
    import shutil

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_model, moe
    from repro_torch.models.base import tree_flatten
    from repro_torch.train import loop
    from repro_torch.train.trainstep import init_train_state, make_train_step

    cfg = get_config("granite_moe_3b_a800m")
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir()
    free = shutil.disk_usage(CKPT_ROOT).free
    state_bytes = 12 * cfg.param_count()  # weights and both moments, float32
    check(free > state_bytes * 1.1, f"{free} bytes free for a {state_bytes}-byte checkpoint")
    cap = moe.expert_capacity(cfg, TRAIN_MICRO * MOE_SEQ)
    print(f"[train-moe] {cfg.name} at full width and depth: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, "
          f"{cfg.moe.n_experts} experts top {cfg.moe.top_k}, d_ff_expert "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}, {cfg.param_count()} parameters; launcher "
          f"flags {' '.join(MOE_FLAGS)}; capacity {cap} a microbatch; predicted peak "
          f"{MOE_PEAK_PREDICTED[0]}-{MOE_PEAK_PREDICTED[1]} bytes; {free} bytes free for the "
          f"step-{MOE_CUT} checkpoint; {torch.cuda.memory_allocated()} bytes held on the card "
          "before the run", flush=True)

    # the final checkpoint of a run is replaced by the fingerprint of its
    # state: two 40 GB checkpoints do not fit the disk beside each other
    prints = {}

    class FingerprintAtEnd(CheckpointManager):
        def save(self, step, tree):
            if step == TRAIN_STEPS:
                prints[self.dir] = fingerprint(torch, tree)
                return None
            return super().save(step, tree)

    dispatch, drops = moe._dispatch, []

    def counting(top_e, e_count, capacity):
        order, keep, slot = dispatch(top_e, e_count, capacity)
        drops.append((~keep).sum())
        return order, keep, slot

    manager = loop.CheckpointManager
    loop.CheckpointManager = FingerprintAtEnd
    try:
        # the main path: 4 steps through the launcher
        whole_dir, cut_dir = str(CKPT_ROOT / "whole"), str(CKPT_ROOT / "cut")
        moe._dispatch = counting
        ops.reset_launch_counts()  # counts start at 0 just before the training path
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            whole, log = quiet(launch_train.main, MOE_FLAGS + ["--ckpt-dir", whole_dir])
        finally:
            moe._dispatch = dispatch
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        tokens = TRAIN_BATCH * MOE_SEQ
        dropped = [int(d) for d in drops]
        print(f"[train-moe] {TRAIN_STEPS} steps in {wall} s (the end state's fingerprint "
              "included): step ms " + json.dumps([t * 1e3 for t in whole.step_times])
              + ", tokens/s " + json.dumps([tokens / t for t in whole.step_times])
              + ", losses " + json.dumps(whole.losses) + ", grad norms "
              + json.dumps(whole.grad_norms) + f", peak device memory {peak} bytes (predicted "
              f"{MOE_PEAK_PREDICTED[0]}-{MOE_PEAK_PREDICTED[1]}); launcher output: "
              + " | ".join(log.strip().splitlines()), flush=True)
        check(whole.steps == TRAIN_STEPS and all(math.isfinite(x) for x in
                                                 whole.losses + whole.grad_norms),
              "MoE training: a loss or gradient norm is not finite")
        check(peak < torch.cuda.get_device_properties(0).total_memory,
              f"MoE training peak {peak} bytes")
        print(f"[train-moe] assignments dropped at capacity ({cap} a expert): "
              f"{sum(dropped)} over {len(dropped)} layer forwards (remat runs each twice) of "
              f"{TRAIN_MICRO * MOE_SEQ * cfg.moe.top_k} assignments, "
              f"{sum(dropped) / len(dropped)} a forward; per forward of the first "
              f"microbatch's layers: " + json.dumps(dropped[:cfg.n_layers]), flush=True)
        print("[train-moe] launches in the run: " + json.dumps(
            {k: launches[k] for k in PER_STEP}), flush=True)
        for name, n in PER_STEP.items():
            check(launches[name] == n * TRAIN_STEPS, f"MoE training: {name} launched "
                  f"{launches[name]} times in {TRAIN_STEPS} steps, not {n * TRAIN_STEPS}")
        gc.collect()
        torch.cuda.empty_cache()

        # a run killed at step 2 resumes from its step-2 checkpoint and ends
        # where the uninterrupted run ended
        t0 = time.perf_counter()
        try:
            quiet(launch_train.main, MOE_FLAGS + ["--ckpt-dir", cut_dir, "--fail-at-step",
                                                  str(MOE_CUT)])
            fail(f"--fail-at-step {MOE_CUT} did not stop the run")
        except RuntimeError as exc:
            if str(exc) != f"injected node failure at step {MOE_CUT}":
                raise
        latest = CheckpointManager(cut_dir).latest_step()
        gc.collect()
        torch.cuda.empty_cache()
        resumed, _ = quiet(launch_train.main, MOE_FLAGS + ["--ckpt-dir", cut_dir])
        check(latest == MOE_CUT and resumed.resumed_from == MOE_CUT
              and resumed.steps == TRAIN_STEPS - MOE_CUT,
              f"the run resumed from {resumed.resumed_from}, not from step {MOE_CUT}")
        check(resumed.losses == whole.losses[MOE_CUT:], f"resumed losses {resumed.losses} != "
              f"{whole.losses[MOE_CUT:]}")
        check(prints[cut_dir] == prints[whole_dir], "the resumed run's end state differs "
              "from the uninterrupted one's: " + json.dumps(
                  [k for k in prints[whole_dir] if prints[cut_dir][k] != prints[whole_dir][k]]))
        print(f"[train-moe] the injected failure at step {MOE_CUT} raised and left its "
              f"step-{MOE_CUT} checkpoint; the rerun resumed from it, its losses "
              f"{resumed.losses} equal the uninterrupted run's bit for bit, and its end state "
              f"has the uninterrupted one's fingerprint in all {len(prints[whole_dir])} leaves "
              f"({time.perf_counter() - t0} s with the checkpoint)", flush=True)
    finally:
        loop.CheckpointManager = manager
        moe._dispatch = dispatch
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the same step twice from the same state, bit for bit (the first state
    # waits on the host); the second step profiled, the MoE layer's parts as
    # profiler ranges (their forward and remat passes: the backward runs
    # outside them)
    shape = ShapeConfig("cli", "train", seq_len=MOE_SEQ, global_batch=TRAIN_BATCH)
    run = RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full", microbatch=TRAIN_MICRO)
    step_fn, _ = make_train_step(cfg, run)
    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=MOE_SEQ, batch=TRAIN_BATCH,
                                         seed=TRAIN_SEED), 0), dev)
    ranges = {"moe routing": "_route", "moe grouping, experts, combine": "_group_and_compute"}
    originals = {name: getattr(moe, name) for name in ranges.values()}

    def in_range(label, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    kept = None
    for i in range(2):
        model, opt_state = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
        if i == 0:
            model, opt_state, m0 = step_fn(model, opt_state, batch)
            kept = [t.detach().cpu() for _, t in tree_flatten({"params": model.tree(),
                                                               "opt": opt_state})]
        else:
            out = {}

            def one_step():
                out["state"] = step_fn(model, opt_state, batch)

            for label, name in ranges.items():
                setattr(moe, name, in_range(label, originals[name]))
            try:
                pwall, busy, copy, kern, spans = profiled(torch, one_step, tuple(ranges))
            finally:
                for name, fn in originals.items():
                    setattr(moe, name, fn)
            model, opt_state, m1 = out.pop("state")
            leaves = [t for _, t in tree_flatten({"params": model.tree(), "opt": opt_state})]
            check(len(leaves) == len(kept) and all(
                torch.equal(a.detach().cpu(), b) for a, b in zip(leaves, kept)),
                "granite-MoE: the same step from the same state gave other params or "
                "optimizer state")
            check(float(m0["loss"]) == float(m1["loss"]), "granite-MoE: repeated step loss")
            del leaves
        del model, opt_state
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    attn = sum(t for t, k in kern if "attn_" in k)
    gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                   "cutlass")))
    moved = sum(t for t, k in kern if "attn_" not in k and any(
        w in k.lower() for w in ("sort", "scatter", "gather", "index", "radix", "scan")))
    print(f"[train-moe] a step repeated from the same state gave params, AdamW moments and "
          f"loss ({float(m1['loss'])}) equal bit for bit", flush=True)
    print(f"[train-moe-trace] one step, profiled: wall {pwall} ms, device kernels {busy} ms "
          f"(attention kernels {attn} ms, GEMMs {gemm} ms, sort / gather / scatter / index "
          f"kernels (MoE routing, grouping, combine and their backward) {moved} ms, other "
          f"{busy - attn - gemm - moved} ms), device copies {copy} ms, device idle "
          f"{100 * (1 - (busy + copy) / pwall)}%; forward and remat passes of the MoE layer "
          "(host ms, device ms): " + json.dumps(spans) + "; top: "
          + ", ".join(f"{k[:50]} {t}" for t, k in kern[:10]), flush=True)

    # check 2: the kernels against the plain attention on one microbatch
    model = init_model(cfg, seed=TRAIN_SEED, device=dev, trainable=True)
    moe_step_vs_plain(torch, ops, cfg, model, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in PER_STEP}


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
    K = {name: mod for name, mod in ops.KERNELS.items() if name not in TRAINING}

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
    if "flash_attention" in _build.LOGS:
        # registers and spills of the attention kernels (ptxas -v); a kernel
        # with a producer warpgroup reports its launch bound's 168, and its
        # consumers raise theirs to 232 (setmaxnreg)
        print("[build] ptxas, attention kernels (registers, spill stores / loads in bytes): "
              + "; ".join(f"{n} {r}, {st}/{ld}" for n, r, st, ld in
                          ptxas_report(_build.LOGS["flash_attention"])), flush=True)
    print(f"[card] {smi}", flush=True)

    # -- phase 2: parity on the card
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    errs = parity(torch, K, rng, dev)
    fused_parity(torch, ops, rng, dev)
    errs.update(attention_parity(torch, rng, dev))
    attention_in_new_thread(torch, rng, dev)
    torch.cuda.synchronize()
    print(f"[parity] kernel vs plain passed for all {len(errs)} kernels in "
          f"{time.perf_counter() - t0} s; max |err|: " + json.dumps(errs), flush=True)

    # -- phase 3: main path
    shapes, record = recorder(K)
    t0 = time.perf_counter()
    ref, launches, _ = main_path(torch, ops, BK, K, record)
    print(f"[main] phase took {time.perf_counter() - t0} s", flush=True)

    trace_notebook(torch)

    # -- phase 3b: the examples and the serve launcher
    t0 = time.perf_counter()
    for kernel, n in examples_on_card(torch, ops, BK).items():
        launches[kernel] += n
    print(f"[examples] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4: real mode
    real_mode(torch, ref)

    # -- phase 4b: serving
    t0 = time.perf_counter()
    from repro_torch.configs import get_config

    served = serving(torch, ops, get_config("mamba2_2p7b"), dev, record)
    launches.update({name: served[name] for name in SERVING})
    print(f"[serve] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4c: training
    t0 = time.perf_counter()
    for kernel, n in training(torch, ops, dev).items():
        launches[kernel] += n
    print(f"[train] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4d: serving granite-MoE and RecurrentGemma (no attention kernel
    # launches on a cached serving path: the counters must stay at 0)
    for name in HYBRID_SERVED:
        t0 = time.perf_counter()
        served = serving_hybrid(torch, ops, name, dev)
        for kernel in TRAINING:
            launches[kernel] += served[kernel]
        print(f"[serve-hybrid] {name} phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4e: training RecurrentGemma, one pattern group
    t0 = time.perf_counter()
    for kernel, n in training_rg(torch, ops, dev).items():
        launches[kernel] += n
    print(f"[train-rg] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4f: training granite-MoE through the train launcher; the
    # attention launches on the JSON line are those of 3b, 4c, 4e and 4f
    t0 = time.perf_counter()
    for kernel, n in training_moe(torch, ops, dev).items():
        launches[kernel] += n
    print(f"[train-moe] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 5: kernel vs plain, then timing, at the main path's shapes
    t0 = time.perf_counter()
    mp = main_path_parity(torch, K, shapes, rng, dev)
    for name in mp:
        errs[name] = max(errs[name], mp[name][0])
    train_shapes = (TRAIN_ATTN, (2, 15, 5, 1024, 1024, 64, "bfloat16", True, None, 0), RG_ATTN,
                    (2, 16, 1, 1024, 1024, 256, "bfloat16", True, 2048, 0), MOE_ATTN,
                    (2, 24, 8, 1024, 1024, 64, "bfloat16", True, None, 0))
    for name, e in attention_parity(torch, rng, dev, train_shapes, "training").items():
        errs[name] = max(errs[name], e)
    print(f"[shapes] kernel vs plain passed at every main-path shape in "
          f"{time.perf_counter() - t0} s: "
          + json.dumps({name: {"shapes": n, "max_abs_err": e} for name, (e, n) in mp.items()}),
          flush=True)
    tm = timings(torch, K, shapes, rng, dev)
    tm.update(attention_timings(torch, rng, dev))
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
        for name in DATAFRAME + SERVING + TRAINING
    ]
    print(f"{smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
