"""Dispatch entry points of the kernels: the frame operators', the Mamba-2
SSD scan (``ssd_scan``) and attention (``attention``).

Backend selection:
  * ``"cuda"``  — the hand-written CUDA kernels (``csrc/*.cu``); on a CPU
                  tensor a kernel wrapper runs its plain version instead,
  * ``"torch"`` — the plain PyTorch versions, on whatever device the inputs
                  lie on.

Default: ``"cuda"`` when a CUDA device is present, else ``"torch"``.  The
frame layer picks the backend per dispatch with the thread-local
:func:`local_backend`: its real-mode background worker dispatches
concurrently with foreground interactions.

Every entry point takes and returns torch tensors on one device and never
moves data between host and device itself; the frame backend does that.

Under ``launch.roofline.count()``, :func:`attention` and :func:`ssd_scan`
charge their kernels' work formulas once a call and count nothing inside,
whichever route runs them; their backward charges its kernels' (attention's
two: ``flash_attention.FlashAttention.backward`` on the card,
:class:`_CountedAttention` on the plain route; the SSD's three:
``ssd_chunk.SSDChunkScan.backward`` and :class:`_CountedSSD`).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch

from . import filter_compact as _fc
from . import flash_attention as _fa
from . import join_probe as _jp
from . import masked_stats as _ms
from . import segment_reduce as _sr
from . import ssd_chunk as _ssd
from . import topk as _tk
from ..launch import roofline as _rl

_TLS = threading.local()  # per-thread override (scoped, race-free)

KERNELS = {
    "masked_stats": _ms,
    "segment_reduce": _sr,
    "topk": _tk,
    "filter_compact": _fc,
    "join_probe": _jp,
    "ssd_chunk_scan": _ssd,
    "flash_attention": _fa,
}
# launch counters by kernel: one per module, attention's two backward kernels
# and the SSD's three, the attention and SSD launches that took the
# tensor-core kernels, and the SSD launches that took each FMA kernel
COUNTERS = {name: mod.launches for name, mod in KERNELS.items()}
COUNTERS.update({"flash_attention_bwd_dq": _fa.launches_dq,
                 "flash_attention_bwd_dkdv": _fa.launches_dkdv,
                 "flash_attention_wgmma": _fa.launches_wgmma,
                 "flash_attention_bwd_dq_wgmma": _fa.launches_dq_wgmma,
                 "flash_attention_bwd_dkdv_wgmma": _fa.launches_dkdv_wgmma,
                 "ssd_chunk_scan_wgmma": _ssd.launches_wgmma,
                 "ssd_chunk_scan_short": _ssd.launches_short,
                 "ssd_chunk_scan_cells": _ssd.launches_cells,
                 "ssd_chunk_scan_inter": _ssd.launches_scan,
                 "ssd_chunk_scan_recur": _ssd.launches_recur,
                 "ssd_chunk_scan_bwd_state": _ssd.launches_bwd_state,
                 "ssd_chunk_scan_bwd_chunk": _ssd.launches_bwd_chunk,
                 "ssd_chunk_scan_bwd_sum": _ssd.launches_bwd_sum,
                 "ssd_chunk_scan_bwd_state_wgmma": _ssd.launches_bwd_state_wgmma,
                 "ssd_chunk_scan_bwd_chunk_wgmma": _ssd.launches_bwd_chunk_wgmma})


@contextmanager
def local_backend(backend: Optional[str]):
    """Thread-local scoped backend override."""
    prev = getattr(_TLS, "forced", None)
    _TLS.forced = backend
    try:
        yield
    finally:
        _TLS.forced = prev


def backend() -> str:
    local = getattr(_TLS, "forced", None)
    if local is not None:
        return local
    return "cuda" if torch.cuda.is_available() else "torch"


def launch_counts() -> dict:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: c.value for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


# -- one call per primitive: the kernel wrapper or the plain version ---------


def _stats_rows(xs, ms):
    if backend() == "cuda":
        return _ms.masked_stats(xs, ms)
    return _ms.masked_stats_plain(xs, ms)


def _segment(keys, values, valids, num_buckets, modes, valid_idx):
    if backend() == "cuda":
        return _sr.segment_reduce(keys, values, valids, num_buckets, modes, valid_idx)
    return _sr.segment_reduce_plain(keys, values, valids, num_buckets, modes, valid_idx)


def _topk_rows(xs, k, largest):
    if backend() == "cuda":
        return _tk.topk(xs, k, largest)
    return _tk.topk_plain(xs, k, largest)


def _compact(xs, keep, fill=0):
    if backend() == "cuda":
        return _fc.filter_compact(xs, keep, fill)
    return _fc.filter_compact_plain(xs, keep, fill)


def _probe(l_keys, r_sorted):
    if backend() == "cuda":
        return _jp.join_probe(l_keys, r_sorted)
    return _jp.join_probe_plain(l_keys, r_sorted)


def _ssd_scan(x, log_a, b, c, chunk):
    if backend() == "cuda":
        return _ssd.ssd_chunk_scan(x, log_a, b, c, chunk)
    return _ssd.ssd_chunk_scan_plain(x, log_a, b, c, chunk)


def _kernel_route(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` launches the CUDA kernels."""
    return backend() == "cuda" and x.device.type == "cuda"


def ssd_scan(x, log_a, bmat, cmat, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba-2 SSD over a batch: x (B, S, H, P), log_a (B, S, H),
    bmat / cmat (B, S, N) → (y (B, S, H, P) in x's type, h_final f32
    (B, H, N, P)), starting from the empty state.  The batch is a grid
    dimension of the kernel (the reference vmaps its per-sequence call);
    ``chunk`` is cut to S and must then divide it, as in the reference.
    Counted: the launches the card makes at this shape (``ssd_recur``
    alone where ``scan_route`` says so, else the intra-chunk kernel and
    ``ssd_scan``), and in the backward the three backward kernels
    (``roofline.ssd_bwd_work``), on every route."""
    chunk = min(int(chunk), x.shape[1])
    if x.shape[1] % chunk:
        raise ValueError(f"ssd_scan: S={x.shape[1]} is not a multiple of chunk={chunk}")
    args = (x.contiguous(), log_a.to(torch.float32).contiguous(),
            bmat.to(x.dtype).contiguous(), cmat.to(x.dtype).contiguous())
    counter = _rl.active()
    if counter is None:
        return _ssd_scan(*args, chunk)
    bt, S, H, Pd = x.shape
    N, e = bmat.shape[-1], x.element_size()
    if _ssd.scan_route(chunk, N) == "recur":
        counter.charge("ssd_chunk_scan_recur", *_rl.recur_work(bt, S, H, Pd, N, e))
    else:
        counter.charge("ssd_chunk_scan", *_rl.ssd_work(bt, S, H, Pd, N, chunk, e))
        counter.charge("ssd_chunk_scan_inter", *_rl.scan_work(bt, S, H, Pd, N, chunk, e))
    if _kernel_route(x):
        with counter.paused():
            return _ssd_scan(*args, chunk)
    return _CountedSSD.apply(*args, chunk)


def attention(q, k, v, causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """GQA attention over q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D) → (B, Hq,
    Sq, D) in q's type.  ``"cuda"``: the flash_attention wrapper (the kernels
    and their backward on CUDA tensors, the plain version on CPU tensors);
    ``"torch"``: the plain version on any device.  Counted: the forward
    kernel's work over the visible pairs."""
    counter = _rl.active()
    if counter is not None:
        shape = _rl.attention_shape(q, k, causal, window, q_offset)
        counter.charge("flash_attention", *_rl.attention_work(shape)["flash_attention"])
        if _kernel_route(q):
            with counter.paused():
                return _fa.flash_attention(q, k, v, causal, window, scale, q_offset)
        return _CountedAttention.apply(q, k, v, causal, window, scale, q_offset)
    if backend() == "cuda":
        return _fa.flash_attention(q, k, v, causal, window, scale, q_offset)
    return _fa.flash_attention_plain(q, k, v, causal, window, scale, q_offset)


class _CountedAttention(torch.autograd.Function):
    """The plain attention while a counter runs: the forward uncounted (its
    work is charged by :func:`attention`), the backward charged as the
    card's dQ and dK/dV kernels and run uncounted (the plain version's
    gradient, recomputed from q, k and v).  On ``meta`` tensors, which hold
    no values, neither runs: the outputs are empty tensors of their shapes.
    Outputs and gradients are contiguous, as the kernels write them, so
    what autograd does with them counts the same on every route."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        ctx.mask = (causal, window, scale, q_offset)
        ctx.save_for_backward(q, k, v)
        if q.is_meta:
            return torch.empty(q.shape, dtype=q.dtype, device=q.device)
        with _rl.uncounted():
            return _fa.flash_attention_plain(q, k, v, causal, window, scale,
                                             q_offset).contiguous()

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        work = _rl.attention_work(_rl.attention_shape(q, k, ctx.mask[0], ctx.mask[1],
                                                      ctx.mask[3]))
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
            _rl.charge(name, work[name])
        if q.is_meta:
            return (*(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v)),
                    None, None, None, None)
        with _rl.uncounted(), torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = _fa.flash_attention_plain(*leaves, *ctx.mask)
            grads = [g.contiguous() for g in torch.autograd.grad(out, leaves, do)]
        return (*grads, None, None, None, None)


class _CountedSSD(torch.autograd.Function):
    """The plain SSD while a counter runs: the forward uncounted (its work is
    charged by :func:`ssd_scan`), the backward charged as the card's three
    backward kernels and run uncounted (the plain version's gradient,
    recomputed from x, log_a, b and c).  On ``meta`` tensors neither runs:
    the outputs are empty tensors of their shapes.  Outputs and gradients
    are contiguous, as the kernels write them."""

    @staticmethod
    def forward(ctx, x, log_a, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, log_a, b, c)
        if x.is_meta:
            bt, _, H, Pd = x.shape
            return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                    torch.empty((bt, H, b.shape[-1], Pd), dtype=torch.float32, device=x.device))
        with _rl.uncounted():
            y, h = _ssd.ssd_chunk_scan_plain(x, log_a, b, c, chunk)
            return y.contiguous(), h.contiguous()

    @staticmethod
    def backward(ctx, dy, dh):
        ins = ctx.saved_tensors
        x, b = ins[0], ins[2]
        _ssd.charge_bwd(x, b.shape[-1], ctx.chunk, dh is not None)
        if x.is_meta:
            return (*(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in ins), None)
        with _rl.uncounted(), torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in ins]
            outs = _ssd.ssd_chunk_scan_plain(*leaves, ctx.chunk)
            pairs = [(o, g) for o, g in zip(outs, (dy, dh)) if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs],
                                        allow_unused=True)
            return (*(torch.zeros_like(t) if g is None else g.contiguous()
                      for t, g in zip(ins, grads)), None)


# --------------------------------------------------------------------------- #
# Padded / batched entry points for the frame layer                            #
#                                                                              #
# Row counts round up to power-of-two buckets (``pad_len``): partitions of one #
# bucket batch into one dispatch.  Padding is an exact no-op in every          #
# reduction: masked_stats tiles its rows with a FIXED tile length (``_TILE``), #
# so padding only adds all-masked tiles; segment_reduce drops rows that are    #
# not valid before it sorts, and folds each bucket's run in an order fixed by  #
# the run's length alone.  That makes every result independent of how far      #
# its input was padded — the property the fused filter→reduce composites       #
# rely on for bit-for-bit parity with the unfused sequence (their reduce runs  #
# at the parent partition's length, the unfused one at the filtered length).   #
# --------------------------------------------------------------------------- #

PAD_MIN = 512  # smallest padded length (also amortises tiny partitions)
_TILE = 16384  # masked_stats tile rows (== masked_stats.TILE)


def pad_len(n: int, minimum: int = PAD_MIN) -> int:
    """Next power-of-two bucket ≥ n (≥ minimum) — the shared batch shape."""
    if n <= minimum:
        return minimum
    return 1 << (int(n) - 1).bit_length()


def _pad_last(x: torch.Tensor, nb: int, value) -> torch.Tensor:
    """Pad the last dimension of ``x`` to ``nb`` with ``value``."""
    n = x.shape[-1]
    if nb == n:
        return x
    tail = torch.full((*x.shape[:-1], nb - n), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=-1)


def masked_stats_batch(xs, ms) -> torch.Tensor:
    """Batched fused describe pass: (C, n) values + (C, n) validity → (C, 5)
    rows of (count, sum, m2, min, max), where m2 = Σ m·(x − mean)² is the
    Chan-merged centered second moment.  One dispatch covers every numeric
    column of a partition.  No physical padding is needed: a row shorter
    than a whole number of tiles is read as if masked past its end."""
    return _stats_rows(xs.to(torch.float32).contiguous(), ms.contiguous())


def topk_padded(x, k: int, largest: bool = True) -> torch.Tensor:
    """``topk`` on a shape-bucketed input (pads with the losing sentinel)."""
    nb = pad_len(x.shape[0])
    sentinel = float("-inf") if largest else float("inf")
    xp = _pad_last(x.to(torch.float32), nb, sentinel)
    return _topk_rows(xp[None].contiguous(), k, largest)[0]


def filter_compact_padded(x, keep, fill=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable compaction of any 1/4/8-byte dtype; returns (compacted[n],
    count).  The kernel tiles any length, so nothing is padded."""
    out, cnt = _compact(x[None].contiguous(), keep.contiguous(), fill)
    return out[0], cnt[0]


def argsort_f64(keys) -> torch.Tensor:
    """Stable ascending argsort of float64 keys, bit-for-bit equal to
    ``np.argsort(keys, kind="stable")`` for keys without NaN (callers gate
    NaN out).  Native float64 on the device: the card has f64, so the
    reference's 3×f32 split is not needed."""
    return torch.sort(keys.to(torch.float64), stable=True).indices


def join_probe_padded(r_sorted, l_keys) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe each left key against the ascending, unique right keys: returns
    ``(pos, hit)`` with ``pos`` clipped to ``[0, m-1]``, ready to gather
    right rows, and ``hit`` marking exact matches.  Both sides must share one
    key type (float32, float64, int32 or int64), compared natively.  NaN left
    keys probe as misses.  The kernel takes any length, so the left keys are
    not padded to a shape bucket as the reference pads them for its jit."""
    m = int(r_sorted.shape[0])
    if m == 0:
        raise ValueError("join_probe_padded: empty right side (caller gates)")
    if r_sorted.dtype != l_keys.dtype:
        raise TypeError(f"join_probe_padded: key types differ ({l_keys.dtype} vs "
                        f"{r_sorted.dtype}); the caller picks one")
    pos, hit = _probe(l_keys.contiguous(), r_sorted.contiguous())
    return pos.clamp(0, m - 1), hit


def segment_reduce_batch(
    keys,
    values: Sequence,  # S value rows, f32[n]
    valids: Sequence,  # V validity rows, bool[n]
    num_buckets: int,
    modes: Sequence[str],  # len S
    valid_idx: Sequence[int],  # len S, value row -> valid row
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched segment reduction: every agg of one groupby in one call.

    Returns ``(reds f32[S, B], counts i32[V, B])`` where ``reds[s]`` reduces
    ``values[s]`` over ``keys`` restricted to ``valids[valid_idx[s]]`` with
    ``modes[s]``, and ``counts[v]`` counts valid rows per bucket."""
    keys = keys.to(torch.int32).contiguous()
    n = keys.shape[0]
    vals = (
        torch.stack([v.to(torch.float32) for v in values])
        if len(values)
        else torch.zeros((0, n), dtype=torch.float32, device=keys.device)
    )
    vmask = torch.stack([m.to(torch.bool) for m in valids])
    return _segment(keys, vals, vmask, int(num_buckets), list(modes),
                    [int(i) for i in valid_idx])


# --------------------------------------------------------------------------- #
# Multi-partition batches                                                      #
#                                                                              #
# The ``*_parts`` wrappers take k same-bucket partitions at once.  Each row    #
# of a batched kernel is computed independently of the others with the same   #
# fixed tiling, so row p of a batch is bit-for-bit the unbatched entry point   #
# on partition p alone.                                                        #
# --------------------------------------------------------------------------- #


def _one_bucket(lengths) -> int:
    nbs = {pad_len(int(n)) for n in lengths}
    if len(nbs) != 1:
        raise ValueError(f"partitions span shape buckets {sorted(nbs)}; group first")
    return nbs.pop()


def segment_reduce_batch_parts(
    keys_parts: Sequence,
    values_parts: Sequence[Sequence],
    valids_parts: Sequence[Sequence],
    num_buckets: int,
    modes: Sequence[str],
    valid_idx: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k partitions' batched segment reductions: ``(reds (P, S, B), counts
    (P, V, B))``, each ``[p]`` bit-for-bit :func:`segment_reduce_batch` on
    that partition alone (one dispatch per partition)."""
    _one_bucket(k.shape[0] for k in keys_parts)
    outs = [
        segment_reduce_batch(k, list(v), list(m), num_buckets, modes, valid_idx)
        for k, v, m in zip(keys_parts, values_parts, valids_parts)
    ]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def topk_padded_parts(xs_parts: Sequence, k: int, largest: bool = True) -> torch.Tensor:
    """k partitions' top-k winner values in one dispatch: (P, k), each row
    bit-for-bit :func:`topk_padded` on that partition alone."""
    nb = _one_bucket(x.shape[0] for x in xs_parts)
    sentinel = float("-inf") if largest else float("inf")
    xs = torch.stack([_pad_last(x.to(torch.float32), nb, sentinel) for x in xs_parts])
    return _topk_rows(xs, k, largest)


def topk_rows(xs, k: int, largest: bool = True) -> torch.Tensor:
    """Top-k winner values of rows already padded to one bucket with the
    losing sentinel: (R, nb) → (R, k), each row bit-for-bit
    :func:`topk_padded` on that row's values alone."""
    return _topk_rows(xs.to(torch.float32).contiguous(), k, largest)


def argsort_f64_parts(keys_parts: Sequence) -> torch.Tensor:
    """k partitions' stable argsorts: (P, nb) int64; row p's first
    ``len(keys_parts[p])`` entries are :func:`argsort_f64` on that partition
    alone (pads are +inf, and stability keeps real +inf rows ahead)."""
    nb = _one_bucket(k.shape[0] for k in keys_parts)
    keys = torch.stack([_pad_last(k.to(torch.float64), nb, float("inf")) for k in keys_parts])
    return torch.sort(keys, dim=-1, stable=True).indices


def filter_compact_padded_parts(
    xs_rows: Sequence, keeps_rows: Sequence
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked stable compactions in one dispatch: R rows of one dtype (and
    one shape bucket) + R keep masks → ``(out (R, nb), counts (R,))``, each
    row bit-for-bit :func:`filter_compact_padded` on that row alone."""
    nb = _one_bucket(x.shape[0] for x in xs_rows)
    xs = torch.stack([_pad_last(x, nb, 0) for x in xs_rows])
    keeps = torch.stack([_pad_last(m.to(torch.bool), nb, False) for m in keeps_rows])
    return _compact(xs, keeps, 0)


def masked_stats_batch_parts(xs_rows: Sequence, ms_rows: Sequence) -> torch.Tensor:
    """Stacked masked-stats rows (k partitions × C columns) in one dispatch:
    (R, 5).  Bit-for-bit per row."""
    xs = torch.cat([x.to(torch.float32) for x in xs_rows])
    ms = torch.cat([m.to(torch.bool) for m in ms_rows])
    return masked_stats_batch(xs, ms)


# --------------------------------------------------------------------------- #
# Fused composites: filter→reduce chains without a materialised intermediate   #
#                                                                              #
# Each composite first STABLE-COMPACTS the kept rows of the unfiltered        #
# partition to the row prefix on the device (the filter_compact kernel), then #
# runs the same reduction the unfused second stage runs.  Compaction is pure  #
# data movement, and the reductions are invariant to trailing padding, so the #
# fused result equals the unfused one to the bit.                              #
# --------------------------------------------------------------------------- #


def filter_then_masked_stats(xs, ms, keep) -> torch.Tensor:
    """Fused filter→describe: (C, n) values + (C, n) validity + keep (bool
    over the first ≤ n rows) → (C, 5) over the kept + valid entries."""
    xs = xs.to(torch.float32).contiguous()
    ms = ms.contiguous()
    keep = _pad_last(keep.to(torch.bool), xs.shape[1], False).contiguous()
    xc, _ = _compact(xs, keep, 0.0)
    mc, _ = _compact(ms, keep, False)
    return _stats_rows(xc, mc)


def filter_then_segment_reduce(
    keys,
    values: Sequence,
    valids: Sequence,
    keep,
    num_buckets: int,
    modes: Sequence[str],
    valid_idx: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused filter→groupby: segment reductions over the kept rows only.
    Same contract as :func:`segment_reduce_batch` on the filtered partition,
    bit-for-bit (compacted-away slots carry key 0 with valid False)."""
    keys = keys.to(torch.int32).contiguous()
    n = keys.shape[0]
    keep = _pad_last(keep.to(torch.bool), n, False).contiguous()
    kc, _ = _compact(keys[None], keep, 0)
    vals = [v.to(torch.float32) for v in values]
    vc = _compact(torch.stack(vals), keep, 0.0)[0] if vals else None
    mc, _ = _compact(torch.stack([m.to(torch.bool) for m in valids]), keep, False)
    return segment_reduce_batch(
        kc[0], list(vc) if vc is not None else [], list(mc), num_buckets, modes, valid_idx
    )


def topk_masked_padded(x, keep, k: int, largest: bool = True) -> torch.Tensor:
    """Fused filter→topk winner values: masked-out rows take the losing
    sentinel, so the result equals ``topk_padded`` on the compacted kept rows
    exactly (callers gate kept-count > k so no sentinel wins)."""
    sentinel = float("-inf") if largest else float("inf")
    x = x.to(torch.float32)
    keep = _pad_last(keep.to(torch.bool), x.shape[0], False)
    return topk_padded(torch.where(keep, x, sentinel), k, largest)
