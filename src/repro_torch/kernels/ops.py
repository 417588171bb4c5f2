"""Dispatch entry points of the frame kernels.

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
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch

from . import filter_compact as _fc
from . import masked_stats as _ms
from . import segment_reduce as _sr
from . import topk as _tk

_TLS = threading.local()  # per-thread override (scoped, race-free)

KERNELS = {
    "masked_stats": _ms,
    "segment_reduce": _sr,
    "topk": _tk,
    "filter_compact": _fc,
}


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
    return {name: mod.launches.value for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches.reset()


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


# --------------------------------------------------------------------------- #
# Padded / batched entry points for the frame layer                            #
#                                                                              #
# Row counts round up to power-of-two buckets (``pad_len``): partitions of one #
# bucket batch into one dispatch.  Every reduction tiles its rows with a       #
# FIXED tile length (``_TILE`` for stats, the segment kernel's ``SEG_TILE``),  #
# so padding a row further only adds all-masked tiles, which are exact no-ops. #
# That makes every result independent of how far its input was padded — the   #
# property the fused filter→reduce composites rely on for bit-for-bit parity  #
# with the unfused sequence (their reduce runs at the parent partition's      #
# length, the unfused one at the filtered length).                             #
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
