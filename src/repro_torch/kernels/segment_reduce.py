"""Segment reduction: the batched groupby partial.

``segment_reduce(keys, values, valids, num_buckets, modes, valid_idx)``
reduces each of the S value rows over the int32 ``keys`` restricted to its
validity row ``valids[valid_idx[s]]`` with ``modes[s]`` (sum / min / max),
and counts the valid rows of each of the V validity rows per bucket, for
any bucket count below 2^24.  CUDA tensors launch
``csrc/segment_reduce.cu``; CPU tensors run :func:`segment_reduce_plain`.

The kernel is a sort-and-fold.  Counts are integer histograms.  For the
value rows, the rows that are live (key in ``[0, B)`` and valid) are
stably sorted by key, so each bucket's valid rows form one run in row
order, and each run is folded in chunks of :data:`FOLD_CHUNK` rows counted
from its first row, then chunks of partials, level by level.  That
association is a function of the run's length alone: padding, rows of other
keys and the other rows of a batched call change no bucket's bits.  The
plain version sums each bucket's rows in row order, left to right.  Keys
outside ``[0, B)`` and invalid rows touch nothing.  :func:`sort_plan` gives
the sort's passes and the kernel's scratch, which grows with the row count
and not with B.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from . import _build
from ._launch import (I32, I64, P, LaunchCounter, bind, check_launch, on_device, require,
                      stream_ptr)

TILE_ROWS = 4096  # == TILE in csrc/segment_reduce.cu: rows a block sorts or folds
MAX_DIGIT_BITS = 11  # == MAX_DIGIT_BITS: at most 2,048 bins a sort pass
FOLD_CHUNK = 32  # == CHUNK: rows (then partials) one thread folds in order
MAX_BUCKETS = 1 << 24
MODES = {"sum": 0, "min": 1, "max": 2}

launches = LaunchCounter("segment_reduce")


class SortPlan(NamedTuple):
    """How the kernel sorts and folds n rows into B buckets, and the int32
    scratch it needs (element counts; all 0 when S == 0: counts alone need
    none)."""

    key_bits: int  # bits of the largest key, B - 1
    passes: int  # LSD radix passes; one 0-bit pass (a stable compaction) for B = 1
    digit_bits: int  # bits a pass
    tiles: int  # row tiles of TILE_ROWS
    fold_levels: int  # least L with FOLD_CHUNK ** L >= n
    sort_keys: int  # two key buffers of n
    sort_ids: int  # two row-id buffers of n
    hist: int  # per-tile digit counts, bins * tiles
    aux: int  # digit totals, digit bases, live rows, longest run

    @property
    def bins(self) -> int:
        return 1 << self.digit_bits

    @property
    def scratch_bytes(self) -> int:
        return 4 * (self.sort_keys + self.sort_ids + self.hist + self.aux)


def sort_plan(n: int, num_buckets: int, num_values: int) -> SortPlan:
    """The sort-and-fold plan for ``n`` rows, ``num_buckets`` buckets and
    ``num_values`` value rows.  The digit width comes from B alone: the
    fewest passes of at most :data:`MAX_DIGIT_BITS` bits (three at most for
    B < 2^24), split evenly."""
    n, B = int(n), int(num_buckets)
    if not 0 < B < MAX_BUCKETS:
        raise ValueError(f"segment_reduce: B out of range ({B})")
    bits = (B - 1).bit_length()
    passes = max(1, -(-bits // MAX_DIGIT_BITS))
    digit_bits = -(-bits // passes)
    tiles = -(-n // TILE_ROWS)
    levels = 1
    while FOLD_CHUNK ** levels < n:
        levels += 1
    if num_values == 0:
        return SortPlan(bits, passes, digit_bits, tiles, levels, 0, 0, 0, 0)
    bins = 1 << digit_bits
    return SortPlan(bits, passes, digit_bits, tiles, levels, 2 * n, 2 * n, bins * tiles,
                    2 * bins + 2)


def segment_reduce_plain(
    keys: torch.Tensor,  # i32[n]
    values: torch.Tensor,  # f32[S, n]
    valids: torch.Tensor,  # bool[V, n]
    num_buckets: int,
    modes: Sequence[str],
    valid_idx: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (reds f32[S, B], cnts i32[V, B]) on the inputs' device.

    Sums add in row order on the CPU (``index_add_``; ``index_put_``'s
    accumulate splits the rows over threads there above 32,768 rows, and two
    calls then differ in the last bits).  On a CUDA device they take
    ``index_put_(accumulate=True)``, in the order its accumulate chooses."""
    dev = keys.device
    S, V, B = values.shape[0], valids.shape[0], int(num_buckets)
    k = keys.long()
    live = (k >= 0) & (k < B)
    cnts = torch.stack([
        torch.bincount(k[live & valids[v]], minlength=B) for v in range(V)
    ]).to(torch.int32)
    reds = []
    for s in range(S):
        sel = live & valids[valid_idx[s]]
        x = values[s][sel]
        if modes[s] == "sum":
            acc = torch.zeros(B, dtype=torch.float32, device=dev)
            if dev.type == "cpu":
                acc.index_add_(0, k[sel], x)
            else:
                acc.index_put_((k[sel],), x, accumulate=True)
        else:
            fill = float("inf") if modes[s] == "min" else float("-inf")
            acc = torch.full((B,), fill, dtype=torch.float32, device=dev)
            acc.scatter_reduce_(0, k[sel], x, "amin" if modes[s] == "min" else "amax")
        reds.append(acc)
    red = torch.stack(reds) if S else torch.zeros((0, B), dtype=torch.float32, device=dev)
    return red, cnts


@functools.lru_cache(maxsize=None)
def _fn():
    return bind(_build.load("segment_reduce"), "repro_segment_reduce",
                [P, P, P, P, I32, I32, I32, I64, I32, I32, I32, P, P, P, P, P, P, P])


def segment_reduce(
    keys: torch.Tensor,
    values: torch.Tensor,
    valids: torch.Tensor,
    num_buckets: int,
    modes: Sequence[str],
    valid_idx: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (reds f32[S, B], cnts i32[V, B]).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if keys.device.type == "cpu":
        return segment_reduce_plain(keys, values, valids, num_buckets, modes, valid_idx)
    if keys.device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {keys.device}")
    dev = keys.device
    require(keys, "keys", torch.int32, 1)
    require(values, "values", torch.float32, 2, dev)
    require(valids, "valids", torch.bool, 2, dev)
    n = keys.shape[0]
    S, V, B = values.shape[0], valids.shape[0], int(num_buckets)
    if values.shape[1] != n or valids.shape[1] != n:
        raise ValueError("segment_reduce: value / validity rows must match keys")
    if len(modes) != S or len(valid_idx) != S or any(not 0 <= i < V for i in valid_idx):
        raise ValueError("segment_reduce: plan does not match the value rows")
    if n == 0 or V == 0 or not 0 < B < MAX_BUCKETS:
        raise ValueError(f"segment_reduce: empty input or B out of range (n={n}, V={V}, B={B})")
    plan = sort_plan(n, B, S)
    scratch = [torch.empty(size, dtype=torch.int32, device=dev) if size else None
               for size in (plan.sort_keys, plan.sort_ids, plan.hist, plan.aux)]
    reds = torch.empty((S, B), dtype=torch.float32, device=dev)
    cnts = torch.empty((V, B), dtype=torch.int32, device=dev)
    host = (ctypes.c_int * max(2 * S, 1))(*[MODES[m] for m in modes],
                                          *[int(i) for i in valid_idx])
    with on_device(dev):
        err = _fn()(keys.data_ptr(), values.data_ptr(), valids.data_ptr(),
                    ctypes.addressof(host), S, V, B, n, plan.passes, plan.digit_bits,
                    plan.fold_levels, *[t.data_ptr() if t is not None else None for t in scratch],
                    reds.data_ptr(), cnts.data_ptr(), stream_ptr(dev))
    check_launch("segment_reduce", err)
    launches.add()
    return reds, cnts
