"""Segment reduction: the batched groupby partial.

``segment_reduce(keys, values, valids, num_buckets, modes, valid_idx)``
reduces each of the S value rows over the int32 ``keys`` restricted to its
validity row ``valids[valid_idx[s]]`` with ``modes[s]`` (sum / min / max),
and counts the valid rows of each of the V validity rows per bucket, for
any bucket count below 2^24.  CUDA tensors launch
``csrc/segment_reduce.cu``; CPU tensors run :func:`segment_reduce_plain`.

The kernel cuts the rows into tiles of :func:`tile_rows` rows (a function
of B only, never of the row count or of how many rows share the call), sums
each bucket's rows of a tile in row order and folds the tiles in tile
order, so padding adds only exact neutrals and a batched call gives each
value row the bits it gets alone.  The plain version sums each bucket's
rows in row order.  Keys outside ``[0, B)`` and invalid rows touch
nothing.  Counts are integers in both versions.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch

from . import _build
from ._launch import I32, I64, P, LaunchCounter, bind, check_launch, require, stream_ptr

SEG_TILE = 2048  # == STAGE in csrc/segment_reduce.cu: the least tile
SCRATCH_BYTES_PER_ROW = 128  # bound on one value / validity row's partials per input row
MAX_BUCKETS = 1 << 24
MODES = {"sum": 0, "min": 1, "max": 2}

launches = LaunchCounter("segment_reduce")


def tile_rows(num_buckets: int) -> int:
    """Rows per tile: ``SEG_TILE * 2**k``, the least whose partials of one
    value or validity row (B * 4 bytes) are at most
    ``SCRATCH_BYTES_PER_ROW`` per row.  Every B up to 65,536, so every B
    whose accumulators fit one block's shared memory, gets ``SEG_TILE``."""
    t = SEG_TILE
    while num_buckets * 4 > SCRATCH_BYTES_PER_ROW * t:
        t *= 2
    return t


def segment_reduce_plain(
    keys: torch.Tensor,  # i32[n]
    values: torch.Tensor,  # f32[S, n]
    valids: torch.Tensor,  # bool[V, n]
    num_buckets: int,
    modes: Sequence[str],
    valid_idx: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (reds f32[S, B], cnts i32[V, B]) on the inputs' device.

    Sums accumulate with ``index_put_(accumulate=True)``, which adds in row
    order on the CPU."""
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
                [P, P, P, P, I32, I32, I32, I64, I32, P, P, P, P, P])


_PLANS: Dict[tuple, torch.Tensor] = {}


def _plan(modes: Sequence[str], valid_idx: Sequence[int], dev: torch.device) -> torch.Tensor:
    """The kernel's device-side plan (modes, then validity rows), cached so a
    repeated groupby uploads nothing."""
    key = (tuple(modes), tuple(int(i) for i in valid_idx), str(dev))
    plan = _PLANS.get(key)
    if plan is None:
        host = [MODES[m] for m in modes] + [int(i) for i in valid_idx]
        plan = torch.tensor(host or [0], dtype=torch.int32, device=dev)
        _PLANS[key] = plan
    return plan


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
    tile = tile_rows(B)
    nt = -(-n // tile)
    part_f = torch.empty(max(nt * S * B, 1), dtype=torch.float32, device=dev)
    part_c = torch.empty(nt * V * B, dtype=torch.int32, device=dev)
    reds = torch.empty((S, B), dtype=torch.float32, device=dev)
    cnts = torch.empty((V, B), dtype=torch.int32, device=dev)
    err = _fn()(keys.data_ptr(), values.data_ptr(), valids.data_ptr(),
                _plan(modes, valid_idx, dev).data_ptr(), S, V, B, n, tile,
                part_f.data_ptr(), part_c.data_ptr(), reds.data_ptr(),
                cnts.data_ptr(), stream_ptr(dev))
    check_launch("segment_reduce", err)
    launches.add()
    return reds, cnts
