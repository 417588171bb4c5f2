"""Stable stream compaction by a keep mask.

``filter_compact(xs, keep, fill)`` moves the kept elements of each row of
``xs`` to the row's prefix in their original order, fills the rest with
``fill``, and returns the per-row kept counts.  ``xs`` may hold any 1-, 4- or
8-byte dtype (bool, int32, float32, int64, float64, …): elements move as raw
bytes, so every column of a partition compacts losslessly.  ``keep`` is one
mask per row, or one 1-D mask shared by every row.

CUDA tensors launch ``csrc/filter_compact.cu``; CPU tensors run
:func:`filter_compact_plain` (a cumulative-sum scatter).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import _build
from ._launch import I32, I64, P, U64, LaunchCounter, bind, check_launch, require, stream_ptr

FC_TILE = 4096  # == TILE in csrc/filter_compact.cu
_BITS = {1: torch.uint8, 4: torch.int32, 8: torch.int64}

launches = LaunchCounter("filter_compact")


def filter_compact_plain(xs: torch.Tensor, keep: torch.Tensor, fill=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, n) any dtype + (R, n) or (n,) bool → (out (R, n), counts i64[R])."""
    r, n = xs.shape
    if keep.dim() == 1:
        keep = keep.unsqueeze(0).expand(r, -1)
    counts = keep.sum(-1)
    out = torch.full_like(xs, fill)
    pos = torch.cumsum(keep, -1) - 1
    rows = torch.arange(r, device=xs.device)[:, None].expand(r, n)
    out[rows[keep], pos[keep]] = xs[keep]
    return out, counts


@functools.lru_cache(maxsize=None)
def _fn():
    return bind(_build.load("filter_compact"), "repro_filter_compact",
                [P, P, P, I64, I64, I64, I32, U64, P, P, P, P])


def _fill_bits(fill, dtype: torch.dtype, size: int) -> int:
    t = torch.tensor([fill], dtype=dtype).view(_BITS[size])
    return int(t.item()) & ((1 << (8 * size)) - 1)


def filter_compact(xs: torch.Tensor, keep: torch.Tensor, fill=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, n) + keep (R, n) or (n,) → (out (R, n) of xs.dtype, counts i64[R]).
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if xs.device.type == "cpu":
        return filter_compact_plain(xs, keep, fill)
    if xs.device.type != "cuda":
        raise ValueError(f"filter_compact: unsupported device {xs.device}")
    dev = xs.device
    require(xs, "xs", None, 2)
    require(keep, "keep", torch.bool, None, dev)
    size = xs.element_size()
    if size not in _BITS:
        raise TypeError(f"filter_compact: {xs.dtype} is not a 1-, 4- or 8-byte type")
    r, n = xs.shape
    keep_rows = 1 if keep.dim() == 1 else keep.shape[0]
    if keep.shape[-1] != n or keep.dim() > 2 or keep_rows not in (1, r):
        raise ValueError(
            f"filter_compact: keep {tuple(keep.shape)} does not fit xs {tuple(xs.shape)}")
    if r == 0 or n == 0:
        raise ValueError(f"filter_compact: empty input {tuple(xs.shape)}")
    nt = -(-n // FC_TILE)
    counts = torch.empty(keep_rows * nt, dtype=torch.int32, device=dev)
    offsets = torch.empty(keep_rows * nt, dtype=torch.int64, device=dev)
    totals = torch.empty(keep_rows, dtype=torch.int64, device=dev)
    out = torch.empty_like(xs)
    err = _fn()(xs.data_ptr(), out.data_ptr(), keep.data_ptr(), keep_rows, r, n,
                size, _fill_bits(fill, xs.dtype, size), counts.data_ptr(),
                offsets.data_ptr(), totals.data_ptr(), stream_ptr(dev))
    check_launch("filter_compact", err)
    launches.add()
    return out, totals.expand(r) if keep_rows == 1 else totals
