"""Masked per-row statistics: (count, sum, m2, min, max) over valid entries.

``masked_stats(xs, ms)`` launches the CUDA kernels of ``csrc/masked_stats.cu``
for CUDA tensors (one block a tile reads the tile once, then one block a row
merges the tiles' partials) and runs :func:`masked_stats_plain` for CPU
tensors.  The plain version repeats the kernel's arithmetic in PyTorch:
fixed ``TILE`` tiles whose partials (count, sum, m2 about the tile mean,
min, max) merge in tile order with the live-gated Chan update, so an
all-masked tile is an exact no-op and the result does not depend on how far
a row was padded.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from ._launch import (I64, P, LaunchCounter, bind, check_launch, on_device, require,
                      stream_ptr)

TILE = 16384  # == ops._TILE == TILE in csrc/masked_stats.cu

launches = LaunchCounter("masked_stats")


def masked_stats_plain(xs: torch.Tensor, ms: torch.Tensor) -> torch.Tensor:
    """(R, n) f32 values + (R, n) bool validity → (R, 5) f32 rows of
    (count, sum, m2, min, max), on the inputs' device."""
    r, n = xs.shape
    nt = max(-(-n // TILE), 1)
    pad = nt * TILE - n
    if pad:
        xs = torch.nn.functional.pad(xs, (0, pad))
        ms = torch.nn.functional.pad(ms, (0, pad), value=False)
    x = xs.reshape(r, nt, TILE)
    m = ms.reshape(r, nt, TILE)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    tcnt = m.sum(-1)
    tsum = torch.where(m, x, zero).sum(-1)
    tmean = tsum / tcnt.to(x.dtype).clamp(min=1.0)
    d = torch.where(m, x - tmean[..., None], zero)
    tm2 = (d * d).sum(-1)
    tmn = torch.where(m, x, inf).amin(-1)
    tmx = torch.where(m, x, -inf).amax(-1)

    cnt = torch.zeros(r, dtype=torch.int64, device=x.device)
    s = torch.zeros(r, dtype=x.dtype, device=x.device)
    m2 = torch.zeros(r, dtype=x.dtype, device=x.device)
    mn = inf.expand(r).clone()
    mx = (-inf).expand(r).clone()
    for t in range(nt):  # tile order: the kernel's pass 2
        tc = tcnt[:, t]
        live = tc > 0
        fc = cnt.to(x.dtype)
        ftc = tc.to(x.dtype)
        delta = tsum[:, t] / ftc.clamp(min=1.0) - s / fc.clamp(min=1.0)
        merged = (m2 + tm2[:, t]) + delta * delta * fc * ftc / (fc + ftc).clamp(min=1.0)
        m2 = torch.where(live, merged, m2)
        s = torch.where(live, s + tsum[:, t], s)
        cnt = cnt + tc
        mn = torch.minimum(mn, tmn[:, t])
        mx = torch.maximum(mx, tmx[:, t])
    return torch.stack([cnt.to(x.dtype), s, m2, mn, mx], dim=-1)


@functools.lru_cache(maxsize=None)
def _fn():
    return bind(_build.load("masked_stats"), "repro_masked_stats",
                [P, P, I64, I64, P, P, P])


def buffer_rows(rows: int, n: int):
    """(rows of five float32 in the one allocation a call makes, the row its
    scratch starts at): the (rows, 5) result first, padded to a multiple of
    four rows so that the scratch starts on 16 bytes, then one row of five
    (20 bytes) a tile for the tiles' partials (``repro_masked_stats``)."""
    head = -(-rows // 4) * 4
    return head + rows * -(-n // TILE), head


def masked_stats(xs: torch.Tensor, ms: torch.Tensor) -> torch.Tensor:
    """(R, n) f32 + (R, n) bool → (R, 5) f32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if xs.device.type == "cpu":
        return masked_stats_plain(xs, ms)
    if xs.device.type != "cuda":
        raise ValueError(f"masked_stats: unsupported device {xs.device}")
    require(xs, "xs", torch.float32, 2)
    require(ms, "ms", torch.bool, 2, xs.device)
    if ms.shape != xs.shape:
        raise ValueError(f"masked_stats: shapes {tuple(xs.shape)} != {tuple(ms.shape)}")
    r, n = xs.shape
    if r == 0 or n == 0:
        raise ValueError(f"masked_stats: empty input {tuple(xs.shape)}")
    dev = xs.device
    size, head = buffer_rows(r, n)
    buf = torch.empty((size, 5), dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    with on_device(dev):
        err = _fn()(xs.data_ptr(), ms.data_ptr(), r, n, ptr + 20 * head, ptr, stream_ptr(dev))
    check_launch("masked_stats", err)
    launches.add()
    return buf[:r]
