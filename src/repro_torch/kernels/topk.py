"""Top-k values of each row, sorted (the sort-with-limit pushdown).

``topk(xs, k, largest)`` launches ``csrc/topk.cu`` for CUDA tensors and runs
:func:`topk_plain` for CPU tensors.  Both select per ``TOPK_TILE`` tile,
keep each tile's k winners, and repeat on the winners until one tile is
left.  ``largest=False`` negates on the way in and out, as the reference
kernel does.  Values only, so the result is exact; +0.0 and -0.0 compare
equal and may trade places.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from ._launch import F32, I32, I64, P, LaunchCounter, bind, check_launch, require, stream_ptr

TOPK_TILE = 2048  # == TILE in csrc/topk.cu

launches = LaunchCounter("topk")


def _rounds(n: int, k: int):
    """Row lengths of the successive rounds: n, then tiles * k, … until one
    tile covers the row."""
    lens = [n]
    while lens[-1] > TOPK_TILE:
        lens.append(-(-lens[-1] // TOPK_TILE) * k)
    return lens


def topk_plain(xs: torch.Tensor, k: int, largest: bool = True) -> torch.Tensor:
    """(R, n) f32 → (R, k) f32, descending (ascending if not ``largest``)."""
    sign = 1.0 if largest else -1.0
    cur = xs * sign if not largest else xs
    r = xs.shape[0]
    for n in _rounds(xs.shape[1], k):
        nt = -(-n // TOPK_TILE)
        pad = nt * TOPK_TILE - n
        if pad:
            cur = torch.nn.functional.pad(cur, (0, pad), value=float("-inf"))
        tiles = cur.reshape(r, nt, TOPK_TILE).sort(dim=-1, descending=True).values
        cur = tiles[..., :k].reshape(r, nt * k)
    return cur * sign if not largest else cur


@functools.lru_cache(maxsize=None)
def _fn():
    return bind(_build.load("topk"), "repro_topk_round",
                [P, I64, I64, I32, F32, F32, P, P])


def topk(xs: torch.Tensor, k: int, largest: bool = True) -> torch.Tensor:
    """(R, n) f32 → (R, k) f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel once per round (or raise)."""
    if xs.device.type == "cpu":
        return topk_plain(xs, k, largest)
    if xs.device.type != "cuda":
        raise ValueError(f"topk: unsupported device {xs.device}")
    require(xs, "xs", torch.float32, 2)
    r, n = xs.shape
    if r == 0 or n == 0 or not 1 <= k <= 128:
        raise ValueError(f"topk: unsupported shape {tuple(xs.shape)} with k={k}")
    dev = xs.device
    sign = 1.0 if largest else -1.0
    lens = _rounds(n, k)
    cur = xs
    for i, ln in enumerate(lens):
        nt = -(-ln // TOPK_TILE)
        out = torch.empty((r, nt * k), dtype=torch.float32, device=dev)
        err = _fn()(cur.data_ptr(), r, ln, k,
                    sign if i == 0 else 1.0, sign if i == len(lens) - 1 else 1.0,
                    out.data_ptr(), stream_ptr(dev))
        check_launch("topk", err)
        cur = out
    launches.add()
    return cur
