"""Top-k values of each row, sorted (the sort-with-limit pushdown).

``topk(xs, k, largest)`` launches ``csrc/topk.cu`` for CUDA tensors and runs
:func:`topk_plain` for CPU tensors.  The kernel is a threshold-filtered
select: ``topk_blocks`` blocks a row each keep their span's k largest
values, then one block a row merges those winners.  ``largest=False``
negates on the way in and out, as the reference kernel does.  NaN ranks
above every value, for ``largest`` either way, as in the reference and in
:func:`topk_plain`: the kernel counts a row's NaNs and emits min(count, k)
of them first.  Values only, so the result is exact whatever the order of
selection; +0.0 and -0.0 compare equal and may trade places.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from ._launch import (F32, I32, I64, P, LaunchCounter, bind, check_launch, on_device, require,
                      stream_ptr)

GRID = 264  # blocks launch 1 aims for across all rows: two an SM of an H100
SPAN = 4096  # fewest values a block of launch 1 takes

launches = LaunchCounter("topk")


def topk_plain(xs: torch.Tensor, k: int, largest: bool = True) -> torch.Tensor:
    """(R, n) f32 → (R, k) f32, descending (ascending if not ``largest``),
    NaN first either way; a row of fewer than k values is padded with the
    losing infinity."""
    cur = xs if largest else -xs
    if cur.shape[1] < k:
        cur = torch.nn.functional.pad(cur, (0, k - cur.shape[1]), value=float("-inf"))
    top = cur.sort(dim=-1, descending=True).values[:, :k]
    return top if largest else -top


def topk_blocks(rows: int, n: int) -> int:
    """Blocks a row of the kernel's first launch: about ``GRID`` in all, none
    on fewer than ``SPAN`` values; 1 means a single launch."""
    return max(1, min(-(-n // SPAN), -(-GRID // rows)))


def buffer_rows(rows: int, n: int):
    """(blocks a row, rows of k float32 in the one allocation a call makes):
    the (rows, k) result first, then the first launch's (rows * blocks, k)
    winners when there are two launches."""
    blocks = topk_blocks(rows, n)
    return blocks, rows + (rows * blocks if blocks > 1 else 0)


@functools.lru_cache(maxsize=None)
def _fn():
    return bind(_build.load("topk"), "repro_topk", [P, I64, I64, I32, I32, F32, P, P, P])


def topk(xs: torch.Tensor, k: int, largest: bool = True) -> torch.Tensor:
    """(R, n) f32 → (R, k) f32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if xs.device.type == "cpu":
        return topk_plain(xs, k, largest)
    if xs.device.type != "cuda":
        raise ValueError(f"topk: unsupported device {xs.device}")
    require(xs, "xs", torch.float32, 2)
    r, n = xs.shape
    if r == 0 or n == 0 or not 1 <= k <= 128:
        raise ValueError(f"topk: unsupported shape {tuple(xs.shape)} with k={k}")
    dev = xs.device
    blocks, size = buffer_rows(r, n)
    buf = torch.empty((size, k), dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    with on_device(dev):
        err = _fn()(xs.data_ptr(), r, n, k, blocks, 1.0 if largest else -1.0, ptr + 4 * r * k,
                    ptr, stream_ptr(dev))
    check_launch("topk", err)
    launches.add()
    return buf[:r]
