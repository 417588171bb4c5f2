"""Sorted-lookup join probe: the broadcast join's probe phase.

``join_probe(l_keys, r_sorted)`` returns, for each left key, ``pos`` = its
searchsorted-left position in the ascending, unique right keys and ``hit``
= whether an exact match exists.  CUDA tensors launch ``csrc/join_probe.cu``
(a lower-bound search whose top levels run over a sample of the right keys
in shared memory, :func:`sample_log2` sizing the sample); CPU tensors run
:func:`join_probe_plain`.

Both give the counting formulation's answers (``pos = #{r < l}``): a NaN
left key has pos 0 and no hit, NaN right keys (sorted last) never count or
match, ±inf compare exactly and -0.0 matches +0.0.  Keys stay native:
float32, float64, int32 or int64, one type for both sides.  ``pos`` is not
clipped here; ``ops.join_probe_padded`` clips it as the reference does.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import _build
from ._launch import (I32, I64, P, LaunchCounter, bind, check_launch, on_device, require,
                      stream_ptr)

DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3}

launches = LaunchCounter("join_probe")

STAGE_MAX = 227 * 1024  # a right side this small is staged whole in shared memory
SAMPLE_MAX = 64 * 1024  # else the sample of every 2^k-th key takes at most this


def sample_log2(m: int, itemsize: int) -> int:
    """log2 of the sample step s for m right keys of ``itemsize`` bytes: 0
    (the whole right side in shared memory) when it fits 227 KB, else the
    least k with 2^k >= 32 / itemsize (the device levels end on one 32-byte
    sector) whose sample, ceil(m / 2^k) keys, fits 64 KB."""
    if m * itemsize <= STAGE_MAX:
        return 0
    k = (32 // itemsize).bit_length() - 1
    while -(-m >> k) * itemsize > SAMPLE_MAX:
        k += 1
    return k


def join_probe_plain(l_keys: torch.Tensor, r_sorted: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (pos i32[n], hit bool[n]): ``torch.searchsorted`` over the right
    keys before their NaN tail, plus an equality gather."""
    m = r_sorted.shape[0]
    if r_sorted.is_floating_point():
        live = int((~torch.isnan(r_sorted)).sum())  # NaNs sort last
        pos = torch.searchsorted(r_sorted[:live], l_keys, side="left")
        pos = torch.where(torch.isnan(l_keys), 0, pos)
    else:
        live = m
        pos = torch.searchsorted(r_sorted, l_keys, side="left")
    hit = (pos < live) & (r_sorted[pos.clamp(max=max(live - 1, 0))] == l_keys)
    return pos.to(torch.int32), hit


@functools.lru_cache(maxsize=None)
def _fns():
    lib = _build.load("join_probe")
    return bind(lib, "repro_join_probe", [P, I64, P, I64, I32, I32, P, I64, P, P, P])


def join_probe(l_keys: torch.Tensor, r_sorted: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (pos i32[n], hit bool[n]).  CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if l_keys.device.type == "cpu":
        return join_probe_plain(l_keys, r_sorted)
    if l_keys.device.type != "cuda":
        raise ValueError(f"join_probe: unsupported device {l_keys.device}")
    dev = l_keys.device
    if l_keys.dtype not in DTYPES:
        raise TypeError(f"join_probe: unsupported key type {l_keys.dtype}")
    require(l_keys, "l_keys", None, 1)
    require(r_sorted, "r_sorted", l_keys.dtype, 1, dev)
    n, m = l_keys.shape[0], r_sorted.shape[0]
    if n == 0 or not 0 < m < 2**31:
        raise ValueError(f"join_probe: unsupported sizes n={n}, m={m}")
    size = l_keys.element_size()
    k = sample_log2(m, size)
    scratch = torch.empty(0 if k == 0 else -(-m >> k) * size, dtype=torch.uint8, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    with on_device(dev):
        err = _fns()(l_keys.data_ptr(), n, r_sorted.data_ptr(), m, DTYPES[l_keys.dtype], k,
                     scratch.data_ptr(), scratch.numel(), pos.data_ptr(), hit.data_ptr(),
                     stream_ptr(dev))
    check_launch("join_probe", err)
    launches.add()
    return pos, hit
