"""Segment reduction: the batched groupby partial.

``segment_reduce(keys, values, valids, num_buckets, modes, valid_idx)``
reduces each of the S value rows over the int32 ``keys`` restricted to its
validity row ``valids[valid_idx[s]]`` with ``modes[s]`` (sum / min / max),
and counts the valid rows of each of the V validity rows per bucket.  CUDA
tensors launch ``csrc/segment_reduce.cu``; CPU tensors run
:func:`segment_reduce_plain`.

The plain version is the reference's tiled one-hot formulation on fixed
``SEG_TILE`` row tiles, folded in tile order (so padding adds only exact
neutrals).  It never goes through TF32: on the card it sets
``torch.backends.cuda.matmul.allow_tf32 = False`` before its products, so
its sums are IEEE float32.  Counts are integers in both versions.
"""
from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch

from . import _build
from ._launch import I32, I64, P, LaunchCounter, bind, check_launch, require, stream_ptr

SEG_TILE = 2048  # == TILE in csrc/segment_reduce.cu
SMEM_LIMIT = 227 * 1024  # an H100 block's dynamic shared memory (bytes)
MODES = {"sum": 0, "min": 1, "max": 2}

launches = LaunchCounter("segment_reduce")


def smem_bytes(n_values: int, n_valids: int, num_buckets: int) -> int:
    """Shared memory one block of the kernel needs: the (S + V) * B bucket
    accumulators plus its tile's staged keys and validity bytes."""
    return ((n_values + n_valids) * num_buckets * 4
            + SEG_TILE * 4 + n_valids * SEG_TILE)


def fits(n_values: int, n_valids: int, num_buckets: int) -> bool:
    return smem_bytes(n_values, n_valids, num_buckets) <= SMEM_LIMIT


def _neutral(mode: str) -> float:
    return {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[mode]


def segment_reduce_plain(
    keys: torch.Tensor,  # i32[n]
    values: torch.Tensor,  # f32[S, n]
    valids: torch.Tensor,  # bool[V, n]
    num_buckets: int,
    modes: Sequence[str],
    valid_idx: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (reds f32[S, B], cnts i32[V, B]) on the inputs' device."""
    dev = keys.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    n = keys.shape[0]
    S, V, B = values.shape[0], valids.shape[0], int(num_buckets)
    nt = max(-(-n // SEG_TILE), 1)
    pad = nt * SEG_TILE - n
    if pad:
        keys = torch.nn.functional.pad(keys, (0, pad))
        values = torch.nn.functional.pad(values, (0, pad))
        valids = torch.nn.functional.pad(valids, (0, pad), value=False)
    iota = torch.arange(B, dtype=torch.int32, device=dev)
    sum_rows = [s for s in range(S) if modes[s] == "sum"]
    reds = [torch.full((B,), _neutral(modes[s]), dtype=torch.float32, device=dev)
            for s in range(S)]
    cnts = torch.zeros((V, B), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(nt):  # tile order: the kernel's pass 2
        sl = slice(t * SEG_TILE, (t + 1) * SEG_TILE)
        hit = keys[sl, None] == iota[None, :]  # (T, B)
        oh = hit.to(torch.float32)
        vt = valids[:, sl]
        cnts += (vt.to(torch.float32) @ oh).to(torch.int64)  # ≤ SEG_TILE: exact
        if sum_rows:
            rows = torch.stack([
                torch.where(vt[valid_idx[s]], values[s, sl], zero) for s in sum_rows
            ])
            part = rows @ oh
            for j, s in enumerate(sum_rows):
                reds[s] = reds[s] + part[j]
        for s in range(S):
            if modes[s] == "sum":
                continue
            sel = hit & vt[valid_idx[s]][:, None]
            if modes[s] == "min":
                c = torch.where(sel, values[s, sl, None], float("inf")).amin(0)
                reds[s] = torch.minimum(reds[s], c)
            else:
                c = torch.where(sel, values[s, sl, None], float("-inf")).amax(0)
                reds[s] = torch.maximum(reds[s], c)
    red = torch.stack(reds) if S else torch.zeros((0, B), dtype=torch.float32, device=dev)
    return red, cnts.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _fn():
    return bind(_build.load("segment_reduce"), "repro_segment_reduce",
                [P, P, P, P, I32, I32, I32, I64, P, P, P, P, P])


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
    if n == 0 or V == 0 or B <= 0:
        raise ValueError(f"segment_reduce: empty input (n={n}, V={V}, B={B})")
    if not fits(S, V, B):
        raise ValueError(
            f"segment_reduce: {S + V} rows x {B} buckets exceed one block's shared "
            "memory (the frame layer gates this ahead of time)")
    nt = -(-n // SEG_TILE)
    part_f = torch.empty(max(nt * S * B, 1), dtype=torch.float32, device=dev)
    part_c = torch.empty(nt * V * B, dtype=torch.int32, device=dev)
    reds = torch.empty((S, B), dtype=torch.float32, device=dev)
    cnts = torch.empty((V, B), dtype=torch.int32, device=dev)
    err = _fn()(keys.data_ptr(), values.data_ptr(), valids.data_ptr(),
                _plan(modes, valid_idx, dev).data_ptr(), S, V, B, n,
                part_f.data_ptr(), part_c.data_ptr(), reds.data_ptr(),
                cnts.data_ptr(), stream_ptr(dev))
    check_launch("segment_reduce", err)
    launches.add()
    return reds, cnts
