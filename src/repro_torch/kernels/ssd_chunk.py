"""Mamba-2 SSD by chunks (state-space duality, arXiv:2405.21060).

``ssd_chunk_scan(x, log_a, b, c, chunk)`` runs the recurrence
``h_t = a_t h_{t-1} + b_t x_tᵀ, y_t = c_t h_t`` from h = 0 over x (batch, S,
H, P), log_a (batch, S, H) float32 and b, c (batch, S, N) (shared by the
heads), and returns ``(y (batch, S, H, P) in x's type, h_final f32 (batch,
H, N, P))``.  It is two steps, as in the reference
(src/repro/kernels/ssd_chunk.py):

1. per (batch, chunk, head) cell of chunk length L, the intra-chunk pass::

       cum     = cumsum(log_a over the chunk)                       (L,)
       M[i,j]  = (C Bᵀ)[i,j] * exp(cum_i - cum_j) for j <= i, else 0
       y_intra = M X                             (L, P), rounded to x's type
       state   = (B * exp(cum_{L-1} - cum))ᵀ X    (N, P), float32

   For CUDA tensors this is one launch of a kernel of ``csrc/ssd_chunk.cu``,
   the one :func:`ssd_route` names: ``ssd_wgmma`` (bf16 on the tensor cores,
   C Bᵀ once per block of :func:`heads_per_block` heads, float32 operands
   as sums of bf16 terms), ``ssd_short`` (chunks of at most
   ``SHORT_MAX_L`` tokens, float32 FMA, C Bᵀ once per block of
   :func:`short_heads` heads, the states written in streaming 16-byte
   vectors) or ``ssd_cells`` (float32 FMA, any other shape); for CPU
   tensors, and in :func:`ssd_chunk_scan_plain`, torch ops.  ``launches``
   counts every launch, ``launches_wgmma``, ``launches_short`` and
   ``launches_cells`` those of each kernel.
2. the inter-chunk state scan h_k = D_k h_{k-1} + S_k from h = 0 (D_k =
   exp(Σ log_a over chunk k), the last row of exp(cum)) and the
   inbound-state correction ``y = y_intra + exp(cum) C h_in``.  For CUDA
   tensors this is one launch of ``ssd_scan`` in ``csrc/ssd_chunk.cu``
   (:func:`ssd_chunk_inter`, counted by ``launches_scan``), chunk-parallel:
   one block per (sequence, head, 64 columns of P, segment of
   :func:`scan_chunks` chunks) repeats the elementwise walk to its
   segment's h_in, then computes each chunk's rows as an (L x N)·(N x P)
   product on the tensor cores (``mma.sync``, float32 sums; h_in as three
   bf16 terms, C exact in bf16, or three terms for float32); exp(cum), and
   D_k with it, comes from the same torch ops as in the plain version, so
   h_final equals the plain version's bit for bit.  For CPU tensors, and
   in :func:`ssd_chunk_inter_plain`, torch ops (a loop over the chunks,
   then one einsum).

At one-token chunks (L = 1, N <= ``RECUR_MAX_N``; :func:`scan_route`)
``ssd_chunk_scan`` runs neither step: one launch of ``ssd_recur``
(:func:`ssd_chunk_recur`, counted by ``launches_recur`` and ``launches``)
walks the tokens from h = 0 with h in registers, so no chunk state reaches
device memory; its h_final equals :func:`ssd_chunk_scan_plain`'s at chunk 1
bit for bit.  ``ssd_short`` stays reachable at L = 1 through
:func:`ssd_chunk_intra`.

The gradient: on CUDA tensors ``ssd_chunk_scan`` is :class:`SSDChunkScan`,
an autograd Function whose forward is the route above (it saves x, log_a, b
and c alone) and whose backward is three launches of ``csrc/ssd_bwd.cu``
(:func:`ssd_chunk_scan_bwd`): a state kernel (the states h_in and their
gradients g, walked from the inputs), a chunk kernel (dx, dlog_a and each
head's terms of db and dc) and ``ssd_bwd_sum`` (db and dc, the heads summed
in order).  :func:`bwd_route` picks the first two from type and sizes:
``ssd_bwd_state_wgmma`` and ``ssd_bwd_chunk_wgmma`` (bf16 on the tensor
cores, TMA loads; the chunk kernel walks :func:`heads_per_block` heads a
block) or ``ssd_bwd_state`` and ``ssd_bwd_chunk`` (float32 FMA, every other
shape).  Each counter counts its own kernel's launches:
``launches_bwd_state_wgmma`` and ``launches_bwd_chunk_wgmma`` the
tensor-core route's, ``launches_bwd_state`` and ``launches_bwd_chunk`` the
FMA kernels', ``launches_bwd_sum`` every ``ssd_bwd_sum``; the roofline is
charged under the same names (:func:`bwd_kernels`).
:func:`ssd_chunk_scan_bwd_plain` writes the same gradient in torch ops; on
CPU tensors autograd differentiates the plain version.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _build
from ..launch import roofline
from ._launch import I32, P, LaunchCounter, bind, check_launch, on_device, require, stream_ptr

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter("ssd_chunk_scan")
launches_wgmma = LaunchCounter("ssd_chunk_scan_wgmma")
launches_short = LaunchCounter("ssd_chunk_scan_short")
launches_cells = LaunchCounter("ssd_chunk_scan_cells")
launches_scan = LaunchCounter("ssd_chunk_scan_inter")
launches_recur = LaunchCounter("ssd_chunk_scan_recur")
launches_bwd_state = LaunchCounter("ssd_chunk_scan_bwd_state")
launches_bwd_chunk = LaunchCounter("ssd_chunk_scan_bwd_chunk")
launches_bwd_sum = LaunchCounter("ssd_chunk_scan_bwd_sum")
launches_bwd_state_wgmma = LaunchCounter("ssd_chunk_scan_bwd_state_wgmma")
launches_bwd_chunk_wgmma = LaunchCounter("ssd_chunk_scan_bwd_chunk_wgmma")
BWD_KERNELS = ("ssd_chunk_scan_bwd_state", "ssd_chunk_scan_bwd_chunk", "ssd_chunk_scan_bwd_sum")
BWD_KERNELS_WGMMA = ("ssd_chunk_scan_bwd_state_wgmma", "ssd_chunk_scan_bwd_chunk_wgmma",
                     "ssd_chunk_scan_bwd_sum")

SHORT_MAX_L = 16  # == SHORT_MAX_L in csrc/ssd_chunk.cu: past it ssd_cells is faster
SHORT_SMEM = 48 * 1024  # shared memory a block of ssd_short aims at: several blocks an SM
SHORT_BLOCKS_PER_SM = 16  # so that the last wave's tail is short
SCAN_MAX_N = 256  # the largest state size ssd_scan holds in registers
SCAN_PS = 64  # == SCAN_PS in csrc/ssd_chunk.cu: P columns a block of ssd_scan
RECUR_MAX_N = 256  # the largest state size ssd_recur holds in registers
RECUR_PB = 16  # == RECUR_PB in csrc/ssd_chunk.cu: P columns a block of ssd_recur
BWD_MAX_L, BWD_MAX_N, BWD_MAX_P = 128, 256, 128  # == MAX_L, MAX_N, MAX_P in csrc/ssd_bwd.cu


def ssd_route(dtype: torch.dtype, L: int, N: int, P: int) -> str:
    """The kernel for a type and chunk, state and head sizes: ``"wgmma"``
    for bf16 with L in {64, 128}, N in {64, 128}, P <= 128 and P % 8 == 0
    (TMA needs 16-byte rows), ``"short"`` for either type with L <=
    ``SHORT_MAX_L`` (L = 1 is the one-token-chunk prompt), ``"cells"`` for
    every other shape."""
    if dtype not in DTYPES:
        raise TypeError(f"ssd_chunk_scan: unsupported type {dtype}")
    if (dtype == torch.bfloat16 and L in (64, 128) and N in (64, 128) and 0 < P <= 128
            and P % 8 == 0):
        return "wgmma"
    if L <= SHORT_MAX_L:
        return "short"
    return "cells"


def bwd_route(dtype: torch.dtype, L: int, N: int, P: int) -> str:
    """The backward's state and chunk kernels for a type and chunk, state
    and head sizes: ``"wgmma"`` (``ssd_bwd_state_wgmma``,
    ``ssd_bwd_chunk_wgmma``) where :func:`ssd_route` takes ``ssd_wgmma``
    (bf16, L and N in {64, 128}, P <= 128, P % 8 == 0), ``"cells"``
    (``ssd_bwd_state``, ``ssd_bwd_chunk``, float32 FMA) for every other
    shape."""
    return "wgmma" if ssd_route(dtype, L, N, P) == "wgmma" else "cells"


def bwd_kernels(dtype: torch.dtype, L: int, N: int, P: int) -> Tuple[str, str, str]:
    """The names of the backward's three launches on the card for a type
    and sizes (state, chunk, sum): those of :func:`bwd_route`'s kernels,
    :data:`BWD_KERNELS` (the FMA kernels) for a type the kernels do not
    take.  Their counters and roofline charges go by these names, entry for
    entry as :func:`launch.roofline.ssd_bwd_work` lists the work."""
    if dtype in DTYPES and bwd_route(dtype, L, N, P) == "wgmma":
        return BWD_KERNELS_WGMMA
    return BWD_KERNELS


def charge_bwd(x: torch.Tensor, N: int, chunk: int, dh_given: bool) -> None:
    """Charge the backward's three launches to an active
    ``roofline.count()`` under :func:`bwd_kernels`' names, each at
    ``ssd_bwd_work``'s figure for its part."""
    bt, S, H, Pd = x.shape
    work = roofline.ssd_bwd_work(bt, S, H, Pd, N, chunk, x.element_size(), dh_given)
    for name, part in zip(bwd_kernels(x.dtype, chunk, N, Pd), BWD_KERNELS):
        roofline.charge(name, work[part])


def scan_route(L: int, N: int) -> str:
    """How :func:`ssd_chunk_scan` runs on CUDA tensors: ``"recur"`` (one
    launch of ``ssd_recur``) at one-token chunks with N <= ``RECUR_MAX_N``,
    else ``"pair"`` (the kernel :func:`ssd_route` names, then ``ssd_scan``)."""
    return "recur" if L == 1 and 0 < N <= RECUR_MAX_N else "pair"


def recur_grid(batch: int, H: int, P: int) -> Tuple[int, int, int]:
    """``ssd_recur``'s grid: one block of four warps per (16 columns of P,
    head, sequence); 4 x 80 = 320 blocks at the serving shape."""
    return -(-P // RECUR_PB), H, batch


def scan_chunks(batch: int, n_chunks: int, H: int, P: int, L: int, sms: int) -> int:
    """Chunks a block of ``ssd_scan`` takes.  Chunks of 64 rows or more: one
    (each chunk's product, 2 L N P operations, outweighs repeating the
    walk to it, one N x P read a chunk).  Shorter ones: as many as leave
    the fewest segments that still give each of the ``sms`` SMs a block,
    since every segment repeats the walk over the chunks before it (on an
    H100 this was the fastest choice at chunks of 1, 2, 16 and 32;
    ``PERF.md``)."""
    if L >= 64:
        return 1
    cells = batch * H * -(-P // SCAN_PS)
    segments = min(n_chunks, -(-sms // cells))
    return -(-n_chunks // segments)


def heads_per_block(batch: int, n_chunks: int, H: int, sms: int) -> int:
    """Heads a block of ``ssd_wgmma``, and of the backward's
    ``ssd_bwd_chunk_wgmma``, walks: as few as fill the ``sms`` SMs with one
    block each (C Bᵀ is computed once a block, so a block takes as many
    heads as that allows).  The last group may be smaller."""
    groups = min(H, max(1, sms // (batch * n_chunks)))
    return -(-H // groups)


def short_heads(batch: int, n_chunks: int, H: int, L: int, N: int, P: int, sms: int) -> int:
    """Heads a block of ``ssd_short`` stages and walks: as many as leave
    ``SHORT_BLOCKS_PER_SM`` blocks for each of the ``sms`` SMs, and no more
    than fit in ``SHORT_SMEM`` bytes beside the chunk's B, C and C Bᵀ (each
    head takes its X, cumsum, w and M: 4 L (P + L + 2) bytes); at least
    one.  The last group may be smaller."""
    groups = min(H, max(1, -(-SHORT_BLOCKS_PER_SM * sms // (batch * n_chunks))))
    fit = (SHORT_SMEM - 4 * L * (2 * N + L)) // (4 * L * (P + L + 2))
    return max(1, min(-(-H // groups), fit))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working type: float32, or float64 for
    float64 inputs (a float64 reference of the same expressions)."""
    return t if t.dtype == torch.float64 else t.float()


def ssd_chunk_intra_plain(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 1 in torch ops → (y_intra (batch, S, H, P) in x's type, chunk
    states f32 (batch, S/L, H, N, P); float64 throughout for float64
    inputs)."""
    bt, S, H, Pd = x.shape
    N, L = b.shape[-1], int(chunk)
    nc = S // L
    xf = _acc(x).reshape(bt, nc, L, H, Pd)
    la = _acc(log_a).reshape(bt, nc, L, H)
    bf = _acc(b).reshape(bt, nc, L, N)
    cf = _acc(c).reshape(bt, nc, L, N)
    cum = la.cumsum(2)  # (bt, nc, L, H)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[..., None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (bt, nc, i, j, H)
    lmask = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    cb = torch.einsum("bnik,bnjk->bnij", cf, bf)
    m = cb[..., None] * lmask  # (bt, nc, i, j, H)
    y = torch.einsum("bnijh,bnjhp->bnihp", m, xf)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (bt, nc, L, H)
    bw = bf[:, :, :, None, :] * decay_end[..., None]  # (bt, nc, L, H, N)
    state = torch.einsum("bnlhk,bnlhp->bnhkp", bw, xf)
    return y.reshape(bt, S, H, Pd).to(x.dtype), state


@functools.lru_cache(maxsize=None)
def _fns():
    """→ {route: C entry point}: ``repro_ssd_chunk`` (ssd_cells, given the
    type code), ``repro_ssd_chunk_wgmma`` (ssd_wgmma, given the heads a
    block walks), ``repro_ssd_chunk_short`` (ssd_short, given both),
    ``repro_ssd_scan`` (the inter-chunk scan, ssd_scan, given the chunks a
    block takes) and ``repro_ssd_recur`` (ssd_recur)."""
    lib = _build.load("ssd_chunk")
    args = [P, P, P, P, I32, I32, I32, I32, I32, I32, I32, P, P, P]
    return {"cells": bind(lib, "repro_ssd_chunk", args),
            "wgmma": bind(lib, "repro_ssd_chunk_wgmma", args),
            "short": bind(lib, "repro_ssd_chunk_short", args[:11] + [I32] + args[11:]),
            "scan": bind(lib, "repro_ssd_scan", [P] * 4 + [I32] * 8 + [P] * 3),
            "recur": bind(lib, "repro_ssd_recur", [P] * 4 + [I32] * 6 + [P] * 3)}


def chunk_decays(log_a: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """exp(cum) (batch, nc, L, H) float32: exp of the inclusive cumsum of
    log_a within each chunk; its last row is the chunk's decay D_k = exp(Σ
    log_a over chunk k).  Both versions of step 2 take them from here, so
    their h agree bit for bit."""
    bt, S, H = log_a.shape
    return torch.exp(_acc(log_a).reshape(bt, n_chunks, S // n_chunks, H).cumsum(2))


def ssd_chunk_inter_plain(y_intra: torch.Tensor, state: torch.Tensor, log_a: torch.Tensor,
                          c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 2 in torch ops: h_k = D_k h_{k-1} + state_k from h = 0, then y =
    y_intra + exp(cum) C h_in → (y in y_intra's type, h_final f32)."""
    bt, S, H, Pd = y_intra.shape
    nc, N = state.shape[1], state.shape[3]
    L = S // nc
    ecum = chunk_decays(log_a, nc)
    chunk_decay = ecum[:, :, -1]  # (bt, nc, H)
    h = torch.zeros((bt, H, N, Pd), dtype=state.dtype, device=y_intra.device)
    h_in = []
    for k in range(nc):
        h_in.append(h)
        h = chunk_decay[:, k, :, None, None] * h + state[:, k]
    ch = torch.einsum("bnlk,bnhkp->bnlhp", _acc(c).reshape(bt, nc, L, N),
                      torch.stack(h_in, 1))
    y = _acc(y_intra).reshape(bt, nc, L, H, Pd) + ecum[..., None] * ch
    return y.reshape(bt, S, H, Pd).to(y_intra.dtype), h


def ssd_chunk_inter(y_intra: torch.Tensor, state: torch.Tensor, log_a: torch.Tensor,
                    c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 2 on CUDA tensors: one launch of ``ssd_scan`` → (y, h_final) as
    :func:`ssd_chunk_inter_plain`."""
    if y_intra.dim() != 4 or state.dim() != 5 or log_a.dim() != 3 or c.dim() != 3:
        raise ValueError(f"ssd_chunk_inter: unsupported ranks y_intra {tuple(y_intra.shape)}, "
                         f"state {tuple(state.shape)}, log_a {tuple(log_a.shape)}, "
                         f"c {tuple(c.shape)}")
    bt, S, H, Pd = y_intra.shape
    nc, N = state.shape[1], state.shape[3]
    if (nc <= 0 or S % nc or state.shape != (bt, nc, H, N, Pd) or log_a.shape != (bt, S, H)
            or c.shape != (bt, S, N) or not 0 < N <= SCAN_MAX_N):
        raise ValueError(f"ssd_chunk_inter: unsupported shapes y_intra {tuple(y_intra.shape)}, "
                         f"state {tuple(state.shape)}, log_a {tuple(log_a.shape)}, "
                         f"c {tuple(c.shape)}")
    if y_intra.device.type != "cuda":
        raise ValueError(f"ssd_chunk_inter: unsupported device {y_intra.device}")
    dev, dt = y_intra.device, y_intra.dtype
    if dt not in DTYPES:
        raise TypeError(f"ssd_chunk_inter: unsupported type {dt}")
    require(y_intra, "y_intra", None, 4)
    require(state, "state", torch.float32, 5, dev)
    require(log_a, "log_a", torch.float32, 3, dev)
    require(c, "c", dt, 3, dev)
    ecum = chunk_decays(log_a, nc)
    y = torch.empty((bt, S, H, Pd), dtype=dt, device=dev)
    h = torch.empty((bt, H, N, Pd), dtype=torch.float32, device=dev)
    cpb = scan_chunks(bt, nc, H, Pd, S // nc, _sm_count(dev.index))
    with on_device(dev):
        check_launch("ssd_chunk_inter", _fns()["scan"](
            y_intra.data_ptr(), state.data_ptr(), ecum.data_ptr(), c.data_ptr(), bt, S, H, Pd,
            N, S // nc, cpb, DTYPES[dt], y.data_ptr(), h.data_ptr(), stream_ptr(dev)))
    launches_scan.add()
    return y, h


def ssd_chunk_recur(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole function at one-token chunks on CUDA tensors: one launch of
    ``ssd_recur`` → (y, h_final) as :func:`ssd_chunk_scan_plain` at chunk 1
    (h_final bit for bit).  The decays exp(log_a) come from
    :func:`chunk_decays`, the plain version's expression."""
    if x.dim() != 4 or log_a.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError(f"ssd_chunk_recur: unsupported ranks x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}")
    bt, S, H, Pd = x.shape
    N = b.shape[-1]
    if (log_a.shape != (bt, S, H) or b.shape != (bt, S, N) or c.shape != b.shape
            or not 0 < N <= RECUR_MAX_N):
        raise ValueError(f"ssd_chunk_recur: unsupported shapes x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_recur: unsupported device {x.device}")
    dev = x.device
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_chunk_recur: unsupported type {x.dtype}")
    require(x, "x", None, 4)
    require(log_a, "log_a", torch.float32, 3, dev)
    require(b, "b", x.dtype, 3, dev)
    require(c, "c", x.dtype, 3, dev)
    ecum = chunk_decays(log_a, S)
    y = torch.empty_like(x)
    h = torch.empty((bt, H, N, Pd), dtype=torch.float32, device=dev)
    with on_device(dev):
        check_launch("ssd_chunk_recur", _fns()["recur"](
            x.data_ptr(), ecum.data_ptr(), b.data_ptr(), c.data_ptr(), bt, S, H, Pd, N,
            DTYPES[x.dtype], y.data_ptr(), h.data_ptr(), stream_ptr(dev)))
    launches_recur.add()
    launches.add()
    return y, h


def ssd_chunk_scan_plain(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (y (batch, S, H, P) in x's type, h_final f32 (batch, H, N, P)),
    all in torch ops."""
    y_intra, state = ssd_chunk_intra_plain(x, log_a, b, c, chunk)
    return ssd_chunk_inter_plain(y_intra, state, log_a, c)


def _bwd_operands(x, log_a, b, c, chunk, dy):
    """The plain backward's operands by chunk: x, dy (batch, nc, L, H, P), b,
    c (batch, nc, L, N), cum, e = exp(cum), w = exp(cum_{L-1} - cum) (batch,
    nc, L, H) and D (batch, nc, H), in the working type."""
    bt, S, H, Pd = x.shape
    N, L = b.shape[-1], int(chunk)
    nc = S // L
    xf = _acc(x).reshape(bt, nc, L, H, Pd)
    dyf = _acc(dy).reshape(bt, nc, L, H, Pd)
    bf = _acc(b).reshape(bt, nc, L, N)
    cf = _acc(c).reshape(bt, nc, L, N)
    cum = _acc(log_a).reshape(bt, nc, L, H).cumsum(2)
    e = torch.exp(cum)
    return xf, dyf, bf, cf, cum, e, torch.exp(cum[:, :, -1:] - cum), e[:, :, -1]


def ssd_bwd_states_plain(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, chunk: int, dy: torch.Tensor,
                         dh: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The states of the plain backward → (h_in, g), each (batch, S / L, H,
    N, P) float32 (float64 for float64 inputs): h_in_k from h = 0 (h ← D_k h
    + S_k, S_k = Σ_j w_j b_j x_jᵀ), and g_k, the gradient of the state after
    chunk k, from g_{nc-1} = dh (0 if None) by g_{k-1} = Q_k + D_k g_k, Q_k =
    Σ_i e_i c_i dy_iᵀ."""
    xf, dyf, bf, cf, _, e, w, D = _bwd_operands(x, log_a, b, c, chunk, dy)
    bt, nc, _, H, Pd = xf.shape
    N = bf.shape[-1]
    state = torch.einsum("bnlhk,bnlhp->bnhkp", bf[:, :, :, None, :] * w[..., None], xf)
    h = torch.zeros((bt, H, N, Pd), dtype=xf.dtype, device=x.device)
    hin = []
    for k in range(nc):
        hin.append(h)
        h = D[:, k, :, None, None] * h + state[:, k]
    q = torch.einsum("bnlhk,bnlhp->bnhkp", cf[:, :, :, None, :] * e[..., None], dyf)
    g = torch.zeros_like(h) if dh is None else dh.to(h.dtype)
    gs = []
    for k in reversed(range(nc)):
        gs.append(g)
        g = q[:, k] + D[:, k, :, None, None] * g
    return torch.stack(hin, 1), torch.stack(gs[::-1], 1)


def ssd_chunk_scan_bwd_plain(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                             c: torch.Tensor, chunk: int, dy: torch.Tensor,
                             dh: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`ssd_chunk_scan_plain` in torch ops, written out
    (not autograd of the forward): given dy (batch, S, H, P) and dh_final
    f32 (batch, H, N, P) or None (zero) → (dx in x's type, dlog_a f32, db in
    b's type, dc in c's type); float64 throughout for float64 inputs.  Per
    chunk, with cum the inclusive cumsum of log_a, e = exp(cum), w =
    exp(cum_{L-1} - cum), D = exp(cum_{L-1}) and M_ij = (c_i·b_j)
    exp(cum_i - cum_j) for j <= i, and h_in and g from
    :func:`ssd_bwd_states_plain`:

    * dx_j = Σ_{i>=j} M_ij dy_i + w_j g_kᵀ b_j;
    * with Z_ij = exp(cum_i - cum_j)(dy_i·x_j): db_j = Σ_h [Σ_i Z_ij c_i +
      w_j g_k x_j] and dc_i = Σ_h [Σ_j Z_ij b_j + e_i h_in dy_i];
    * dcum_i = Σ_j A_ij - Σ_j A_ji (A = (C Bᵀ) ∘ Z) + e_i c_i·(h_in dy_i)
      - w_i b_i·(g_k x_i), and at i = L - 1 also Σ_j w_j b_j·(g_k x_j) +
      D_k ⟨g_k, h_in⟩; dlog_a is the reverse cumsum of dcum in the chunk.

    Every decay is at most 1 (log_a <= 0).  The tests and chip_smoke.py use
    it; the card's route runs the kernels of ``csrc/ssd_bwd.cu``."""
    bt, S, H, Pd = x.shape
    N, L = b.shape[-1], int(chunk)
    xf, dyf, bf, cf, cum, e, w, D = _bwd_operands(x, log_a, b, c, chunk, dy)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[..., None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (bt, nc, i, j, H)
    E = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    cb = torch.einsum("bnik,bnjk->bnij", cf, bf)[..., None]  # (bt, nc, i, j, 1)
    hin, g = ssd_bwd_states_plain(x, log_a, b, c, chunk, dy, dh)

    z = torch.einsum("bnihp,bnjhp->bnijh", dyf, xf) * E
    m = cb * E
    a = cb * z
    bg = torch.einsum("bnjk,bnhkp->bnjhp", bf, g)  # g_kᵀ b_j
    dx = torch.einsum("bnijh,bnihp->bnjhp", m, dyf) + w[..., None] * bg
    v = torch.einsum("bnhkp,bnjhp->bnjhk", g, xf)  # g_k x_j
    db = torch.einsum("bnijh,bnik->bnjk", z, cf) + torch.einsum("bnjh,bnjhk->bnjk", w, v)
    u = torch.einsum("bnhkp,bnihp->bnihk", hin, dyf)  # h_in dy_i
    dc = torch.einsum("bnijh,bnjk->bnik", z, bf) + torch.einsum("bnih,bnihk->bnik", e, u)
    sv = w * torch.einsum("bnjk,bnjhk->bnjh", bf, v)
    dcum = a.sum(3) - a.sum(2) + e * torch.einsum("bnik,bnihk->bnih", cf, u) - sv
    last = sv.sum(2) + D * (g * hin).sum((-2, -1))
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + last[:, :, None]], 2)
    dla = dcum.flip(2).cumsum(2).flip(2)
    return (dx.reshape(bt, S, H, Pd).to(x.dtype), dla.reshape(bt, S, H).to(log_a.dtype),
            db.reshape(bt, S, N).to(b.dtype), dc.reshape(bt, S, N).to(c.dtype))


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    """→ {kernel: C entry point} of ``csrc/ssd_bwd.cu``: ``state`` and
    ``chunk`` (the float32 FMA kernels, given the type code), their
    tensor-core route ``state_wgmma`` and ``chunk_wgmma`` (bf16; the chunk
    kernel given the heads a block walks) and ``sum``."""
    lib = _build.load("ssd_bwd")
    return {"state": bind(lib, "repro_ssd_bwd_state", [P] * 6 + [I32] * 7 + [P] * 3),
            "chunk": bind(lib, "repro_ssd_bwd_chunk", [P] * 7 + [I32] * 7 + [P] * 5),
            "state_wgmma": bind(lib, "repro_ssd_bwd_state_wgmma", [P] * 6 + [I32] * 6 + [P] * 3),
            "chunk_wgmma": bind(lib, "repro_ssd_bwd_chunk_wgmma",
                                [P] * 7 + [I32] * 7 + [P] * 5),
            "sum": bind(lib, "repro_ssd_bwd_sum", [P] * 2 + [I32] * 6 + [P] * 3)}


def require_aligned(**tensors: torch.Tensor) -> None:
    """Raise, naming the tensor, where one of ``tensors`` (the operands a
    tensor-core kernel loads by TMA) does not start on a 16-byte boundary;
    the route's row strides are multiples of 16 bytes by its sizes."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: its data must start on a 16-byte boundary for TMA, "
                             f"at {t.data_ptr():#x}")


def _bwd_checked(x, log_a, b, c, chunk, dy, dh):
    """Raise on what the backward kernels do not take → (the route of
    :func:`bwd_route`, dtype code, shape arguments (batch, S, H, P, N, L))."""
    if x.dim() != 4 or log_a.dim() != 3 or b.dim() != 3 or c.dim() != 3:
        raise ValueError(f"ssd_chunk_scan_bwd: unsupported ranks x {tuple(x.shape)}, "
                         f"log_a {tuple(log_a.shape)}, b {tuple(b.shape)}")
    bt, S, H, Pd = x.shape
    N, L = b.shape[-1], int(chunk)
    if (log_a.shape != (bt, S, H) or b.shape != (bt, S, N) or c.shape != b.shape
            or dy.shape != x.shape or (dh is not None and dh.shape != (bt, H, N, Pd))
            or not 0 < L <= BWD_MAX_L or S % L or not 0 < N <= BWD_MAX_N
            or not 0 < Pd <= BWD_MAX_P):
        raise ValueError(f"ssd_chunk_scan_bwd: unsupported shapes x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}, chunk {L}, dy {tuple(dy.shape)}, dh "
                         f"{None if dh is None else tuple(dh.shape)} (L <= {BWD_MAX_L}, "
                         f"N <= {BWD_MAX_N}, P <= {BWD_MAX_P})")
    dt = x.dtype
    if dt not in DTYPES:
        raise TypeError(f"ssd_chunk_scan_bwd: unsupported type {dt}")
    route = bwd_route(dt, L, N, Pd)
    if route == "wgmma":
        require_aligned(x=x, b=b, c=c, dy=dy)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan_bwd: unsupported device {x.device}")
    dev = x.device
    require(x, "x", None, 4)
    require(log_a, "log_a", torch.float32, 3, dev)
    require(b, "b", dt, 3, dev)
    require(c, "c", dt, 3, dev)
    require(dy, "dy", dt, 4, dev)
    if dh is not None:
        require(dh, "dh", torch.float32, 4, dev)
    return route, DTYPES[dt], (bt, S, H, Pd, N, L)


def _states(x, log_a, b, c, dy, dh, route, code, shape):
    """One launch of the state kernel of ``route`` on inputs
    :func:`_bwd_checked` took (its ``route``, ``code`` and ``shape``) →
    (h_in, g)."""
    bt, S, H, Pd, N, L = shape
    hin = torch.empty((bt, S // L, H, N, Pd), dtype=torch.float32, device=x.device)
    g = torch.empty_like(hin)
    ptrs = (x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
            0 if dh is None else dh.data_ptr())
    out = (hin.data_ptr(), g.data_ptr(), stream_ptr(x.device))
    with on_device(x.device):
        if route == "wgmma":
            check_launch("ssd_chunk_scan_bwd_state_wgmma",
                         _bwd_fns()["state_wgmma"](*ptrs, *shape, *out))
            launches_bwd_state_wgmma.add()
        else:
            check_launch("ssd_chunk_scan_bwd_state",
                         _bwd_fns()["state"](*ptrs, *shape, code, *out))
            launches_bwd_state.add()
    return hin, g


def ssd_bwd_states(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   chunk: int, dy: torch.Tensor, dh: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the state kernel :func:`bwd_route` names on CUDA
    tensors → (h_in, g) as :func:`ssd_bwd_states_plain`, float32."""
    return _states(x, log_a, b, c, dy, dh, *_bwd_checked(x, log_a, b, c, chunk, dy, dh))


def ssd_chunk_scan_bwd(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                       chunk: int, dy: torch.Tensor, dh: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient on CUDA tensors, three launches → (dx, dlog_a, db, dc) as
    :func:`ssd_chunk_scan_bwd_plain`: the state kernel (:func:`ssd_bwd_states`)
    writes h_in and g; the chunk kernel dx, dlog_a and each head's terms of
    db and dc (batch, S / L, H, L, N) float32; ``ssd_bwd_sum`` db and dc.
    The first two are those :func:`bwd_route` names; the tensor-core route
    needs x, b, c and dy on 16-byte boundaries.  Takes L <= 128, N <= 256,
    P <= 128, float32 or bf16; raises on anything else, and on a failed
    build or launch (no other route is tried)."""
    route, code, shape = _bwd_checked(x, log_a, b, c, chunk, dy, dh)
    hin, g = _states(x, log_a, b, c, dy, dh, route, code, shape)
    bt, S, H, Pd, N, L = shape
    dbp = torch.empty((bt, S // L, H, L, N), dtype=torch.float32, device=x.device)
    dcp = torch.empty_like(dbp)
    dx = torch.empty_like(x)
    dla = torch.empty((bt, S, H), dtype=torch.float32, device=x.device)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    fns = _bwd_fns()
    ins = (x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
           hin.data_ptr(), g.data_ptr())
    with on_device(x.device):
        stream = stream_ptr(x.device)
        out = (dx.data_ptr(), dla.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), stream)
        if route == "wgmma":
            G = heads_per_block(bt, S // L, H, _sm_count(x.device.index))
            check_launch("ssd_chunk_scan_bwd_chunk_wgmma",
                         fns["chunk_wgmma"](*ins, *shape, G, *out))
            launches_bwd_chunk_wgmma.add()
        else:
            check_launch("ssd_chunk_scan_bwd_chunk", fns["chunk"](*ins, *shape, code, *out))
            launches_bwd_chunk.add()
        check_launch("ssd_chunk_scan_bwd_sum", fns["sum"](
            dbp.data_ptr(), dcp.data_ptr(), bt, S, H, N, L, code, db.data_ptr(), dc.data_ptr(),
            stream))
        launches_bwd_sum.add()
    return dx, dla, db, dc


class SSDChunkScan(torch.autograd.Function):
    """The kernels as an autograd Function: the forward launches what a call
    that needs no gradient launches, and saves x, log_a, b and c alone; the
    backward recomputes the states in :func:`ssd_chunk_scan_bwd`'s three
    launches.  A gradient that is not given (h_final unused) counts as 0."""

    @staticmethod
    def forward(ctx, x, log_a, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, log_a, b, c)
        if scan_route(chunk, b.shape[-1]) == "recur":
            return ssd_chunk_recur(x, log_a, b, c)
        y_intra, state = ssd_chunk_intra(x, log_a, b, c, chunk)
        return ssd_chunk_inter(y_intra, state, log_a, c)

    @staticmethod
    def backward(ctx, dy, dh):
        x, log_a, b, c = ctx.saved_tensors
        charge_bwd(x, b.shape[-1], ctx.chunk, dh is not None)  # under launch.roofline.count()
        with roofline.uncounted():
            dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
            if dy.data_ptr() % 16:  # an aligned copy for the TMA loads
                dy = dy.clone()
            dx, dla, db, dc = ssd_chunk_scan_bwd(x, log_a, b, c, ctx.chunk, dy,
                                                 None if dh is None else dh.float().contiguous())
        return dx, dla, db, dc, None


def ssd_chunk_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (y, h_final) as :func:`ssd_chunk_scan_plain`.  CPU tensors take the
    plain version (autograd differentiates it); CUDA tensors go through
    :class:`SSDChunkScan`: ``ssd_recur`` once where :func:`scan_route` says
    ``"recur"``, else one kernel for each step, and the backward kernels (or
    raise)."""
    if x.device.type == "cpu":
        return ssd_chunk_scan_plain(x, log_a, b, c, chunk)
    return SSDChunkScan.apply(x, log_a, b, c, int(chunk))


def ssd_chunk_intra(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 1 on CUDA tensors: one launch of the kernel :func:`ssd_route`
    names → (y_intra, chunk states) as :func:`ssd_chunk_intra_plain`."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_scan: unsupported device {x.device}")
    dev = x.device
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_chunk_scan: unsupported type {x.dtype}")
    require(x, "x", None, 4)
    require(log_a, "log_a", torch.float32, 3, dev)
    require(b, "b", x.dtype, 3, dev)
    require(c, "c", x.dtype, 3, dev)
    bt, S, H, Pd = x.shape
    N, L = b.shape[-1], int(chunk)
    if (log_a.shape != (bt, S, H) or b.shape != (bt, S, N) or c.shape != b.shape
            or L <= 0 or S % L):
        raise ValueError(f"ssd_chunk_scan: unsupported shapes x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}, chunk {L}")
    y = torch.empty_like(x)
    state = torch.empty((bt, S // L, H, N, Pd), dtype=torch.float32, device=dev)
    ptrs = (x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr())
    out = (y.data_ptr(), state.data_ptr(), stream_ptr(dev))
    route = ssd_route(x.dtype, L, N, Pd)
    if route == "wgmma":
        # its TMA maps need x, b and c on 16-byte boundaries, or the launch fails
        G = heads_per_block(bt, S // L, H, _sm_count(dev.index))
        with on_device(dev):
            check_launch("ssd_chunk_scan_wgmma",
                         _fns()["wgmma"](*ptrs, bt, S, H, Pd, N, L, G, *out))
        launches_wgmma.add()
    elif route == "short":
        G = short_heads(bt, S // L, H, L, N, Pd, _sm_count(dev.index))
        with on_device(dev):
            check_launch("ssd_chunk_scan_short",
                         _fns()["short"](*ptrs, bt, S, H, Pd, N, L, DTYPES[x.dtype], G, *out))
        launches_short.add()
    else:
        with on_device(dev):
            check_launch("ssd_chunk_scan",
                         _fns()["cells"](*ptrs, bt, S, H, Pd, N, L, DTYPES[x.dtype], *out))
        launches_cells.add()
    launches.add()
    return y, state
