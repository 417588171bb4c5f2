"""Blocked online-softmax attention (FlashAttention) with GQA, causal and
sliding-window masks and a query offset, forward and backward.

``flash_attention(q, k, v, causal, window, scale, q_offset)`` over q (B, Hq,
Sq, D) and k, v (B, Hkv, Skv, D) returns o (B, Hq, Sq, D) in q's type, as
the reference's Pallas kernel (src/repro/kernels/flash_attention.py) does:
q-head h reads kv-head h // (Hq / Hkv), q is cast to float32 and scaled by
``scale`` (default D^-0.5) before the product, and key j is visible from
query row i when j <= i + q_offset (causal) and j > i + q_offset - window.
The reference's tiling contract holds: ``Sq % min(128, Sq) == 0`` and
``Skv % min(128, Skv) == 0``, else ValueError.

For CUDA tensors the wrapper is a :class:`torch.autograd.Function` over the
kernels of ``csrc/flash_attention.cu``: the forward (one launch per call; it
also writes the per-row log-sum-exp and, for bf16 inputs that need a
gradient, O in float32), and a backward of two launches, dQ (which also
computes Δ = rowsum(dO ∘ O) from the float32 O) then dK/dV (which sums each
GQA group inside one block).  The backward is deterministic: no atomics, one
summation order.  For CPU tensors the wrapper runs
:func:`flash_attention_plain`, whose gradient is PyTorch's autograd.

The forward has two kernels, chosen by :func:`forward_route` from the type
and the head width alone: bf16 with D % 8 == 0 takes ``attn_fwd_wgmma``
(TMA loads, bf16 products on the tensor cores, P rounded to bf16 before
P·V, float32 accumulators); float32, and bf16 of another width, take
``attn_fwd`` (IEEE float32 FMA, never TF32).  ``launches`` counts every
forward launch, ``launches_wgmma`` those of the tensor-core kernel.  The
backward follows the same rule (:func:`backward_route`): bf16 with D % 8 ==
0 takes ``attn_bwd_dq_wgmma`` and ``attn_bwd_dkdv_wgmma`` (P and dS rounded
to bf16 before their products, float32 accumulators), the rest the FMA
kernels; ``launches_dq`` and ``launches_dkdv`` count every backward launch,
``launches_dq_wgmma`` and ``launches_dkdv_wgmma`` the tensor-core ones.

The plain versions mirror the reference's two oracles: :func:`attention_ref`
(``ref.attention_ref``: −inf mask fill, one softmax) and
:func:`flash_attention_plain` (``ref.attention_xla_chunked``: −1e30 fill,
query blocks of 512, which is what the reference's ``ops.attention`` runs
off the TPU).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import _build
from ..launch import roofline
from ._launch import (F32, I32, P, LaunchCounter, bind, check_launch, on_device, require,
                      stream_ptr)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK = 128  # the reference's block size, which sets the tiling contract
MAX_D = 256  # RecurrentGemma's local attention (head dim 256) is the widest
NEG_FILL = -1e30

launches = LaunchCounter("flash_attention")
launches_wgmma = LaunchCounter("flash_attention_wgmma")
launches_dq = LaunchCounter("flash_attention_bwd_dq")
launches_dkdv = LaunchCounter("flash_attention_bwd_dkdv")
launches_dq_wgmma = LaunchCounter("flash_attention_bwd_dq_wgmma")
launches_dkdv_wgmma = LaunchCounter("flash_attention_bwd_dkdv_wgmma")


def _dims(q: torch.Tensor, k: torch.Tensor, scale: Optional[float]):
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_attention: GQA needs Hq % Hkv == 0, got {Hq} % {Hkv}")
    return B, Hq, Hkv, Sq, Skv, D, (scale if scale is not None else D ** -0.5)


def _mask(Sq: int, Skv: int, causal: bool, window: Optional[int], q_offset: int,
          device) -> torch.Tensor:
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """The oracle (``ref.attention_ref``): float32 logits, hidden entries
    −inf, one softmax over all keys, output in q's type."""
    B, Hq, Hkv, Sq, Skv, D, scale = _dims(q, k, scale)
    group = Hq // Hkv
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    mask = _mask(Sq, Skv, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


def flash_attention_plain(q, k, v, causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None, q_offset: int = 0,
                          block_q: int = 512) -> torch.Tensor:
    """``ref.attention_xla_chunked`` in torch ops: up to ``block_q`` query
    rows, :func:`attention_ref`; beyond, query blocks of ``block_q`` (halved
    until it divides Sq), hidden entries −1e30."""
    B, Hq, Hkv, Sq, Skv, D, scale = _dims(q, k, scale)
    if Sq <= block_q:
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                             q_offset=q_offset)
    while Sq % block_q:
        block_q //= 2
    group = Hq // Hkv
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    outs = []
    for i in range(Sq // block_q):
        qf = q[:, :, i * block_q:(i + 1) * block_q].float() * scale
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
        mask = _mask(block_q, Skv, causal, window, q_offset + i * block_q, q.device)
        logits = torch.where(mask, logits, NEG_FILL)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype))
    return torch.cat(outs, dim=2)


def check_tiling(Sq: int, Skv: int) -> None:
    """The reference's contract: each sequence length tiles by min(128, S)."""
    if Sq % min(BLOCK, Sq) or Skv % min(BLOCK, Skv):
        raise ValueError(f"flash_attention: seq lens must tile: {Sq} % {min(BLOCK, Sq)}, "
                         f"{Skv} % {min(BLOCK, Skv)}")


# ------------------------------------------------------------------ kernels --


@functools.lru_cache(maxsize=None)
def _fns():
    lib = _build.load("flash_attention")
    mask = [I32, I32, I32, I32, I32, I32, F32, I32, I32, I32, I32]  # B..D, scale, masks, dtype
    return (bind(lib, "repro_flash_fwd", [P, P, P, *mask, P, P, P, P]),
            bind(lib, "repro_flash_bwd_dq", [P, P, P, P, P, P, *mask, P, P, P]),
            bind(lib, "repro_flash_bwd_dkdv", [P, P, P, P, P, P, *mask, P, P, P]),
            bind(lib, "repro_flash_fwd_wgmma", [P, P, P, *mask, P, P, P, P]),
            bind(lib, "repro_flash_bwd_dq_wgmma", [P, P, P, P, P, P, *mask, P, P, P]),
            bind(lib, "repro_flash_bwd_dkdv_wgmma", [P, P, P, P, P, P, *mask, P, P, P]))


def forward_route(dtype: torch.dtype, D: int) -> str:
    """The forward kernel for a type and head width: ``"wgmma"`` for bf16
    with D % 8 == 0 (TMA needs 16-byte row strides), ``"fma"`` for float32
    and any other bf16 width; raises for D > 256 or another type."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: unsupported type {dtype}")
    if not 0 < D <= MAX_D:
        raise ValueError(f"flash_attention: head dim {D} not in 1..{MAX_D}")
    return "wgmma" if dtype == torch.bfloat16 and D % 8 == 0 else "fma"


def backward_route(dtype: torch.dtype, D: int) -> str:
    """The backward kernels (dQ and dK/dV) for a type and head width, by the
    rule of :func:`forward_route`: ``"wgmma"`` for bf16 with D % 8 == 0,
    ``"fma"`` for float32 (IEEE, never TF32) and other bf16 widths.  At D >
    128 the tensor-core kernels split the gradient's columns in halves over
    their two consumer warpgroups and the FMA kernels stage kv tiles of 32
    keys; the route names the same kernels."""
    return forward_route(dtype, D)


def _check_inputs(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: unsupported type {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        require(t, name, q.dtype, 4, q.device)
    if (k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or q.shape[3] > MAX_D):
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (head dim <= {MAX_D})")


def _mask_args(q, k, causal, window, scale, q_offset):
    B, Hq, Hkv, Sq, Skv, D, scale = _dims(q, k, scale)
    return [B, Hq, Hkv, Sq, Skv, D, float(scale), int(bool(causal)),
            0 if window is None else int(window), int(q_offset), DTYPES[q.dtype]]


def flash_forward(q, k, v, causal=True, window=None, scale=None, q_offset=0,
                  keep_f32: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                                    torch.Tensor]:
    """One forward launch on CUDA tensors, on the kernel
    :func:`forward_route` picks → (o in q's type, o in float32 if
    ``keep_f32`` and q is bf16 else None, log-sum-exp f32 (B, Hq, Sq))."""
    _check_inputs(q, k, v)
    wgmma = forward_route(q.dtype, q.shape[3]) == "wgmma"
    o = torch.empty_like(q)
    o32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
           if keep_f32 and q.dtype != torch.float32 else None)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with on_device(q.device):
        err = _fns()[3 if wgmma else 0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        *_mask_args(q, k, causal, window, scale, q_offset),
                                        o.data_ptr(), 0 if o32 is None else o32.data_ptr(),
                                        lse.data_ptr(), stream_ptr(q.device))
    check_launch("flash_attention_wgmma" if wgmma else "flash_attention", err)
    launches.add()
    if wgmma:
        launches_wgmma.add()
    return o, o32, lse


def backward_dq(q, k, v, o32, lse, do, causal=True, window=None, scale=None, q_offset=0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dQ launch on CUDA tensors, on the kernel :func:`backward_route`
    picks → (dq in q's type, Δ = rowsum(dO ∘ O) float32 (B, Hq, Sq));
    ``o32`` is the forward's output in float32."""
    _check_inputs(q, k, v)
    require(o32, "o", torch.float32, 4, q.device)
    require(lse, "lse", torch.float32, 3, q.device)
    require(do, "do", q.dtype, 4, q.device)
    if o32.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError("flash_attention backward: o, do and lse must match q")
    wgmma = backward_route(q.dtype, q.shape[3]) == "wgmma"
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    with on_device(q.device):
        err = _fns()[4 if wgmma else 1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        o32.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                        *_mask_args(q, k, causal, window, scale, q_offset),
                                        delta.data_ptr(), dq.data_ptr(), stream_ptr(q.device))
    check_launch("flash_attention_bwd_dq_wgmma" if wgmma else "flash_attention_bwd_dq", err)
    launches_dq.add()
    if wgmma:
        launches_dq_wgmma.add()
    return dq, delta


def backward_dkdv(q, k, v, lse, delta, do, causal=True, window=None, scale=None, q_offset=0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV launch on CUDA tensors, on the kernel :func:`backward_route`
    picks → (dk, dv) in k's type; ``delta`` from :func:`backward_dq`."""
    _check_inputs(q, k, v)
    require(lse, "lse", torch.float32, 3, q.device)
    require(delta, "delta", torch.float32, 3, q.device)
    require(do, "do", q.dtype, 4, q.device)
    if do.shape != q.shape or lse.shape != q.shape[:3] or delta.shape != lse.shape:
        raise ValueError("flash_attention backward: do, lse and delta must match q")
    wgmma = backward_route(q.dtype, q.shape[3]) == "wgmma"
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with on_device(q.device):
        err = _fns()[5 if wgmma else 2](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                        *_mask_args(q, k, causal, window, scale, q_offset),
                                        dk.data_ptr(), dv.data_ptr(), stream_ptr(q.device))
    check_launch("flash_attention_bwd_dkdv_wgmma" if wgmma else "flash_attention_bwd_dkdv",
                 err)
    launches_dkdv.add()
    if wgmma:
        launches_dkdv_wgmma.add()
    return dk, dv


def flash_backward(q, k, v, o32, lse, do, causal=True, window=None, scale=None,
                   q_offset=0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two backward launches, dQ then dK/dV → (dq, dk, dv)."""
    mask = (causal, window, scale, q_offset)
    dq, delta = backward_dq(q, k, v, o32, lse, do, *mask)
    dk, dv = backward_dkdv(q, k, v, lse, delta, do, *mask)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernels as an autograd Function: saves q, k, v, the float32 O and
    the log-sum-exp; the backward is the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        grad = any(ctx.needs_input_grad[:3])
        o, o32, lse = flash_forward(q, k, v, causal, window, scale, q_offset, keep_f32=grad)
        ctx.save_for_backward(q, k, v, o if o32 is None else o32, lse)
        ctx.mask = (causal, window, scale, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        causal, window, _, q_offset = ctx.mask
        work = roofline.attention_work(roofline.attention_shape(q, k, causal, window, q_offset))
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
            roofline.charge(name, work[name])  # under launch.roofline.count()
        with roofline.uncounted():
            dq, dk, dv = flash_backward(q, k, v, o32, lse, do.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, q_offset: int = 0) -> torch.Tensor:
    """→ o as :func:`flash_attention_plain`, under the tiling contract.  CPU
    tensors take the plain version; CUDA tensors the kernels (or raise)."""
    check_tiling(q.shape[2], k.shape[2])
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, scale, q_offset)
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                                window, scale, q_offset)
