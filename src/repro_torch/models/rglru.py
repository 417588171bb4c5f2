"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

    r_t = σ(W_r x_t),  i_t = σ(W_i x_t)
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

Block structure: in_proj → conv1d (width 4) → RG-LRU → gate ⊙ → out_proj.

The reference runs the diagonal recurrence as ``jax.lax.associative_scan``
(plain XLA, no Pallas kernel).  Here it is a log-step (Hillis-Steele) scan
over the sequence in torch ops: ⌈log2 S⌉ steps, each combining every
position with the one ``off`` before it, from the previous step's tensors;
autograd differentiates it as it is.  Decode (S == 1) is the one-step
update.  The gates' float32 products must be IEEE float32 on the card,
never TF32.

Under tensor parallelism (``models/tp.py``) ``in_proj`` is held in column
slices and ``out_proj`` in row slices over the shards, as the reference
places them; the projected columns join on the row's first device, where
the conv, both gates (``w_rec_gate`` and ``w_in_gate`` stay whole, as the
reference keeps them), the scan and the gating run whole.  With x in
sequence slices (``tp.SeqSlices``) ``in_proj`` takes the sequence gathered
whole onto each shard and ``out_proj``'s parts are reduce-scattered back
into slices.

A cache over a data row's model shards lies as the reference's
``make_cache_specs`` places it: the state and the conv tail by width.  The
block then computes where it lies: each shard runs the depthwise conv on
its channels against its tail (its channels of the input, weights and bias
in one move, ``tp.send``), the conv's output joins on the first device for
the two gates (whole matrices over the whole width), and each shard runs
the recurrence on its width with its state and gates it (its width of log
a, the scaled input and the gate in one move); with
``out_proj`` in row slices (its rows are the width) each shard multiplies
its own part, so no state is gathered.  Every op there acts per channel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import tp as TP
from .base import ParamSpec, ShardCtx, matrix_spec, replicated_spec
from .layers import _gelu, column_product, row_product


def rglru_spec(cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, ParamSpec]:
    """The projections are cast to the compute type where they are used; the
    conv, Λ and the two gate matrices are used in float32 and stay so."""
    r = cfg.rglru
    d, w = cfg.d_model, r.lru_width
    return {
        "in_proj": matrix_spec(ctx, (d, 2 * w), tp_dim=1, fsdp_dim=0),  # (x, gate)
        "conv_w": replicated_spec((r.conv_width, w), "normal:0.1"),
        "conv_b": replicated_spec((w,), "zeros"),
        "lambda_p": replicated_spec((w,), "normal:0.5"),
        "w_rec_gate": matrix_spec(ctx, (w, w), tp_dim=None, fsdp_dim=0, init="normal:0.01",
                                  at_use=False),
        "w_in_gate": matrix_spec(ctx, (w, w), tp_dim=None, fsdp_dim=0, init="normal:0.01",
                                 at_use=False),
        "out_proj": matrix_spec(ctx, (w, d), tp_dim=0, fsdp_dim=1),
    }


@dataclass
class RGLRUCache:
    """Over a data row's model shards (``lm.init_cache(mesh=...)``) ``h`` and
    ``conv`` are tuples of width slices, slice ``s`` on shard ``s``'s
    device, each where ``tp`` divides the width."""

    h: torch.Tensor  # (B, W) recurrent state, float32
    conv: torch.Tensor  # (B, cw-1, W) conv tail, float32
    pos: torch.Tensor  # scalar int32

    def tensors(self):
        return (*TP.parts_of(self.h), *TP.parts_of(self.conv), self.pos)


def init_rglru_cache(cfg: ModelConfig, batch: int, device) -> RGLRUCache:
    r = cfg.rglru
    return RGLRUCache(
        h=torch.zeros((batch, r.lru_width), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, r.conv_width - 1, r.lru_width), dtype=torch.float32,
                         device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def _conv(padded: torch.Tensor, w: torch.Tensor, b: torch.Tensor, S: int) -> torch.Tensor:
    """The causal depthwise conv over ``padded`` (B, W-1+S, C); the float32
    weights promote the product to float32, as in the reference."""
    return sum(padded[:, i:i + S, :] * w[i][None, None, :] for i in range(w.shape[0])) + b


def _lru_scan(log_a: torch.Tensor, u: torch.Tensor, h0: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(log_a_t)·h_{t-1} + u_t over S by a log-step scan.

    log_a, u: (B, S, W) float32; h0 (B, W) or None → (h (B, S, W), h_last
    (B, W)).  The initial state is folded into the first input, as in the
    reference."""
    if h0 is not None:
        u = torch.cat([u[:, :1] + torch.exp(log_a[:, :1]) * h0[:, None], u[:, 1:]], dim=1)
    la, h = log_a, u
    S, off = u.shape[1], 1
    while off < S:
        # position t takes (la, h) of t - off as the earlier element:
        # h_t += exp(la_t) h_{t-off}, la_t += la_{t-off}
        h = torch.cat([h[:, :off], h[:, off:] + torch.exp(la[:, off:]) * h[:, :-off]], dim=1)
        la = torch.cat([la[:, :off], la[:, off:] + la[:, :-off]], dim=1)
        off *= 2
    return h, h[:, -1]


def rglru_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, d)
    cache: Optional[RGLRUCache] = None,
) -> Tuple[torch.Tensor, Optional[RGLRUCache]]:
    r = cfg.rglru
    B, S, d = x.shape
    dt = x.dtype
    proj = column_product(x, params["in_proj"])  # (B, S, 2W)
    u, gate = torch.chunk(proj, 2, dim=-1)

    # causal depthwise conv1d on the recurrent branch
    W = r.conv_width
    if cache is None:
        u, new_conv = _conv(F.pad(u, (0, 0, W - 1, 0)), params["conv_w"], params["conv_b"], S), None
    elif isinstance(cache.conv, tuple):  # each shard its channels, against its tail
        devs = [t.device for t in cache.conv]
        outs, new_conv = [], []
        for tail, (u_s, w, b) in zip(cache.conv, TP.send(list(zip(*(
                t.chunk(len(devs), -1) for t in (u, params["conv_w"], params["conv_b"])))), devs)):
            padded = torch.cat([tail.to(dt), u_s], dim=1)
            new_conv.append(padded[:, -(W - 1):, :].float())
            outs.append(_conv(padded, w, b, S))
        u, new_conv = TP.join(outs, -1, x.device), tuple(new_conv)
    else:
        padded = torch.cat([cache.conv.to(dt), u], dim=1)
        new_conv = padded[:, -(W - 1):, :].float()
        u = _conv(padded, params["conv_w"], params["conv_b"], S)

    uf = u.float()
    if uf.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("rglru_block: the gates' float32 products would run in TF32; "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    rec_gate = torch.sigmoid(uf @ params["w_rec_gate"])
    in_gate = torch.sigmoid(uf @ params["w_in_gate"])
    log_lambda = -r.c_constant * F.softplus(params["lambda_p"])  # (W,) < 0
    log_a = log_lambda[None, None, :] * rec_gate  # (B, S, W)
    scaled_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-8)) * (
        in_gate * uf)

    if cache is None:
        h, _ = _lru_scan(log_a, scaled_in, None)
        new_cache = None
    elif isinstance(cache.h, tuple):  # each shard its width, with its state
        devs = [t.device for t in cache.h]
        n = len(devs)
        outs, h_new = [], []
        for h_s, (la_s, in_s, g_s) in zip(cache.h, TP.send(list(zip(*(t.chunk(n, -1) for t in (
                log_a, scaled_in, _gelu(gate.float()).to(dt))))), devs)):
            h, h_s = _recur(la_s, in_s, h_s)
            outs.append(h.to(dt) * g_s)
            h_new.append(h_s)
        new_cache = RGLRUCache(h=tuple(h_new), conv=new_conv, pos=cache.pos + S)
        w = params["out_proj"]
        if isinstance(w, tuple):  # its rows of out_proj are the shard's width
            return TP.collect([o @ t.to(dt) for o, t in zip(outs, w)], x), new_cache
        return TP.join(outs, -1, x.device) @ w.to(dt), new_cache
    else:
        h, h_last = _recur(log_a, scaled_in, cache.h)
        new_cache = RGLRUCache(h=h_last, conv=new_conv, pos=cache.pos + S)

    out = h.to(dt) * _gelu(gate.float()).to(dt)
    return row_product(out, params["out_proj"], like=x), new_cache


def _recur(log_a: torch.Tensor, u: torch.Tensor, h0: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence from the cached state ``h0`` (B, W): one step where S
    is 1, else the log-step scan → (h (B, S, W), h_last (B, W))."""
    if u.shape[1] == 1:
        h_new = torch.exp(log_a[:, 0]) * h0 + u[:, 0]
        return h_new[:, None, :], h_new
    return _lru_scan(log_a, u, h0)
