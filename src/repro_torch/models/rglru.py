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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .base import ParamSpec, ShardCtx, matrix_spec, replicated_spec
from .layers import _gelu


def rglru_spec(cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, ParamSpec]:
    """The projections are cast to the compute type where they are used; the
    conv, Λ and the two gate matrices are used in float32 and stay so."""
    r = cfg.rglru
    d, w = cfg.d_model, r.lru_width
    return {
        "in_proj": matrix_spec(ctx, (d, 2 * w)),  # (x, gate)
        "conv_w": replicated_spec((r.conv_width, w), "normal:0.1"),
        "conv_b": replicated_spec((w,), "zeros"),
        "lambda_p": replicated_spec((w,), "normal:0.5"),
        "w_rec_gate": replicated_spec((w, w), "normal:0.01"),
        "w_in_gate": replicated_spec((w, w), "normal:0.01"),
        "out_proj": matrix_spec(ctx, (w, d)),
    }


@dataclass
class RGLRUCache:
    h: torch.Tensor  # (B, W) recurrent state, float32
    conv: torch.Tensor  # (B, cw-1, W) conv tail, float32
    pos: torch.Tensor  # scalar int32

    def tensors(self):
        return (self.h, self.conv, self.pos)


def init_rglru_cache(cfg: ModelConfig, batch: int, device) -> RGLRUCache:
    r = cfg.rglru
    return RGLRUCache(
        h=torch.zeros((batch, r.lru_width), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, r.conv_width - 1, r.lru_width), dtype=torch.float32,
                         device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


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
    proj = x @ params["in_proj"].to(dt)  # (B, S, 2W)
    u, gate = torch.chunk(proj, 2, dim=-1)

    # causal depthwise conv1d on the recurrent branch; the float32 weights
    # promote the product to float32, as in the reference
    W = r.conv_width
    if cache is None:
        padded = F.pad(u, (0, 0, W - 1, 0))
        new_conv = None
    else:
        padded = torch.cat([cache.conv.to(dt), u], dim=1)
        new_conv = padded[:, -(W - 1):, :].float()
    u = sum(padded[:, i:i + S, :] * params["conv_w"][i][None, None, :]
            for i in range(W)) + params["conv_b"]

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
    elif S == 1:
        h_new = torch.exp(log_a[:, 0]) * cache.h + scaled_in[:, 0]
        h = h_new[:, None, :]
        new_cache = RGLRUCache(h=h_new, conv=new_conv, pos=cache.pos + S)
    else:
        h, h_last = _lru_scan(log_a, scaled_in, cache.h)
        new_cache = RGLRUCache(h=h_last, conv=new_conv, pos=cache.pos + S)

    out = h.to(dt) * _gelu(gate.float()).to(dt)
    return out @ params["out_proj"].to(dt), new_cache
