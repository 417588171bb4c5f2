"""AdamW over a tree of tensors, as the reference writes it, plus the int8
error-feedback gradient compression helpers:

* linear warmup + cosine ``lr_at``, b2 = 0.95, decoupled weight decay on
  leaves of two or more dimensions only (``torch.optim.AdamW`` would decay
  every leaf), global-norm clipping;
* **int8 error-feedback compression**: quantise per tensor to int8 with one
  scale, dequantise, and carry the quantisation error into the next step's
  gradient (Karimireddy et al. 2019).  On one device the exchange itself is
  the identity; the quantise → dequantise and the carried error are what the
  step sees.

Master weights are float32; the moments are float32.  Trees are nested dicts
of tensors (``LM.tree()``), walked in sorted-key order as JAX flattens them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.base import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay; ``step`` an integer tensor → float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=tree_flatten(params)[0][1].device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params), "step": step}


def global_norm(grads) -> torch.Tensor:
    """sqrt(Σ over leaves in order of Σ g²), float32."""
    gsq = 0
    for _, g in tree_flatten(grads):
        gsq = gsq + torch.sum(torch.square(g.float()))
    return torch.sqrt(gsq)


UPDATE_SLICE = 1 << 24  # elements of a leaf updated at a time


def adamw_update(cfg: AdamWConfig, params, grads, state
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step → (params, new state, {"grad_norm", "lr"}).  The
    reference returns new trees; here each leaf's new param (in its storage
    type) and moments overwrite the given tensors as soon as they are
    computed, slice by slice of ``UPDATE_SLICE`` elements (the arithmetic
    is elementwise), and the trees returned hold those tensors, so a step
    holds one copy of the weights and moments and one slice's temporaries
    (a leaf's would be 20 GB beside granite-MoE's 4 GB expert leaves).
    Gradients are clipped by the global norm's scale, the reference's
    arithmetic."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = 1 - b1 ** step.float(), 1 - b2 ** step.float()

    def upd_slice(p, g, mu, nu, decay: bool):
        g = g.float() * clip
        new_mu = b1 * mu + (1 - b1) * g
        new_nu = b2 * nu + (1 - b2) * g * g
        delta = (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + cfg.eps)
        pf = p.float()
        if decay:
            pf = pf * (1 - lr * cfg.weight_decay)
        p.copy_(pf - lr * delta)
        mu.copy_(new_mu)
        nu.copy_(new_nu)

    def upd(p, g, mu, nu):
        decay = p.dim() >= 2  # decoupled weight decay on matrices only
        flat = (p.detach().view(-1), g.reshape(-1), mu.view(-1), nu.view(-1))
        with torch.no_grad():
            for a in range(0, flat[0].numel(), UPDATE_SLICE):
                upd_slice(*(t[a:a + UPDATE_SLICE] for t in flat), decay)
        return p, mu, nu

    flat = tree_flatten(params)
    paths = [path for path, _ in flat]
    out = [upd(p, g, m, n) for (_, p), (_, g), (_, m), (_, n)
           in zip(flat, tree_flatten(grads), tree_flatten(state["mu"]),
                  tree_flatten(state["nu"]))]
    new_p = tree_unflatten(paths, [o[0] for o in out])
    new_state = {"mu": tree_unflatten(paths, [o[1] for o in out]),
                 "nu": tree_unflatten(paths, [o[2] for o in out]), "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------- compression --


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (the dequantised gradient with the carried error, the new error)."""
    g_ef = g.float() + err
    deq = dequantize_int8(*quantize_int8(g_ef))
    return deq, g_ef - deq


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
