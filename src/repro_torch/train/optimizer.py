"""AdamW over a tree of tensors, as the reference writes it, plus the int8
error-feedback gradient compression helpers:

* linear warmup + cosine ``lr_at``, b2 = 0.95, decoupled weight decay on
  leaves of two or more dimensions only (``torch.optim.AdamW`` would decay
  every leaf), global-norm clipping;
* **int8 error-feedback compression**: quantise per tensor to int8 with one
  scale, dequantise, and carry the quantisation error into the next step's
  gradient (Karimireddy et al. 2019).  The train step quantises the mean
  gradient (``compress_with_feedback``), as the reference's step does;
  ``compressed_psum`` is the reference's exchange across data shards
  itself, run single-controller over a list of the shards' gradients.

Master weights are float32; the moments are float32.  Trees are nested dicts
of tensors (``LM.tree()``), walked in sorted-key order as JAX flattens them.
A leaf of a train state placed over a mesh's data rows (``fsdp.Sliced``)
is updated part by part where each part lies (the arithmetic is
elementwise); a leaf held whole on every row is updated on the first row
and copied to the others.  The global norm and the compression's scale
read each leaf whole (the norm a layer at a time past ``NORM_WHOLE_MAX``
elements), so both take the same bits in every layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..models.base import tree_flatten, tree_map, tree_unflatten
from ..models.fsdp import Sliced


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
        if isinstance(p, Sliced):
            return p.like()
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=tree_flatten(params)[0][1].device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params), "step": step}


# A sliced leaf of more elements is not gathered whole for the global norm
# (qwen3_moe_30b_a3b's stacked experts at 24 layers, 4.8e9 elements, would
# take 19.3 GB on a card that holds its share of the state).
NORM_WHOLE_MAX = 1 << 31


def global_norm(grads) -> torch.Tensor:
    """sqrt(Σ over leaves in order of Σ g²), float32.  A sliced leaf is
    gathered whole onto its first device, one leaf at a time, and squared
    there in place: a sum over its slices would round otherwise, so the
    norm takes the same bits whatever the layout.  A stacked leaf of more
    than ``NORM_WHOLE_MAX`` elements is gathered a layer at a time instead,
    its layers' sums added in layer order: still the same bits in every
    layout, within float32 rounding (1e-6 relative) of the whole sum."""
    gsq = 0
    for _, g in tree_flatten(grads):
        if not isinstance(g, Sliced):
            gsq = gsq + torch.sum(torch.square(g.float()))
            continue
        first = g.devices[0][0]
        if g.numel() <= NORM_WHOLE_MAX or 0 in (g.dim, g.tp_dim):
            gsq = gsq + torch.sum(g.whole(first).square_())
            continue
        layers = 0
        for i in range(g.shape[0]):
            layers = layers + torch.sum(g.whole(first, layer=i).square_())
        gsq = gsq + layers
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
    scalars = {}  # (clip, lr, bc1, bc2) on each device a part lies on

    def on(dev):
        if dev not in scalars:
            scalars[dev] = tuple(t.to(dev) for t in (clip, lr, bc1, bc2))
        return scalars[dev]

    def upd_slice(p, g, mu, nu, decay: bool, clip, lr, bc1, bc2):
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

    def upd_tensor(p, g, mu, nu):
        decay = p.dim() >= 2  # decoupled weight decay on matrices only
        flat = (p.detach().view(-1), g.reshape(-1), mu.view(-1), nu.view(-1))
        consts = on(p.device)
        with torch.no_grad():
            for a in range(0, flat[0].numel(), UPDATE_SLICE):
                upd_slice(*(t[a:a + UPDATE_SLICE] for t in flat), decay, *consts)

    def upd(p, g, mu, nu):
        if not isinstance(p, Sliced):
            upd_tensor(p, g, mu, nu)
            return p, mu, nu
        for r in range(g.rows):  # one row where the leaf is whole on every row
            for s in range(g.shards):
                upd_tensor(p.parts[r][s], g.parts[r][s], mu.parts[r][s], nu.parts[r][s])
        with torch.no_grad():
            for r in range(g.rows, p.rows):
                for t in (p, mu, nu):
                    for dst, src in zip(t.parts[r], t.parts[0]):
                        dst.copy_(src)
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


def quantize_int8(g: torch.Tensor, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (g in int8 steps of ``scale``, the scale: by default g's largest
    |value| over 127)."""
    if scale is None:
        scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(g, err):
    """→ (the dequantised gradient with the carried error, the new error).
    Sliced leaves: the scale is the largest |value| over the slices (a
    maximum, so the same bits as the whole leaf's); the rest is
    elementwise, slice by slice; the new error goes to every row's copy of
    a leaf held whole on every row."""
    if not isinstance(g, Sliced):
        g_ef = g.float() + err
        deq = dequantize_int8(*quantize_int8(g_ef))
        return deq, g_ef - deq
    first = g.devices[0][0]
    g_efs = [[gp.float() + ep for gp, ep in zip(g.parts[r], err.parts[r])]
             for r in range(g.rows)]
    amax = None
    for row in g_efs:
        for x in row:
            m = torch.max(torch.abs(x)).to(first)
            amax = m if amax is None else torch.maximum(amax, m)
    scale = amax / 127.0 + 1e-12
    deq = Sliced(g.shape, g.dim, g.tp_dim, [], g.devices)
    new_err = Sliced(err.shape, err.dim, err.tp_dim, [], err.devices)
    for row in g_efs:
        d_row = []
        for x in row:
            d_row.append(dequantize_int8(*quantize_int8(x, scale.to(x.device))))
        deq.parts.append(d_row)
        new_err.parts.append([x - d for x, d in zip(row, d_row)])
    for r in range(g.rows, err.rows):
        new_err.parts.append([e.to(d, copy=True) for e, d in zip(new_err.parts[0],
                                                                 err.devices[r])])
    return deq, new_err


def init_error_state(params):
    return tree_map(lambda p: p.like() if isinstance(p, Sliced) else
                    torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compressed_psum(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The reference's error-feedback int8 all-reduce over data shards,
    shard ``i`` holding ``gs[i]`` and its carried error ``errs[i]`` → (the
    mean gradient, float32, on the first shard's device; each shard's new
    error, on its device).  Each shard quantises its gradient with its
    error; the scale shared is the largest shard's; each requantises
    against it, and the int32 payloads add in shard order before the
    division by the shard count."""
    first = gs[0].device
    g_efs, new_errs, scales = [], [], []
    for g, e in zip(gs, errs):
        g_ef = g.float() + e
        q, scale = quantize_int8(g_ef)
        new_errs.append(g_ef - dequantize_int8(q, scale))
        g_efs.append(g_ef)
        scales.append(scale.to(first))
    scale_max = scales[0]
    for sc in scales[1:]:
        scale_max = torch.maximum(scale_max, sc)
    total = None
    for g_ef in g_efs:
        q2 = torch.clamp(torch.round(g_ef / scale_max.to(g_ef.device)), -127, 127)
        q2 = q2.to(torch.int32).to(first)
        total = q2 if total is None else total + q2
    n = torch.tensor(float(len(gs)), dtype=torch.float32, device=first)
    return total.float() * scale_max / n, new_errs
