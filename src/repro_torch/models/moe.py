"""Mixture-of-Experts FFN: top-k routing with its two aux losses, then
sort-based capacity grouping and a grouped product over the experts.

The global path of the reference (``moe_ffn``), token for token: a router
in float32, top-k with the lower expert index first on ties, a stable sort
of the (token, expert) assignments by expert, each expert's first
``capacity`` assignments kept and the rest dropped, the kept tokens
gathered into an (experts, capacity, d) grid, the expert MLPs as batched
products (``torch.einsum``: the reference computes them outside any Pallas
kernel), and the weighted combine back to tokens.

The combine is deterministic: the reference adds each token's k expert
outputs into a zero row in the compute type, in ascending expert id (the
order of its stable sort).  ``index_add_`` on a CUDA bf16 tensor adds with
atomics in an order that changes from run to run, so here the k
contributions are un-permuted to (T, k, d), ordered by expert id, and added
one after the other from 0, rounding to the compute type after each add.

So is the backward.  The gather of each token into its k grid rows
(``_TokenGather``) would differentiate through ``index_put_(accumulate=True)``,
which on the card adds a token's up to k gradient rows in an order that may
change between runs; its backward adds them from 0 in ascending expert id,
as the combine does.  The gather of each assignment's grid row
(``_SlotGather``) writes its gradient rows without adding, the kept slots
being distinct.  Every other index on the path takes each index once per
row (the router's ``gather``, the combine's ``gather`` / ``index_copy``,
the weights' permutation), so its backward adds one value into each
element, in any order.

Expert parallelism (``moe_ffn_sharded``, ``moe_ffn_ep``) runs on a model
mesh (``launch/mesh.py``), single-controller: model shard ``s`` of a data
row holds experts ``[s·e_loc, (s+1)·e_loc)`` of the ``padded_experts(tp)``
on its own device, routes the row's tokens itself (the router is
replicated) at the row's capacity, and computes its experts' part of the
combine; the parts go to the row's first device and are added there in
shard order (the reference's ``psum`` over the model axis), and the aux
losses are averaged over the data rows in row order (its ``pmean``).  The
row's tokens and the router go out by ``tp.broadcast``, whose backward adds
the shards' gradients in shard order.
``moe_ffn`` at the same context, with no mesh, is the global semantics,
padded experts included.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import tp as TP
from .base import ParamSpec, ShardCtx, matrix_spec
from .layers import _gelu


def moe_spec(cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, ParamSpec]:
    """The router and the experts' weights; each is cast to the compute type
    where it is used, so serving stores it in that type."""
    assert cfg.moe is not None
    d = cfg.d_model
    e_pad = cfg.moe.padded_experts(ctx.tp)
    f = cfg.moe.d_ff_expert
    specs = {
        "router": matrix_spec(ctx, (d, e_pad), tp_dim=None, fsdp_dim=0, init="normal:0.01"),
        "w_up": matrix_spec(ctx, (e_pad, d, f), tp_dim=0, fsdp_dim=1),
        "w_down": matrix_spec(ctx, (e_pad, f, d), tp_dim=0, fsdp_dim=2),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        specs["w_gate"] = matrix_spec(ctx, (e_pad, d, f), tp_dim=0, fsdp_dim=1)
    return specs


def _route(params, cfg: ModelConfig, xf: torch.Tensor, e_pad: int,
           top_e: Optional[torch.Tensor] = None):
    """Router: top-k over the real experts (padded ones masked to -1e30) →
    (weights (T, k) float32 summing to 1, experts (T, k) int64, aux losses).
    The top k are the first k of a stable descending sort, so of two equal
    probabilities the lower expert index comes first, as in
    ``jax.lax.top_k``.  Given ``top_e``, those experts are taken instead,
    their weights and the aux losses from this router's probabilities (a
    check replays another run's routing so)."""
    moe = cfg.moe
    logits = (xf @ params["router"].to(xf.dtype)).float()
    if e_pad > moe.n_experts:
        pad_mask = torch.arange(e_pad, device=xf.device) >= moe.n_experts
        logits = torch.where(pad_mask[None, :], -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    if top_e is None:
        top_e = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :moe.top_k]
    top_w = probs.gather(-1, top_e)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # aux losses (Switch-style load balance + router z-loss)
    T = xf.shape[0]
    # a fixed-size count: nothing is read back to size the output, and
    # integer adds give the same float32 values in any order
    flat_e = top_e.reshape(-1)
    counts = torch.zeros(e_pad, dtype=torch.int64, device=xf.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e)).float()
    frac_tokens = counts / (T * moe.top_k)
    mean_probs = probs.mean(0)
    aux = moe.n_experts * torch.sum(frac_tokens * mean_probs)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_w, top_e, {"moe_aux": aux * moe.aux_loss_coef,
                          "moe_z": zloss * moe.router_z_coef}


def _dispatch(top_e: torch.Tensor, e_count: int, capacity: int, e_first: int = 0):
    """The reference's capacity grouping of the T·k assignments to experts
    ``[e_first, e_first + e_count)`` → (order: the stable sort by expert,
    the others last, keep: whether the sorted assignment is one of those
    experts' and fits its capacity, slot: its row of the (e_count ·
    capacity) grid, or the dump row e_count · capacity when not kept)."""
    local = top_e.reshape(-1) - e_first
    in_range = (local >= 0) & (local < e_count)
    sort_key = torch.where(in_range, local, e_count)  # out of range sorts last
    order = torch.argsort(sort_key, stable=True)
    sorted_e = sort_key[order]
    # position within each expert's run (first occurrence via searchsorted)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(sorted_e.shape[0], device=top_e.device) - first
    keep = (sorted_e < e_count) & (pos_in_e < capacity)
    slot = torch.where(keep, sorted_e * capacity + pos_in_e, e_count * capacity)
    return order, keep, slot


def _group_and_compute(params, cfg: ModelConfig, xf: torch.Tensor, top_w: torch.Tensor,
                       top_e: torch.Tensor, e_first: int, e_count: int, capacity: int
                       ) -> torch.Tensor:
    """Capacity grouping, the MLPs of experts ``[e_first, e_first + e_count)``
    (the ``e_count`` experts ``params`` holds) over the (E, C, d) grid, and
    the weighted combine back to tokens → (T, d) in x's type; an assignment
    to another expert adds 0."""
    d = xf.shape[1]
    dt = xf.dtype
    order, _, slot = _dispatch(top_e, e_count, capacity, e_first)

    # gather tokens into the (E, C, d) grid; dropped ones land on the dump
    # row, which is sliced away
    buf = torch.zeros((e_count * capacity + 1, d), dtype=dt, device=xf.device)
    buf = buf.index_put((slot,), _TokenGather.apply(xf, order, top_e))
    grid = buf[:-1].reshape(e_count, capacity, d)

    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        g = torch.einsum("ecd,edf->ecf", grid, params["w_gate"].to(dt))
        u = torch.einsum("ecd,edf->ecf", grid, params["w_up"].to(dt))
        h = act(g.float()).to(dt) * u
    else:
        u = torch.einsum("ecd,edf->ecf", grid, params["w_up"].to(dt))
        h = _gelu(u.float()).to(dt)
    y_grid = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(dt))

    # each sorted assignment's weighted output (0 when dropped), in x's type
    y_assign = _SlotGather.apply(y_grid.reshape(e_count * capacity, d), slot)
    contrib = y_assign * top_w.reshape(-1)[order][:, None].to(dt)
    return _sum_by_expert(contrib, order, top_e)


def _sum_by_expert(rows: torch.Tensor, order: torch.Tensor, top_e: torch.Tensor) -> torch.Tensor:
    """The (T·k, d) rows of the sorted assignments summed per token →
    (T, d): back to (T, k, d) in the order of the sort (ascending expert id
    within a token, its k experts being distinct), then added from 0 in
    that order, rounding to the rows' type after each add."""
    T, k = top_e.shape
    d = rows.shape[1]
    per_token = torch.empty_like(rows).index_copy(0, order, rows).reshape(T, k, d)
    by_expert = torch.argsort(top_e, dim=-1)
    per_token = per_token.gather(1, by_expert[..., None].expand(T, k, d))
    out = torch.zeros((T, d), dtype=rows.dtype, device=rows.device)
    for j in range(k):
        out = out + per_token[:, j]
    return out


class _SlotGather(torch.autograd.Function):
    """Each sorted assignment's row of the (E·C, d) grid, zero where it was
    dropped (``slot`` is E·C, one past the grid).  The kept slots are
    distinct, so the backward writes each gradient row to its grid row
    without adding; an accumulating index would add every dropped
    assignment's zero row into one grid row, which the card serialises (at
    granite-MoE's training shape it took a third of the step)."""

    @staticmethod
    def forward(ctx, y_flat: torch.Tensor, slot: torch.Tensor):
        rows = y_flat.shape[0]
        ctx.save_for_backward(slot)
        ctx.rows = rows
        kept = (slot < rows)[:, None]
        return torch.where(kept, y_flat[torch.clamp(slot, max=rows - 1)],
                           torch.zeros((), dtype=y_flat.dtype, device=y_flat.device))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (slot,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows + 1, grad.shape[1]))
        out.index_put_((slot,), grad)  # the dropped rows land on row E·C, cut off
        return out[:-1], None


class _TokenGather(torch.autograd.Function):
    """``xf[order // k]``: each token's row once for each of its k sorted
    assignments.  The backward adds a token's k gradient rows from 0 in
    ascending expert id (``_sum_by_expert``), the order in which the
    reference's scatter-add meets them, instead of an accumulating index
    whose order on the card may change between runs."""

    @staticmethod
    def forward(ctx, xf: torch.Tensor, order: torch.Tensor, top_e: torch.Tensor):
        ctx.save_for_backward(order, top_e)
        return xf[order // top_e.shape[1]]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        order, top_e = ctx.saved_tensors
        return _sum_by_expert(grad, order, top_e), None, None


def expert_capacity(cfg: ModelConfig, tokens: int) -> int:
    moe = cfg.moe
    raw = tokens * moe.top_k / moe.n_experts * moe.capacity_factor
    return max(8, int(math.ceil(raw / 8.0)) * 8)


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor, ctx: ShardCtx
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Global-semantics MoE FFN: x (B, S, d) → (y, aux losses), over the
    ``padded_experts(ctx.tp)`` experts (the padded ones never routed to)."""
    B, S, d = x.shape
    e_pad = cfg.moe.padded_experts(ctx.tp)
    xf = x.reshape(B * S, d)
    top_w, top_e, aux = _route(params, cfg, xf, e_pad)
    cap = expert_capacity(cfg, B * S)
    y = _group_and_compute(params, cfg, xf, top_w, top_e, 0, e_pad, cap)
    return y.reshape(B, S, d), aux


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def expert_slices(params, ctx: ShardCtx, devices: Sequence[torch.device]) -> List[Dict]:
    """Each model shard's parameters on its device: the router, and its
    ``e_pad / tp`` experts.  An expert leaf of ``params`` is either every
    expert (shard ``s`` takes rows ``[s·e_loc, (s+1)·e_loc)``: a view where
    the shard's device is the leaf's) or already a tuple of the shards'
    slices, each on its shard's device."""
    out = []
    routers = TP.broadcast(params["router"], devices)
    for s, dev in enumerate(devices):
        local = {"router": routers[s]}
        for name in EXPERT_LEAVES:
            if name not in params:
                continue
            w = params[name]
            if isinstance(w, (tuple, list)):
                local[name] = w[s]
            else:
                e_loc = w.shape[0] // ctx.tp
                local[name] = w[s * e_loc:(s + 1) * e_loc].to(dev)
        out.append(local)
    return out


def moe_ffn_sharded(params, cfg: ModelConfig, x: torch.Tensor, ctx: ShardCtx, mesh
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert-parallel MoE over ``mesh`` (a ``launch.mesh.ModelMesh``): x
    (B, S, d) → (y on the mesh's first device, aux losses there).

    The batch is split over the data rows when ``B`` divides by their
    count; otherwise every row takes the whole batch (the reference's
    ``dspec = None``).  In each row every model shard runs
    :func:`moe_ffn_ep` on its own device, and the parts are added on the
    row's first device in shard order; the rows' outputs gather onto the
    mesh's first device in row order, and each aux loss is the mean over
    the rows, added in row order."""
    rows = mesh.dp_total
    B = x.shape[0]
    split = B % rows == 0
    b = B // rows if split else B
    ys, auxes = [], []
    for r in range(rows):
        devs = mesh.row_devices(r)
        xr = x[r * b:(r + 1) * b] if split else x
        local = expert_slices(params, ctx, devs)
        xs = TP.broadcast(xr, devs)
        y = aux = None
        for s, dev in enumerate(devs):
            y_s, aux_s = moe_ffn_ep(local[s], cfg, xs[s], ctx, s)
            y_s = y_s.to(devs[0])
            if s == 0:  # the aux losses are replicated over the model axis
                y, aux = y_s, aux_s
            else:
                y = y + y_s
        ys.append(y)
        auxes.append(aux)
    first = mesh.first
    out = torch.cat([y.to(first) for y in ys]) if split else ys[0].to(first)
    mean = {}
    for k in auxes[0]:
        total = auxes[0][k].to(first)
        for a in auxes[1:]:
            total = total + a[k].to(first)
        mean[k] = total / rows
    return out, mean


def moe_ffn_ep(params_local, cfg: ModelConfig, x_local: torch.Tensor, ctx: ShardCtx,
               shard: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Model shard ``shard``'s part of the expert-parallel MoE:
    ``params_local`` hold the router and experts ``[shard·e_loc,
    (shard+1)·e_loc)`` of the ``padded_experts(tp)``; ``x_local`` is the
    data row's tokens (replicated over the model axis).  The row's tokens
    are routed here at the row's capacity, and the kept assignments to
    this shard's experts computed → (this shard's part of y, in x's type;
    the row's aux losses).  The reference's body ends with a ``psum`` over
    the model axis and a ``pmean`` over the data axes: single-controller,
    :func:`moe_ffn_sharded` does both across the shards."""
    B, S, d = x_local.shape
    e_pad = cfg.moe.padded_experts(ctx.tp)
    e_loc = e_pad // ctx.tp
    xf = x_local.reshape(B * S, d)
    top_w, top_e, aux = _route(params_local, cfg, xf, e_pad)
    cap = expert_capacity(cfg, B * S)
    y = _group_and_compute(params_local, cfg, xf, top_w, top_e, shard * e_loc, e_loc, cap)
    return y.reshape(B, S, d), aux
