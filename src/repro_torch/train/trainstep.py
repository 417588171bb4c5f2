"""The train step: loss → grads → (compressed) gradient → AdamW.

Built once per (ModelConfig, RunConfig).  The step is a Python call, run
eagerly; gradient accumulation (microbatching) sums float32 gradients over
``run.microbatch``-row slices of the batch, then divides by their count.
The step updates the parameters and the AdamW moments in place, leaf by
leaf (the reference returns new trees), and accumulates in place, so it
holds one copy of the weights, the moments and the gradients.

Over a model mesh (single-controller), data row ``i`` of ``dp_total`` takes
rows ``[i·B/dp_total, (i+1)·B/dp_total)`` of the batch and computes its
gradient on the model's replica on its first device; the gradients are
added on the mesh's first device in row order, from the first, then
divided by ``dp_total``, so a step equals the step with ``microbatch =
B/dp_total`` bit for bit on one device.  AdamW runs there on the master
weights, which then go back to the replicas.

With the state placed (:func:`place_train_state`, the counterpart of the
reference dry run's input shardings), each row keeps its slices of the
weights and moments: row ``r`` gathers each layer's weights as it runs it,
and the gather's backward adds the row's gradient into each slice's float32
accumulator on the slice's device, rows in order, so the accumulated slices
equal the replicated step's gradient bit for bit; AdamW then updates each
slice where it lies.  Over ``tp > 1`` model shards the placed state is
tensor parallel (TP, or TP × FSDP): each shard computes with its slices on
its own device, its gradient lands in its slices' accumulators, and an MoE
runs expert-parallel over the shards (without ``use_ep`` on the whole batch,
on the first row's cards, at one capacity as the reference's global
``moe_ffn``; the other rows' slices are gathered there and take their
gradient back); a whole model over such a mesh still
computes on whole replicas, one a shard device.  A tensor-parallel step
runs the reference's sequence parallelism between blocks where its
condition holds (``lm.seq_parallel``) and takes its loss on the head's
vocabulary slices (``lm.forward_loss``), so no card holds a row's whole
logits.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig, RunConfig
from ..models.base import (SINGLE, ShardCtx, tree_flatten, tree_map,
                           tree_specs_to_shapes, tree_unflatten)
from ..models.fsdp import Sliced
from ..models.lm import (LM, data_rows, forward_loss, init_model, init_placed,
                         model_spec, placer, replica, sync_replicas)
from .optimizer import (
    AdamWConfig,
    adamw_update,
    compress_with_feedback,
    init_error_state,
    init_opt_state,
)


def make_shard_ctx(run: RunConfig) -> ShardCtx:
    if run.pods > 1:
        return ShardCtx(tp=run.tp, dp=run.dp, pods=run.pods, data_axes=("pod", "data"))
    return ShardCtx(tp=run.tp, dp=run.dp, pods=1, data_axes=("data",))


def batch_spec(cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, tuple]:
    """The placement of each batch entry: its batch dim over the data axes."""
    dspec = ctx.data_spec()
    toks = (dspec, None, None) if cfg.n_codebooks > 1 else (dspec, None)
    out = {"tokens": toks, "labels": toks}
    if cfg.n_vis_tokens:
        out["vis_embeds"] = (dspec, None, None)
    return out


def loss_fn(model: LM, cfg: ModelConfig, batch, ctx: ShardCtx, remat: bool, mesh=None,
            use_ep: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    loss, aux = forward_loss(model, cfg, batch, ctx, mesh=mesh, remat=remat, use_ep=use_ep)
    total = loss + sum(aux.values(), 0.0)
    return total, {"loss": loss, **aux}


def value_and_grad(model: LM, cfg: ModelConfig, batch, ctx: ShardCtx, remat: bool, mesh=None,
                   use_ep: bool = False):
    """→ (total loss, metrics, float32 gradients as a tree like
    ``model.tree()``, on the model's device).  Over a ``mesh`` whose data
    rows split the batch (``lm.data_rows``), each row's gradient comes from
    the replicas on its devices; the rows' gradients, totals and metrics
    are added on the mesh's first device in row order and divided by the
    number of rows.  A placed model's gradients are fresh accumulators, a
    ``Sliced`` leaf for each of its leaves, into which the rows add."""
    rows = 1 if mesh is None else data_rows(mesh, cfg, batch["tokens"].shape[0], use_ep)
    b = batch["tokens"].shape[0] // rows
    grads = _zero_grads(model) if model.placed else None
    total = metrics = None
    for r in range(rows):
        part = batch if rows == 1 else {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
        t, m, g = _row_value_and_grad(model, cfg, part, ctx, remat,
                                      None if mesh is None else mesh.row(r), use_ep)
        if total is None:
            total, metrics = t, m
        else:
            total = total + t.to(total.device)
            metrics = {k: v + m[k].to(v.device) for k, v in metrics.items()}
        if g is None:  # a placed model's row added its gradient in place
            continue
        if grads is None:
            grads = g
        else:
            _tree_add_(grads, g)
        del g
    if rows == 1:
        return total, metrics, grads
    _tree_div_(grads, rows)
    return total / rows, {k: v / rows for k, v in metrics.items()}, grads


def _row_value_and_grad(model: LM, cfg: ModelConfig, batch, ctx: ShardCtx, remat: bool, mesh,
                        use_ep: bool):
    """One data row's (total, metrics, gradient tree on the model's
    device): the gradient of every replica the row computed with, added in
    the order of the row's devices (a replica of another device holds only
    its shard's part).  A placed model's row adds its gradient into the
    leaves' accumulators (the gathers' backward) and returns None for it."""
    if mesh is not None:
        batch = {k: v.to(mesh.first) for k, v in batch.items()}
    if model.placed:
        total, metrics = loss_fn(model, cfg, batch, ctx, remat, mesh, use_ep)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, None
    models = [model]
    if mesh is not None:
        reps = (replica(model, dev) for dev in mesh.row_devices(0))
        models = list({id(m): m for m in reps}.values())  # distinct, in shard order
    flats = [tree_flatten(m.tree()) for m in models]
    total, metrics = loss_fn(models[0], cfg, batch, ctx, remat, mesh, use_ep)
    leaves = [p for flat in flats for _, p in flat]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    n = len(flats[0])
    dev = model.device
    out = [g.float().to(dev) for g in grads[:n]]
    for i in range(1, len(models)):
        for j, g in enumerate(grads[i * n:(i + 1) * n]):
            if g is not None:
                out[j] = out[j] + g.float().to(dev)
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(
        [path for path, _ in flats[0]], out)


def _zero_grads(model: LM):
    """Fresh float32 accumulators for a placed model's gradient, each set
    as its leaf's ``grad`` (the gathers' backward adds into it): one a part,
    on the first row only for a leaf held whole on every row."""
    def fresh(leaf: Sliced) -> Sliced:
        leaf.grad = leaf.like(rows=leaf.rows if leaf.dim is not None else 1)
        return leaf.grad

    return tree_map(fresh, model.tree())


def make_train_step(cfg: ModelConfig, run: RunConfig, mesh=None,
                    opt: Optional[AdamWConfig] = None, use_ep: bool = False):
    """Returns (step_fn, ctx).  step_fn(model, opt_state, batch) → (model,
    opt_state, metrics); the model's parameters and the moments of
    ``opt_state`` are updated in place (the reference returns new ones).
    Compression keeps its error-feedback tree in opt_state["err"].  Over a
    ``mesh`` (the model on its first device) each data row computes its
    part of the gradient on its own replica (:func:`value_and_grad`); a
    model placed over the mesh (:func:`place_train_state`) is stepped slice
    by slice where each slice lies."""
    ctx = make_shard_ctx(run)
    opt = opt or AdamWConfig(lr=run.lr, weight_decay=run.weight_decay, grad_clip=run.grad_clip)
    remat = run.remat != "none"

    def step(model: LM, opt_state, batch):
        if run.microbatch:
            n_micro = run.shape.global_batch // run.microbatch
            grads = loss_sum = None
            for i in range(n_micro):
                sl = {k: v[i * run.microbatch:(i + 1) * run.microbatch] for k, v in batch.items()}
                total, _, g = value_and_grad(model, cfg, sl, ctx, remat, mesh, use_ep)
                if grads is None:
                    grads, loss_sum = g, total
                else:
                    _tree_add_(grads, g)
                    loss_sum = loss_sum + total
                del g
            _tree_div_(grads, n_micro)
            metrics = {"loss": loss_sum / n_micro}
        else:
            _, metrics, grads = value_and_grad(model, cfg, batch, ctx, remat, mesh, use_ep)

        if run.grad_compression and "err" in opt_state:
            flat_g = tree_flatten(grads)
            pairs = [compress_with_feedback(g, e) for (_, g), (_, e)
                     in zip(flat_g, tree_flatten(opt_state["err"]))]
            paths = [path for path, _ in flat_g]
            grads = tree_unflatten(paths, [p[0] for p in pairs])
            opt_state = dict(opt_state)
            opt_state["err"] = tree_unflatten(paths, [p[1] for p in pairs])

        inner = {k: v for k, v in opt_state.items() if k != "err"}
        _, new_inner, opt_metrics = adamw_update(opt, model.tree(), grads, inner)
        sync_replicas(model)
        if model.placed:
            del grads
            tree_map(lambda leaf: setattr(leaf, "grad", None), model.tree())
        new_state = dict(new_inner)
        if "err" in opt_state:
            new_state["err"] = opt_state["err"]
        return model, new_state, {**metrics, **opt_metrics}

    return step, ctx


def _tensors(leaf) -> List[torch.Tensor]:
    return leaf.all_parts() if isinstance(leaf, Sliced) else [leaf]


def _tree_add_(a, b) -> None:
    for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)):
        for xp, yp in zip(_tensors(x), _tensors(y)):
            xp.add_(yp.to(xp.device))


def _tree_div_(a, n: int) -> None:
    for _, x in tree_flatten(a):
        for xp in _tensors(x):
            xp.div_(n)


def init_train_state(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx = SINGLE, seed: int = 0,
                     device=None):
    """→ (model with float32 master weights on ``device`` (the card unless
    asked), optimizer state)."""
    model = init_model(cfg, ctx, seed=seed, device=device, trainable=True)
    opt_state = init_opt_state(model.tree())
    if run.grad_compression:
        opt_state["err"] = init_error_state(model.tree())
    return model, opt_state


def init_placed_state(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx, mesh, seed: int = 0,
                      fsdp: bool = True):
    """:func:`init_train_state`'s state placed over ``mesh`` as it is made
    (``lm.init_placed``: each leaf drawn on the mesh's first device from
    the generator that would make the whole model there, placed at once and
    freed, a leaf over ``base.WHOLE_DRAW_MAX`` elements a layer slice at a
    time), so the whole state never lies on one device: sliced over the
    model shards where a placement names the model axis and, with ``fsdp``,
    over the data rows where it names the data axes."""
    model = init_placed(cfg, ctx, mesh, seed, fsdp)
    opt_state = init_opt_state(model.tree())
    if run.grad_compression:
        opt_state["err"] = init_error_state(model.tree())
    return model, opt_state


def place_train_state(model: LM, opt_state, mesh, fsdp: bool = True):
    """Store a whole train state in slices over ``mesh``, as the
    reference's placements say (``ParamSpec.placement``; the dry run's
    input shardings): row ``r`` keeps slice ``r`` of each leaf's data-axis
    dimension (with ``fsdp``; without, each row keeps the leaf whole over
    the data axes), and shard ``s`` of the row slice ``s`` of its model-axis
    dimension, on ``mesh.device(r, s)``; a leaf with neither axis is held
    whole on every row's first device.  The moments and the error tree are
    sliced like their parameters.  The given state is consumed, as the dry
    run donates it: each whole leaf is dropped as soon as it is sliced.  →
    (the model, now placed, and the placed optimizer state)."""
    if mesh.tp != model.ctx.tp:
        raise ValueError(f"a mesh of {mesh.tp} model shards under ShardCtx(tp={model.ctx.tp})")
    place = placer(model.cfg, model.ctx, mesh, fsdp)
    model.place_(lambda path, t: place(path, t, True))

    def place_tree(tree, prefix=()):
        for k in list(tree):
            if isinstance(tree[k], dict):
                place_tree(tree[k], prefix + (k,))
            else:
                t = tree.pop(k)
                tree[k] = place(prefix + (k,), t, False)
                del t

    for key in ("mu", "nu", "err"):
        if key in opt_state:
            place_tree(opt_state[key])
    opt_state["step"] = opt_state["step"].to(mesh.first)
    return model, opt_state


def row_state_bytes(model: LM, opt_state) -> List[int]:
    """The bytes of the train state (weights, moments, error tree) that
    each data row of a placed model holds, counted on its tensors."""
    out: List[int] = []
    for tree in (model.tree(), opt_state["mu"], opt_state["nu"], opt_state.get("err", {})):
        for _, leaf in tree_flatten(tree):
            for r, row in enumerate(leaf.parts):
                while len(out) <= r:
                    out.append(0)
                out[r] += sum(p.numel() * p.element_size() for p in row)
    return out


def card_state_bytes(model: LM, opt_state) -> List[int]:
    """The bytes of the train state (weights, moments, error tree) that
    each card of a placed model's mesh holds, row-major over (data row,
    model shard), counted on its tensors: a leaf not sliced over the shards
    lies on its row's first card."""
    tp = model.ctx.tp
    out: List[int] = []
    for tree in (model.tree(), opt_state["mu"], opt_state["nu"], opt_state.get("err", {})):
        for _, leaf in tree_flatten(tree):
            for r, row in enumerate(leaf.parts):
                for s, p in enumerate(row):
                    while len(out) <= r * tp + s:
                        out.append(0)
                    out[r * tp + s] += p.numel() * p.element_size()
    return out


def placement_bytes(cfg: ModelConfig, ctx: ShardCtx, arrays: int = 4) -> Tuple[int, int]:
    """(bytes of a whole float32 train state, bytes a data row holds where
    each leaf is sliced as its placement says) for ``arrays`` float32
    copies of the parameters (weights, gradients and two moments: 4), from
    the specs alone: nothing is allocated."""
    whole = row = 0
    dspec = ctx.data_spec()
    for _, spec in tree_flatten(model_spec(cfg, ctx)):
        n = int(torch.Size(spec.shape).numel())
        whole += n
        row += n // ctx.dp_total if dspec in spec.placement and ctx.dp_total > 1 else n
    return whole * 4 * arrays, row * 4 * arrays


def train_state_specs(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx):
    """((parameter shapes, placements), (optimizer state shapes,
    placements)): ``meta`` tensors, nothing allocated; the moments (and the
    compression's error tree) are placed like the parameters."""
    p_shapes, p_specs = tree_specs_to_shapes(model_spec(cfg, ctx))  # float32, as the moments
    o_shapes = {"mu": p_shapes, "nu": p_shapes,
                "step": torch.empty((), dtype=torch.int32, device="meta")}
    o_specs = {"mu": p_specs, "nu": p_specs, "step": ()}
    if run.grad_compression:
        o_shapes["err"] = p_shapes
        o_specs["err"] = p_specs
    return (p_shapes, p_specs), (o_shapes, o_specs)
