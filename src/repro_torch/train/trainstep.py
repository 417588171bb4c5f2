"""The train step: loss → grads → (compressed) gradient → AdamW.

Built once per (ModelConfig, RunConfig).  The step is a Python call, run
eagerly; gradient accumulation (microbatching) sums float32 gradients over
``run.microbatch``-row slices of the batch, then divides by their count.
The step updates the parameters and the AdamW moments in place, leaf by
leaf (the reference returns new trees), and accumulates in place, so it
holds one copy of the weights, the moments and the gradients.
The port runs on one device, so the reference's mesh context reduces to
``ShardCtx(tp=1)`` and its data-parallel reduction to the identity.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, RunConfig
from ..models.base import SINGLE, ShardCtx, tree_flatten, tree_unflatten
from ..models.lm import LM, forward, init_model, lm_loss
from .optimizer import (
    AdamWConfig,
    adamw_update,
    compress_with_feedback,
    init_error_state,
    init_opt_state,
)


def make_shard_ctx(run: RunConfig) -> ShardCtx:
    """One device: no tensor parallelism, whatever ``run.tp`` says."""
    return SINGLE


def loss_fn(model: LM, cfg: ModelConfig, batch, ctx: ShardCtx, remat: bool
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, _, aux = forward(model, cfg, batch["tokens"], ctx, remat=remat,
                             vis_embeds=batch.get("vis_embeds"))
    loss = lm_loss(logits, batch["labels"], cfg.vocab)
    total = loss + sum(aux.values(), 0.0)
    return total, {"loss": loss, **aux}


def value_and_grad(model: LM, cfg: ModelConfig, batch, ctx: ShardCtx, remat: bool):
    """→ (total loss, metrics, float32 gradients as a tree like ``model.tree()``)."""
    flat = tree_flatten(model.tree())
    total, metrics = loss_fn(model, cfg, batch, ctx, remat)
    grads = torch.autograd.grad(total, [p for _, p in flat])
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, tree_unflatten(
        [path for path, _ in flat], [g.float() for g in grads])


def make_train_step(cfg: ModelConfig, run: RunConfig, opt: Optional[AdamWConfig] = None):
    """Returns (step_fn, ctx).  step_fn(model, opt_state, batch) → (model,
    opt_state, metrics); the model's parameters and the moments of
    ``opt_state`` are updated in place (the reference returns new ones).
    Compression keeps its error-feedback tree in opt_state["err"]."""
    ctx = make_shard_ctx(run)
    opt = opt or AdamWConfig(lr=run.lr, weight_decay=run.weight_decay, grad_clip=run.grad_clip)
    remat = run.remat != "none"

    def step(model: LM, opt_state, batch):
        if run.microbatch:
            n_micro = run.shape.global_batch // run.microbatch
            grads = loss_sum = None
            for i in range(n_micro):
                sl = {k: v[i * run.microbatch:(i + 1) * run.microbatch] for k, v in batch.items()}
                total, _, g = value_and_grad(model, cfg, sl, ctx, remat)
                if grads is None:
                    grads, loss_sum = g, total
                else:
                    _tree_add_(grads, g)
                    loss_sum = loss_sum + total
                del g
            _tree_div_(grads, n_micro)
            metrics = {"loss": loss_sum / n_micro}
        else:
            _, metrics, grads = value_and_grad(model, cfg, batch, ctx, remat)

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
        new_state = dict(new_inner)
        if "err" in opt_state:
            new_state["err"] = opt_state["err"]
        return model, new_state, {**metrics, **opt_metrics}

    return step, ctx


def _tree_add_(a, b) -> None:
    for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)):
        x.add_(y)


def _tree_div_(a, n: int) -> None:
    for _, x in tree_flatten(a):
        x.div_(n)


def init_train_state(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx = SINGLE, seed: int = 0,
                     device=None):
    """→ (model with float32 master weights on ``device`` (the card unless
    asked), optimizer state)."""
    model = init_model(cfg, ctx, seed=seed, device=device, trainable=True)
    opt_state = init_opt_state(model.tree())
    if run.grad_compression:
        opt_state["err"] = init_error_state(model.tree())
    return model, opt_state
