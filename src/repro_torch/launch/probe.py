"""Cost probes for the roofline: one step counted in parts.

    total = outer (embed + logits + loss [+ their gradient]; no layers)
          + n_groups × one group of the block pattern (a layer of each of its
            types: forward [+ remat recompute + backward])
          + each extra layer (the layers past the last whole group)
          + the gradients' accumulation (the stacked leaves', the
            microbatches', the aux losses') (train)
          + the AdamW update over the whole parameter tree (train)
          + the decode cache restacked (decode)

Each part is counted by ``roofline.count()`` on ``meta`` tensors: nothing
is allocated, and the count depends on shapes alone.  Dispatch counting
sees every loop iteration (the reference splits its step because XLA's
cost analysis counts a scan body once), so the split serves two other
ends: a full-size step counts in the time of one group, and the dry run's
rows carry each part.  A group runs as the whole step runs it: its leaves a
layer of the stacked leaves (whose gradient is a whole stacked leaf, zeros
but for the layer's slice), its output's gradient handed in (no stand-in
loss), under one ``torch.utils.checkpoint`` region where the step
rematerialises, so the parts add up to the whole step exactly.

The collective term (:func:`collective_costs`) is reckoned from the port's
placements and its transfer points, since there is no HLO to read.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from contextlib import nullcontext
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, RunConfig
from ..kernels import ops as kops
from ..models.base import ShardCtx, stack_tree, tree_flatten, tree_specs_to_shapes
from ..models.blocks import Block, block_spec, init_block_cache
from ..models import lm as LMmod
from ..models.layers import compute_dtype
from ..models.lm import LM, forward, init_cache, lm_loss, model_spec
from ..train.optimizer import AdamWConfig, adamw_update
from .roofline import Cost, count
from .specs import block_split_dims, decode_input_specs, train_input_specs

__all__ = ["Cost", "block_counts", "probe_block", "probe_group", "probe_outer", "probe_optimizer",
           "probe_accumulation", "probe_cache_restack", "corrected_costs", "collective_costs"]


def _counted(fn) -> Cost:
    """``fn()`` counted on the plain kernel route (``meta`` tensors)."""
    with kops.local_backend("torch"), count() as c:
        fn()
    return c.cost


def block_counts(cfg: ModelConfig) -> Dict[str, int]:
    counts: Dict[str, int] = Counter()
    for i in range(cfg.n_layers):
        counts[cfg.block_pattern[i % len(cfg.block_pattern)]] += 1
    return dict(counts)


def _map(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def _meta_leaves(spec, cfg: ModelConfig, trainable: bool):
    """A ParamSpec tree's leaves on ``meta``, stored as the model stores
    them: float32 to train, a cast-at-use leaf in the compute type to serve."""
    shapes, _ = tree_specs_to_shapes(spec)
    if trainable:
        return shapes
    dt, flat = compute_dtype(cfg), dict(tree_flatten(spec))
    return _map(lambda path, t: t.to(flat[path].dtype(dt)), shapes)


def _meta_block(btype: str, cfg: ModelConfig, ctx: ShardCtx, stack: int, trainable: bool):
    spec = block_spec(btype, cfg, ctx)
    spec = stack_tree(spec, stack) if stack else spec
    return Block(btype, cfg, _meta_leaves(spec, cfg, trainable), stacked=bool(stack),
                 trainable=trainable)


def _meta_model(cfg: ModelConfig, ctx: ShardCtx, trainable: bool) -> LM:
    return LM(cfg, _meta_leaves(model_spec(cfg, ctx), cfg, trainable), ctx, trainable=trainable)


def _layer_input(cfg: ModelConfig, B: int, S: int, kind: str):
    """(x, positions) on ``meta`` for ``kind``'s layers: one new token at
    decode, else the sequence with a VLM's patch embeddings before it."""
    x_S = 1 if kind == "decode" else S + cfg.n_vis_tokens
    x = torch.empty((B, x_S, cfg.d_model), dtype=compute_dtype(cfg), device="meta",
                    requires_grad=kind == "train")
    return x, torch.empty((B, x_S), dtype=torch.int64, device="meta")


def _probe_layers(cfg: ModelConfig, btypes, ctx: ShardCtx, B: int, S: int, kind: str,
                  remat: bool, ctx_params: ShardCtx, stack: int) -> Cost:
    """Layers of ``btypes`` in turn (one group of the pattern, or one
    layer), as the step runs them: the gradient of all of them under one
    remat region (train), or their forward (serving)."""
    train = kind == "train"
    blocks = [_meta_block(bt, cfg, ctx_params, stack, trainable=train) for bt in btypes]
    x, positions = _layer_input(cfg, B, S, kind)
    if train:
        def body(x):
            auxes = []
            for block in blocks:
                x, _, aux = block(x, positions, ctx, layer=0)
                auxes.extend(aux.values())
            return (x, *auxes)

        def run():
            backend = kops.backend()  # the recompute runs on autograd's thread
            if remat:
                outs = checkpoint(body, x, use_reentrant=False,
                                  context_fn=lambda: (nullcontext(), kops.local_backend(backend)))
            else:
                outs = body(x)
            leaves = [x] + [p for block in blocks for p in block.parameters()]
            torch.autograd.grad(outs, leaves, [torch.empty_like(o) for o in outs],
                                allow_unused=True)
        return _counted(run)

    caches = [init_block_cache(bt, cfg, B, S, "meta") if kind == "decode" else None
              for bt in btypes]

    @torch.no_grad()
    def run():
        y = x
        for block, cache in zip(blocks, caches):
            y = block(y, positions, ctx, layer=0, cache=cache)[0]

    return _counted(run)


def probe_block(cfg: ModelConfig, btype: str, ctx: ShardCtx, mesh, B: int, S: int, kind: str,
                remat: bool = True, ctx_params: Optional[ShardCtx] = None,
                stack: Optional[int] = None) -> Cost:
    """One layer of type ``btype``: its gradient (train) or its forward
    (serving), on ``meta``.  ``S``: the sequence length (train, prefill;
    a VLM's layers see its patch embeddings too) or the cache's capacity
    (decode, whose input is one new token).  ``stack``: the layers its
    leaves are stacked over (default: the config's pattern groups; 0: an
    extra layer's unstacked leaves).  ``mesh`` is unused: a layer's work
    does not depend on where it runs (the collective term is reckoned
    apart)."""
    del mesh
    if stack is None:
        stack = cfg.pattern_groups[0]
    return _probe_layers(cfg, (btype,), ctx, B, S, kind, remat, ctx_params or ctx, stack)


def probe_group(cfg: ModelConfig, ctx: ShardCtx, B: int, S: int, kind: str, remat: bool = True,
                ctx_params: Optional[ShardCtx] = None) -> Cost:
    """One group of the block pattern (a layer of each of its types, in
    order), under one remat region as the step recomputes a group: where
    the pattern has several types, a layer's trailing ops are recomputed
    for the next one, which a layer alone would not need."""
    return _probe_layers(cfg, cfg.block_pattern, ctx, B, S, kind, remat, ctx_params or ctx,
                         cfg.pattern_groups[0])


def probe_outer(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx, mesh, kind: str,
                batch_override: int = 0, ctx_params: Optional[ShardCtx] = None) -> Cost:
    """Embed + logits + loss (+ the gradient of every leaf) with no
    layers, on ``meta``."""
    del mesh
    cfg0 = dataclasses.replace(cfg, n_layers=0)
    shape = run.shape
    if batch_override and batch_override != shape.global_batch:
        shape = dataclasses.replace(shape, global_batch=batch_override)
    model = _meta_model(cfg0, ctx_params or ctx, trainable=kind == "train")
    if kind in ("train", "prefill"):
        ins, _ = train_input_specs(cfg0, shape, ctx)
        tokens, vis = ins["tokens"], ins.get("vis_embeds")  # int32, as the loader's
        if kind == "train":
            def step():
                logits, _, aux = forward(model, cfg0, tokens, ctx, vis_embeds=vis)
                total = lm_loss(logits, tokens, cfg0.vocab) + sum(aux.values(), 0.0)
                torch.autograd.grad(total, list(model.parameters()), allow_unused=True)
            return _counted(step)

        @torch.no_grad()
        def prefill():
            forward(model, cfg0, tokens, ctx, vis_embeds=vis)[0][:, -1]
        return _counted(prefill)
    ins, _ = decode_input_specs(cfg0, shape, ctx)
    tokens = ins["tokens"]

    @torch.no_grad()
    def decode():
        forward(model, cfg0, tokens, ctx, cache={}, start_pos=ins["pos"])[0][:, -1]
    return _counted(decode)


def probe_optimizer(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx, mesh) -> Cost:
    """One AdamW update (global norm, clip, moments, decay) over the whole
    parameter tree, on ``meta``."""
    del mesh
    from ..train.trainstep import train_state_specs

    (p_shapes, _), (o_shapes, _) = train_state_specs(cfg, run, ctx)
    state = {k: v for k, v in o_shapes.items() if k != "err"}
    grads = _map(lambda _, t: torch.empty_like(t), p_shapes)
    opt = AdamWConfig(lr=run.lr, weight_decay=run.weight_decay, grad_clip=run.grad_clip)
    return _counted(lambda: adamw_update(opt, p_shapes, grads, state))


def probe_accumulation(cfg: ModelConfig, ctx: ShardCtx, n_micro: int,
                       microbatched: bool) -> Cost:
    """What the step adds up besides the layers, reckoned: each stacked
    leaf's gradient is the sum of its layers' whole-leaf gradients (an add
    of the stacked leaf for each layer after the first, in float32), and a
    microbatched step adds the microbatches' float32 gradients into the
    first's and their losses, then divides both by their number.  An MoE
    model's two auxiliary losses (scalars) add up over its layers and into
    the loss."""
    n_groups = cfg.pattern_groups[0]
    flat = tree_flatten(model_spec(cfg, ctx))
    stacked = sum(int(torch.Size(s.shape).numel()) for p, s in flat if p[0] == "groups")
    whole = sum(int(torch.Size(s.shape).numel()) for _, s in flat)
    adds = stacked * max(n_groups - 1, 0)
    per_micro = Cost(float(adds), 12.0 * adds)
    if cfg.moe is not None:
        layers = sum(n for bt, n in block_counts(cfg).items() if bt in ("attn", "local_attn"))
        per_micro = per_micro + Cost(2.0 * (layers + 1), 2.0 * (12 * layers + 8))
    total = per_micro * n_micro
    if microbatched:
        total = total + Cost(float((whole + 1) * (n_micro - 1)), 12.0 * (whole + 1) * (n_micro - 1))
        total = total + Cost(float(whole + 1), 8.0 * (whole + 1))
    return total


def probe_cache_restack(cfg: ModelConfig, B: int, S: int) -> Cost:
    """A decode step's new cache, restacked: each group type's layers'
    caches stacked into one tree again (``lm._stack``), on ``meta``."""
    from ..models.lm import _index, _stack

    n_groups = cfg.pattern_groups[0]
    cache = init_cache(cfg, B, S, device="meta").get("groups", {})
    return _counted(lambda: [_stack([_index(c, g) for g in range(n_groups)])
                             for c in cache.values()])


def corrected_costs(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx, mesh, kind: str,
                    ctx_params: Optional[ShardCtx] = None) -> Tuple[Cost, Dict[str, Any]]:
    """The cost of one whole step over every device (the dry run divides it
    evenly over the mesh).  ``ctx_params``: the parameters' placement
    context (decode cells place them over the model axis only).  A
    microbatched train step counts one microbatch and scales it by their
    number (the optimizer runs once)."""
    ctx_params = ctx_params or ctx
    shape = run.shape
    B = shape.global_batch
    n_micro = 1
    if kind == "train" and run.microbatch:
        n_micro = max(1, B // run.microbatch)
        B = run.microbatch
    total = probe_outer(cfg, run, ctx, mesh, kind, batch_override=B, ctx_params=ctx_params)
    detail: Dict[str, Any] = {"outer_flops": total.flops}
    n_groups, n_extra = cfg.pattern_groups
    remat = run.remat != "none"
    if kind == "decode":
        B, S = shape.global_batch, shape.seq_len
    else:
        S = shape.seq_len
    for btype in dict.fromkeys(cfg.block_pattern):
        c = probe_block(cfg, btype, ctx, mesh, B, S, kind, remat, ctx_params)
        detail[f"block_{btype}_flops"] = c.flops
    if n_groups:
        group = (probe_group(cfg, ctx, B, S, kind, remat, ctx_params)
                 if len(cfg.block_pattern) > 1 else c)
        detail["group_flops"] = group.flops
        total = total + n_groups * group
    for i in range(n_extra):  # an extra layer is recomputed only from sliced weights
        c = probe_block(cfg, cfg.block_pattern[i % len(cfg.block_pattern)], ctx, mesh, B, S,
                        kind, False, ctx_params, stack=0)
        detail[f"extra_{i}_flops"] = c.flops
        total = total + c
    if cfg.moe is not None and kind != "train":  # the aux losses add up over the layers
        layers = sum(n for bt, n in block_counts(cfg).items() if bt in ("attn", "local_attn"))
        total = total + Cost(2.0 * layers, 2.0 * (12 * layers - 4))
    if kind == "decode" and n_groups:
        c = probe_cache_restack(cfg, B, S)
        detail["restack_flops"] = c.flops
        total = total + c
    if kind == "train":
        total = total * n_micro
        acc = probe_accumulation(cfg, ctx_params, n_micro, bool(run.microbatch))
        detail["accumulate_flops"] = acc.flops
        c = probe_optimizer(cfg, run, ctx_params, mesh)
        detail["opt_flops"] = c.flops
        total = total + acc + c
    return total, detail


# ---------------------------------------------------------------- collectives --


def collective_costs(cfg: ModelConfig, run: RunConfig, ctx: ShardCtx, kind: str,
                     ctx_params: Optional[ShardCtx] = None) -> Dict[str, int]:
    """Bytes one step moves between distinct cards, summed over the mesh,
    by kind, reckoned from the port's placements and transfer points over
    a mesh of ``ctx.dp_total`` data rows of ``ctx.tp`` model shards
    (single-controller: a data row computes on its first card;
    ``launch/mesh.py``).  R rows, T shards, b sequences a row a pass:

    * train, the state in slices as ``ctx_params``' placements say
      (``models/fsdp.py``; float32): ``fsdp-gather``, each row gathers
      each use of a sliced leaf (a stacked leaf layer by layer; every use
      twice under remat, whose recompute gathers again; a tied embedding
      once) from the other rows' slices, (R − 1) / R of it;
      ``fsdp-grad-add``, each gather's backward adds the row's gradient
      into the slices where they lie, (R − 1) / R of a sliced leaf, a leaf
      held whole on every row from each row but the first; ``grad-norm``,
      each sliced gradient gathered onto the first card;
      ``whole-leaf-update``, AdamW's new weights and moments of a leaf held
      whole on every row copied from the first row to the others;
    * ``ep-dispatch`` / ``ep-combine`` (MoE run expert-parallel, T > 1): a row's
      tokens and the router sent from its first card to each other shard
      and the shard's output back, again in the recompute, and their
      gradients the other way in the backward;
    * ``split-s`` (decode, T > 1, a contiguous cache placed by slots: its
      kv heads do not divide T, its capacity does): the new token's q, k
      and v to each other shard and its partial (o, m, l, float32) back;
    * ``logits-gather`` (serving, R > 1): each row's logits onto the first
      card;
    * tensor parallelism within a row (T > 1, ``models/tp.py``;
      :func:`tp_moves`): ``tp-broadcast``, ``tp-sum``, ``tp-join``,
      ``tp-scatter``, and under sequence parallelism (``lm.seq_parallel``)
      ``sp-gather`` and ``sp-scatter``, each with its backward (train).
      A training step moves no logits: its loss's per-token statistics
      move (``tp-*``).

    Serving keeps a replica of the weights on each row (made once, not a
    step's traffic).  Inputs placed by the caller and scalars (the loss,
    the norm, the aux losses) are not counted."""
    ctxp = ctx_params or ctx
    R, T = ctx.dp_total, ctx.tp
    shape = run.shape
    train = kind == "train"
    e = 2 if cfg.dtype == "bfloat16" else 4
    n_micro = shape.global_batch // run.microbatch if train and run.microbatch else 1
    batch = shape.global_batch // n_micro
    rows = R if R > 1 and batch % R == 0 else 1  # lm.data_rows, MoE expert-parallel
    b = batch // rows
    passes = 2 if train and run.remat != "none" else 1
    out: Dict[str, int] = Counter()
    if train and ctxp.dp_total > 1:
        P = ctxp.dp_total
        dspec = ctxp.data_spec()
        for path, spec in tree_flatten(model_spec(cfg, ctxp)):
            nbytes = 4 * int(torch.Size(spec.shape).numel())
            uses = 1 if path == ("embed", "tok") and cfg.tie_embeddings else passes
            if dspec in spec.placement:
                out["fsdp-gather"] += n_micro * uses * rows * nbytes * (P - 1) // P
                out["fsdp-grad-add"] += n_micro * rows * nbytes * (P - 1) // P
                out["grad-norm"] += nbytes * (P - 1) // P
            else:
                out["fsdp-grad-add"] += n_micro * (rows - 1) * nbytes
                out["whole-leaf-update"] += 3 * nbytes * (P - 1)
    S = 1 if kind == "decode" else shape.seq_len
    if cfg.moe is not None and T > 1:
        layers = sum(n for bt, n in block_counts(cfg).items() if bt in ("attn", "local_attn"))
        router = (4 if train else e) * cfg.d_model * cfg.moe.padded_experts(T)
        x = b * S * cfg.d_model * e
        moves = passes + (1 if train else 0)  # forward passes, then the backward
        each = n_micro * rows * layers * (T - 1) * moves
        out["ep-dispatch"] += each * (router + x)
        out["ep-combine"] += each * x
    if kind == "decode" and T > 1:
        D, Hq, Hkv = cfg.head_dim, cfg.n_q_heads, cfg.n_kv_heads
        one = e * b * (Hq + 2 * Hkv) * D + 4 * b * Hq * (D + 2)
        dims = block_split_dims(cfg, T, b, shape.seq_len)
        for btype, n in block_counts(cfg).items():
            if btype in ("attn", "local_attn") and dims[btype].k == 2:  # by slots
                out["split-s"] += rows * n * (T - 1) * one
    if not train and rows > 1:
        width = cfg.padded_vocab(T) * max(cfg.n_codebooks, 1)
        out["logits-gather"] += (rows - 1) * b * S * width * e
    if T > 1:
        fwd, bwd = tp_moves(cfg, kind, b, shape.seq_len, T)
        for k, v in fwd.items():
            out[k] += n_micro * rows * v
        for k, v in bwd.items():
            out[k] += n_micro * rows * v
        if train and passes == 2:  # the recompute runs every region's forward again
            for k, v in tp_moves(cfg, kind, b, shape.seq_len, T, recomputed=True)[0].items():
                out[k] += n_micro * rows * v
    return {k: int(v) for k, v in out.items() if v}


def _window(cfg: ModelConfig, btype: str) -> Optional[int]:
    return cfg.window if btype == "attn" else cfg.local_window


def tp_moves(cfg: ModelConfig, kind: str, b: int, S: int, T: int, recomputed: bool = False,
             capacity: Optional[int] = None) -> Tuple[Dict[str, int], Dict[str, int]]:
    """The bytes one data row's pass moves between its T model shards'
    distinct cards by the tensor-parallel moves (``models/tp.py``), b
    sequences of S tokens (one new token at decode, into a cache of S
    slots) → (the forward's, the backward's; train only), by move;
    ``recomputed``: the forward moves a remat recompute runs again (all but
    a VLM's cut of its sequence); ``capacity``: a prefill that writes a
    cache of that many slots (serving; without, a cache-free forward).
    A cached pass reads each block's cache where ``lm.init_cache(mesh=...)``
    places it: a KV cache by kv heads moves no q, k or v, only the cache's
    ``pos`` to each shard; by slots or whole, q joins on the first card and
    the output goes back (a prefill into slots also sends each shard the
    new k and v its slots take, and gathers the written slots); the SSD's
    and RG-LRU's conv channels go out with their weights (one ``tp.send``,
    a ``tp-scatter``) and their output joins, and the scan's inputs go out
    by heads or width (the SSD's B and C to every shard, in the same move)
    and the SSD's y joins, while RG-LRU's gated output meets ``out_proj``'s
    rows where it lies.
    Each kind counts its move and that move's backward: ``tp-broadcast``
    (T − 1 copies from the first card; the gradients back), ``tp-sum`` (T − 1
    partials onto the first card; the gradient out), ``tp-join`` /
    ``tp-scatter`` ((T − 1) / T of a tensor onto / from the first card),
    ``sp-gather`` / ``sp-scatter`` (each shard's (T − 1) / T of the whole
    tensor).  Norm scales and gradients are float32, token ids int32,
    positions and labels int64.  An MoE over the shards runs expert-parallel
    (``ep-*`` of :func:`collective_costs`), as the train step always runs it
    and the dry run's cells serve it: the global path's join of the experts
    onto the first card is no cell's move."""
    train = kind == "train"
    decode = kind == "decode"
    cached = decode or capacity is not None
    slots = S if decode else capacity  # the cache's
    e = 2 if cfg.dtype == "bfloat16" else 4
    d, D = cfg.d_model, cfg.head_dim
    K = max(cfg.n_codebooks, 1)
    S_in = 1 if decode else S  # the tokens' positions
    St = S_in + (0 if decode else cfg.n_vis_tokens)  # the layers'
    sp = LMmod.seq_parallel(True, St, T, {} if cached else None)
    A = b * St * d * e
    fwd: Dict[str, float] = Counter()
    bwd: Dict[str, float] = Counter()

    def move(kind_, nbytes, share, grad=train):
        fwd[kind_] += share * nbytes
        if grad:
            bwd[kind_] += share * nbytes

    def bcast(nbytes, grad=train):
        move("tp-broadcast", nbytes, T - 1, grad)

    def spread(nbytes):
        move("sp-gather" if sp else "tp-broadcast", nbytes, T - 1)

    def collect(nbytes):
        move("sp-scatter" if sp else "tp-sum", nbytes, T - 1)

    def whole_layer():  # sequence slices joined on the first card and cut back
        if sp:
            move("tp-join", A, (T - 1) / T)
            move("tp-scatter", A, (T - 1) / T)

    norm = 4 * d * (2 if cfg.norm_type == "layernorm" else 1)

    def norms(n):
        if sp:
            for _ in range(n):
                bcast(norm)

    def mlp():
        spread(A)
        collect(A)

    def columns(width, rows_width):  # the SSD / RG-LRU projections
        spread(A)
        move("tp-join", b * St * width * e, (T - 1) / T)
        move("tp-scatter", b * St * rows_width * e, (T - 1) / T)
        collect(A)

    def cut(nbytes):  # a whole tensor cut into the shards' slices
        move("tp-scatter", nbytes, (T - 1) / T)

    def joined(nbytes):  # the shards' slices joined on the first card
        move("tp-join", nbytes, (T - 1) / T)

    def conv(channels, width, out_e):  # each shard's channels against its tail
        cut(b * St * channels * e + 4 * (width + 1) * channels)  # input, weights, bias
        joined(b * St * channels * out_e)

    dims = block_split_dims(cfg, T, b, slots) if cached else {}
    Hq, Hkv = cfg.n_q_heads, cfg.n_kv_heads
    for btype, n in block_counts(cfg).items():
        attention = btype in ("attn", "local_attn")
        placed = dims.get(btype)
        layout = placed and {1: "heads", 2: "slots"}.get(placed.k) if attention else None
        for _ in range(n):
            if attention:
                norms(2)
                if cfg.attn_tp_eligible(T):
                    spread(A)
                    kv_split = cfg.kv_sharded(T)
                    if not kv_split:
                        bcast(2 * b * Hkv * St * D * e)
                    if cfg.qk_norm:
                        bcast(4 * D)
                        bcast(4 * D, grad=train and kv_split)
                    bcast(8 * b * St, grad=False)  # positions
                    if layout == "heads":  # each shard its heads: only pos goes out
                        bcast(4, grad=False)
                    elif cached:  # q joined where the cache (or its first slots) lies
                        joined(b * Hq * St * D * e)
                        cut(b * Hq * St * D * e)
                    collect(A)
                else:
                    whole_layer()
                if layout == "slots" and not decode:  # the tokens out, the slots gathered
                    cap = min(slots, _window(cfg, btype) or slots)
                    w = min(St, cap // T)  # the most tokens a shard's slots take
                    move("tp-scatter", 2 * b * Hkv * w * D * e + 16, T - 1, grad=False)
                    joined(2 * b * Hkv * cap * D * e)
                if cfg.moe is not None:
                    whole_layer()
                else:
                    mlp()
            elif btype == "ssd":
                norms(1)
                s_ = cfg.ssd
                di, N = s_.expand * d, s_.d_state
                H = di // s_.head_dim
                if not cached:
                    columns(2 * di + 2 * N + H, di)
                    continue
                spread(A)
                joined(b * St * (2 * di + 2 * N + H) * e)
                if placed.conv is not None:
                    conv(di + 2 * N, s_.conv_width, e)
                if placed.h is not None:  # the scan by heads: x (float32 at decode), log a, B, C
                    xe = 4 if decode else e
                    cut(b * St * (di * xe + 4 * H))
                    move("tp-scatter", 2 * b * St * N * e, T - 1, grad=False)
                    joined(b * St * di * xe)  # y back
                cut(b * St * di * e)
                collect(A)
            elif btype == "rglru":
                norms(2)
                W = cfg.rglru.lru_width
                if not (cached and placed.h is not None):
                    columns(2 * W, W)
                    mlp()
                    continue
                spread(A)
                joined(b * St * 2 * W * e)
                if placed.conv is not None:
                    conv(W, cfg.rglru.conv_width, 4)
                cut(b * St * W * (8 + e))  # log a and the scaled input, the gate
                collect(A)  # each shard's rows of out_proj
                mlp()
    text = b * S_in * K
    bcast(4 * text, grad=False)  # the token ids to the vocabulary slices
    move("sp-scatter" if sp and not cfg.n_vis_tokens else "tp-sum", text * d * e, T - 1)
    if sp and cfg.n_vis_tokens and not recomputed:  # the patch embeddings' and text's cut
        move("tp-scatter", A, (T - 1) / T)
    norms(1)
    spread(A)  # the final norm's output to the head's slices
    if train:  # the loss's per-token statistics (B, S, K): max, sum of exps, gold
        stats = 4 * text
        bcast(2 * text * 4, grad=False)  # the labels (int64)
        move("tp-join", T * stats, (T - 1) / T, grad=False)  # the shards' maxima
        bcast(stats, grad=False)  # the maximum back
        move("tp-sum", 2 * stats, T - 1)  # the sums of exponentials, the gold logits
    else:
        move("tp-join", text * cfg.padded_vocab(T) * e, (T - 1) / T, grad=False)
    as_int = lambda c: {k: int(round(v)) for k, v in c.items() if v}  # noqa: E731
    if recomputed:
        return as_int(fwd), {}
    return as_int(fwd), as_int(bwd)
