"""The decoder LM: embeds → the block-pattern groups → final norm → head.

Parameters keep the reference's tree (``embed``, ``final_norm``,
``groups/p<i>_<type>`` stacked along a leading ``n_groups`` dim, ``extra``
for remainder layers), held by the :class:`LM` module.  The reference scans
over the groups; here the layers are a loop over them, each group
optionally rematerialised in the backward (``remat``).  Caches are stacked
the same way.  :func:`lm_loss` is the training loss.

Over a model mesh (``launch/mesh.py``), single-controller: each data row
runs the model on its own slice of the batch on its own first device, with
the model's :func:`replica` there (the model itself where it lies there),
and the logits gather onto the mesh's first device in row order.  Within a
row, ``use_ep`` runs each MoE layer expert-parallel over the row's model
shards, and the caches lie over those shards as the reference places them
(:func:`init_cache`): each block reads and writes its part where it lies.
A model made over a mesh of ``tp > 1`` shards (``init_model(...,
mesh=)``, ``params_from_numpy(..., mesh=)``) is tensor parallel: each row
keeps slice ``s`` of every leaf whose placement names the model axis on its
shard ``s`` and the rest whole on its first device (``models/tp.py``), and
the blocks compute on the slices where they lie.  A model whose state is
stored in slices over the rows or the shards (the train storage,
``models/fsdp.py``: :func:`init_placed`) has no replicas: each row gathers
a layer's weights onto its devices (each shard's slices onto the shard's)
inside the layer's remat region and frees them after; under tensor
parallelism an MoE runs expert-parallel over the same shards.

Sequence parallelism: under the reference's condition (:func:`seq_parallel`)
a tensor-parallel model keeps the residual stream between blocks in
sequence slices over the row's shards (``tp.SeqSlices``), as the reference's
``_constrain`` lays it out; every value is the whole-row path's.  A training
step over the shards takes the loss where the head's vocabulary slices lie
(:func:`forward_loss`, :func:`lm_loss_sliced`): no card holds a row's whole
logits.  The reference's other ``_constrain`` hints have no counterpart.
"""
from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels import ops as kops
from ..launch.mesh import indexed_device
from .attention import KVCache, ShardedKVCache
from . import tp as TP
from .base import (SINGLE, ShardCtx, init_params, resolve_device, stack_tree, tree_flatten,
                   tree_map)
from .blocks import Block, ParamTree, block_spec, init_block_cache
from .fsdp import Sliced, draw_leaf, place_leaf, use_tree
from .layers import (apply_norm, compute_dtype, embed_spec, embed_tokens, lm_logits, logit_slices,
                     norm_spec)
from .rglru import RGLRUCache
from .ssd import SSDCache

_CACHES = (SSDCache, KVCache, ShardedKVCache, RGLRUCache)

# ------------------------------------------------------------------ params --


def model_spec(cfg: ModelConfig, ctx: ShardCtx = SINGLE) -> Dict[str, Any]:
    n_groups, n_extra = cfg.pattern_groups
    pattern = cfg.block_pattern
    spec: Dict[str, Any] = {"embed": embed_spec(cfg, ctx), "final_norm": norm_spec(cfg)}
    if n_groups > 0:
        spec["groups"] = {
            f"p{i}_{btype}": stack_tree(block_spec(btype, cfg, ctx), n_groups)
            for i, btype in enumerate(pattern)
        }
    if n_extra:
        spec["extra"] = {
            f"x{i}_{pattern[i % len(pattern)]}": block_spec(pattern[i % len(pattern)], cfg, ctx)
            for i in range(n_extra)
        }
    return spec


class LM(nn.Module):
    """The model's parameters as modules; ``forward`` runs :func:`forward`.
    ``trainable``: the parameters require grad (the training storage)."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any], ctx: ShardCtx = SINGLE,
                 trainable: bool = False):
        super().__init__()
        self.cfg, self.ctx = cfg, ctx
        pattern = cfg.block_pattern
        self.embed = ParamTree(tree["embed"], trainable)
        self.final_norm = ParamTree(tree["final_norm"], trainable)
        self.groups = nn.ModuleDict({
            key: Block(pattern[i], cfg, sub, stacked=True, trainable=trainable)
            for i, (key, sub) in enumerate(tree.get("groups", {}).items())
        })
        self.extra = nn.ModuleDict({
            key: Block(pattern[i % len(pattern)], cfg, sub, stacked=False, trainable=trainable)
            for i, (key, sub) in enumerate(tree.get("extra", {}).items())
        })

    def tree(self) -> Dict[str, Any]:
        """The parameters as the reference's tree of tensors."""
        out = {"embed": self.embed.tree(), "final_norm": self.final_norm.tree()}
        if len(self.groups):
            out["groups"] = {key: block.tree() for key, block in self.groups.items()}
        if len(self.extra):
            out["extra"] = {key: block.tree() for key, block in self.extra.items()}
        return out

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def place_(self, fn) -> None:
        """Replace every parameter by ``fn(path, tensor)``, leaf by leaf
        (``blocks.ParamTree.place_``); replicas made before are dropped."""
        self.__dict__.pop("_replicas", None)
        self.embed.place_(fn, ("embed",))
        self.final_norm.place_(fn, ("final_norm",))
        for name in ("groups", "extra"):
            for key, block in getattr(self, name).items():
                block.place_(fn, (name, key))

    @property
    def tensor_parallel(self) -> bool:
        """Whether the parameters are held in slices over a data row's
        model shards (``models/tp.py``)."""
        return isinstance(self.embed.tok, TP.Shards)

    @property
    def placed(self) -> bool:
        """Whether the parameters are stored in slices over a mesh's data
        rows or model shards (the train storage, ``models/fsdp.py``)."""
        return isinstance(self.embed.tok, Sliced)

    @property
    def placed_tp(self) -> bool:
        """Whether the train storage slices the model-axis leaves over the
        model shards (tensor parallelism in training)."""
        return self.placed and self.embed.tok.tp_dim is not None

    @property
    def over_shards(self) -> bool:
        """Whether the model-axis leaves lie in slices over the model
        shards, to serve (:attr:`tensor_parallel`) or to train
        (:attr:`placed_tp`)."""
        return self.tensor_parallel or self.placed_tp

    def forward(self, tokens, cache=None, start_pos=None, remat: bool = False,
                vis_embeds=None, mesh=None, use_ep: bool = False):
        return forward(self, self.cfg, tokens, self.ctx, mesh=mesh, cache=cache,
                       start_pos=start_pos, remat=remat, vis_embeds=vis_embeds, use_ep=use_ep)


def replica(model: LM, device) -> LM:
    """The model's parameters on ``device``: the model itself where it lies
    there (no copy), else a copy made the first time and kept on the model
    (trainable if the model is), which :func:`sync_replicas` refreshes
    after an update.  A replica's replica is the model's.  A tensor-parallel
    model is placed by a data row's devices (``device``: a sequence of
    them): its slices on the row's shards, its whole leaves on the first."""
    model = model.__dict__.get("_master", model)
    if model.tensor_parallel:
        dev = tuple(indexed_device(d) for d in device)
        if model.embed.tok.devices == dev:
            return model
    else:
        dev = indexed_device(device)
        if model.device == dev or model.placed:
            return model  # a placed model gathers onto the device that computes
    reps = model.__dict__.setdefault("_replicas", {})
    if dev not in reps:
        trainable = next(model.parameters()).requires_grad
        with torch.no_grad():
            tree = tree_map(lambda t: t.to(dev) if isinstance(t, TP.Shards) else t.detach().to(
                dev[0] if isinstance(dev, tuple) else dev, copy=True), model.tree())
        rep = LM(model.cfg, tree, model.ctx, trainable=trainable)
        rep.__dict__["_master"] = model
        reps[dev] = rep
    return reps[dev]


def sync_replicas(model: LM) -> None:
    """Copy the model's parameters into each of its replicas."""
    with torch.no_grad():
        for rep in model.__dict__.get("_replicas", {}).values():
            for p, q in zip(rep.parameters(), model.parameters()):
                p.copy_(q)


def data_rows(mesh, cfg: ModelConfig, batch: int, use_ep: bool = False) -> int:
    """How many data rows of ``mesh`` split a batch of ``batch``: all of
    them when they divide it and the rows are independent (a dense model,
    or MoE run expert-parallel, which routes each row at its own capacity as
    the reference's EP does); else one, the first, which takes the whole
    batch (a global-semantics MoE routes the whole batch at one capacity)."""
    n = mesh.dp_total
    return n if n > 1 and batch % n == 0 and (cfg.moe is None or use_ep) else 1


def init_model(cfg: ModelConfig, ctx: ShardCtx = SINGLE, seed: int = 0, device=None,
               trainable: bool = False, mesh=None) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (the card unless asked).  Serving: each in the type it is
    used in.  ``trainable``: every leaf float32 and requiring grad, cast to
    the compute type at use (the reference's master weights).  ``mesh``
    with ``tp > 1`` model shards: made straight into the slices of a
    tensor-parallel model (the generator on the mesh's first device; the
    values are those made whole there): for serving, over its first data
    row (``tp.init_params_sliced``); ``trainable``, the train storage over
    its data rows and model shards (:func:`init_placed`)."""
    if mesh is not None and mesh.tp > 1:
        if mesh.tp != ctx.tp:
            raise ValueError(f"a mesh of {mesh.tp} model shards under ShardCtx(tp={ctx.tp})")
        if trainable:
            return init_placed(cfg, ctx, mesh, seed)
        devices = mesh.row_devices(0)
        resolve_device(devices[0])
        return LM(cfg, TP.init_params_sliced(model_spec(cfg, ctx), seed, compute_dtype(cfg),
                                             devices), ctx)
    dev = resolve_device(device if mesh is None else mesh.first)
    tree = init_params(model_spec(cfg, ctx), seed, compute_dtype(cfg), dev, master=trainable)
    return LM(cfg, tree, ctx, trainable=trainable)


def mesh_ctx(mesh, tp: int, fsdp: bool = True) -> ShardCtx:
    """The context whose placements a train state over ``mesh`` stores:
    ``tp`` model shards and, with ``fsdp``, the mesh's data rows (without,
    no data axis: each row holds the state whole over the data axes)."""
    if not fsdp:
        return ShardCtx(tp=tp)
    if mesh.axis_names[0] == "pod":
        return ShardCtx(tp=tp, dp=mesh.shape[1], pods=mesh.shape[0], data_axes=("pod", "data"))
    return ShardCtx(tp=tp, dp=mesh.shape[0])


def placer(cfg: ModelConfig, ctx: ShardCtx, mesh, fsdp: bool = True):
    """(path, whole leaf, requires grad) → the leaf placed over ``mesh``
    (``fsdp.place_leaf``), from the placements at :func:`mesh_ctx`."""
    mctx = mesh_ctx(mesh, ctx.tp, fsdp)
    specs = dict(tree_flatten(model_spec(cfg, mctx)))

    def place(path, t, requires_grad):
        spec = specs[path]
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {spec.shape}")
        return place_leaf(t, spec.placement, mctx.data_spec(), path, mesh, requires_grad)

    return place


def init_placed(cfg: ModelConfig, ctx: ShardCtx, mesh, seed: int = 0, fsdp: bool = True) -> LM:
    """``init_model(..., trainable=True)``'s float32 weights, each leaf
    drawn on the mesh's first device from the generator that would make the
    whole model there and placed over ``mesh`` as it is drawn
    (``fsdp.draw_leaf``: a leaf over ``base.WHOLE_DRAW_MAX`` elements a
    layer slice at a time), so the whole model never lies on one device:
    sliced over the model shards where a leaf's placement names the model
    axis and, with ``fsdp``, over the data rows where it names the data
    axes (without, held whole on every row)."""
    if mesh.tp != ctx.tp:
        raise ValueError(f"a mesh of {mesh.tp} model shards under ShardCtx(tp={ctx.tp})")
    first = resolve_device(mesh.first)
    gen = torch.Generator(device=first)
    gen.manual_seed(seed)
    mctx = mesh_ctx(mesh, ctx.tp, fsdp)
    compute = compute_dtype(cfg)
    tree = TP.map_paths(lambda path, spec: draw_leaf(spec, gen, compute, mctx.data_spec(), path,
                                                     mesh), model_spec(cfg, mctx))
    return LM(cfg, tree, ctx, trainable=True)


def expert_parallel(model: LM, cfg: ModelConfig, use_ep: bool) -> bool:
    """Whether an MoE layer runs expert-parallel over a data row's shards:
    as asked, and always where the train storage slices the experts over
    the model shards (each shard computes with its own experts).  Which
    rows take the batch is :func:`data_rows`' to say, from the caller's
    ``use_ep``: without it the batch stays whole on the first row and is
    routed at one capacity, with one pair of aux losses, as the
    reference's global ``moe_ffn``."""
    return use_ep or (cfg.moe is not None and isinstance(model, LM) and model.placed_tp)


# ------------------------------------------------------------------- cache --


@dataclass
class RowCaches:
    """A cache tree for each data row of a mesh that splits the batch."""

    rows: List[Any]


def _over_fields(fn, caches):
    """A cache made field by field from ``caches`` (alike): ``fn`` over the
    fields' tensors, slice by slice where a field is held in slices over
    the shards (a tuple); any other field (a split dimension) as the first
    cache's."""
    first = caches[0]
    if not isinstance(first, _CACHES):
        raise TypeError(f"no rule for {type(first).__name__}")

    def field(vals):
        if isinstance(vals[0], tuple):
            return tuple(fn(list(ts)) for ts in zip(*vals))
        return fn(vals) if isinstance(vals[0], torch.Tensor) else vals[0]

    return dataclasses.replace(first, **{f.name: field([getattr(c, f.name) for c in caches])
                                         for f in dataclasses.fields(first)})


def _stack(caches):
    return _over_fields(torch.stack, caches)


def _index(cache, i: int):
    return _over_fields(lambda ts: ts[0][i], [cache])


def init_cache(cfg: ModelConfig, batch: int, capacity: int, device=None, mesh=None,
               use_ep: bool = False):
    """Per-layer caches, stacked like the parameters, on ``device`` (the
    card unless asked).  Over a ``mesh``: one cache tree a data row where
    :func:`data_rows` splits the batch (:class:`RowCaches`), each placed
    over its row's model shards leaf by leaf as ``launch.specs.split_dims``
    says (the reference's ``make_cache_specs`` but for its one exception):
    a KV cache by kv heads, else by slots (split-S decode), the SSD state by
    heads, the RG-LRU state and every conv tail by width, each where ``tp``
    divides it; the rest (``pos``, a ring whose kv heads do not divide) on
    the row's first device."""
    if mesh is not None:
        rows = data_rows(mesh, cfg, batch, use_ep)
        if rows > 1:
            return RowCaches([init_cache(cfg, batch // rows, capacity, mesh=mesh.row(r))
                              for r in range(rows)])
        from ..launch.specs import split_dims

        shards = mesh.row_devices(0)
        meta = init_cache(cfg, batch, capacity, device="meta")
        dims = split_dims(cfg, len(shards), meta)
        return {part: {key: _placed(node, dims[part][key], shards, part == "groups")
                       for key, node in caches.items()} for part, caches in meta.items()}
    dev = resolve_device(device)
    n_groups, n_extra = cfg.pattern_groups
    pattern = cfg.block_pattern
    cache: Dict[str, Any] = {}
    if n_groups > 0:
        cache["groups"] = {
            f"p{i}_{btype}": _stack(
                [init_block_cache(btype, cfg, batch, capacity, dev)] * n_groups)
            for i, btype in enumerate(pattern)
        }
    if n_extra:
        cache["extra"] = {
            f"x{i}_{pattern[i % len(pattern)]}": init_block_cache(
                pattern[i % len(pattern)], cfg, batch, capacity, dev)
            for i in range(n_extra)
        }
    return cache


def _placed(meta, dims, shards, stacked: bool):
    """The zero cache of ``meta``'s shapes placed over a data row's model
    ``shards``: a field that ``dims`` splits as a tuple of its slices, slice
    ``s`` on ``shards[s]``; any other whole on the first.  A KV cache split
    so is a :class:`ShardedKVCache` along that dimension."""
    def make(t, dim):
        if dim is None:
            return torch.zeros(t.shape, dtype=t.dtype, device=shards[0])
        shape = list(t.shape)
        shape[dim + stacked] //= len(shards)
        return tuple(torch.zeros(shape, dtype=t.dtype, device=d) for d in shards)

    fields = {f.name: make(getattr(meta, f.name), getattr(dims, f.name))
              for f in dataclasses.fields(meta)}
    if isinstance(meta, KVCache) and dims.k is not None:
        return ShardedKVCache(dim=dims.k, **fields)
    return dataclasses.replace(meta, **fields)


def cache_tensors(cache):
    """Every tensor of a stacked cache tree, each shard's slice once."""
    if isinstance(cache, RowCaches):
        return [t for row in cache.rows for t in cache_tensors(row)]
    out = []
    tree_map(lambda c: out.extend(c.tensors()), cache)
    return out


def cache_shard_bytes(cache, tp: int) -> List[int]:
    """The bytes each of a data row's ``tp`` model shards holds of its cache
    tree, by its layout: a field held in slices, slice ``s`` on shard ``s``;
    a whole tensor on shard 0 (the row's first device)."""
    if isinstance(cache, RowCaches):
        raise TypeError("cache_shard_bytes takes one data row's cache tree")
    out = [0] * tp

    def count(c):
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            if isinstance(v, torch.Tensor):
                out[0] += v.numel() * v.element_size()
            elif isinstance(v, tuple):
                for s, t in enumerate(v):
                    out[s] += t.numel() * t.element_size()

    tree_map(count, cache)
    return out


# ----------------------------------------------------------------- forward --


def seq_parallel(mesh, S: int, tp: int, cache) -> bool:
    """The reference's condition for sequence parallelism between blocks
    (its ``seq_sp``), with ``tp > 1``: a model mesh, more than one
    position, a sequence (a VLM's patch embeddings included) that ``tp``
    divides, and no cache."""
    return mesh is not None and tp > 1 and S > 1 and S % tp == 0 and cache is None


def forward(
    params: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, S) or (B, K, S) for multi-codebook
    ctx: ShardCtx = SINGLE,
    mesh=None,
    cache=None,
    start_pos: Optional[torch.Tensor] = None,
    remat: bool = False,
    vis_embeds: Optional[torch.Tensor] = None,  # (B, n_vis, d) VLM stub input
    use_ep: bool = False,
) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Returns (logits, new_cache, aux_losses).  ``remat`` (without a cache)
    recomputes each group's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant).  A VLM config
    (``cfg.n_vis_tokens``) given ``vis_embeds`` prepends them to the token
    embeddings; positions run over the whole sequence and the logits cover
    the text positions only, as in the reference.  ``mesh``: a model mesh
    (``launch.mesh.make_mesh``) to run over, the logits and aux losses on
    its first device; ``use_ep`` runs the MoE layers expert-parallel.  A
    tensor-parallel model under :func:`seq_parallel` runs with its residual
    stream in sequence slices; the logits come back joined."""
    return _forward(params, cfg, tokens, ctx, mesh, cache, start_pos, remat, vis_embeds,
                    use_ep, None)


def forward_loss(params: LM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 ctx: ShardCtx = SINGLE, mesh=None, remat: bool = False, use_ep: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(the training loss of ``batch``, the aux losses).  A tensor-parallel
    model over a mesh of model shards takes the loss where the head's
    vocabulary slices lie (:func:`lm_loss_sliced`): each shard computes and
    keeps its columns of the logits, only per-token statistics move, and a
    data row's nll sum and label count go to the mesh's first device, the
    rows' added there in row order.  Any other model: :func:`lm_loss` on
    :func:`forward`'s logits."""
    if mesh is not None and mesh.tp > 1 and params.over_shards:
        (nll, count), _, aux = _forward(params, cfg, batch["tokens"], ctx, mesh, None, None,
                                        remat, batch.get("vis_embeds"), use_ep, batch["labels"])
        return nll / count.clamp(min=1), aux
    logits, _, aux = forward(params, cfg, batch["tokens"], ctx, mesh=mesh, remat=remat,
                             vis_embeds=batch.get("vis_embeds"), use_ep=use_ep)
    return lm_loss(logits, batch["labels"], cfg.vocab), aux


def _forward(params: LM, cfg: ModelConfig, tokens, ctx: ShardCtx, mesh, cache, start_pos,
             remat: bool, vis_embeds, use_ep: bool, labels):
    """:func:`forward`; given ``labels``, the head computes the loss on its
    vocabulary slices instead of the logits → ((the nll sum, the label
    count) on the mesh's first device, None, aux losses)."""
    shard_models = None
    if mesh is not None:
        if mesh.tp != ctx.tp:
            raise ValueError(f"a mesh of {mesh.tp} model shards under ShardCtx(tp={ctx.tp})")
        rows = data_rows(mesh, cfg, tokens.shape[0], use_ep)
        if rows > 1:
            return _forward_rows(params, cfg, tokens, ctx, mesh, rows, cache, start_pos, remat,
                                 vis_embeds, use_ep, labels)
        mesh = mesh.row(0)
    use_ep = expert_parallel(params, cfg, use_ep)
    if mesh is not None:
        tensor_parallel = params.tensor_parallel
        params = replica(params, mesh.row_devices(0) if tensor_parallel else mesh.first)
        tokens = tokens.to(mesh.first)
        if use_ep and cfg.moe is not None and not tensor_parallel:
            shard_models = [replica(params, d) for d in mesh.row_devices(0)]
    dt = compute_dtype(cfg)
    dev = tokens.device
    backend = kops.backend()  # a recompute runs on autograd's thread

    def contexts():
        return nullcontext(), kops.local_backend(backend)

    remat = remat and cache is None
    placed = params.placed

    def region(fn, *args, always: bool = False):
        """``fn(*args)``, its activations recomputed in the backward under
        ``remat``: a group's always (the reference's jax.checkpoint around
        the group body), the embedding's, an extra block's and the head's
        where the weights are sliced, so that their gathers run again in
        the backward instead of being kept.  A region over the model
        shards recomputes inside one backward node (:class:`_Recompute`)."""
        if not (remat and (always or placed)):
            return fn(*args)
        if params.placed_tp:
            return _Recompute.run(fn, backend, *args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)

    emb = params.embed.tree()
    tied = None
    if placed and cfg.tie_embeddings:
        # the table serves both ends: gathered once a row, so that the
        # gradients of its two uses add as on a whole leaf
        tied = use_tree({"tok": emb["tok"]}, dev)

    def embed_params(keys):
        return tied or use_tree({k: emb[k] for k in keys}, dev)

    vis = cfg.n_vis_tokens and vis_embeds is not None
    n_vis = vis_embeds.shape[1] if vis else 0
    sp = params.over_shards and seq_parallel(mesh, tokens.shape[-1] + n_vis, ctx.tp, cache)
    # a VLM's patch embeddings join the text's before the sequence is cut
    x = region(lambda t: embed_tokens(embed_params(("tok",)), cfg, t, seq=sp and not vis).to(dt),
               tokens)
    if vis:
        x = torch.cat([vis_embeds.to(device=x.device, dtype=dt), x], dim=1)
        if sp:
            x = TP.cut_seq(x, mesh.row_devices(0))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if start_pos is not None:
        positions = start_pos + positions

    n_groups, n_extra = cfg.pattern_groups
    new_cache: Optional[Dict[str, Any]] = None if cache is None else {}
    aux_total: Dict[str, torch.Tensor] = {}

    def merge(aux):
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v

    if n_groups > 0:
        outs: Dict[str, list] = {key: [] for key in params.groups}

        def group_body(x, g):
            auxes = []
            for key, block in params.groups.items():
                c_in = None if cache is None else _index(cache["groups"][key], g)
                shards = None if shard_models is None else [m.groups[key] for m in shard_models]
                x, c_out, aux = block(x, positions, ctx, layer=g, cache=c_in, mesh=mesh,
                                      use_ep=use_ep, shards=shards, cfg=cfg)
                auxes.append(aux)
                if c_out is not None:
                    outs[key].append(c_out)
            return x, auxes

        for g in range(n_groups):
            # the recompute runs on the same kernel backend as the forward
            x, auxes = region(group_body, x, g, always=True)
            for aux in auxes:
                merge(aux)
        if new_cache is not None:
            new_cache["groups"] = {key: _stack(cs) for key, cs in outs.items()}
    if n_extra:
        extra: Dict[str, Any] = {}
        for key, block in params.extra.items():
            c_in = None if cache is None else cache["extra"][key]
            shards = None if shard_models is None else [m.extra[key] for m in shard_models]
            x, c_out, aux = region(
                lambda x, block=block, c_in=c_in, shards=shards: block(
                    x, positions, ctx, cache=c_in, mesh=mesh, use_ep=use_ep, shards=shards,
                    cfg=cfg), x)
            merge(aux)
            if c_out is not None:
                extra[key] = c_out
        if new_cache is not None:
            new_cache["extra"] = extra

    def head(x, labels=None):
        x = apply_norm(use_tree(params.final_norm.tree(), dev), cfg, x)
        w = embed_params(("tok",) if cfg.tie_embeddings else ("head",))
        if labels is None:
            return lm_logits(w, cfg, x, ctx.tp, skip=n_vis)  # text positions only
        return lm_loss_sliced(logit_slices(w, cfg, x, skip=n_vis), labels, cfg.vocab,
                              cfg.n_codebooks, sum_only=True)

    if labels is None:
        return region(head, x), new_cache, aux_total
    labels = labels.to(dev)
    return (region(head, x, labels), (labels != -100).sum()), None, aux_total


def _forward_rows(params: LM, cfg: ModelConfig, tokens, ctx: ShardCtx, mesh, rows: int, cache,
                  start_pos, remat: bool, vis_embeds, use_ep: bool, labels=None):
    """:func:`forward` over ``rows`` data rows, each on its slice of the
    batch; the logits gather onto the mesh's first device in row order, and
    each aux loss is the mean over the rows (added in row order).  Given
    ``labels``, no logits move: each row's nll sum and label count (scalars)
    are added on the mesh's first device in row order."""
    b = tokens.shape[0] // rows
    outs = []
    for r in range(rows):
        dev = mesh.device(r, 0)
        part = slice(r * b, (r + 1) * b)
        outs.append(_forward(
            params, cfg, tokens[part], ctx, mesh.row(r),
            None if cache is None else cache.rows[r],
            None if start_pos is None else start_pos.to(dev), remat,
            None if vis_embeds is None else vis_embeds[part], use_ep,
            None if labels is None else labels[part]))
    first = mesh.first
    if labels is None:
        out = torch.cat([o[0].to(first) for o in outs])
    else:  # the rows' nll sums and label counts, added in row order
        out = outs[0][0]
        for o in outs[1:]:
            out = tuple(a + b.to(first) for a, b in zip(out, o[0]))
    aux: Dict[str, torch.Tensor] = {}
    for k in outs[0][2]:
        total = outs[0][2][k].to(first)
        for o in outs[1:]:
            total = total + o[2][k].to(first)
        aux[k] = total / rows
    new_cache = None if cache is None else RowCaches([o[1] for o in outs])
    return out, new_cache, aux


class _Recompute(torch.autograd.Function):
    """A region run without keeping its activations, then run again inside
    this node's backward, where its own backward runs too (a reentrant
    recompute).  A region over the model shards saves tensors on several
    devices, whose backward nodes the autograd engine runs on several
    device threads at once: ``torch.utils.checkpoint``'s non-reentrant
    recompute starts from whichever thread first unpacks a saved tensor,
    and two threads may start it at once.  Here one node owns the
    recompute.  The outputs are the region's tensors, flattened (a group's
    aux losses beside its activation); an input that requires grad takes
    its gradient back, and an anchor that requires grad makes the outputs
    of a region without one (the embedding's: token ids in) differentiable,
    so that its gathers' backward still adds into the weights'
    accumulators.  The inputs are flattened too (a ``tp.SeqSlices`` into
    its slices)."""

    @staticmethod
    def run(fn, backend, *args):
        box = []
        anchor = torch.empty(0, requires_grad=True)
        leaves, spec = pytree.tree_flatten(args)
        flat = _Recompute.apply(lambda *ls: fn(*pytree.tree_unflatten(list(ls), spec)), backend,
                                box, anchor, *leaves)
        return pytree.tree_unflatten(list(flat), box[0])

    @staticmethod
    def forward(ctx, fn, backend, box, anchor, *args):
        ctx.fn, ctx.backend, ctx.args = fn, backend, args
        with torch.no_grad(), kops.local_backend(backend):
            flat, spec = pytree.tree_flatten(fn(*args))
        box.append(spec)
        return tuple(flat)

    @staticmethod
    def backward(ctx, *grads):
        args = tuple(a.detach().requires_grad_(a.requires_grad) if torch.is_tensor(a) else a
                     for a in ctx.args)
        with torch.enable_grad(), kops.local_backend(ctx.backend):
            flat, _ = pytree.tree_flatten(ctx.fn(*args))
        pairs = [(o, g) for o, g in zip(flat, grads)
                 if g is not None and torch.is_tensor(o) and o.requires_grad]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
        return (None, None, None, None,
                *(a.grad if torch.is_tensor(a) and a.requires_grad else None for a in args))


# -------------------------------------------------------------------- loss --


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 over labels != -100.
    logits (B, S, V) or (B, S, K, V); labels (B, S) or (B, K, S).  The
    padded vocab tail is masked out of the softmax; the gold logit is
    gathered (the reference's masked sum selects the same value)."""
    lf = logits.float()
    if lf.shape[-1] > vocab:
        pad = torch.arange(lf.shape[-1], device=lf.device) >= vocab
        lf = lf.masked_fill(pad, -1e30)
    if logits.dim() == 4:  # multi-codebook: (B, S, K, V) against labels (B, K, S)
        lf = lf.permute(0, 2, 1, 3)
    mask = labels != -100
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1)


def lm_loss_sliced(parts: List[torch.Tensor], labels: torch.Tensor, vocab: int,
                   codebooks: int = 1, sum_only: bool = False) -> torch.Tensor:
    """:func:`lm_loss` of logits held as the shards' column slices: ``parts``
    (B, S, c_s), each on its shard's device, in shard order, which joined
    along the last dimension are the logits (B, S, K·V), V the padded
    vocabulary (codebook k's columns ``[k·V, (k+1)·V)``, against labels
    (B, K, S)).  The softmax runs where the columns lie: each shard takes
    its maximum over the columns of each codebook it holds (the padded tail
    masked where it lies; -1e30 for a codebook it holds none of), the
    global maximum is the exact maximum of the shards' maxima, the shards'
    sums of exponentials are added in shard order in float32
    (``tp.reduce_sum``), and the gold logit is the label's column on the
    shard that holds it, 0 on the others, added the same way.  Only these
    per-token values (B, S, K) and the labels move, every shard taking part
    in each move, and each shard's gradient of its columns forms on its
    device.  → on the labels' device, the mean nll over labels != -100
    (``sum_only``: their sum)."""
    dev = labels.device
    devs = [p.device for p in parts]
    V = sum(p.shape[-1] for p in parts) // codebooks
    mask = labels != -100
    safe = torch.where(mask, labels, 0).long()
    ids_at = TP.broadcast(safe[:, None] if codebooks == 1 else safe, devs)  # (B, K, S) a shard
    segs, at = [], 0
    for p in parts:  # each shard's (first vocab id, float32 logits) of each codebook, or None
        row = []
        for k in range(codebooks):
            lo, hi = max(k * V, at), min((k + 1) * V, at + p.shape[-1])
            if lo >= hi:
                row.append(None)
                continue
            seg = p[..., lo - at:hi - at].float()
            if hi - k * V > vocab:  # the padded tail
                seg = seg.masked_fill(torch.arange(lo - k * V, hi - k * V, device=p.device)
                                      >= vocab, -1e30)
            row.append((lo - k * V, seg))
        segs.append(row)
        at += p.shape[-1]
    shape = parts[0].shape[:-1]
    with torch.no_grad():
        maxima = [torch.stack([torch.full(shape, -1e30, device=d) if c is None else c[1].amax(-1)
                               for c in row], -1) for row, d in zip(segs, devs)]
        top = TP.join([m[None] for m in maxima], 0, dev).amax(0)  # (B, S, K)
        tops = TP.broadcast(top, devs)
    sums, golds = [], []
    for row, d, t, ids in zip(segs, devs, tops, ids_at):
        zero = torch.zeros(shape, device=d)
        e, g = [], []
        for k, c in enumerate(row):
            if c is None:
                e.append(zero)
                g.append(zero)
                continue
            first, seg = c
            e.append(torch.exp(seg - t[..., k:k + 1]).sum(-1))
            local = ids[:, k] - first
            hit = (local >= 0) & (local < seg.shape[-1])
            picked = seg.gather(-1, local.clamp(0, seg.shape[-1] - 1)[..., None])[..., 0]
            g.append(torch.where(hit, picked, 0.0))
        sums.append(torch.stack(e, -1))
        golds.append(torch.stack(g, -1))
    nll = (top + torch.log(TP.reduce_sum(sums, dev)) - TP.reduce_sum(golds, dev)).permute(0, 2, 1)
    nll = (nll[:, 0] if codebooks == 1 else nll) * mask
    total = nll.sum()
    return total if sum_only else total / mask.sum().clamp(min=1)
