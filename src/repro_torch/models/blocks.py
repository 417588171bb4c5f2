"""Per-layer blocks with per-type caches: (pre-norm residual) attention and
local-attention blocks with their MLP or MoE feed-forward, the SSD block,
and the RG-LRU block with its MLP.

A block's leaves held in slices over a data row's model shards
(``models/tp.py``) reach the layers as tuples of the shards' slices; the
norms and the residual adds stay on the row's first device, or, where the
row's activation is in sequence slices over the shards (``tp.SeqSlices``),
run on each slice where it lies.  An MoE block keeps its feed-forward as it
is: expert-parallel under ``use_ep`` (its experts' slices are the shards'
experts), else the global path on the experts joined on the first device;
over sequence slices the slices join on the first device for it and its
output is cut back."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import tp as TP
from .base import ShardCtx
from .attention import attention_block, attn_spec, init_kv_cache
from .fsdp import Sliced, gather, use_tree
from .layers import apply_mlp, apply_norm, mlp_spec, norm_spec
from .moe import EXPERT_LEAVES, moe_ffn, moe_ffn_sharded, moe_spec
from .rglru import init_rglru_cache, rglru_block, rglru_spec
from .ssd import init_ssd_cache, ssd_block, ssd_spec

ATTENTION = ("attn", "local_attn")


def block_spec(btype: str, cfg: ModelConfig, ctx: ShardCtx) -> Dict[str, Any]:
    if btype in ATTENTION:
        spec = {"norm1": norm_spec(cfg), "attn": attn_spec(cfg, ctx), "norm2": norm_spec(cfg)}
        if cfg.moe is not None:
            spec["moe"] = moe_spec(cfg, ctx)
        else:
            spec["mlp"] = mlp_spec(cfg, ctx)
        return spec
    if btype == "ssd":
        return {"norm1": norm_spec(cfg), "ssd": ssd_spec(cfg, ctx)}
    if btype == "rglru":
        return {"norm1": norm_spec(cfg), "rglru": rglru_spec(cfg, ctx), "norm2": norm_spec(cfg),
                "mlp": mlp_spec(cfg, ctx)}
    raise ValueError(f"unknown block type {btype!r}")


def init_block_cache(btype: str, cfg: ModelConfig, batch: int, capacity: int, device):
    if btype in ATTENTION:
        window = cfg.window if btype == "attn" else cfg.local_window
        return init_kv_cache(cfg, batch, capacity, window=window, device=device)
    if btype == "ssd":
        return init_ssd_cache(cfg, batch, device)
    if btype == "rglru":
        return init_rglru_cache(cfg, batch, device)
    raise ValueError(f"unknown block type {btype!r}")


def block_fwd(
    btype: str,
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    ctx: ShardCtx,
    cache=None,
    use_ep: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """One pre-norm residual block → (x, new cache, aux losses).  ``mesh``:
    the data row's model mesh; ``use_ep`` runs the MoE expert-parallel
    over it."""
    aux: Dict[str, torch.Tensor] = {}
    if btype in ATTENTION:
        window = cfg.window if btype == "attn" else cfg.local_window
        h, new_cache = attention_block(params["attn"], cfg, apply_norm(params["norm1"], cfg, x),
                                       positions, window=window, cache=cache, mesh=mesh, ctx=ctx)
        x = x + h
        h2_in = apply_norm(params["norm2"], cfg, x)
        if cfg.moe is not None:
            if use_ep and mesh is not None:
                h2, aux = TP.on_whole(lambda t: moe_ffn_sharded(params["moe"], cfg, t, ctx, mesh),
                                      h2_in)
            else:
                h2, aux = TP.on_whole(lambda t: moe_ffn(params["moe"], cfg, t, ctx), h2_in)
        else:
            h2 = apply_mlp(params["mlp"], cfg, h2_in)
        return x + h2, new_cache, aux
    if btype == "ssd":
        h, new_cache = ssd_block(params["ssd"], cfg, apply_norm(params["norm1"], cfg, x),
                                 cache=cache)
        return x + h, new_cache, aux
    if btype == "rglru":
        h, new_cache = rglru_block(params["rglru"], cfg, apply_norm(params["norm1"], cfg, x),
                                   cache=cache)
        x = x + h
        return x + apply_mlp(params["mlp"], cfg, apply_norm(params["norm2"], cfg, x)), new_cache, aux
    raise ValueError(f"unknown block type {btype!r}")


class ParamTree(nn.Module):
    """A nested dict of tensors held as a module: its parameter names are
    the tree's paths joined by dots, so the reference's parameter tree maps
    onto the port's one to one.  ``trainable`` parameters require grad.  A
    leaf stored in slices over a mesh (``fsdp.Sliced``, ``tp.Shards``) is
    held as it is, outside the module's parameters."""

    def __init__(self, tree: Dict[str, Any], trainable: bool = False):
        super().__init__()
        self._sliced: Dict[str, Any] = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, trainable))
            elif isinstance(v, (Sliced, TP.Shards)):
                self._sliced[k] = v
                setattr(self, k, v)
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=trainable))

    def tree(self) -> Dict[str, Any]:
        out = {name: p for name, p in self.named_parameters(recurse=False)}
        out.update(self._sliced)
        out.update({name: m.tree() for name, m in self.named_children()})
        return out

    def place_(self, fn, prefix: Tuple[str, ...] = ()) -> None:
        """Replace every parameter by ``fn(path, tensor)`` (a ``Sliced``),
        leaf by leaf, dropping the module's hold on each tensor as it goes."""
        for name in list(self._parameters):
            t = self._parameters.pop(name)
            self._sliced[name] = leaf = fn(prefix + (name,), t)
            del t
            setattr(self, name, leaf)
        for name, m in self.named_children():
            m.place_(fn, prefix + (name,))


class Block(ParamTree):
    """The parameters of one block type of the pattern, stacked over the
    layers that use it (leading ``n_groups`` dimension when ``stacked``)."""

    def __init__(self, btype: str, cfg: ModelConfig, tree: Dict[str, Any], stacked: bool,
                 trainable: bool = False):
        super().__init__(tree, trainable)
        self.btype, self.cfg, self.stacked = btype, cfg, stacked

    def layer(self, layer: int, device=None):
        """Layer ``layer``'s parameters as ``device`` computes with them:
        sliced leaves gathered there (``fsdp.use_tree``)."""
        return use_tree(self.tree(), device, layer if self.stacked else None)

    def expert_slice(self, name: str, layer: int, shard: int, shards: int, device):
        """Model shard ``shard`` of ``shards``'s experts of leaf ``name`` at
        ``layer``: a view of this block's leaf (a replica on the shard's
        device), or, sliced, the shard's slices gathered onto ``device``."""
        w = self.tree()["moe"][name]
        if isinstance(w, Sliced):
            return gather(w, device, layer if self.stacked else None, shard)
        w = w[layer] if self.stacked else w
        e_loc = w.shape[0] // shards
        return w[shard * e_loc:(shard + 1) * e_loc]

    def forward(self, x, positions, ctx: ShardCtx, layer: int = 0, cache=None, mesh=None,
                use_ep: bool = False, shards: Optional[Sequence["Block"]] = None,
                cfg: Optional[ModelConfig] = None):
        """``shards``: this block on each model shard's device (the model's
        replicas there), whose expert slices the shards compute with.
        ``cfg``: the config the caller runs the model under (``lm.forward``'s,
        as the reference's blocks take it), else the one it was made with."""
        tree = self.tree()
        ep = shards is not None and "moe" in tree
        params = use_tree(tree, x.device, layer if self.stacked else None,
                          skip=EXPERT_LEAVES if ep else ())
        if ep:
            moe = dict(params["moe"])
            devices = mesh.row_devices(0)
            for name in EXPERT_LEAVES:
                if name in tree["moe"]:
                    moe[name] = tuple(b.expert_slice(name, layer, s, len(shards), devices[s])
                                      for s, b in enumerate(shards))
            params = dict(params, moe=moe)
        elif "moe" in params and not (use_ep and mesh is not None):
            # experts in slices over the shards, run by the global path
            params = dict(params, moe={k: TP.join(w, 0, x.device) if isinstance(w, tuple) else w
                                       for k, w in params["moe"].items()})
        return block_fwd(self.btype, params, cfg or self.cfg, x, positions, ctx, cache=cache,
                         use_ep=use_ep, mesh=mesh)
