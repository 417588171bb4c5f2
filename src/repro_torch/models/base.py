"""Parameter declaration: one source of truth for shapes and initialisation.

``model_spec`` builds a tree of :class:`ParamSpec` (shape, init rule, and
whether the reference casts the parameter to the compute type where it is
used); :func:`init_params` materialises tensors from it with a seeded
``torch.Generator``.  Serving stores a cast-at-use parameter in the compute
type; training (``master=True``) stores every leaf in float32, as the
reference does, and casts at use, so AdamW's small updates are not lost to
bf16 rounding.

Each spec carries the reference's placement: one entry per dimension,
``None``, the model axis, or the data axes (``"data"``, or ``("pod",
"data")``), equal to ``tuple(pspec)`` of the reference's ``PartitionSpec``
(Megatron TP over ``model``, ZeRO/FSDP over the data axes where the
dimension divides).  Over the single-controller mesh (``launch/mesh.py``) a
model at ``tp > 1`` keeps, on each data row, slice ``s`` of every leaf whose
placement names the model axis on the row's shard ``s`` (``models/tp.py``)
and the rest whole on the row's first device; a train state keeps its
data-axis slices on the rows too (``models/fsdp.py``).  The placements are
what the reference's dry run shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ShardCtx:
    """Mesh-shape context: axis names and sizes (no live mesh needed)."""

    tp: int = 1
    dp: int = 1
    pods: int = 1
    model_axis: str = "model"
    data_axes: Tuple[str, ...] = ("data",)  # ("pod", "data") for multi-pod

    @property
    def dp_total(self) -> int:
        return self.dp * self.pods

    def data_spec(self):
        """The combined data-parallel axes: one name, or a tuple of them."""
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]


SINGLE = ShardCtx()

# A leaf of more elements is drawn one slice of its first (layer-stack)
# dimension at a time: drawn whole, its float32 draw and the scaled copy
# take 8 bytes an element beside the leaf (qwen3_moe_30b_a3b's stacked
# experts, 9.66e9 elements a leaf, could not be made on an 80 GB card).
WHOLE_DRAW_MAX = 1 << 31


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"  # "normal:<scale>" | "zeros" | "ones"
    # the reference casts it to the compute type where it is used
    # (``.astype(dt)``), so the port stores it in that type
    at_use: bool = False
    # one entry a dimension: None, a mesh axis name or a tuple of them
    placement: Tuple[Any, ...] = ()

    def dtype(self, compute: torch.dtype, master: bool = False) -> torch.dtype:
        return compute if self.at_use and not master else torch.float32

    @property
    def drawn_whole(self) -> bool:
        """Whether :meth:`materialise` makes the leaf in one draw; else it
        draws one slice of the first dimension at a time
        (:meth:`draw_slice`), so that the float32 draw beside the leaf is
        one slice's (ROADMAP C16)."""
        return self.init in ("zeros", "ones") or math.prod(self.shape) <= WHOLE_DRAW_MAX

    def draw_slice(self, gen: torch.Generator, device) -> torch.Tensor:
        """The next first-dimension slice of a leaf not drawn whole: float32,
        scaled; stored, it rounds to the leaf's type."""
        return torch.randn(self.shape[1:], generator=gen, dtype=torch.float32,
                           device=device).mul_(self._scale())

    def _scale(self) -> float:
        return float(self.init.split(":", 1)[1]) if ":" in self.init else 0.02

    def materialise(self, gen: torch.Generator, compute: torch.dtype,
                    device, master: bool = False) -> torch.Tensor:
        dt = self.dtype(compute, master)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        if self.drawn_whole:
            out = torch.randn(self.shape, generator=gen, dtype=torch.float32, device=device)
            return (out * self._scale()).to(dt)
        out = torch.empty(self.shape, dtype=dt, device=device)
        for i in range(self.shape[0]):
            out[i] = self.draw_slice(gen, device)
        return out


def _divides(dim: int, parts: int) -> bool:
    return parts > 0 and dim % parts == 0


def fsdp_axis(ctx: ShardCtx, dim: int):
    """Shard ``dim`` over the data axes if it divides; else replicate."""
    if ctx.dp_total > 1 and _divides(dim, ctx.dp_total):
        return ctx.data_spec()
    return None


def tp_axis(ctx: ShardCtx, dim: int):
    if ctx.tp > 1 and _divides(dim, ctx.tp):
        return ctx.model_axis
    return None


def matrix_spec(ctx: ShardCtx, shape: Tuple[int, ...], tp_dim: Optional[int],
                fsdp_dim: Optional[int], init: str = "normal", at_use: bool = True
                ) -> ParamSpec:
    """A weight matrix with one TP-sharded dim and one FSDP-sharded dim; the
    reference casts it to the compute type at use unless ``at_use`` is
    False (the RG-LRU gates, which it uses in float32)."""
    axes: list = [None] * len(shape)
    if tp_dim is not None:
        axes[tp_dim] = tp_axis(ctx, shape[tp_dim])
    if fsdp_dim is not None and axes[fsdp_dim] is None:
        axes[fsdp_dim] = fsdp_axis(ctx, shape[fsdp_dim])
    return ParamSpec(shape=tuple(shape), init=init, at_use=at_use, placement=tuple(axes))


def replicated_spec(shape: Tuple[int, ...], init: str = "ones") -> ParamSpec:
    """A small replicated parameter, used in float32."""
    return ParamSpec(shape=tuple(shape), init=init, placement=(None,) * len(shape))


# ------------------------------------------------------------------ trees --


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def init_params(tree, seed: int, compute: torch.dtype, device,
                master: bool = False) -> Dict[str, Any]:
    """Materialise a ParamSpec tree, leaf by leaf in tree order, from one
    ``torch.Generator`` seeded with ``seed`` on ``device``; ``master``:
    every leaf in float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tree_map(lambda s: s.materialise(gen, compute, device, master), tree)


def stack_specs(spec: ParamSpec, n: int) -> ParamSpec:
    """Prepend a layer-stack dimension of ``n``, replicated across the mesh."""
    return replace(spec, shape=(n,) + spec.shape, placement=(None,) + spec.placement)


def stack_tree(tree, n: int):
    return tree_map(lambda s: stack_specs(s, n), tree)


def tree_specs_to_shapes(tree):
    """ParamSpec tree → (a tree of float32 ``meta`` tensors of its shapes,
    the tree of its placements); nothing is allocated."""
    shapes = tree_map(lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"), tree)
    return shapes, tree_map(lambda s: s.placement, tree)


def tree_flatten(tree, prefix: Tuple[str, ...] = ()):
    """[(path, leaf)] with dict keys in sorted order at every level, the
    order in which JAX flattens a dict."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_flatten(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def keystr(path: Tuple[str, ...]) -> str:
    """A path as ``jax.tree_util.keystr`` writes it: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def tree_unflatten(paths, leaves):
    """The nested dict of ``leaves`` at ``paths``."""
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree."""
    return tree_map(lambda x: x[i], tree)


def param_count(tree) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(tree)))


def resolve_device(device=None) -> torch.device:
    """The device a model entry point runs on: the card unless the caller
    asks for another; asking for the card where there is none raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the model runs on a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return dev
