"""Tensor parallelism of the dense weights over a data row's model shards
(single-controller, as the rest of the model mesh), for serving and for
training.

The reference shards every dense matrix Megatron-style over its ``model``
axis (``ParamSpec.placement``): ``wq`` / ``wk`` / ``wv``, ``w_gate`` /
``w_up``, the SSD and RG-LRU ``in_proj`` and the head by columns, ``wo``,
``w_down`` and ``out_proj`` by rows, the embedding table by vocabulary rows,
the experts by expert.  A served model keeps such a leaf as a
:class:`Shards`: shard ``s`` of a data row holds slice ``s`` of that
dimension on the row's ``s``-th device; the train storage keeps it as an
``fsdp.Sliced`` leaf with the same slices (over the data rows too, under
TP × FSDP).  Every other leaf (the norms, the router, the SSD's conv and
decays, RG-LRU's gates, a dimension ``tp`` does not divide) stays whole on
the row's first device.  :data:`TP_BLOCKS` names the block types whose
leaves are split: all of them.

A block computes on the slices where they lie: a row's activation is copied
to its shards (:func:`broadcast`, :func:`scatter`), each shard computes its
column slices' outputs or its part of a row-parallel product, and the parts
come back to the row's first device, added in shard order (:func:`reduce_sum`,
in float32, rounded once to the parts' type) or, column slices, joined in
order (:func:`join`).  The SSD and RG-LRU blocks join their projected
columns and run the rest whole on the first device.  Each move is an
autograd function whose backward is its Megatron conjugate, in a fixed
order, with no float atomics, so a repeated forward or training step is bit
for bit.  Each direction runs inside a ``record_function`` range
(``tp_broadcast``, ``tp_sum``, ``tp_gather``, ``tp_seq_gather``,
``tp_seq_scatter``, named for what it does), so that a torch.profiler trace
reads its device time.

Sequence parallelism between blocks (the reference's layout of the residual
stream, ``lm.seq_parallel``): a row's activation between two blocks is a
:class:`SeqSlices`, shard ``s`` holding tokens ``[s·S/tp, (s+1)·S/tp)`` on
its own device.  The norms and the residual adds run on the slices where
they lie; a column-parallel product gathers the whole sequence onto every
shard (:func:`all_gather_seq`, where the whole-row path broadcasts) and a
row-parallel product hands each shard the sum of the partials for its own
tokens (:func:`reduce_scatter_seq`, where the whole-row path sums onto the
first device).  Both add the same partials in the same order as
:func:`reduce_sum`, so every value is the whole-row path's bit for bit.
:func:`spread` and :func:`collect` take either layout.

The cache-free forward, the KV caches and the blocks' use of the slices are
in ``models/{lm,attention,layers,blocks,ssd,rglru}.py``; the train storage
in slices and its gradient in ``models/fsdp.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.profiler import record_function

from .base import ParamSpec

# the block types whose leaves are split over the model shards: all of them
TP_BLOCKS = ("attn", "local_attn", "ssd", "rglru")


class Shards:
    """One leaf held as ``len(parts)`` slices of dimension ``dim`` over a
    data row's model shards: ``parts[s]`` (slice ``s``, contiguous) on
    shard ``s``'s device, ``devices[s]`` (as the mesh names it: a CPU
    tensor's own device has no index).  ``shape``: the whole leaf's."""

    def __init__(self, shape: Sequence[int], dim: int, parts: Sequence[torch.Tensor],
                 devices: Sequence[torch.device]):
        self.shape = tuple(shape)
        self.dim = dim
        self.parts = tuple(parts)
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def at(self, layer: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """Each shard's slice (of layer ``layer`` of a stacked leaf): views."""
        return self.parts if layer is None else tuple(p[layer] for p in self.parts)

    def to(self, devices: Sequence[torch.device]) -> "Shards":
        """A copy with slice ``s`` on ``devices[s]``."""
        return Shards(self.shape, self.dim,
                      [p.detach().to(d, copy=True) for p, d in zip(self.parts, devices)], devices)


def model_dim(placement: Tuple[Any, ...], path: Tuple[str, ...] = ()) -> Optional[int]:
    """The dimension tensor parallelism splits a leaf at ``path`` along:
    the one its placement names the model axis in, or None (whole) where it
    names none or the leaf belongs to a block not in :data:`TP_BLOCKS`."""
    if len(path) >= 2 and path[0] in ("groups", "extra") \
            and path[1].split("_", 1)[1] not in TP_BLOCKS:
        return None
    return next((i for i, a in enumerate(placement) if a == "model"), None)


def _region(shape: Sequence[int], dim: int, s: int, n: int):
    m = shape[dim] // n
    return (slice(None),) * dim + (slice(s * m, (s + 1) * m),)


def split(t: torch.Tensor, dim: int, devices: Sequence[torch.device]) -> Shards:
    """``t`` cut into ``len(devices)`` slices of ``dim``, slice ``s`` copied
    onto ``devices[s]``: a new tensor each, on the same device too."""
    n = len(devices)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split {n} ways")
    src = t.detach()
    return Shards(t.shape, dim, [src[_region(t.shape, dim, s, n)].to(d, copy=True).contiguous()
                                 for s, d in enumerate(devices)], devices)


def place(t: torch.Tensor, placement, path: Tuple[str, ...],
          devices: Sequence[torch.device]):
    """A whole leaf as a data row over ``devices`` holds it: :class:`Shards`
    where :func:`model_dim` names a dimension, else the tensor on the row's
    first device."""
    dim = model_dim(placement, path)
    if dim is None:
        return t.detach().to(devices[0])
    return split(t, dim, devices)


def map_paths(fn, tree, prefix: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict, in its insertion order."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def init_params_sliced(tree: Dict[str, Any], seed: int, compute: torch.dtype,
                       devices: Sequence[torch.device]) -> Dict[str, Any]:
    """``base.init_params`` of a ParamSpec tree on ``devices[0]``, each leaf
    placed over ``devices`` (:func:`place`) as it is drawn: the same
    generator, the same draws in the same order, so the values are those of
    the whole draw.  A leaf drawn whole (up to ``base.WHOLE_DRAW_MAX``
    elements) is split at once and freed; a larger one, drawn a layer slice
    at a time, is split slice by slice, so that no device holds it whole."""
    first = devices[0]
    gen = torch.Generator(device=first)
    gen.manual_seed(seed)

    def make(path, spec: ParamSpec):
        dim = model_dim(spec.placement, path)
        if dim is None or spec.drawn_whole or dim == 0:
            return place(spec.materialise(gen, compute, first), spec.placement, path, devices)
        n = len(devices)
        part = list(spec.shape)
        part[dim] //= n
        dt = spec.dtype(compute)
        parts = [torch.empty(part, dtype=dt, device=d) for d in devices]
        for i in range(spec.shape[0]):
            rows = spec.draw_slice(gen, first)
            for s, p in enumerate(parts):
                p[i].copy_(rows[_region(rows.shape, dim - 1, s, n)])
        return Shards(spec.shape, dim, parts, devices)

    return map_paths(make, tree)


def shard_bytes(tree, shards: int) -> list:
    """The bytes each model shard of a data row holds of a parameter tree
    (whole leaves on shard 0)."""
    out = [0] * shards

    def count(_, leaf):
        if isinstance(leaf, Shards):
            for s, p in enumerate(leaf.parts):
                out[s] += p.numel() * p.element_size()
        else:
            out[0] += leaf.numel() * leaf.element_size()

    map_paths(count, tree)
    return out


def parts_of(t) -> Tuple[torch.Tensor, ...]:
    """A cache field's tensors: its slices, or the tensor itself."""
    return t if isinstance(t, tuple) else (t,)


# ------------------------------------------------------------------ moves --
#
# Megatron's conjugate pairs, each a ``torch.autograd.Function`` whose
# backward is fixed: autograd would add the gradients that several devices
# send back to one tensor in the order their threads deliver them, so a
# repeated step would not be bit for bit.  Each direction runs inside the
# range of what it does: a broadcast's backward is a sum (``tp_sum``), a
# sum's backward a broadcast (``tp_broadcast``), a join's backward sends each
# shard its part (``tp_broadcast``), a scatter's brings each part back
# (``tp_gather``).


def _sum_on(parts, device, dtype) -> torch.Tensor:
    """``parts`` (None skipped) added on ``device`` in order, in float32,
    rounded once to ``dtype``."""
    total = None
    for p in parts:
        if p is None:
            continue
        p = p.to(device).float()
        total = p if total is None else total + p
    return total.to(dtype)


def _moved(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: a copy, or a view of ``t`` where it lies there."""
    return t.view_as(t) if t.device == torch.device(device) else t.to(device)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.homes = [p.device for p in parts]
        with record_function("tp_broadcast"):
            return tuple(_moved(p, d) for p, d in zip(parts, devices))

    @staticmethod
    def backward(ctx, *grads):
        with record_function("tp_gather"):
            return (None, *(None if g is None else g.to(h) for g, h in zip(grads, ctx.homes)))


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.home, ctx.dtype = x.device, x.dtype
        with record_function("tp_broadcast"):
            return tuple(_moved(x, d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        with record_function("tp_sum"):
            return _sum_on(grads, ctx.home, ctx.dtype), None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, device, *parts):
        ctx.homes = [(p.device, p.dtype) for p in parts]
        with record_function("tp_sum"):
            out = _sum_on(parts, device, parts[0].dtype)
            return out.view_as(out) if any(out is p for p in parts) else out

    @staticmethod
    def backward(ctx, grad):
        with record_function("tp_broadcast"):
            return (None, *(grad.to(device=d, dtype=dt) for d, dt in ctx.homes))


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, device, *parts):
        ctx.dim = dim
        ctx.homes = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        with record_function("tp_gather"):
            return torch.cat([p.to(device) for p in parts], dim)

    @staticmethod
    def backward(ctx, grad):
        with record_function("tp_broadcast"):
            pieces = grad.split(ctx.sizes, ctx.dim)
            return (None, None, *(g.to(h) for g, h in zip(pieces, ctx.homes)))


def scatter(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]):
    """Part ``s`` on ``devices[s]`` (no copy where it lies there); the
    backward brings each part's gradient back to it."""
    return _Scatter.apply(tuple(devices), *parts)


def _packed(parts: Sequence[torch.Tensor], device) -> Tuple[torch.Tensor, ...]:
    """``parts`` on ``device`` in one copy: packed into one byte buffer (the
    widest elements first, so that each lies aligned) and read back there
    as views of it."""
    order = sorted(range(len(parts)), key=lambda i: -parts[i].element_size())
    buf = torch.cat([parts[i].contiguous().reshape(-1).view(torch.uint8) for i in order])
    buf = buf.to(device)
    got, at = [None] * len(parts), 0
    for i in order:
        n = parts[i].numel() * parts[i].element_size()
        got[i] = buf[at:at + n].view(parts[i].dtype).view(parts[i].shape)
        at += n
    return tuple(got)


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, k, *flat):
        with record_function("tp_broadcast"):
            out = []
            for s, d in enumerate(devices):
                parts = flat[s * k:(s + 1) * k]
                out += ([p.view_as(p) for p in parts] if parts[0].device == torch.device(d)
                        else _packed(parts, d))
            return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("tp.send carries no gradient")


def send(parts: Sequence[Sequence[torch.Tensor]], devices: Sequence[torch.device]
         ) -> List[Tuple[torch.Tensor, ...]]:
    """Shard ``s``'s tensors ``parts[s]`` (alike in number from shard to
    shard, on one device) to ``devices[s]`` in one move: a shard that lies
    elsewhere gets them in one copy (:func:`_packed`), one that lies where
    they are gets them as they are.  A cached pass's inputs only: no
    gradient flows back."""
    k = len(parts[0])
    if torch.is_grad_enabled() and any(t.requires_grad for p in parts for t in p):
        raise ValueError("tp.send carries no gradient")
    flat = _Send.apply(tuple(devices), k, *(t for p in parts for t in p))
    return [tuple(flat[s * k:(s + 1) * k]) for s in range(len(parts))]


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]):
    """A row's activation (or a whole weight) on each of its shards'
    devices; the backward adds the shards' gradients on x's device in shard
    order, in float32, rounded once to x's type."""
    return _Broadcast.apply(x, tuple(devices))


def reduce_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' partial results added on ``device`` in shard order, in
    float32, rounded once to the parts' type (the reference's ``psum`` over
    the model axis); the backward sends the gradient to every shard."""
    return _ReduceSum.apply(device, *parts)


def join(parts: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """The shards' column slices joined on ``device`` in shard order; the
    backward splits the gradient and sends each shard its part."""
    return _Join.apply(dim, device, *parts)


# ------------------------------------------------- the sequence in slices --


class SeqSlices:
    """A row's activation (B, S, ...) held as ``len(parts)`` slices of its
    sequence (dimension 1) over the row's model shards: ``parts[s]``, tokens
    ``[s·S/n, (s+1)·S/n)``, on shard ``s``'s device.  ``+`` adds two such
    activations slice by slice; ``shape``, ``dtype`` and ``device`` (the
    first shard's, the row's first device) read as the whole
    activation's."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(p.device for p in self.parts)

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[1] = sum(p.shape[1] for p in self.parts)
        return torch.Size(s)

    def to(self, dtype: torch.dtype) -> "SeqSlices":
        return SeqSlices([p.to(dtype) for p in self.parts])

    def __add__(self, other: "SeqSlices") -> "SeqSlices":
        return SeqSlices([a + b for a, b in zip(self.parts, other.parts)])


pytree.register_pytree_node(SeqSlices, lambda x: (list(x.parts), None),
                            lambda parts, _: SeqSlices(parts))


def _cuts(sizes: Sequence[int]):
    out, at = [], 0
    for n in sizes:
        out.append(slice(at, at + n))
        at += n
    return out


def _at(dim: int, cut: slice):
    return (slice(None),) * dim + (cut,)


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *parts):
        ctx.dim, ctx.dtype = dim, parts[0].dtype
        ctx.homes = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        with record_function("tp_seq_gather"):
            return tuple(torch.cat([p.to(d) for p in parts], dim) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        with record_function("tp_seq_scatter"):
            out = tuple(_sum_on([g[_at(ctx.dim, c)] for g in grads], home, ctx.dtype)
                        for c, home in zip(_cuts(ctx.sizes), ctx.homes))
        return (None, None, *out)


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *parts):
        ctx.dim = dim
        ctx.homes = [(p.device, p.dtype) for p in parts]
        n = len(parts)
        size = parts[0].shape[dim]
        if size % n:
            raise ValueError(f"a sequence of {size} does not split {n} ways")
        cuts = _cuts([size // n] * n)
        with record_function("tp_seq_scatter"):
            return tuple(_sum_on([p[_at(dim, c)] for p in parts], home, parts[0].dtype)
                         for c, (home, _) in zip(cuts, ctx.homes))

    @staticmethod
    def backward(ctx, *grads):
        with record_function("tp_seq_gather"):
            return (None, *(torch.cat([g.to(d) for g in grads], ctx.dim).to(dt)
                            for d, dt in ctx.homes))


def all_gather_seq(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]
                   ) -> Tuple[torch.Tensor, ...]:
    """The shards' sequence slices (dimension 1) joined in shard order on
    each of ``devices``; the backward is a reduce-scatter: slice ``s`` takes
    the sum of every shard's gradient for its tokens, added in shard order
    in float32 and rounded once."""
    return _AllGatherSeq.apply(1, tuple(devices), *parts)


def reduce_scatter_seq(parts: Sequence[torch.Tensor], dim: int = 1) -> Tuple[torch.Tensor, ...]:
    """Shard ``s`` gets the shards' partial results for its tokens (its
    ``1/n`` of dimension ``dim``), added on its device in shard order in
    float32 and rounded once to the parts' type: what :func:`reduce_sum`
    gives those tokens; the backward is an all-gather of the slices'
    gradients onto every shard."""
    return _ReduceScatterSeq.apply(dim, *parts)


def spread(x, devices: Sequence[torch.device]) -> Tuple[torch.Tensor, ...]:
    """The whole activation on each of ``devices``, for a column-parallel
    product: a :class:`SeqSlices` gathered (:func:`all_gather_seq`), a
    whole tensor broadcast (:func:`broadcast`)."""
    if isinstance(x, SeqSlices):
        return all_gather_seq(x.parts, devices)
    return broadcast(x, devices)


def collect(parts: Sequence[torch.Tensor], like):
    """The shards' partial outputs of a row-parallel product added, in the
    layout of ``like`` (the product's input): reduce-scattered into
    :class:`SeqSlices`, else summed on ``like``'s device."""
    if isinstance(like, SeqSlices):
        return SeqSlices(reduce_scatter_seq(parts))
    return reduce_sum(parts, like.device)


def join_seq(x):
    """A :class:`SeqSlices` joined on the row's first device (a layer that
    needs the whole sequence there); a whole tensor as it is."""
    if isinstance(x, SeqSlices):
        return join(x.parts, 1, x.device)
    return x


def cut_seq(x: torch.Tensor, devices: Sequence[torch.device]) -> SeqSlices:
    """A whole activation cut into sequence slices, slice ``s`` sent to
    ``devices[s]``; the backward brings each slice's gradient back."""
    return SeqSlices(scatter(x.chunk(len(devices), dim=1), devices))


def on_whole(fn, x):
    """``fn(x)`` for a layer that needs the whole sequence on the row's
    first device: :class:`SeqSlices` joined there and the output (the
    first of a tuple) cut back into slices; a whole tensor as it is."""
    if not isinstance(x, SeqSlices):
        return fn(x)
    out = fn(join_seq(x))
    if isinstance(out, tuple):
        return (cut_seq(out[0], x.devices), *out[1:])
    return cut_seq(out, x.devices)
