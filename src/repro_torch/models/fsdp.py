"""The train state stored in slices over a model mesh's data rows (FSDP) and
model shards (TP, and TP × FSDP).

The reference places every weight with a ``PartitionSpec`` whose data axes
slice one dimension (``fsdp_axis``) and whose model axis slices another
(``tp_axis``: Megatron's column and row slices, the experts by expert), and
its dry run compiles the train step with those placements as the input
shardings: each card keeps its slice of the float32 weights and of the
AdamW moments, GSPMD gathers a layer's weights over the data axes before
the layer runs and reduce-scatters its gradient after.

Here a placed leaf is a :class:`Sliced`: data row ``r`` keeps slice ``r`` of
the dimension the placement names the data axes in, and, where it names the
model axis (``tp.model_dim``), shard ``s`` of the row keeps slice ``s`` of
that dimension on ``mesh.device(r, s)``; a leaf without it lies on the
row's first device.  A leaf whose placement names no data axis (the norms,
a dimension the rows do not divide, or every leaf of a state held whole on
each row) is held whole over the data axes on every row.  The placements
are read from ``ParamSpec.placement``, so they read the same whether the
state is whole or sliced.

:func:`gather` is the use of a leaf: a ``torch.autograd.Function`` that
copies the slices of one layer onto the device that computes with it, and
whose backward adds each slice's part of the layer's gradient into that
slice's float32 accumulator (``leaf.grad``), on the slice's device, where
it lies.  So no device holds a whole leaf's gradient after a step, and the
gathered weights live as long as the computation that uses them.  Both run
inside ``record_function`` ranges (``fsdp_gather``, ``fsdp_grad_add``), so
a torch.profiler trace reads their device time.  A row's
backward adds one piece into each accumulator element (each leaf is
gathered once a row for each device that uses it), so the rows' gradients
add in row order, as the replicated step adds them on its first device.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from .tp import Shards, model_dim


class Sliced:
    """One leaf stored over a mesh: ``parts[r][s]`` on ``devices[r][s]``.

    ``dim``: the dimension split over the data rows (row ``r`` holds
    ``[r·n, (r+1)·n)``), or None: every row holds the leaf whole.
    ``tp_dim``: the dimension split over the model shards (the one its
    placement names the model axis in), or None: one part a row.
    ``grad``: the float32 accumulators of a step's gradient (a ``Sliced``
    of the same layout, with one row only where the leaf is whole on every
    row), or None."""

    def __init__(self, shape: Sequence[int], dim: Optional[int], tp_dim: Optional[int],
                 parts: List[List[torch.Tensor]], devices: List[List[torch.device]]):
        self.shape = tuple(shape)
        self.dim, self.tp_dim = dim, tp_dim
        self.parts, self.devices = parts, devices
        self.grad: Optional["Sliced"] = None

    # -- layout --
    @property
    def rows(self) -> int:
        return len(self.devices)

    @property
    def shards(self) -> int:
        return len(self.devices[0])

    @property
    def device(self) -> torch.device:
        return self.parts[0][0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype

    def numel(self) -> int:
        return int(torch.Size(self.shape).numel())

    def region(self, r: Optional[int], s: Optional[int], shape: Optional[Sequence[int]] = None,
               lead: int = 0):
        """Part ``(r, s)``'s index into a tensor of ``shape`` (the whole
        leaf's, or one missing its first ``lead`` dimensions: a layer of a
        stacked leaf); ``r`` or ``s`` None: that dimension whole."""
        shape = self.shape if shape is None else shape
        idx = [slice(None)] * len(shape)
        if self.dim is not None and r is not None:
            n = shape[self.dim - lead] // self.rows
            idx[self.dim - lead] = slice(r * n, (r + 1) * n)
        if self.tp_dim is not None and s is not None:
            m = shape[self.tp_dim - lead] // self.shards
            idx[self.tp_dim - lead] = slice(s * m, (s + 1) * m)
        return tuple(idx)

    def all_parts(self) -> List[torch.Tensor]:
        return [p for row in self.parts for p in row]

    def like(self, fill=torch.zeros, rows: Optional[int] = None,
             requires_grad: bool = False) -> "Sliced":
        """A leaf of this layout (its first ``rows`` rows) made by ``fill``
        (shape, dtype float32, device) on each part's device."""
        rows = self.rows if rows is None else rows
        parts = [[fill(p.shape, dtype=torch.float32, device=d).requires_grad_(requires_grad)
                  for p, d in zip(self.parts[r], self.devices[r])] for r in range(rows)]
        return Sliced(self.shape, self.dim, self.tp_dim, parts,
                      [list(d) for d in self.devices[:rows]])

    # -- whole copies (no autograd) --
    def whole(self, device, layer: Optional[int] = None, shard: Optional[int] = None,
              row: int = 0) -> torch.Tensor:
        """The leaf (layer ``layer`` of a stacked leaf; shard ``shard``'s
        experts only) copied onto ``device``, a new tensor; a leaf held whole
        on every row is read from row ``row``'s copy."""
        lead = 0 if layer is None else 1
        rows = range(self.rows) if self.dim is not None else (row,)
        shards = range(self.shards) if shard is None else (shard,)
        srcs = [self.parts[r][s] if layer is None else self.parts[r][s][layer]
                for r in rows for s in shards]
        dev = torch.device(device)
        if len(srcs) == 1:
            return srcs[0].detach().to(dev, copy=True)
        if len(shards) == 1 and all(t.device == dev for t in srcs):
            # the rows' slices side by side on the device: one copy
            return torch.cat([t.detach() for t in srcs], dim=self.dim - lead)
        shape = list(self.shape[lead:])
        if self.tp_dim is not None and shard is not None:
            shape[self.tp_dim - lead] //= self.shards
        out = torch.empty(shape, dtype=self.dtype, device=device)
        pieces = iter(srcs)
        for r in rows:
            for s in shards:
                at = self.region(r if self.dim is not None else None,
                                 None if shard is not None else s, shape, lead)
                out[at].copy_(next(pieces).detach())
        return out

    def copy_from(self, whole: torch.Tensor) -> None:
        """Overwrite every part with its region of ``whole`` (any device)."""
        with torch.no_grad():
            for r in range(self.rows):
                for s in range(self.shards):
                    at = self.region(r if self.dim is not None else None, s)
                    self.parts[r][s].copy_(whole[at])

    # -- gradient --
    def add_grad(self, grad: torch.Tensor, layer: Optional[int], shard: Optional[int]) -> None:
        """Add ``grad`` (of :meth:`whole` at ``layer`` / ``shard``) into the
        accumulators, each part's piece on its own device."""
        acc = self.grad
        lead = 0 if layer is None else 1
        shape = grad.shape
        rows = range(self.rows) if self.dim is not None else (0,)
        shards = range(self.shards) if shard is None else (shard,)
        with torch.no_grad():
            for r in rows:
                for s in shards:
                    dst = acc.parts[r][s]
                    dst = dst if layer is None else dst[layer]
                    at = self.region(r if self.dim is not None else None,
                                     None if shard is not None else s, shape, lead)
                    dst.add_(grad[at].to(dst.device))


class _Gather(torch.autograd.Function):
    """parts → the leaf (one layer, one shard's experts) on ``device``;
    backward: each part's piece of the gradient into its accumulator."""

    @staticmethod
    def forward(ctx, leaf: Sliced, layer, shard, device, row, *parts):
        ctx.leaf, ctx.layer, ctx.shard, ctx.n = leaf, layer, shard, len(parts)
        with record_function("fsdp_gather"):
            return leaf.whole(device, layer, shard, row)

    @staticmethod
    def backward(ctx, grad):
        with record_function("fsdp_grad_add"):
            ctx.leaf.add_grad(grad, ctx.layer, ctx.shard)
        return (None,) * (5 + ctx.n)


def _row_of(leaf: Sliced, device) -> int:
    """The row whose copy of a whole-on-every-row leaf lies on ``device``
    (the first row where none does)."""
    dev = torch.device(device)
    for r, devs in enumerate(leaf.devices):
        if any(d == dev for d in devs):
            return r
    return 0


def gather(leaf: Sliced, device, layer: Optional[int] = None,
           shard: Optional[int] = None) -> torch.Tensor:
    """The leaf (``layer`` of a stacked one; ``shard``'s experts) on
    ``device``, differentiable into the leaf's accumulators."""
    row = _row_of(leaf, device) if leaf.dim is None else 0
    parts = leaf.all_parts() if leaf.dim is not None else leaf.parts[row]
    return _Gather.apply(leaf, layer, shard, torch.device(device), row, *parts)


def use_tree(tree, device, layer: Optional[int] = None, skip: Tuple[str, ...] = ()):
    """A parameter tree as the computation on ``device`` uses it: each
    :class:`Sliced` leaf gathered (layer ``layer`` of a stacked tree), a
    leaf sliced over the model shards as the tuple of its shards' slices,
    each gathered over the rows onto its shard's device of ``device``'s
    row; each ``tp.Shards`` leaf the tuple of its shards' slices where they
    lie, each tensor indexed at ``layer``; keys in ``skip`` are left out."""
    if isinstance(tree, dict):
        return {k: use_tree(v, device, layer, skip) for k, v in tree.items() if k not in skip}
    if isinstance(tree, Sliced):
        if tree.tp_dim is None:
            return gather(tree, device, layer)
        devices = tree.devices[_row_of(tree, device)]
        return tuple(gather(tree, d, layer, s) for s, d in enumerate(devices))
    if isinstance(tree, Shards):
        return tree.at(layer)
    return tree if layer is None else tree[layer]


# ------------------------------------------------------------------ placing --


def _split_dims(placement: Tuple[Any, ...], data_spec, path: Tuple[str, ...]
               ) -> Tuple[Optional[int], Optional[int]]:
    """(the dimension the data axes slice, the dimension the model shards
    slice: the one ``tp.model_dim`` names) of a placement."""
    dim = next((i for i, a in enumerate(placement) if a == data_spec and a is not None), None)
    return dim, model_dim(placement, path)


def _layout(shape, placement, data_spec, path, mesh) -> Sliced:
    """An empty leaf of ``shape`` laid out over ``mesh`` as ``placement``
    says: the devices of its parts, no part yet."""
    dim, tp_dim = _split_dims(placement, data_spec, path)
    shards = mesh.tp if tp_dim is not None else 1
    devices = [[mesh.device(r, s) for s in range(shards)] for r in range(mesh.dp_total)]
    return Sliced(shape, dim, tp_dim, [], devices)


def place_leaf(t: torch.Tensor, placement, data_spec, path, mesh,
               requires_grad: bool = False) -> Sliced:
    """``t`` (whole, any device) sliced over ``mesh`` as ``placement``
    says: each part a new tensor on its device."""
    leaf = _layout(t.shape, placement, data_spec, path, mesh)
    for r in range(leaf.rows):
        row = []
        for s in range(leaf.shards):
            src = t.detach()[leaf.region(r if leaf.dim is not None else None, s)]
            part = torch.empty(src.shape, dtype=t.dtype, device=leaf.devices[r][s])
            part.copy_(src)
            row.append(part.requires_grad_(requires_grad))
        leaf.parts.append(row)
    return leaf


def draw_leaf(spec, gen: torch.Generator, compute: torch.dtype, data_spec, path, mesh) -> Sliced:
    """A float32 master leaf drawn from ``gen`` (on the mesh's first device)
    as ``spec.materialise(..., master=True)`` draws it there, placed over
    ``mesh`` and requiring grad.  A leaf drawn whole is sliced at once and
    freed; a larger one (over ``base.WHOLE_DRAW_MAX`` elements) is drawn a
    layer slice at a time and each slice's regions copied into the parts,
    so that no device holds it whole (ROADMAP C16)."""
    first = mesh.first
    leaf = _layout(spec.shape, spec.placement, data_spec, path, mesh)
    if spec.drawn_whole or 0 in (leaf.dim, leaf.tp_dim):
        return place_leaf(spec.materialise(gen, compute, first, master=True), spec.placement,
                          data_spec, path, mesh, requires_grad=True)
    whole = torch.empty(spec.shape, device="meta")  # the parts' shapes, nothing allocated
    leaf.parts = [[torch.empty(whole[leaf.region(r if leaf.dim is not None else None, s)].shape,
                               dtype=torch.float32, device=leaf.devices[r][s])
                   for s in range(leaf.shards)] for r in range(leaf.rows)]
    with torch.no_grad():
        for i in range(spec.shape[0]):
            rows = spec.draw_slice(gen, first)
            for r in range(leaf.rows):
                for s in range(leaf.shards):
                    at = leaf.region(r if leaf.dim is not None else None, s, rows.shape, lead=1)
                    leaf.parts[r][s][i].copy_(rows[at])
    for p in leaf.all_parts():
        p.requires_grad_(True)
    return leaf
