"""The model mesh: a grid of ``torch.device``s that one process drives.

The reference builds a ``jax`` mesh with axes ``("data", "model")``, or
``("pod", "data", "model")`` over several pods.  Here the mesh is a small
value: its axis names, its shape and the device of every position, in the
row-major order ``jax.make_mesh`` assigns devices in.  Nothing starts a
process group: the model code runs every shard from one process, shard after
shard (single-controller, as ``frame/dist.py`` runs the data mesh).  Devices
may repeat, so ``["cpu"] * 4`` or ``["cuda:0"] * 4`` emulates four shards on
one device.

A data row is one position of the data axes (``pod`` × ``data``, flattened
in order); its shards are the positions of the ``model`` axis.  Row ``r``'s
first device holds what the row keeps whole; shard ``s`` of the row holds
its slice of the experts and of the KV cache and, for a model made in
slices (``models/tp.py``), its slice of every leaf whose placement names
the model axis.

A function, not a module-level constant: importing this module touches no
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class ModelMesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[torch.device, ...]  # row-major over ``shape``

    @property
    def tp(self) -> int:
        return self.shape[-1]

    @property
    def dp_total(self) -> int:
        """The number of data rows (pods × data)."""
        return len(self.devices) // self.tp

    @property
    def first(self) -> torch.device:
        """The first device: where answers gather."""
        return self.devices[0]

    def device(self, row: int, shard: int) -> torch.device:
        return self.devices[row * self.tp + shard]

    def row_devices(self, row: int) -> Tuple[torch.device, ...]:
        return self.devices[row * self.tp:(row + 1) * self.tp]

    def row(self, row: int) -> "ModelMesh":
        """Data row ``row`` alone, as a mesh of one data row."""
        return ModelMesh(("data", "model"), (1, self.tp), self.row_devices(row))


def indexed_device(device) -> torch.device:
    """``cuda`` without an index names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          devices: Optional[Sequence] = None) -> ModelMesh:
    n = 1
    for d in shape:
        n *= d
    if devices is None:
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"a mesh of shape {shape} needs {n} devices; this host has "
                               f"{have} CUDA devices")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(indexed_device(d) for d in devices)
        if len(devs) != n:
            raise ValueError(f"a mesh of shape {shape} needs {n} devices; {len(devs)} given")
    return ModelMesh(axes, tuple(shape), devs)


def make_mesh(dp: int, tp: int, pods: int = 1, devices: Optional[Sequence] = None) -> ModelMesh:
    """A ``(dp, tp)`` mesh, or ``(pods, dp, tp)`` when ``pods > 1``, over
    ``devices`` (which may repeat) or, with ``devices=None``, over the
    host's first ``pods · dp · tp`` cards; too few cards raise, naming both
    counts."""
    if pods > 1:
        return _mesh((pods, dp, tp), ("pod", "data", "model"), devices)
    return _mesh((dp, tp), ("data", "model"), devices)


def make_production_mesh(multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> ModelMesh:
    """The reference's production shapes: (16, 16), or (2, 16, 16) over two
    pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, devices)
