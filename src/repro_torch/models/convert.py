"""Parameters of the JAX package's models, given as numpy arrays, as the
port's :class:`~repro_torch.models.lm.LM`.

The tree's paths and shapes carry over one to one (the leading ``n_groups``
stacking included).  For serving, a parameter the reference casts to the
compute type where it uses it (``.astype(dt)``: the projections, the
attention and MLP weights, embeddings and head) is stored in that type; one
it computes with in float32 (``a_log``, ``dt_bias``, ``d_skip``, the conv
weights, the norm and qk-norm scales) stays float32.  For training
(``trainable=True``) every leaf is float32 and requires grad, as the
reference keeps its master weights.  Over a ``mesh`` of ``tp > 1`` model
shards each leaf is placed as a tensor-parallel model holds it: serving
(``models/tp.py``), sliced over the first data row's shards where its
placement names the model axis, else whole on the row's first device;
training, in the train storage over the mesh's data rows and model shards
(``lm.placer``, ``models/fsdp.py``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import tp as TP
from .base import SINGLE, ShardCtx, resolve_device
from .layers import compute_dtype
from .lm import LM, model_spec, placer


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device=None,
                      trainable: bool = False, ctx: ShardCtx = SINGLE, mesh=None) -> LM:
    """``tree``: the reference's parameter tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``), made at ``ctx`` (whose ``tp``
    pads the vocab and the experts) → the port's model on ``device`` (the
    card unless asked), in the serving storage or, ``trainable``, the
    training storage; over ``mesh`` (``tp > 1``), tensor parallel."""
    sliced = mesh is not None and mesh.tp > 1
    if sliced and mesh.tp != ctx.tp:
        raise ValueError(f"a tensor-parallel model is made at its mesh's ShardCtx(tp="
                         f"{mesh.tp}), not at tp={ctx.tp}")
    devices = mesh.row_devices(0) if sliced else None
    dev = resolve_device(device if devices is None else devices[0])
    compute = compute_dtype(cfg)
    if sliced and trainable:
        place = placer(cfg, ctx, mesh)

    def walk(spec, arrays, path):
        if set(spec) != set(arrays):
            where = "/".join(path)
            raise ValueError(f"{where and '/' + where or 'params'}: keys {sorted(arrays)} != "
                             f"{sorted(spec)}")
        out = {}
        for key, s in spec.items():
            if isinstance(s, dict):
                out[key] = walk(s, arrays[key], path + (key,))
                continue
            a = np.array(arrays[key], dtype=np.float32)  # a writable copy
            if a.shape != s.shape:
                raise ValueError(f"/{'/'.join(path + (key,))}: shape {a.shape} != {s.shape}")
            t = torch.from_numpy(a).to(dtype=s.dtype(compute, trainable))
            if sliced and trainable:
                out[key] = place(path + (key,), t, True)
            else:
                out[key] = (TP.place(t, s.placement, path + (key,), devices) if sliced
                            else t.to(dev))
        return out

    return LM(cfg, walk(model_spec(cfg, ctx), tree, ()), ctx, trainable=trainable)
