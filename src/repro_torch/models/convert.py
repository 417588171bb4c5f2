"""Parameters of the JAX package's models, given as numpy arrays, as the
port's :class:`~repro_torch.models.lm.LM`.

The tree's paths and shapes carry over one to one (the leading ``n_groups``
stacking included).  For serving, a parameter the reference casts to the
compute type where it uses it (``.astype(dt)``: the projections, the
attention and MLP weights, embeddings and head) is stored in that type; one
it computes with in float32 (``a_log``, ``dt_bias``, ``d_skip``, the conv
weights, the norm and qk-norm scales) stays float32.  For training
(``trainable=True``) every leaf is float32 and requires grad, as the
reference keeps its master weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from .base import SINGLE, ShardCtx, resolve_device
from .layers import compute_dtype
from .lm import LM, model_spec


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device=None,
                      trainable: bool = False, ctx: ShardCtx = SINGLE) -> LM:
    """``tree``: the reference's parameter tree with numpy leaves
    (``jax.tree.map(np.asarray, params)``), made at ``ctx`` (whose ``tp``
    pads the vocab and the experts) → the port's model on ``device`` (the
    card unless asked), in the serving storage or, ``trainable``, the
    training storage."""
    dev = resolve_device(device)
    compute = compute_dtype(cfg)

    def walk(spec, arrays, path):
        if set(spec) != set(arrays):
            raise ValueError(f"{path or 'params'}: keys {sorted(arrays)} != {sorted(spec)}")
        out = {}
        for key, s in spec.items():
            where = f"{path}/{key}"
            if isinstance(s, dict):
                out[key] = walk(s, arrays[key], where)
                continue
            a = np.array(arrays[key], dtype=np.float32)  # a writable copy
            if a.shape != s.shape:
                raise ValueError(f"{where}: shape {a.shape} != {s.shape}")
            out[key] = torch.from_numpy(a).to(device=dev, dtype=s.dtype(compute, trainable))
        return out

    return LM(cfg, walk(model_spec(cfg, ctx), tree, ""), ctx, trainable=trainable)
