"""What the model cells share: the port's ``ModelConfig`` from a
configuration file, the weights handed to the port, token streams from the
seed, and the per-leaf comparisons."""
from __future__ import annotations

import statistics
from dataclasses import replace
from typing import Dict, Tuple

import torch

from . import mamba_ref


def port_config(m: Dict):
    """The port's configuration of the file's model: the registry's entry
    with every size the file gives."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SSDConfig

    dm = mamba_ref.dims(m)
    return replace(get_config(m["arch"]), n_layers=dm.layers, d_model=dm.d, vocab=dm.vocab,
                   n_q_heads=dm.heads, n_kv_heads=dm.heads, head_dim=dm.p,
                   tie_embeddings=bool(m["tie_embeddings"]), dtype=m["dtype"],
                   ssd=SSDConfig(d_state=dm.n, head_dim=dm.p, expand=m["expand"],
                                 conv_width=dm.conv, chunk=dm.chunk))


def port_model(m: Dict, weights: Dict[Tuple[str, ...], torch.Tensor], trainable: bool):
    """The port's ``LM`` over the benchmark's weights (the tensors are
    taken as they are, not copied)."""
    from repro_torch.models.base import SINGLE
    from repro_torch.models.lm import LM

    return LM(port_config(m), mamba_ref.as_tree(weights), SINGLE, trainable=trainable)


def tokens(seed: int, index: int, n: int, vocab: int, device) -> torch.Tensor:
    """Sequence ``index`` of the seed's stream: n token ids, uniform over the
    vocabulary, made on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 2_654_435_761 + 97 * (index + 1)) % (1 << 63))
    return torch.randint(0, vocab, (n,), generator=gen, device=device, dtype=torch.int64)


def leaf_gaps(got: Dict, want: Dict, skip=()) -> list:
    """For each leaf, the gap between the two norms of that leaf, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(want.values())
    return [abs(got[k] - want[k]) / max(want[k], med) for k in want if k not in skip]


def flat_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_paths(v, prefix + (k,))
    else:
        yield prefix, tree
