"""The correctness contracts of the frame kernels: their plain PyTorch
versions, which the tests hold against the JAX package's Pallas kernels and
the CUDA kernels are held against on the card.

This module keeps the reference's layout (``kernels/ref.py``); the functions
themselves live beside their kernels.  Only the dataframe subset is here:
masked_stats, segment_reduce, topk and filter_compact.
"""
from .filter_compact import filter_compact_plain
from .masked_stats import masked_stats_plain
from .segment_reduce import segment_reduce_plain
from .topk import topk_plain

__all__ = ["masked_stats_plain", "segment_reduce_plain", "topk_plain", "filter_compact_plain"]
