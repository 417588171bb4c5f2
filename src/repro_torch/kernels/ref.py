"""The correctness contracts of the kernels: their plain PyTorch
versions, which the tests hold against the JAX package's Pallas kernels and
the CUDA kernels are held against on the card.

This module keeps the reference's layout (``kernels/ref.py``); the functions
themselves live beside their kernels.  ``attention_ref`` and
``flash_attention_plain`` mirror the reference's ``attention_ref`` and
``attention_xla_chunked``.
"""
from .filter_compact import filter_compact_plain
from .flash_attention import attention_ref, flash_attention_plain
from .join_probe import join_probe_plain
from .masked_stats import masked_stats_plain
from .segment_reduce import segment_reduce_plain
from .ssd_chunk import ssd_chunk_scan_plain
from .topk import topk_plain

__all__ = ["masked_stats_plain", "segment_reduce_plain", "topk_plain", "filter_compact_plain",
           "join_probe_plain", "ssd_chunk_scan_plain", "attention_ref", "flash_attention_plain"]
