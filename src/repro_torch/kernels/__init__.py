"""repro_torch.kernels — hand-written CUDA kernels for the frame hot spots,
the Mamba-2 SSD scan and attention (forward and backward).

Each kernel module holds the ctypes wrapper of its ``csrc/*.cu`` kernel, the
plain PyTorch version of the same function, and a launch counter; ``ref.py``
gathers the plain versions, the kernels' contracts; ``ops.py`` the dispatch entry points used by the
frame layer.  Nothing here compiles or touches a GPU at import time.
"""
from . import (filter_compact, flash_attention, join_probe, masked_stats, ops, ref,
               segment_reduce, ssd_chunk, topk)

__all__ = ["ops", "ref", "masked_stats", "segment_reduce", "topk", "filter_compact",
           "join_probe", "ssd_chunk", "flash_attention"]
