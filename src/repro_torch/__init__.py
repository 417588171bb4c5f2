"""repro_torch — the PyTorch / CUDA port of the opportunistic dataframe engine.

Same layout and module names as the JAX package it was ported from:
``core`` (the think-time engine), ``frame`` (the dataframe layer) and
``kernels`` (hand-written CUDA kernels for an H100).  It imports torch and
numpy, never JAX.
"""
