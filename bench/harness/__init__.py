"""The benchmark's harness: cell lookup, set-up, the measured window, the
traced window, the comparison that decides ``correct`` and the result line.

Nothing here imports ``jax`` or the JAX package; the port (``repro_torch``)
is imported, inside functions, only by the cell kinds under ``bench/kinds/``
and by ``lm.py``'s builders; the plain references (``frame_ref.py``,
``mamba_ref.py``) import nothing of it.
"""
