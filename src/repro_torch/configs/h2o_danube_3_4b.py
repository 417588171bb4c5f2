"""H2O-Danube3-4B: 24L d=3840, 32H GQA(kv=8) hd=120, d_ff=10240, vocab 32000,
llama+mistral mix with sliding-window attention (w=4096).
[arXiv:2401.16818; unverified]  SWA bounds the KV cache -> long_500k runnable."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_q_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10_240,
    vocab=32_000,
    window=4096,
)
