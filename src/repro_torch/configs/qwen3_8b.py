"""Qwen3-8B: 36L d=4096, 32H GQA(kv=8) hd=128, d_ff=12288, vocab 151936,
qk-norm.  [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_q_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12_288,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
