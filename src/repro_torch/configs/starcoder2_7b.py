"""StarCoder2-7B: 32L d=4608, 36H GQA(kv=4) hd=128, d_ff=18432, vocab 49152,
LayerNorm + gelu, RoPE.  [arXiv:2402.19173; hf]
36 heads % 16 TP != 0 -> attention data-parallel (DESIGN.md §4)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_q_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_432,
    vocab=49_152,
    mlp_type="gelu",
    norm_type="layernorm",
)
