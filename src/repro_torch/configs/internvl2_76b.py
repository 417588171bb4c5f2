"""InternVL2-Llama3-76B backbone: 80L d=8192, 64H GQA(kv=8) hd=128,
d_ff=28672, vocab 128256.  [arXiv:2404.16821; unverified]
The InternViT frontend is a STUB per the brief: input_specs() supplies 256
precomputed patch embeddings prepended to the text sequence."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_q_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab=128_256,
    rope_theta=500_000.0,
    n_vis_tokens=256,
)
