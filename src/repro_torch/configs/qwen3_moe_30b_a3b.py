"""Qwen3-30B-A3B: 48L d=2048, 32H GQA(kv=4) hd=128, MoE 128e top-8 d_ff=768,
vocab 151936, qk-norm.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_q_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,  # nominal (experts carry the FFN capacity)
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
)
