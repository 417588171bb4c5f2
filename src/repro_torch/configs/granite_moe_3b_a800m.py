"""Granite-3.0 3B-A800M MoE: 32L d=1536, 24H GQA(kv=8), MoE 40e top-8
d_ff=512, vocab 49155.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24 heads % 16 TP != 0 -> attention runs data-parallel (DESIGN.md §4);
experts padded 40→48 for EP over 16 model shards (padded experts masked)."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_q_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49_155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
)
