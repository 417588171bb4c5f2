"""RecurrentGemma-9B (Griffin): 38 blocks d=4096, pattern (RG-LRU, RG-LRU,
local-attn w=2048), MQA 16H(kv=1) hd=256, d_ff=12288, vocab 256000.
[arXiv:2402.19427; unverified]  Bounded state -> long_500k runnable.
38 % 3 = 2 remainder blocks are unrolled after 12 scanned groups."""
from .base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_q_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab=256_000,
    mlp_type="geglu",
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
)
