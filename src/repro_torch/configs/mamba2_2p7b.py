"""Mamba2-2.7B: 64L d=2560 attention-free SSD (state-space duality),
d_state=128, headdim=64 (80 heads at expand=2), vocab 50280.
[arXiv:2405.21060; unverified]  SSM -> long_500k runnable."""
from .base import ModelConfig, SSDConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_q_heads=80,   # SSD heads (d_inner/headdim); no attention
    n_kv_heads=80,
    head_dim=64,
    d_ff=0,
    vocab=50_280,
    block_pattern=("ssd",),
    ssd=SSDConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=128),
)
