"""MusicGen-large: 48L d=2048, 32H MHA(kv=32) hd=64, d_ff=8192, decoder-only
over EnCodec tokens, vocab 2048 x 4 codebooks (summed embeddings, 4 parallel
heads).  [arXiv:2306.05284; hf]  The EnCodec frontend is a STUB per the brief.
Adaptation note: sinusoidal positions replaced by RoPE (shared backbone)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_q_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    mlp_type="gelu",
    norm_type="layernorm",
    n_codebooks=4,
)
