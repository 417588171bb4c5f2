"""SmolLM-360M: 32L d=960, 15H GQA(kv=5) hd=64, d_ff=2560, vocab 49152,
llama-arch small.  [hf:HuggingFaceTB/SmolLM-360M; hf]
15 heads % 16 TP != 0 -> attention data-parallel (DESIGN.md §4)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_q_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49_152,
    tie_embeddings=True,
)
