"""Model / run configuration system.

One :class:`ModelConfig` describes every assigned architecture through a
repeating ``block_pattern`` (e.g. ``("attn",)`` for dense transformers,
``("rglru", "rglru", "attn")`` for RecurrentGemma, ``("ssd",)`` for Mamba-2)
plus optional MoE / SSM / recurrent sub-configs.  Padding for mesh
divisibility is *explicit* (``padded_vocab``, TP-ineligible attention is
declared, never silently patched).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2

    def padded_experts(self, tp: int) -> int:
        return pad_to(self.n_experts, tp)


@dataclass(frozen=True)
class SSDConfig:
    """Mamba-2 (state-space duality) block."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128

    def n_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block."""

    lru_width: int = 4096
    conv_width: int = 4
    c_constant: float = 8.0  # Griffin's fixed `c` in a = exp(-c·softplus(Λ)·r)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_q_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[str, ...] = ("attn",)
    mlp_type: str = "swiglu"  # "swiglu" | "gelu"
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window attention
    local_window: int = 2048  # window for 'local_attn' blocks (hybrid archs)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssd: Optional[SSDConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # modality frontend stubs ([vlm]/[audio]): see launch/specs.py
    n_codebooks: int = 1  # >1: audio (EnCodec token streams, summed embeds)
    n_vis_tokens: int = 0  # >0: vlm (precomputed patch embeddings prepended)
    dtype: str = "bfloat16"
    # family tag for shape-applicability decisions
    family: str = "dense"  # dense | moe | vlm | hybrid | ssm | audio

    # ----------------------------------------------------------- derived ----
    @property
    def gqa_group(self) -> int:
        return self.n_q_heads // self.n_kv_heads

    def padded_vocab(self, tp: int) -> int:
        return pad_to(self.vocab, tp * 8)

    def attn_tp_eligible(self, tp: int) -> bool:
        """Head-sharded TP possible only when q heads divide evenly; otherwise
        attention runs data-parallel with model-replicated weights (the skew
        shows up in the roofline — see DESIGN.md §4)."""
        return self.n_q_heads % tp == 0

    def kv_sharded(self, tp: int) -> bool:
        return self.attn_tp_eligible(tp) and self.n_kv_heads % tp == 0

    @property
    def pattern_groups(self) -> Tuple[int, int]:
        """(n_scanned_groups, n_remainder_layers)."""
        p = len(self.block_pattern)
        return self.n_layers // p, self.n_layers % p

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (bounded state / window)."""
        quad = any(
            b == "attn" for b in self.block_pattern
        ) and self.window is None
        return not quad

    # -- parameter count (for MODEL_FLOPS = 6·N·D) -----------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        qh, kvh, hd = self.n_q_heads, self.n_kv_heads, self.head_dim
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks > 1:
            n += (self.n_codebooks - 1) * v * d * 2
        per_layer = {}
        per_layer["attn"] = d * qh * hd + 2 * d * kvh * hd + qh * hd * d + 2 * d
        per_layer["local_attn"] = per_layer["attn"]
        if self.mlp_type in ("swiglu", "geglu"):
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.moe is not None:
            e = self.moe.top_k if active_only else self.moe.n_experts
            moe_mlp = d * self.moe.n_experts  # router
            n_ff = 3 if self.mlp_type == "swiglu" else 2
            moe_mlp += e * n_ff * d * self.moe.d_ff_expert
            mlp = moe_mlp
        if self.ssd is not None:
            di = self.ssd.expand * d
            ns = self.ssd.d_state
            nh = self.ssd.n_heads(d)
            per_layer["ssd"] = (
                d * (2 * di + 2 * ns + nh)  # in_proj (x, z, B, C, dt)
                + di * self.ssd.conv_width
                + di * d  # out proj
                + 2 * d
            )
        if self.rglru is not None:
            w = self.rglru.lru_width
            per_layer["rglru"] = (
                2 * d * w + w * self.rglru.conv_width + 3 * w + w * d + 2 * d
            )
        total_blocks = 0
        for i in range(self.n_layers):
            b = self.block_pattern[i % len(self.block_pattern)]
            blk = per_layer.get(b, per_layer.get("attn", 0))
            if b in ("attn", "local_attn"):
                total_blocks += blk + mlp
            elif b == "ssd":
                total_blocks += blk  # mamba blocks have no separate MLP
            elif b == "rglru":
                total_blocks += blk + mlp
        return n + total_blocks


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    # distribution
    dp: int = 16
    tp: int = 16
    pods: int = 1
    # training
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: str = "full"  # "none" | "full"
    grad_compression: bool = False  # int8 error-feedback psum
    microbatch: Optional[int] = None  # grad accumulation

    @property
    def tokens_per_step(self) -> int:
        return self.shape.seq_len * self.shape.global_batch


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=len(cfg.block_pattern) * 2,
        d_model=64,
        n_q_heads=4,
        n_kv_heads=max(1, 4 // max(cfg.gqa_group, 1)),
        head_dim=16,
        d_ff=128,
        vocab=128,
        n_vis_tokens=8 if cfg.n_vis_tokens else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=8, top_k=2, d_ff_expert=32,
            capacity_factor=cfg.moe.capacity_factor,
        )
    if cfg.ssd is not None:
        kw["ssd"] = SSDConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=32)
    if cfg.rglru is not None:
        kw["rglru"] = RGLRUConfig(lru_width=64, conv_width=4)
    if cfg.window is not None:
        kw["window"] = 32
    kw["local_window"] = 32
    return replace(cfg, name=cfg.name + "-smoke", **kw)
