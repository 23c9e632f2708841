"""qwen3-0.6b [dense] — Qwen3 family [hf:Qwen/Qwen3-8B].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, qk_norm, GQA.
Qwen3 uses head_dim=128 (decoupled from d_model/n_heads).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-0.6b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (0.6B sibling)",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    norm_type="rms",
    mlp_type="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        arch_id="qwen3-0.6b-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512)
