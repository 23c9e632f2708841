"""qwen3-1.7b [dense] — Qwen3 family [hf:Qwen/Qwen3-8B].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, qk_norm, GQA.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-1.7b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (1.7B sibling)",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    norm_type="rms",
    mlp_type="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        arch_id="qwen3-1.7b-smoke",
        n_layers=2, d_model=160, n_heads=4, n_kv_heads=2, head_dim=40,
        d_ff=320, vocab_size=512)
