"""qwen3-moe-235b-a22b [moe] — [hf:Qwen/Qwen3-30B-A3B family].

94L d_model=4096 64H (GQA kv=4) vocab=151936, 128 experts top-8,
expert FFN dim d_ff=1536, qk_norm.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-235B-A22B (per hf:Qwen/Qwen3-30B-A3B card family)",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,               # expert FFN width (d_expert mirrors it)
    vocab_size=151936,
    norm_type="rms",
    mlp_type="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    d_expert=1536,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        arch_id="qwen3-moe-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab_size=512, n_experts=4, top_k=2, d_expert=64)
