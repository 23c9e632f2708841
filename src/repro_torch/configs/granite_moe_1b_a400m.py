"""granite-moe-1b-a400m [moe] — [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) vocab=49155, 32 experts top-8,
expert FFN dim d_ff=512.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                # expert FFN width
    vocab_size=49155,
    norm_type="rms",
    mlp_type="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    n_experts=32,
    top_k=8,
    d_expert=512,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        arch_id="granite-moe-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=512, n_experts=4, top_k=2, d_expert=64)
