"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (GQA kv=32 = full MHA) d_ff=5632 vocab=100352.
StableLM-2 uses LayerNorm, SwiGLU MLP, and partial rotary (25% of head_dim).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-1.6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    norm_type="layer",
    mlp_type="swiglu",
    qk_norm=False,
    rope_theta=10_000.0,
    rope_pct=0.25,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        arch_id="stablelm-1.6b-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=352, vocab_size=512)
