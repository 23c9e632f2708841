"""starcoder2-15b [dense] — arXiv:2402.19173.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152, GQA, RoPE.
StarCoder2 uses LayerNorm and a GELU MLP (non-gated), sliding window 4096
in the published model; the window also enables the long_500k carve-out.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    norm_type="layer",
    mlp_type="gelu",
    qk_norm=False,
    rope_theta=100_000.0,
    sliding_window=4096,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        arch_id="starcoder2-15b-smoke",
        n_layers=2, d_model=192, n_heads=6, n_kv_heads=2,
        d_ff=384, vocab_size=512, sliding_window=64)
