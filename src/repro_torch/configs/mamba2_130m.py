"""mamba2-130m [ssm] — arXiv:2405.21060 (SSD / state-space duality).

24L d_model=768, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads, conv width 4.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    norm_type="rms",
    tie_embeddings=True,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        arch_id="mamba2-130m-smoke",
        n_layers=2, d_model=128, vocab_size=512,
        ssm_state=32, ssm_head_dim=32, ssm_chunk=16)
