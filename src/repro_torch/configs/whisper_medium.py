"""whisper-medium [audio] — arXiv:2212.04356.

Enc-dec, 24 encoder + 24 decoder layers, d_model=1024 16H (MHA) d_ff=4096
vocab=51865.  The mel-spectrogram + conv frontend is a STUB (input_specs
supplies 1500 precomputed frame embeddings).  LayerNorm + GELU, no RoPE
(learned absolute positions).

long_500k: SKIPPED for this arch (DESIGN.md §4 — 30 s audio yields ~1500
encoder frames; a 524K-token decode is out of family scope).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=24,             # decoder layers
    n_encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm_type="layer",
    mlp_type="gelu",
    rope_pct=0.0,            # no rotary; positions are learned/absolute
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        arch_id="whisper-medium-smoke",
        n_layers=2, n_encoder_layers=2, encoder_seq=32,
        d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512)
