"""phi-3-vision-4.2b [vlm] — [hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (GQA kv=32 = MHA) d_ff=8192 vocab=32064.
phi3-mini language backbone + CLIP vision tower; the vision tower +
projector are STUBBED (input_specs supplies patch embeddings).
576 image tokens (24x24 patches after projection).

long_500k uses the dense sliding-window carve-out (DESIGN.md §4).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    norm_type="rms",
    mlp_type="swiglu",
    rope_theta=10_000.0,
    n_image_tokens=576,
    norm_eps=1e-5,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        arch_id="phi-3-vision-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512, n_image_tokens=16)
