"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin).

38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000.
Pattern: two RG-LRU recurrent blocks then one local (sliding-window 2048)
attention block — the "1:2" ratio.  RG-LRU width = d_model.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    norm_type="rms",
    mlp_type="swiglu",
    rope_theta=10_000.0,
    sliding_window=2048,
    hybrid_period=3,
    rglru_width=4096,
    ssm_conv=4,
)


def smoke_config() -> ModelConfig:
    # 3 layers = one full (rec, rec, attn) group
    return CONFIG.replace(
        arch_id="recurrentgemma-9b-smoke",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512, sliding_window=32, rglru_width=128)
