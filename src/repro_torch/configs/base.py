"""Model/architecture configuration schema (the port's own copy).

Field for field the same dataclass as the JAX package's ``ModelConfig``;
the only change is ``torch_dtype`` in place of ``jnp_dtype``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # citation (hf:... / arXiv:...)

    # transformer backbone
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    norm_type: str = "rms"           # rms | layer
    mlp_type: str = "swiglu"         # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_pct: float = 1.0            # fraction of head_dim rotated (stablelm: .25)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # sliding-window attention (dense long-context decode carve-out; also the
    # local-attention layers of hybrid archs)
    sliding_window: Optional[int] = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # expert FFN hidden dim
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid (RecurrentGemma): every `hybrid_period`-th layer is local
    # attention, the rest are RG-LRU recurrent blocks
    hybrid_period: int = 0           # 3 -> pattern (rec, rec, attn)
    rglru_width: int = 0             # recurrence width (d_model if 0)

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # precomputed mel-frame embeddings (stub)

    # vlm
    n_image_tokens: int = 0          # precomputed patch embeddings (stub)

    dtype: str = "bfloat16"

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid natively; dense only when a
        sliding window is configured (see DESIGN.md §4)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no decode step; all assigned archs do."""
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (for 6ND model-FLOPs in the roofline; N_active for MoE).
    def param_count(self, active_only: bool = False) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        Dh, H, Hkv = self.head_dim_, self.n_heads, self.n_kv_heads
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb

        def attn_params() -> int:
            return D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D

        def mlp_params(f: int) -> int:
            return (3 if self.mlp_type == "swiglu" else 2) * D * f

        if self.family == "ssm":
            # mamba2 block: in_proj (x, z, B, C, dt), conv, out_proj
            din = self.d_inner
            g = 1
            proj_in = D * (2 * din + 2 * g * self.ssm_state + self.n_ssm_heads)
            conv = (din + 2 * g * self.ssm_state) * self.ssm_conv
            out = din * D
            total += L * (proj_in + conv + out + 2 * D)
            return total
        if self.family == "hybrid":
            period = max(self.hybrid_period, 1)
            n_attn = L // period
            n_rec = L - n_attn
            w = self.rglru_width or D
            rec = D * w * 2 + w * 3 + w * D + self.ssm_conv * w  # gates+conv+proj
            total += n_attn * (attn_params() + mlp_params(F) + 2 * D)
            total += n_rec * (rec + mlp_params(F) + 2 * D)
            return total
        if self.family == "moe":
            e = self.top_k if active_only else self.n_experts
            per_layer = attn_params() + D * self.n_experts  # router
            per_layer += e * 3 * D * self.d_expert
            total += L * (per_layer + 2 * D)
            return total
        if self.family == "audio":
            enc = self.n_encoder_layers * (attn_params() + mlp_params(F) + 2 * D)
            dec = L * (2 * attn_params() + mlp_params(F) + 3 * D)  # +cross attn
            return total + enc + dec
        # dense / vlm backbone
        total += L * (attn_params() + mlp_params(F) + 2 * D)
        return total
