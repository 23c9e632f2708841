"""Shared model building blocks (PyTorch, nested-dict params).

The port of the JAX package's ``models/layers.py`` for the dense family.
Layouts match the reference at every public function: activations
[B, S, D], q [B, S, H, Dh], k/v [B, S, Hkv, Dh], KV pages
[n_pages, P, Hkv, Dh].  Activations flow in ``cfg.torch_dtype``; norms and
softmax accumulate in f32.  The two attention functions of the serving path
go through hand-written CUDA kernels on a CUDA tensor and through their
plain versions on a CPU tensor (``kernels/*/ops.py``).  ``full_attention``
and ``paged_chunk_attention`` only pass through to those wrappers: they are
kept so that the port's layer names match ``repro.models.layers`` one for
one, which the parity tests and the transformer rely on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.paged_attention.ops import paged_decode_chunk

NEG_INF = -1e30


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, rope_pct: float, theta: float,
                     device: torch.device) -> Tuple[torch.Tensor, int]:
    rot = int(head_dim * rope_pct) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] (broadcastable).

    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]) as the reference
    does, not the half-split ``rotate_half`` layout."""
    inv, rot = rope_frequencies(cfg.head_dim_, cfg.rope_pct, cfg.rope_theta,
                                x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv           # [..., S, rot/2]
    sin = torch.sin(ang)[..., :, None, :]                  # [..., S, 1, rot/2]
    cos = torch.cos(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2].float(), x_rot[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------- attention
def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B,S,Hkv,Dh] -> [B,S,Hkv*n_rep,Dh] (GQA broadcast)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def causal_mask(q_len: int, kv_len: int, q_offset: int,
                window: Optional[int] = None,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Boolean [q_len, kv_len]; True = attendable.  q position i (global
    q_offset+i) may attend kv position j iff j <= i and (window is None or
    i - j < window)."""
    qpos = q_offset + torch.arange(q_len, device=device)[:, None]
    kpos = torch.arange(kv_len, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Softmax attention with the reference's XLA-path numerics.
    q:[B,Sq,H,Dh] k,v:[B,Skv,H,Dh] mask:[Sq,Skv].  Logits and softmax in
    f32, probabilities cast to v's type before P.V."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: Optional[int],
                   scale: float) -> torch.Tensor:
    """Full-sequence attention (k/v already GQA-expanded), the port of
    ``layers.full_attention(impl="pallas")``: the flash kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def attention_qkv(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project + qk-norm + rope.  Returns q:[B,S,H,Dh], k/v:[B,S,Hkv,Dh]."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    return q, k, v


def chunk_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, positions: torch.Tensor,
                           cfg: ModelConfig) -> torch.Tensor:
    """T-token attention: q:[B,T,H,Dh] over a dense cache [B,C,Hkv,Dh]
    whose chunk k/v has already been written; query t attends cache
    positions <= positions[:, t].  The reference's gathered-dense (XLA)
    math for the paged step, with its numerics: probabilities cast to v's
    type before P.V.  The port's paged step runs
    :func:`paged_chunk_attention`; this is the oracle tests hold it to."""
    C = cache_k.shape[1]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.head_dim_ ** -0.5
    k = repeat_kv(cache_k, n_rep)
    v = repeat_kv(cache_v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    slots = torch.arange(C, device=q.device)
    valid = slots[None, None, :] <= positions[..., None]        # [B,T,C]
    logits = torch.where(valid[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Paged attention for a T-token chunk straight over the KV pool
    (q [B,T,H,Dh]; pages [n_pages,P,Hkv,Dh]; the chunk's K/V must already
    be in the pages): the paged kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    return paged_decode_chunk(q, k_pages, v_pages, page_table, pos,
                              scale=cfg.head_dim_ ** -0.5,
                              n_rep=cfg.n_heads // cfg.n_kv_heads)


# --------------------------------------------------------------------- MLP
def mlp_block(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_type != "swiglu":
        raise NotImplementedError(
            f"mlp_type {cfg.mlp_type!r} is not ported yet (ROADMAP.md A11)")
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# --------------------------------------------------------------- embedding
def embed(tokens: torch.Tensor, p: dict) -> torch.Tensor:
    return p["tok"][tokens]


def unembed(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("...d,vd->...v", x, p["tok"])
    return x @ p["out"]
