"""Shared model building blocks (PyTorch, nested-dict params).

The port of the JAX package's ``models/layers.py``: norms (rms and layer),
RoPE (partial with ``rope_pct``), attention, the swiglu and gelu MLPs, the
tied unembedding with the reference's backward, and the training
forward's ``attention_block`` over ``sdpa`` or ``chunked_sdpa`` (plain
PyTorch, differentiable).
Layouts match the reference at every public function: activations
[B, S, D], q [B, S, H, Dh], k/v [B, S, Hkv, Dh], KV pages
[n_pages, P, Hkv, Dh].  Activations flow in ``cfg.torch_dtype``; norms and
softmax accumulate in f32.  The two attention functions of the serving path
go through hand-written CUDA kernels on a CUDA tensor and through their
plain versions on a CPU tensor (``kernels/*/ops.py``).  ``full_attention``,
``paged_chunk_attention`` and ``decode_attention`` only pass through to
those wrappers: they are kept so that the port's layer names match
``repro.models.layers`` one for one, which the parity tests and the
transformer rely on.  The dense slot-cache writes (``kv_cache_update*``)
update the cache in place, where the reference returns a new array: the
serving cache is hundreds of MB at full width, and the callers never read
the old one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.paged_attention.ops import (decode_attention_kernel,
                                           paged_decode_chunk)

NEG_INF = -1e30


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in f32 over the population variance (``jnp.var``), not
    torch's default unbiased one."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * weight.float() + bias.float()
    return out.to(x.dtype)


def apply_norm(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps)


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


def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: Optional[int], scale: float,
                 q_chunk: int = 512) -> torch.Tensor:
    """:func:`sdpa` over query chunks of ``q_chunk`` rows, so that only a
    [B, H, q_chunk, Skv] score block is live at a time (the reference's
    memory-efficient attention of its production train shapes)."""
    S, Skv = q.shape[1], k.shape[1]
    c = min(q_chunk, S)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    outs = []
    for q0 in range(0, S, c):
        qpos = torch.arange(q0, min(q0 + c, S), device=q.device)[:, None]
        m = torch.ones((qpos.shape[0], Skv), dtype=torch.bool,
                       device=q.device)
        if causal:
            m = m & (kpos <= qpos)
        if window is not None:
            m = m & (kpos > qpos - window)
        outs.append(sdpa(q[:, q0:q0 + c], k, v, m, scale))
    return torch.cat(outs, dim=1)


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


def attention_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    positions: torch.Tensor, window: Optional[int] = None,
                    attention_impl: str = "xla") -> torch.Tensor:
    """Full (training) self-attention over x [B,S,D]: ``"xla"`` is
    :func:`sdpa` under the causal mask, ``"xla_chunked"``
    :func:`chunked_sdpa`, both differentiable; ``"pallas"`` is the flash
    kernel (B2 on the card, forward only: under autograd its wrapper
    raises)."""
    S = x.shape[1]
    q, k, v = attention_qkv(x, p, cfg, positions)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.head_dim_ ** -0.5
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    if attention_impl == "pallas":
        out = flash_attention(q, k, v, causal=True, window=window,
                              scale=scale)
    elif attention_impl == "xla_chunked":
        out = chunked_sdpa(q, k, v, causal=True, window=window, scale=scale)
    elif attention_impl == "xla":
        out = sdpa(q, k, v, causal_mask(S, S, 0, window, device=x.device),
                   scale)
    else:
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ------------------------------------------------------------ decode utils
def mask_cache_rows(mask: torch.Tensor, new: dict, old: dict) -> dict:
    """Per cache leaf of ``new``, its rows where ``mask`` [B] is set and
    ``old``'s elsewhere (the batch axis is 0 for pos, 1 for the rest)."""
    out = {}
    for key, v in new.items():
        shape = [1] * v.dim()
        ax = 0 if key == "pos" else 1
        shape[ax] = v.shape[ax]
        out[key] = torch.where(mask.reshape(shape), v, old[key])
    return out


def pad_cache_seq(ks: torch.Tensor, vs: torch.Tensor, C: int,
                  window: Optional[int], pad_cache_to: Optional[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grow a prefill cache's seq dim (axis 2 of [L,B,C,H,D]) for decode
    headroom.  Windowed caches never grow past the window (the ring already
    holds the last ``window`` entries; C == window when S > window)."""
    if pad_cache_to is None:
        return ks, vs
    target = min(pad_cache_to, window) if window else pad_cache_to
    if target <= C:
        return ks, vs
    pads = (0, 0, 0, 0, 0, target - C)
    return F.pad(ks, pads), F.pad(vs, pads)


def _cache_slots(positions: torch.Tensor, C: int,
                 window: Optional[int]) -> torch.Tensor:
    """Cache slot of each position: ring-rolled with a window, else clamped
    to the last slot."""
    if window is not None:
        return torch.remainder(positions, C)
    return torch.clamp(positions, max=C - 1)


def kv_cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                    window: Optional[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one step's k/v ([B,1,Hkv,Dh]) at per-sequence ``pos`` [B]
    (ring-rolled if windowed) into cache_[kv] [B,C,Hkv,Dh], in place."""
    B, C = cache_k.shape[0], cache_k.shape[1]
    slot = _cache_slots(pos.long().expand(B), C, window)
    b = torch.arange(B, device=cache_k.device)
    cache_k[b, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[b, slot] = v[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def kv_cache_update_chunk(cache_k: torch.Tensor, cache_v: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor, valid: torch.Tensor,
                          window: Optional[int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write up to T tokens' k/v ([B,T,Hkv,Dh]) at per-sequence positions
    ``pos .. pos+T-1`` (ring-rolled if windowed), in place.  ``valid``
    [B,T] masks the tail: an invalid position re-writes the cache's
    existing value, so a sequence advancing fewer than T tokens leaves the
    rest of its row untouched."""
    B, C = cache_k.shape[0], cache_k.shape[1]
    T = k.shape[1]
    dev = cache_k.device
    positions = pos.long().expand(B)[:, None] + torch.arange(
        T, device=dev)[None, :]
    slot = _cache_slots(positions, C, window)
    b = torch.arange(B, device=dev)[:, None]
    m = valid[..., None, None]
    cache_k[b, slot] = torch.where(m, k.to(cache_k.dtype), cache_k[b, slot])
    cache_v[b, slot] = torch.where(m, v.to(cache_v.dtype), cache_v[b, slot])
    return cache_k, cache_v


def chunk_decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, positions: torch.Tensor,
                           cfg: ModelConfig) -> torch.Tensor:
    """T-token attention: q:[B,T,H,Dh] over a dense cache [B,C,Hkv,Dh]
    whose chunk k/v has already been written; query t attends cache
    positions <= positions[:, t].  The reference's gathered-dense (XLA)
    math for the dense chunk step (and the paged step's gathered-dense
    path), with its numerics: probabilities cast to v's type before P.V.
    It serves the dense plane's ``decode_chunk``; the port's paged step
    runs :func:`paged_chunk_attention`, which tests hold to this."""
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


def chunk_decode_attention_windowed(q: torch.Tensor, cache_k: torch.Tensor,
                                    cache_v: torch.Tensor,
                                    k_new: torch.Tensor, v_new: torch.Tensor,
                                    pos: torch.Tensor,
                                    valid_len: torch.Tensor,
                                    positions: torch.Tensor,
                                    cfg: ModelConfig,
                                    window: int) -> torch.Tensor:
    """Chunked attention for ring (sliding-window) caches, computed against
    the **pre-write** cache plus the chunk's own k/v (a chunk write can
    clobber ring slots that earlier in-chunk queries still need).  Query t
    (logical position ``positions[:, t]``) attends the pre-write cache,
    whose slot s holds the largest position < pos congruent to s (mod C),
    masked to its window, and the chunk itself, causally, window-masked and
    clipped to each sequence's valid length.  The reference's XLA math,
    with its numerics: probabilities cast to v's type before P.V."""
    B, C = cache_k.shape[0], cache_k.shape[1]
    T = k_new.shape[1]
    dev = q.device
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.head_dim_ ** -0.5
    pos = pos.long().expand(B)
    p = positions.long()[..., None]                             # [B,T,1]
    win = min(window, C)
    slots = torch.arange(C, device=dev)[None, :]
    h_old = pos[:, None] - 1 - torch.remainder(pos[:, None] - 1 - slots, C)
    valid_old = (h_old[:, None, :] >= 0) & (h_old[:, None, :] > p - win)
    k_c = repeat_kv(cache_k, n_rep)
    v_c = repeat_kv(cache_v, n_rep)
    log_c = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_c.float()) * scale
    log_c = torch.where(valid_old[:, None], log_c,
                        torch.full_like(log_c, NEG_INF))
    t_new = torch.arange(T, device=dev)
    p_new = pos[:, None] + t_new[None, :]                       # [B,T]
    valid_new = ((p_new[:, None, :] <= p) & (p_new[:, None, :] > p - win)
                 & (t_new[None, None, :] < valid_len.long()[:, None, None]))
    k_n = repeat_kv(k_new, n_rep)
    v_n = repeat_kv(v_new, n_rep)
    log_n = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_n.float()) * scale
    log_n = torch.where(valid_new[:, None], log_n,
                        torch.full_like(log_n, NEG_INF))
    probs = torch.softmax(torch.cat([log_c, log_n], dim=-1), dim=-1)
    vals = torch.cat([v_c, v_n.to(v_c.dtype)], dim=1)          # [B,C+T,...]
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(vals.dtype), vals)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention: q [B,1,H,Dh] over the dense cache [B,C,Hkv,Dh],
    the port of ``layers.decode_attention(impl="pallas")``: the ring kernel
    on a CUDA tensor, its plain version on a CPU tensor.  ``pos`` [B] is
    each sequence's position; with a window the cache is a ring and entries
    older than ``window`` are masked."""
    B = cache_k.shape[0]
    pos = pos.to(torch.int32).expand(B).contiguous()
    return decode_attention_kernel(q, cache_k, cache_v, pos, window=window,
                                   scale=cfg.head_dim_ ** -0.5,
                                   n_rep=cfg.n_heads // cfg.n_kv_heads)


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
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# --------------------------------------------------------------- embedding
def embed(tokens: torch.Tensor, p: dict) -> torch.Tensor:
    return p["tok"][tokens]


class _TiedUnembed(torch.autograd.Function):
    """``x @ w.T`` with the reference's backward (its ``custom_vjp``):
    dx = g @ w in x's type and dw = g^T x in w's type."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return torch.einsum("...d,vd->...v", x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        dx = torch.einsum("...v,vd->...d", g, w).to(x.dtype)
        dw = torch.einsum("...v,...d->vd", g, x).to(w.dtype)
        return dx, dw


def _tied_unembed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _TiedUnembed.apply(x, w)


def unembed(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return _tied_unembed(x, p["tok"])
    return x @ p["out"]
