"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), serving entry
points.

The port of the JAX package's ``models/encdec.py``.  The modality frontend
(mel spectrogram + conv feature extractor) is a stub: the caller supplies
precomputed frame embeddings [B, T_enc, D].  After it: a bidirectional
encoder with a learned position table ``enc_pos``, a causal decoder with
cross-attention over the encoder's output, LayerNorm + GELU.  The decoder
has no position signal of its own (``rope_pct=0``), as in the reference.

The encoder's attention and the cross-attention are the plain
:func:`layers.sdpa`, as the reference computes them.  The decoder's causal
self-attention goes through the kernels on a CUDA tensor: the flash kernel
in the monolithic ``prefill``, the ring kernel in ``decode_step`` and the
paged chunk kernel in ``decode_chunk_paged``; ``decode_chunk`` (the dense
plane) keeps the reference's dense math.

Decode caches: the decoder's self-attention K/V (dense slot cache or the
pool's pages) plus the cross-attention memory ``xk`` / ``xv``
[L, B, T_enc, Hkv, Dh], computed once from the frames (``encode_cross``).
Like the transformer's, ``decode_step`` and ``decode_chunk`` write the new
K/V into the given cache in place and ``decode_chunk_paged`` into the
given pages.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from . import layers as L
from . import transformer as T


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters with the tree, shapes and scales of the reference's
    ``encdec.init_params``; the draws come from ``generator``, which must
    live on ``device``."""
    dev = resolve_device(device)
    D, NE, ND = cfg.d_model, cfg.n_encoder_layers, cfg.n_layers

    def norm(*shape):
        return T.init_norm(cfg, shape, dev)

    embed = T.init_embedding(cfg, generator, dev)
    enc_pos = T._normal((cfg.encoder_seq, D), 0.02, cfg, generator, dev)
    enc = {"attn_norm": norm(NE, D),
           "attn": T.init_attention(cfg, NE, generator, dev),
           "mlp_norm": norm(NE, D),
           "mlp": T.init_mlp(cfg, NE, generator, dev)}
    dec = {"attn_norm": norm(ND, D),
           "attn": T.init_attention(cfg, ND, generator, dev),
           "xattn_norm": norm(ND, D),
           # cross-attention has full heads on both sides (Whisper is MHA)
           "xattn": T.init_attention(cfg, ND, generator, dev),
           "mlp_norm": norm(ND, D),
           "mlp": T.init_mlp(cfg, ND, generator, dev)}
    return {"embed": embed, "enc_pos": enc_pos, "enc_layers": enc,
            "enc_norm": norm(D), "dec_layers": dec, "final_norm": norm(D)}


def _scale(cfg: ModelConfig) -> float:
    return cfg.head_dim_ ** -0.5


def _n_rep(cfg: ModelConfig) -> int:
    return cfg.n_heads // cfg.n_kv_heads


def encode(params: dict, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: precomputed conv-frontend embeddings [B, T_enc, D]."""
    Te = frames.shape[1]
    x = frames.to(cfg.torch_dtype) + params["enc_pos"][None, :Te]
    positions = torch.arange(Te, device=x.device)[None, :]
    n_rep = _n_rep(cfg)
    for i in range(cfg.n_encoder_layers):
        p = T._layer(params["enc_layers"], i)
        h = L.apply_norm(x, p["attn_norm"], cfg)
        q, k, v = L.attention_qkv(h, p["attn"], cfg, positions)
        o = L.sdpa(q, L.repeat_kv(k, n_rep), L.repeat_kv(v, n_rep), None,
                   _scale(cfg))                # bidirectional: no mask
        x = x + torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"])
        h = L.apply_norm(x, p["mlp_norm"], cfg)
        x = x + L.mlp_block(h, p["mlp"], cfg)
    return L.apply_norm(x, params["enc_norm"], cfg)


def _cross_kv(memory: torch.Tensor, p: dict
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = torch.einsum("bsd,dhk->bshk", memory, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, p["wv"])
    return k, v


def _cross_attend(x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                  p: dict, cfg: ModelConfig) -> torch.Tensor:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    n_rep = _n_rep(cfg)
    o = L.sdpa(q, L.repeat_kv(xk, n_rep), L.repeat_kv(xv, n_rep), None,
               _scale(cfg))
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _dec_tail(x: torch.Tensor, o: torch.Tensor, p: dict, xk: torch.Tensor,
              xv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A decoder layer after its self-attention ``o``: the residual, the
    cross-attention over the memory and the MLP."""
    x = x + torch.einsum("bshk,hkd->bsd", o, p["attn"]["wo"])
    h = L.apply_norm(x, p["xattn_norm"], cfg)
    x = x + _cross_attend(h, xk, xv, p["xattn"], cfg)
    h = L.apply_norm(x, p["mlp_norm"], cfg)
    return x + L.mlp_block(h, p["mlp"], cfg)


def _finish(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    x = L.apply_norm(x, params["final_norm"], cfg)
    return L.unembed(x, params["embed"], cfg)


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed caches: decoder k/v [L,batch,max_seq,Hkv,Dh], cross memory
    xk/xv [L,batch,T_enc,Hkv,Dh] and pos [batch]."""
    dev = resolve_device(device)
    Hkv, Dh, NL = cfg.n_kv_heads, cfg.head_dim_, cfg.n_layers

    def zeros(S):
        return torch.zeros((NL, batch, S, Hkv, Dh), dtype=cfg.torch_dtype,
                           device=dev)

    return {"k": zeros(max_seq), "v": zeros(max_seq),
            "xk": zeros(cfg.encoder_seq), "xv": zeros(cfg.encoder_seq),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def encode_cross(params: dict, cfg: ModelConfig, frames: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the encoder and project each decoder layer's cross K/V.

    Returns (xk, xv) [L, B, T_enc, Hkv, Dh]: the same ``encode`` and
    per-layer projections as :func:`prefill`'s ``xk`` / ``xv``, so the
    chunked admission fills a slot's memory without a monolithic
    prefill."""
    memory = encode(params, cfg, frames)
    xks, xvs = [], []
    for i in range(cfg.n_layers):
        k, v = _cross_kv(memory, T._layer(params["dec_layers"], i)["xattn"])
        xks.append(k)
        xvs.append(v)
    return torch.stack(xks), torch.stack(xvs)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor, pad_cache_to: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode ``frames`` and run the decoder over the full prompt [B,S]
    (causal self-attention through :func:`layers.full_attention`).
    Returns (last-token logits [B,V], cache) with k/v [L,B,S,Hkv,Dh]
    (padded to ``pad_cache_to``), xk/xv and pos [B] = S."""
    memory = encode(params, cfg, frames)
    x = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None, :]
    n_rep = _n_rep(cfg)
    ks, vs, xks, xvs = [], [], [], []
    for i in range(cfg.n_layers):
        p = T._layer(params["dec_layers"], i)
        xk, xv = _cross_kv(memory, p["xattn"])
        h = L.apply_norm(x, p["attn_norm"], cfg)
        q, k, v = L.attention_qkv(h, p["attn"], cfg, positions)
        o = L.full_attention(q, L.repeat_kv(k, n_rep), L.repeat_kv(v, n_rep),
                             causal=True, window=None, scale=_scale(cfg))
        x = _dec_tail(x, o, p, xk, xv, cfg)
        ks.append(k)
        vs.append(v)
        xks.append(xk)
        xvs.append(xv)
    logits = _finish(x[:, -1:], params, cfg)[:, 0]
    ks, vs = L.pad_cache_seq(torch.stack(ks), torch.stack(vs), S, None,
                             pad_cache_to)
    return logits, {"k": ks, "v": vs, "xk": torch.stack(xks),
                    "xv": torch.stack(xvs),
                    "pos": torch.full((B,), S, dtype=torch.int32,
                                      device=dev)}


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """One decoder token ([B] int) against the caches: each layer writes its
    K/V at ``pos`` and attends through :func:`layers.decode_attention` (the
    ring kernel on the card), then cross-attends the memory.  Returns
    (logits [B,V], cache) with pos + 1; k/v are updated in place."""
    B = token.shape[0]
    dev = token.device
    pos = cache["pos"].to(device=dev, dtype=torch.int32).expand(B)
    x = L.embed(token[:, None], params["embed"]).to(cfg.torch_dtype)
    positions = pos[:, None]
    for i in range(cfg.n_layers):
        p = T._layer(params["dec_layers"], i)
        h = L.apply_norm(x, p["attn_norm"], cfg)
        q, k, v = L.attention_qkv(h, p["attn"], cfg, positions)
        ck, cv = L.kv_cache_update(cache["k"][i], cache["v"][i], k, v, pos,
                                   None)
        o = L.decode_attention(q, ck, cv, pos, cfg)
        x = _dec_tail(x, o, p, cache["xk"][i], cache["xv"][i], cfg)
    logits = _finish(x, params, cfg)[:, 0]
    return logits, dict(cache, pos=pos + 1)


def decode_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 valid_len: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """T decoder tokens ([B,T] int) against the dense caches in one
    forward: each sequence advances by ``valid_len[b] <= T`` positions;
    causal within the chunk, full attention over the cached prefix, the
    memory cross-attended every layer (the transformer's non-windowed
    ``decode_chunk``).  Returns (logits [B,T,V], cache) with pos +
    valid_len; k/v are updated in place."""
    B, T_ = tokens.shape
    dev = tokens.device
    pos = cache["pos"].to(device=dev, dtype=torch.int32).expand(B)
    valid_len = valid_len.to(device=dev, dtype=torch.int32)
    x = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    positions = pos[:, None].long() + torch.arange(T_, device=dev)[None, :]
    valid = torch.arange(T_, device=dev)[None, :] < valid_len[:, None]
    for i in range(cfg.n_layers):
        p = T._layer(params["dec_layers"], i)
        h = L.apply_norm(x, p["attn_norm"], cfg)
        q, k, v = L.attention_qkv(h, p["attn"], cfg, positions)
        ck, cv = cache["k"][i], cache["v"][i]
        L.kv_cache_update_chunk(ck, cv, k, v, pos, valid, None)
        o = L.chunk_decode_attention(q, ck, cv, positions, cfg)
        x = _dec_tail(x, o, p, cache["xk"][i], cache["xv"][i], cfg)
    return _finish(x, params, cfg), dict(cache, pos=pos + valid_len)


def decode_chunk_paged(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       valid_len: torch.Tensor, cache: dict,
                       k_pages: torch.Tensor, v_pages: torch.Tensor,
                       page_table: torch.Tensor, *, max_seq: int):
    """Paged-native :func:`decode_chunk`: the decoder's self-attention K/V
    lives in the pool pages (written in place, then attended through
    :func:`layers.paged_chunk_attention`, the paged chunk kernel on the
    card); the slim cache carries {"xk", "xv", "pos"}.  The writes are
    routed and dropped as in ``transformer.decode_chunk_paged``.
    Returns (logits [B,T,V], slim cache, k_pages, v_pages)."""
    B, T_ = tokens.shape
    dev = tokens.device
    pos = cache["pos"].to(device=dev, dtype=torch.int32)
    pos = pos.expand(B).contiguous()
    x = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    positions = pos[:, None].long() + torch.arange(T_, device=dev)[None, :]
    valid = torch.arange(T_, device=dev)[None, :] < valid_len[:, None]
    wb, wt, wpage, woff = T.paged_writes(positions, valid, page_table,
                                         k_pages.shape[2], max_seq)
    for i in range(cfg.n_layers):
        p = T._layer(params["dec_layers"], i)
        h = L.apply_norm(x, p["attn_norm"], cfg)
        q, k, v = L.attention_qkv(h, p["attn"], cfg, positions)
        kp, vp = k_pages[i], v_pages[i]
        kp.index_put_((wpage, woff), k[wb, wt].to(kp.dtype))
        vp.index_put_((wpage, woff), v[wb, wt].to(vp.dtype))
        o = L.paged_chunk_attention(q, kp, vp, page_table, pos, cfg)
        x = _dec_tail(x, o, p, cache["xk"][i], cache["xv"][i], cfg)
    slim = {"xk": cache["xk"], "xv": cache["xv"],
            "pos": pos + valid_len.to(torch.int32)}
    return _finish(x, params, cfg), slim, k_pages, v_pages
