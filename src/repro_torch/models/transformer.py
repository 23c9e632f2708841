"""Decoder-only transformer (the dense qwen3 / stablelm-2 / starcoder2
family, the MoE families and the VLM backbone).

The port of the JAX package's ``models/transformer.py``: ``init_params``;
the training ``forward`` (plain PyTorch attention and the MoE's capacity
dispatch, differentiable, with the MoE aux loss and per-layer
recomputation under ``remat``); and the serving entry points, the
monolithic ``prefill``, the paged-native ``decode_chunk_paged``, and the
dense slot-cache plane (``init_cache``, ``decode_step``,
``decode_chunk``), sliding-window rings included.
Parameters keep the reference's tree and its leading layer dimension L;
each layer is a loop iteration over views of those stacked tensors
(PyTorch runs eagerly, so there is no scan).  ``decode_step`` and
``decode_chunk`` write the new K/V into the given cache in place and
return it, where the reference returns a new cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from . import layers as L
from . import moe as M


# float32 elements a draw may hold at once (1 GiB): a larger stack of
# layers is drawn one layer at a time
_DRAW_ELEMS = 1 << 28


def _normal(shape, std: float, cfg: ModelConfig, generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
    if math.prod(shape) > _DRAW_ELEMS and len(shape) > 2:
        out = torch.empty(shape, dtype=cfg.torch_dtype, device=device)
        for part in out:
            part.copy_(_normal(part.shape, std, cfg, generator, device))
        return out
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * std).to(cfg.torch_dtype)


def _glorot(a: int, b: int) -> float:
    return (2.0 / (a + b)) ** 0.5


def init_norm(cfg: ModelConfig, shape, device: torch.device) -> dict:
    """Ones (and, for a layer norm, a zero bias ``"b"``) of ``shape``."""
    p = {"w": torch.ones(shape, dtype=cfg.torch_dtype, device=device)}
    if cfg.norm_type == "layer":
        p["b"] = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
    return p


def init_attention(cfg: ModelConfig, NL: int, generator: torch.Generator,
                   device: torch.device) -> dict:
    """``NL`` stacked attention layers: the reference's
    ``layers.init_attention`` tree, shapes and scales."""
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    def n(shape, std):
        return _normal(shape, std, cfg, generator, device)

    attn = {"wq": n((NL, D, H, Dh), _glorot(D, Dh)),
            "wk": n((NL, D, Hkv, Dh), _glorot(D, Dh)),
            "wv": n((NL, D, Hkv, Dh), _glorot(D, Dh)),
            "wo": n((NL, H, Dh, D), _glorot(Dh, D))}
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((NL, Dh), dtype=cfg.torch_dtype,
                                    device=device)
        attn["k_norm"] = torch.ones((NL, Dh), dtype=cfg.torch_dtype,
                                    device=device)
    return attn


def init_mlp(cfg: ModelConfig, NL: int, generator: torch.Generator,
             device: torch.device) -> dict:
    """``NL`` stacked dense MLPs (``w_gate`` for swiglu only)."""
    D, F = cfg.d_model, cfg.d_ff
    s_in = _glorot(D, F)
    mlp = {"w_up": _normal((NL, D, F), s_in, cfg, generator, device),
           "w_down": _normal((NL, F, D), s_in, cfg, generator, device)}
    if cfg.mlp_type == "swiglu":
        mlp["w_gate"] = _normal((NL, D, F), s_in, cfg, generator, device)
    return mlp


def init_embedding(cfg: ModelConfig, generator: torch.Generator,
                   device: torch.device) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    embed = {"tok": _normal((V, D), D ** -0.5, cfg, generator, device)}
    if not cfg.tie_embeddings:
        embed["out"] = _normal((D, V), D ** -0.5, cfg, generator, device)
    return embed


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters with the tree, shapes and scales of the reference's
    ``transformer.init_params``; the draws come from ``generator``, which
    must live on ``device``."""
    dev = resolve_device(device)
    NL, D = cfg.n_layers, cfg.d_model
    attn = init_attention(cfg, NL, generator, dev)
    embed = init_embedding(cfg, generator, dev)
    if cfg.n_experts > 0:
        mlp = M.init_moe_layer(cfg, generator, dev, NL)
    else:
        mlp = init_mlp(cfg, NL, generator, dev)
    return {
        "embed": embed,
        "layers": {
            "attn_norm": init_norm(cfg, (NL, D), dev),
            "attn": attn,
            "mlp_norm": init_norm(cfg, (NL, D), dev),
            "mlp": mlp,
        },
        "final_norm": init_norm(cfg, (D,), dev),
    }


def _layer(tree: dict, i: int) -> dict:
    """Views of layer ``i`` of the layer-stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(tree: dict):
    """The per-layer parameter trees of the layer-stacked tree, each leaf
    taken apart once with ``torch.unbind``, whose backward is one
    ``stack`` (indexing ``v[i]`` under autograd would give each layer's
    backward a zero tensor the size of the whole stack)."""
    parts = {k: _layers(v) if isinstance(v, dict) else torch.unbind(v, 0)
             for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _ffn(x: torch.Tensor, lp: dict, cfg: ModelConfig,
         moe_impl: str = "dropless") -> Tuple[torch.Tensor, torch.Tensor]:
    """FFN sub-block: the MoE or the dense MLP.  Returns (y, aux loss)."""
    if cfg.n_experts > 0:
        y, aux, _counts = M.moe_block(x, lp["mlp"], cfg, impl=moe_impl)
        return y, aux
    return L.mlp_block(x, lp["mlp"], cfg), x.new_zeros((), dtype=torch.float32)


def _mlp_residual(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    """Serving's FFN residual, through the dropless MoE (its aux loss and
    expert counts are training telemetry, which serving drops)."""
    h = L.apply_norm(x, lp["mlp_norm"], cfg)
    return x + _ffn(h, lp, cfg)[0]


def _block(x: torch.Tensor, p: dict, cfg: ModelConfig,
           positions: torch.Tensor, attention_impl: str,
           moe_impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One training layer: -> (x, the layer's MoE aux loss)."""
    h = L.apply_norm(x, p["attn_norm"], cfg)
    x = x + L.attention_block(h, p["attn"], cfg, positions,
                              window=cfg.sliding_window,
                              attention_impl=attention_impl)
    h = L.apply_norm(x, p["mlp_norm"], cfg)
    y, aux = _ffn(h, p, cfg, moe_impl)
    return x + y, aux


def forward(params: dict, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            inputs_embeds: Optional[torch.Tensor] = None,
            attention_impl: str = "xla", moe_impl: str = "einsum",
            return_aux: bool = False, remat: bool = False,
            unembed: bool = True):
    """Training forward over tokens [B,S] (or ``inputs_embeds`` [B,S,D]).
    Returns logits [B,S,V], or with ``unembed=False`` the final hidden
    states [B,S,D]; with ``return_aux`` also the MoE aux loss, the mean
    over layers.  ``remat=True`` recomputes each layer in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    per layer does."""
    x = (inputs_embeds if inputs_embeds is not None
         else L.embed(tokens, params["embed"])).to(cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = x.new_zeros((), dtype=torch.float32)
    for lp in _layers(params["layers"]):
        if remat:
            x, a = checkpoint(_block, x, lp, cfg, positions, attention_impl,
                              moe_impl, use_reentrant=False)
        else:
            x, a = _block(x, lp, cfg, positions, attention_impl, moe_impl)
        aux = aux + a
    x = L.apply_norm(x, params["final_norm"], cfg)
    out = L.unembed(x, params["embed"], cfg) if unembed else x
    if return_aux:
        return out, aux / max(cfg.n_layers, 1)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed dense slot cache: k/v [L,batch,C,Hkv,Dh] with C = max_seq, or
    min(max_seq, W) for a sliding window W (a ring), and pos [batch]."""
    dev = resolve_device(device)
    W = cfg.sliding_window
    C = min(max_seq, W) if W else max_seq
    shape = (cfg.n_layers, batch, C, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params: dict, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            inputs_embeds: Optional[torch.Tensor] = None,
            pad_cache_to: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the full prompt ([B,S] int, left-padded to its bucket by the
    engine), or ``inputs_embeds`` [B,S,D] in its place (the VLM's fused
    image prefix and text).  Returns (last-token logits [B,V], cache) with
    cache k/v [L,B,C,Hkv,Dh] and pos [B] = S.  C = S, or min(S, W) with a
    sliding window W, whose last C positions are ring-aligned (slot = pos
    % C).  ``pad_cache_to`` adds decode headroom to the cache (never past
    W)."""
    x = (inputs_embeds if inputs_embeds is not None
         else L.embed(tokens, params["embed"])).to(cfg.torch_dtype)
    B, S = x.shape[0], x.shape[1]
    dev = x.device
    positions = torch.arange(S, device=dev)[None, :]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.head_dim_ ** -0.5
    W = cfg.sliding_window
    C = min(S, W) if W else S
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.apply_norm(x, lp["attn_norm"], cfg)
        q, k, v = L.attention_qkv(h, lp["attn"], cfg, positions)
        o = L.full_attention(q, L.repeat_kv(k, n_rep), L.repeat_kv(v, n_rep),
                             causal=True, window=W, scale=scale)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = _mlp_residual(x, lp, cfg)
        # keep the last C positions, ring-aligned so that slot = pos % C
        kc, vc = k[:, S - C:], v[:, S - C:]
        if W:
            kc = torch.roll(kc, S % C, dims=1)
            vc = torch.roll(vc, S % C, dims=1)
        ks.append(kc)
        vs.append(vc)
    x = L.apply_norm(x[:, -1:], params["final_norm"], cfg)
    logits = L.unembed(x[:, 0], params["embed"], cfg)
    ks, vs = L.pad_cache_seq(torch.stack(ks), torch.stack(vs), C, W,
                             pad_cache_to)
    cache = {"k": ks, "v": vs,
             "pos": torch.full((B,), S, dtype=torch.int32, device=dev)}
    return logits, cache


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict) -> Tuple[torch.Tensor, dict]:
    """One token ([B] int) against the dense cache: every layer writes its
    K/V at ``pos`` and attends through :func:`layers.decode_attention` (the
    ring kernel on the card).  Returns (logits [B,V], cache) with pos + 1;
    the cache's k/v are the input's, updated in place."""
    B = token.shape[0]
    dev = token.device
    pos = cache["pos"].to(device=dev, dtype=torch.int32).expand(B)
    x = L.embed(token[:, None], params["embed"]).to(cfg.torch_dtype)
    positions = pos[:, None]
    W = cfg.sliding_window
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.apply_norm(x, lp["attn_norm"], cfg)
        q, k, v = L.attention_qkv(h, lp["attn"], cfg, positions)
        ck, cv = L.kv_cache_update(cache["k"][i], cache["v"][i], k, v, pos,
                                   W)
        o = L.decode_attention(q, ck, cv, pos, cfg, window=W)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = _mlp_residual(x, lp, cfg)
    x = L.apply_norm(x, params["final_norm"], cfg)
    logits = L.unembed(x[:, 0], params["embed"], cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def decode_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 valid_len: torch.Tensor, cache: dict
                 ) -> Tuple[torch.Tensor, dict]:
    """T tokens ([B,T] int) against the dense cache in one forward: each
    sequence advances by ``valid_len[b] <= T`` positions (an idle row, 0,
    keeps its cache row and position).  Causal within the chunk, full (or
    windowed) attention over the cached prefix.  Ring caches attend the
    pre-write cache plus the chunk, then write; plain caches write, then
    attend.  Returns (logits [B,T,V], cache) with pos + valid_len; callers
    read row ``valid_len[b]-1``.  The cache's k/v are updated in place."""
    B, T = tokens.shape
    dev = tokens.device
    pos = cache["pos"].to(device=dev, dtype=torch.int32).expand(B)
    valid_len = valid_len.to(device=dev, dtype=torch.int32)
    x = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    positions = pos[:, None].long() + torch.arange(T, device=dev)[None, :]
    valid = torch.arange(T, device=dev)[None, :] < valid_len[:, None]
    W = cfg.sliding_window
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.apply_norm(x, lp["attn_norm"], cfg)
        q, k, v = L.attention_qkv(h, lp["attn"], cfg, positions)
        ck, cv = cache["k"][i], cache["v"][i]
        if W:
            o = L.chunk_decode_attention_windowed(
                q, ck, cv, k, v, pos, valid_len, positions, cfg, window=W)
            L.kv_cache_update_chunk(ck, cv, k, v, pos, valid, W)
        else:
            L.kv_cache_update_chunk(ck, cv, k, v, pos, valid, W)
            o = L.chunk_decode_attention(q, ck, cv, positions, cfg)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = _mlp_residual(x, lp, cfg)
    x = L.apply_norm(x, params["final_norm"], cfg)
    logits = L.unembed(x, params["embed"], cfg)                  # [B,T,V]
    return logits, {"k": cache["k"], "v": cache["v"],
                    "pos": pos + valid_len}


def paged_writes(positions: torch.Tensor, valid: torch.Tensor,
                 page_table: torch.Tensor, P: int, C: int
                 ) -> Tuple[torch.Tensor, ...]:
    """Where a paged chunk step writes: the (row, token) pairs (wb, wt) of
    the chunk positions [B,T] that are ``valid``, have a page and lie below
    the dense slot length C, and their (page, offset) in the pool, found
    once per step (one device sync).  The other writes are dropped, as the
    reference's ``mode="drop"`` scatter drops them."""
    maxp = page_table.shape[1]
    pslot = torch.clamp(positions // P, max=maxp - 1)
    page_of = torch.gather(page_table.long(), 1, pslot)           # [B,T]
    off = positions % P
    inb = valid & (page_of >= 0) & (positions < C)
    wb, wt = inb.nonzero(as_tuple=True)
    return wb, wt, page_of[wb, wt], off[wb, wt]


def decode_chunk_paged(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       valid_len: torch.Tensor, cache: dict,
                       k_pages: torch.Tensor, v_pages: torch.Tensor,
                       page_table: torch.Tensor, *, max_seq: int):
    """Paged-native chunk step: the KV pool IS the decode cache.

    tokens [B,T] int; valid_len [B] (each sequence advances by
    ``valid_len[b] <= T`` positions); cache {"pos": [B] int32};
    pages [L,n_pages,P,Hkv,Dh]; page_table [B,max_pages] int32, -1 padded.
    New K/V is written straight into the pool pages named by the table,
    then attention runs over the pages (write-then-attend).  The caller
    (the engine) guarantees that every page about to be written has
    refcount 1 and that no two rows write one position.

    The pool pages are updated in place; this replaces the reference's
    donation of the page arrays to its jitted step.  A write whose position
    has no page (-1 entry), lies at or past the dense slot length (``max_seq``,
    or the window W if smaller) or past ``valid_len`` is dropped, as the
    reference's ``mode="drop"`` scatter drops it: only in-bounds rows are
    indexed.  Like the reference's kernel path, the attention applies no
    window: a windowed config is served here only when ``max_seq <= W``,
    where no window ever masks (the engine keeps the others on the dense
    ring plane).

    Returns (logits [B,T,V], {"pos": pos + valid_len}, k_pages, v_pages).
    """
    B, T = tokens.shape
    dev = tokens.device
    pos = cache["pos"].to(device=dev, dtype=torch.int32)
    pos = pos.expand(B).contiguous()
    x = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    positions = pos[:, None].long() + torch.arange(T, device=dev)[None, :]
    valid = torch.arange(T, device=dev)[None, :] < valid_len[:, None]

    W = cfg.sliding_window
    C = min(max_seq, W) if W else max_seq
    wb, wt, wpage, woff = paged_writes(positions, valid, page_table,
                                       k_pages.shape[2], C)

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.apply_norm(x, lp["attn_norm"], cfg)
        q, k, v = L.attention_qkv(h, lp["attn"], cfg, positions)
        kp, vp = k_pages[i], v_pages[i]
        kp.index_put_((wpage, woff), k[wb, wt].to(kp.dtype))
        vp.index_put_((wpage, woff), v[wb, wt].to(vp.dtype))
        o = L.paged_chunk_attention(q, kp, vp, page_table, pos, cfg)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = _mlp_residual(x, lp, cfg)
    x = L.apply_norm(x, params["final_norm"], cfg)
    logits = L.unembed(x, params["embed"], cfg)                  # [B,T,V]
    return logits, {"pos": pos + valid_len.to(torch.int32)}, k_pages, v_pages
