"""Dense decoder-only transformer (the qwen3 family), serving entry points.

The port of the JAX package's ``models/transformer.py`` for the paged
serving plane: ``init_params``, the monolithic ``prefill`` and the
paged-native ``decode_chunk_paged``.  Parameters keep the reference's tree
and its leading layer dimension L; each layer is a loop iteration over
views of those stacked tensors (PyTorch runs eagerly, so there is no scan).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from . import layers as L


def _normal(shape, std: float, cfg: ModelConfig, generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * std).to(cfg.torch_dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> dict:
    """Random parameters with the tree, shapes and scales of the reference's
    ``transformer.init_params``; the draws come from ``generator``, which
    must live on ``device``."""
    dev = resolve_device(device)
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    F, V, NL = cfg.d_ff, cfg.vocab_size, cfg.n_layers
    dt = cfg.torch_dtype

    def s(a, b):
        return (2.0 / (a + b)) ** 0.5

    def n(shape, std):
        return _normal(shape, std, cfg, generator, dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    attn = {"wq": n((NL, D, H, Dh), s(D, Dh)),
            "wk": n((NL, D, Hkv, Dh), s(D, Dh)),
            "wv": n((NL, D, Hkv, Dh), s(D, Dh)),
            "wo": n((NL, H, Dh, D), s(Dh, D))}
    if cfg.qk_norm:
        attn["q_norm"] = ones(NL, Dh)
        attn["k_norm"] = ones(NL, Dh)
    s_in = s(D, F)
    embed = {"tok": n((V, D), D ** -0.5)}
    if not cfg.tie_embeddings:
        embed["out"] = n((D, V), D ** -0.5)
    return {
        "embed": embed,
        "layers": {
            "attn_norm": {"w": ones(NL, D)},
            "attn": attn,
            "mlp_norm": {"w": ones(NL, D)},
            "mlp": {"w_up": n((NL, D, F), s_in),
                    "w_down": n((NL, F, D), s_in),
                    "w_gate": n((NL, D, F), s_in)},
        },
        "final_norm": {"w": ones(D)},
    }


def _layer(tree: dict, i: int) -> dict:
    """Views of layer ``i`` of the layer-stacked parameter tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _mlp_residual(x: torch.Tensor, lp: dict, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, lp["mlp_norm"]["w"], cfg.norm_eps)
    return x + L.mlp_block(h, lp["mlp"], cfg)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process the full prompt ([B,S] int, left-padded to its bucket by the
    engine).  Returns (last-token logits [B,V], cache) with cache k/v
    [L,B,S,Hkv,Dh] and pos [B] = S."""
    x = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None, :]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.head_dim_ ** -0.5
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.rms_norm(x, lp["attn_norm"]["w"], cfg.norm_eps)
        q, k, v = L.attention_qkv(h, lp["attn"], cfg, positions)
        o = L.full_attention(q, L.repeat_kv(k, n_rep), L.repeat_kv(v, n_rep),
                             causal=True, window=None, scale=scale)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = _mlp_residual(x, lp, cfg)
        ks.append(k)
        vs.append(v)
    x = L.rms_norm(x[:, -1:], params["final_norm"]["w"], cfg.norm_eps)
    logits = L.unembed(x[:, 0], params["embed"], cfg)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device)}
    return logits, cache


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
    has no page (-1 entry), lies at or past ``max_seq`` or past
    ``valid_len`` is dropped, as the reference's ``mode="drop"`` scatter
    drops it: only in-bounds rows are indexed.

    Returns (logits [B,T,V], {"pos": pos + valid_len}, k_pages, v_pages).
    """
    B, T = tokens.shape
    dev = tokens.device
    pos = cache["pos"].to(device=dev, dtype=torch.int32)
    pos = pos.expand(B).contiguous()
    x = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    positions = pos[:, None].long() + torch.arange(T, device=dev)[None, :]
    valid = torch.arange(T, device=dev)[None, :] < valid_len[:, None]

    P = k_pages.shape[2]
    maxp = page_table.shape[1]
    pslot = torch.clamp(positions // P, max=maxp - 1)
    page_of = torch.gather(page_table.long(), 1, pslot)           # [B,T]
    off = positions % P
    inb = valid & (page_of >= 0) & (positions < max_seq)
    # the in-bounds rows, found once per step (one device sync)
    wb, wt = inb.nonzero(as_tuple=True)
    wpage, woff = page_of[wb, wt], off[wb, wt]

    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = L.rms_norm(x, lp["attn_norm"]["w"], cfg.norm_eps)
        q, k, v = L.attention_qkv(h, lp["attn"], cfg, positions)
        kp, vp = k_pages[i], v_pages[i]
        kp.index_put_((wpage, woff), k[wb, wt].to(kp.dtype))
        vp.index_put_((wpage, woff), v[wb, wt].to(vp.dtype))
        o = L.paged_chunk_attention(q, kp, vp, page_table, pos, cfg)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = _mlp_residual(x, lp, cfg)
    x = L.rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    logits = L.unembed(x, params["embed"], cfg)                  # [B,T,V]
    return logits, {"pos": pos + valid_len.to(torch.int32)}, k_pages, v_pages
