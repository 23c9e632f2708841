"""Model API of the port: ``build_model(cfg) -> Model``.

The same façade as the JAX package's ``models/model.py`` for the serving
entry points: the paged plane's ``prefill`` and ``decode_chunk_paged``, and
the dense slot-cache plane's ``init_cache``, ``decode_step`` and
``decode_chunk``; and the encoder-decoder's ``encode_cross``.  Every
family of the reference is served: dense (rms or layer norm, swiglu or
gelu MLPs, partial RoPE, sliding windows), MoE (the reference's serving
dispatch, ``moe_serve_impl="dropless"``), the VLM (the dense backbone
behind a fused image prefix: the batch's ``image_embeds``) and the
encoder-decoder (the batch's ``frames``).  The ssm family (mamba2) and the
hybrid family (recurrentgemma) have no pages: their ``decode_chunk_paged``
is None, and the engine keeps their decode state (and the hybrid's
sliding-window K/V rings) in a ``StateCachePool``.  Training
(``forward``, ``loss_fn``) and ``input_specs`` are not ported (ROADMAP.md
A14, A15).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import encdec, rglru, ssm, transformer, vlm


@dataclass
class Model:
    cfg: ModelConfig
    # init(generator, device=None) -> params
    init: Callable[..., dict]
    # prefill(params, {"tokens": [B,S]}, pad_cache_to=None)
    #   -> (last logits [B,V], cache)
    prefill: Callable[..., Tuple[torch.Tensor, dict]]
    # decode_step(params, tok [B], cache) -> (logits [B,V], cache)
    decode_step: Callable[..., Tuple[torch.Tensor, dict]]
    # decode_chunk(params, toks [B,T], valid_len [B], cache)
    #   -> (logits [B,T,V], cache)
    decode_chunk: Callable[..., Tuple[torch.Tensor, dict]]
    # decode_chunk_paged(params, tokens, valid_len, slim_cache, k_pages,
    # v_pages, page_table, *, max_seq) -> (logits, slim_cache, k_pages,
    # v_pages); the pages are updated in place.  None for the ssm family.
    decode_chunk_paged: Optional[Callable[..., Any]]
    # init_cache(batch, max_seq, device=None) -> {"k", "v", "pos"}, or
    # {"conv", "ssm", "pos"} for the ssm family, {"conv", "h", "k", "v",
    # "pos"} for the hybrid, {"k", "v", "xk", "xv", "pos"} for audio
    init_cache: Callable[..., dict]
    # encode_cross(params, frames [B,T_enc,D]) -> (xk, xv) [L,B,T_enc,Hkv,
    # Dh]: the encoder-decoder's cross-attention memory, so a chunked
    # admission fills a slot without a monolithic prefill; None elsewhere
    encode_cross: Optional[Callable[..., Any]] = None


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "vlm":
        return Model(
            cfg=cfg,
            init=lambda generator, device=None: vlm.init_params(
                cfg, generator, device),
            prefill=lambda params, batch, **kw: vlm.prefill(
                params, cfg, batch["tokens"], batch.get("image_embeds"),
                **kw),
            decode_step=lambda params, tok, cache: vlm.decode_step(
                params, cfg, tok, cache),
            decode_chunk=lambda params, toks, n, cache: vlm.decode_chunk(
                params, cfg, toks, n, cache),
            decode_chunk_paged=lambda params, toks, n, cache, kp, vp, pt,
            **kw: vlm.decode_chunk_paged(params, cfg, toks, n, cache, kp,
                                         vp, pt, **kw),
            init_cache=functools.partial(vlm.init_cache, cfg),
        )
    if cfg.family == "audio":
        return Model(
            cfg=cfg,
            init=lambda generator, device=None: encdec.init_params(
                cfg, generator, device),
            prefill=lambda params, batch, **kw: encdec.prefill(
                params, cfg, batch["tokens"], batch["frames"], **kw),
            decode_step=lambda params, tok, cache: encdec.decode_step(
                params, cfg, tok, cache),
            decode_chunk=lambda params, toks, n, cache: encdec.decode_chunk(
                params, cfg, toks, n, cache),
            decode_chunk_paged=lambda params, toks, n, cache, kp, vp, pt,
            **kw: encdec.decode_chunk_paged(params, cfg, toks, n, cache, kp,
                                            vp, pt, **kw),
            init_cache=functools.partial(encdec.init_cache, cfg),
            encode_cross=lambda params, frames: encdec.encode_cross(
                params, cfg, frames),
        )
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            init=lambda generator, device=None: ssm.init_params(
                cfg, generator, device),
            prefill=lambda params, batch: ssm.prefill(params, cfg,
                                                      batch["tokens"]),
            decode_step=lambda params, tok, cache: ssm.decode_step(
                params, cfg, tok, cache),
            decode_chunk=lambda params, toks, n, cache: ssm.decode_chunk(
                params, cfg, toks, n, cache),
            decode_chunk_paged=None,
            init_cache=functools.partial(ssm.init_cache, cfg),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda generator, device=None: rglru.init_params(
                cfg, generator, device),
            prefill=lambda params, batch, **kw: rglru.prefill(
                params, cfg, batch["tokens"], **kw),
            decode_step=lambda params, tok, cache: rglru.decode_step(
                params, cfg, tok, cache),
            decode_chunk=lambda params, toks, n, cache: rglru.decode_chunk(
                params, cfg, toks, n, cache),
            decode_chunk_paged=None,
            init_cache=functools.partial(rglru.init_cache, cfg),
        )
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: transformer.init_params(
            cfg, generator, device),
        prefill=lambda params, batch, **kw: transformer.prefill(
            params, cfg, batch["tokens"], **kw),
        decode_step=lambda params, tok, cache: transformer.decode_step(
            params, cfg, tok, cache),
        decode_chunk=lambda params, toks, n, cache: transformer.decode_chunk(
            params, cfg, toks, n, cache),
        decode_chunk_paged=lambda params, toks, n, cache, kp, vp, pt, **kw:
            transformer.decode_chunk_paged(params, cfg, toks, n, cache, kp,
                                           vp, pt, **kw),
        init_cache=functools.partial(transformer.init_cache, cfg),
    )
