"""Model API of the port: ``build_model(cfg) -> Model``.

The same façade as the JAX package's ``models/model.py`` for the serving
entry points: the paged plane's ``prefill`` and ``decode_chunk_paged``, and
the dense slot-cache plane's ``init_cache``, ``decode_step`` and
``decode_chunk``.  The dense and MoE rms/swiglu families are ported,
sliding windows included; the MoE layers run the reference's serving
dispatch (``moe_serve_impl="dropless"``).  The ssm family (mamba2) and the
hybrid family (recurrentgemma) have no pages: their ``decode_chunk_paged``
is None, and the engine keeps their decode state (and the hybrid's
sliding-window K/V rings) in a ``StateCachePool``.  The other families
raise, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import rglru, ssm, transformer


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
    # "pos"} for the hybrid
    init_cache: Callable[..., dict]


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = []
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        unsupported.append(f"family {cfg.family!r} (ROADMAP.md A12)")
    if cfg.norm_type != "rms" or cfg.mlp_type != "swiglu":
        unsupported.append("layer norm / gelu MLPs (ROADMAP.md A11)")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.arch_id}: not ported yet: " + "; ".join(unsupported))


def build_model(cfg: ModelConfig) -> Model:
    _check_supported(cfg)
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
