"""Model API of the port: ``build_model(cfg) -> Model``.

The same façade as the JAX package's ``models/model.py`` for the entry
points the paged serving plane calls.  Only the dense family is ported;
the others raise, naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from ..configs.base import ModelConfig
from . import transformer


@dataclass
class Model:
    cfg: ModelConfig
    # init(generator, device=None) -> params
    init: Callable[..., dict]
    # prefill(params, {"tokens": [B,S]}) -> (last logits [B,V], cache)
    prefill: Callable[..., Tuple[torch.Tensor, dict]]
    # decode_chunk_paged(params, tokens, valid_len, slim_cache, k_pages,
    # v_pages, page_table, *, max_seq) -> (logits, slim_cache, k_pages,
    # v_pages); the pages are updated in place
    decode_chunk_paged: Callable[..., Any]


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = []
    if cfg.family != "dense":
        unsupported.append(f"family {cfg.family!r} (ROADMAP.md A10-A13)")
    if cfg.n_experts:
        unsupported.append("MoE layers (ROADMAP.md A10)")
    if cfg.sliding_window is not None:
        unsupported.append("sliding windows (ROADMAP.md A11)")
    if cfg.norm_type != "rms" or cfg.mlp_type != "swiglu":
        unsupported.append("layer norm / gelu MLPs (ROADMAP.md A11)")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.arch_id}: not ported yet: " + "; ".join(unsupported))


def build_model(cfg: ModelConfig) -> Model:
    _check_supported(cfg)
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: transformer.init_params(
            cfg, generator, device),
        prefill=lambda params, batch: transformer.prefill(
            params, cfg, batch["tokens"]),
        decode_chunk_paged=lambda params, toks, n, cache, kp, vp, pt, **kw:
            transformer.decode_chunk_paged(params, cfg, toks, n, cache, kp,
                                           vp, pt, **kw),
    )
