"""VLM backbone (phi-3-vision): the language decoder that consumes stubbed
vision embeddings.

The port of the JAX package's ``models/vlm.py``.  The vision
tower and projector are a stub: the caller supplies precomputed patch
embeddings [B, T_img, D].  ``fuse`` puts them before the text tokens'
embeddings (one leading image) and everything else is the dense
transformer backbone's, the KV cache included: the image prefix enters
the cache (or the pool's pages) at prefill, after which every decode
step is the backbone's.  Training runs the backbone's ``forward`` over the
fused sequence, and the loss is masked to the text positions
(``text_loss_mask``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import layers as L
from . import transformer as T

init_params = T.init_params
init_cache = T.init_cache


def fuse(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
         image_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """[B,S_txt] tokens + [B,T_img,D] patch embeddings -> [B,T_img+S_txt,D]."""
    tok = L.embed(tokens, params["embed"]).to(cfg.torch_dtype)
    if image_embeds is None:
        return tok
    return torch.cat([image_embeds.to(device=tok.device,
                                      dtype=cfg.torch_dtype), tok], dim=1)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            image_embeds: Optional[torch.Tensor] = None,
            attention_impl: str = "xla", return_aux: bool = False,
            remat: bool = False, unembed: bool = True):
    x = fuse(params, cfg, tokens, image_embeds)
    return T.forward(params, cfg, None, inputs_embeds=x,
                     attention_impl=attention_impl, return_aux=return_aux,
                     remat=remat, unembed=unembed)


def text_loss_mask(cfg: ModelConfig, batch: int, text_len: int,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """Loss positions [batch, T_img + text_len]: only text tokens train
    (the image prefix is masked)."""
    img = torch.zeros((batch, cfg.n_image_tokens), dtype=torch.bool,
                      device=device)
    txt = torch.ones((batch, text_len), dtype=torch.bool, device=device)
    return torch.cat([img, txt], dim=1)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            image_embeds: Optional[torch.Tensor] = None,
            **kw) -> Tuple[torch.Tensor, dict]:
    x = fuse(params, cfg, tokens, image_embeds)
    return T.prefill(params, cfg, None, inputs_embeds=x, **kw)


# decode is text-only once the image prefix is cached
decode_step = T.decode_step
decode_chunk = T.decode_chunk
decode_chunk_paged = T.decode_chunk_paged
