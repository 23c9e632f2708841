"""Model API of the port: ``build_model(cfg) -> Model``.

The same façade as the JAX package's ``models/model.py``.  Training:
``forward`` (logits and the MoE aux loss) and ``loss_fn`` (cross entropy
plus ``AUX_COEF`` times the aux loss; with ``remat`` the chunked cross
entropy over per-layer recomputation) for the dense, MoE and VLM
families, over plain PyTorch attention (``attention_impl`` "xla" or
"xla_chunked") and the MoE's capacity dispatch (``moe_impl`` "einsum" or
"gather"), differentiable by autograd.  The ssm, hybrid and audio
families' ``forward`` and ``loss_fn`` raise, naming ROADMAP.md A14.
Serving: the paged plane's ``prefill`` and ``decode_chunk_paged``, and
the dense slot-cache plane's ``init_cache``, ``decode_step`` and
``decode_chunk``; and the encoder-decoder's ``encode_cross``.  Every
family of the reference is served: dense (rms or layer norm, swiglu or
gelu MLPs, partial RoPE, sliding windows), MoE (the reference's serving
dispatch, ``moe_serve_impl="dropless"``), the VLM (the dense backbone
behind a fused image prefix: the batch's ``image_embeds``) and the
encoder-decoder (the batch's ``frames``).  The ssm family (mamba2) and the
hybrid family (recurrentgemma) have no pages: their ``decode_chunk_paged``
is None, and the engine keeps their decode state (and the hybrid's
sliding-window K/V rings) in a ``StateCachePool``.  The serving entry
points run the kernels whatever ``attention_impl`` and ``moe_impl`` say
(the MoE through its dropless dispatch); those two choose the training
forward's path.  ``input_specs`` is not ported (ROADMAP.md A15).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import encdec, rglru, ssm, transformer, vlm
from . import layers as L

AUX_COEF = 0.01   # MoE load-balance loss weight


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood in float32."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  impl: str = "onehot") -> torch.Tensor:
    """Mean token cross entropy in float32 over logits [..., V] and
    integer labels, or its mean over ``mask``'s positions.

    The reference's two ``impl``s take the gold logit by a one-hot
    contraction (which keeps a vocab-sharded product local) or by a
    gather; both are one ``torch.gather`` here, equal bit for bit to the
    one-hot sum (which adds only exact zeros), without building the
    [B, S, V] one-hot."""
    if impl not in ("onehot", "gather"):
        raise ValueError(f"unknown cross-entropy impl {impl!r}")
    nll = _nll(logits, labels)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def chunked_cross_entropy(hidden: torch.Tensor, labels: torch.Tensor,
                          params: dict, cfg: ModelConfig,
                          mask: Optional[torch.Tensor] = None,
                          chunk: int = 512) -> torch.Tensor:
    """Cross entropy from the final hidden states [B,S,D] without the full
    [B,S,V] logits: sequence chunks of ``chunk`` positions, each unembedded
    and reduced under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), so that one chunk's logits are live at a time in
    the forward and the backward.  The chunks' sums are added in order."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=hidden.device)

    def chunk_nll(h, y, m):
        nll = _nll(L.unembed(h, params["embed"], cfg), y)
        return torch.sum(nll * m), torch.sum(m).float()

    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, c):
        s, n = checkpoint(chunk_nll, hidden[:, s0:s0 + c],
                          labels[:, s0:s0 + c], mask[:, s0:s0 + c],
                          use_reentrant=False)
        total = total + s
        count = count + n
    return total / torch.clamp(count, min=1.0)


@dataclass
class Model:
    cfg: ModelConfig
    # init(generator, device=None) -> params
    init: Callable[..., dict]
    # forward(params, batch) -> (logits [B,S,V], aux loss): the training
    # forward of {"tokens"} (+ "image_embeds" for the VLM)
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    # loss_fn(params, {"tokens", "labels", ...}) -> scalar loss
    loss_fn: Callable[..., torch.Tensor]
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


def _not_ported(cfg: ModelConfig, what: str) -> Callable[..., Any]:
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"{what} of the {cfg.family} family ({cfg.arch_id}) is not "
            f"ported yet (ROADMAP.md A14, its second half: the ssm, hybrid "
            f"and audio families)")
    return refuse


def _training(cfg: ModelConfig, attention_impl: str, moe_impl: str,
              remat: bool) -> Tuple[Callable[..., Any], Callable[..., Any]]:
    """(forward, loss_fn) of the dense, MoE and VLM families, as the
    reference's ``build_model`` wires them."""
    if cfg.family in ("ssm", "hybrid", "audio"):
        return _not_ported(cfg, "forward"), _not_ported(cfg, "loss_fn")
    vision = cfg.family == "vlm"

    def run(params, batch, **kw):
        if vision:
            return vlm.forward(params, cfg, batch["tokens"],
                               batch.get("image_embeds"),
                               attention_impl=attention_impl,
                               return_aux=True, **kw)
        return transformer.forward(params, cfg, batch["tokens"],
                                   attention_impl=attention_impl,
                                   moe_impl=moe_impl, return_aux=True, **kw)

    def fwd(params, batch):
        return run(params, batch, remat=remat)

    def loss_fn(params, batch):
        labels, mask = batch["labels"], None
        if vision:   # labels padded over the image prefix, which is masked
            B, S_txt = batch["tokens"].shape
            mask = vlm.text_loss_mask(cfg, B, S_txt, labels.device)
            labels = torch.cat([labels.new_zeros((B, cfg.n_image_tokens)),
                                labels], dim=1)
        if remat:   # never materialize the full logits
            hidden, aux = run(params, batch, remat=True, unembed=False)
            return chunked_cross_entropy(hidden, labels, params, cfg,
                                         mask=mask) + AUX_COEF * aux
        logits, aux = fwd(params, batch)
        return cross_entropy(logits, labels, mask) + AUX_COEF * aux

    return fwd, loss_fn


def build_model(cfg: ModelConfig, attention_impl: str = "xla",
                moe_impl: str = "einsum", remat: bool = False) -> Model:
    """The model of ``cfg``.  ``attention_impl`` ("xla", "xla_chunked" or
    "pallas": B2, forward only), ``moe_impl`` ("einsum" or "gather") and
    ``remat`` choose the training ``forward`` and ``loss_fn``; the serving
    entry points ignore them."""
    fwd, loss_fn = _training(cfg, attention_impl, moe_impl, remat)
    if cfg.family == "vlm":
        return Model(
            cfg=cfg,
            forward=fwd,
            loss_fn=loss_fn,
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
            forward=fwd,
            loss_fn=loss_fn,
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
            forward=fwd,
            loss_fn=loss_fn,
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
            forward=fwd,
            loss_fn=loss_fn,
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
        forward=fwd,
        loss_fn=loss_fn,
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
