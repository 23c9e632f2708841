"""Mixture-of-Experts FFN (qwen3-moe / granite-moe families), serving half.

The port of the JAX package's ``models/moe.py`` for the serving entry
points, which use its dropless dispatch: every token keeps all ``top_k``
choices, with no capacity buffers and no cross-token state, so a token's
output does not depend on what it is batched with (chunked == sequential
prefill, paged == dense plane, bitwise).  Like the reference, ``_dropless``
runs all E experts over the step's token block and masks the combine to
the top-k gates; those three products are exactly the grouped expert FFN
over a capacity buffer that holds the whole block for every expert, so they
go through ``kernels/moe_ffn`` (the hand-written CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor), the token block expanded over
the experts without a copy.

The capacity dispatches (``_capacity``, ``_dispatch_masks``,
``_group_einsum``, ``_group_gather``) serve training and are not ported
yet: ``moe_block`` raises for them, naming ROADMAP item A14.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.moe_ffn.ops import moe_ffn


def init_moe_layer(cfg: ModelConfig, generator: torch.Generator,
                   device: torch.device, n_layers: int) -> dict:
    """The reference's ``init_moe_layer`` tree, stacked over ``n_layers``:
    router [L,D,E] in float32 whatever the model's type, expert weights
    w_gate/w_up [L,E,D,F] and w_down [L,E,F,D] in ``cfg.torch_dtype``."""
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    s = (2.0 / (D + Fe)) ** 0.5

    def n(shape, std, dtype):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * std).to(dtype)

    L, dt = n_layers, cfg.torch_dtype
    return {"router": n((L, D, E), D ** -0.5, torch.float32),
            "w_gate": n((L, E, D, Fe), s, dt),
            "w_up": n((L, E, D, Fe), s, dt),
            "w_down": n((L, E, Fe, D), s, dt)}


def _route(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xg [G,D] -> (gates [G,k] renormalised, idx [G,k] int32, probs [G,E]).

    ``jax.lax.top_k`` returns equal values lower index first;
    ``torch.topk`` promises no order among ties, so the top k are the first
    k of a stable descending sort, which keeps lax's order."""
    logits = xg.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True)   # qwen3 renorm
    return gates, idx.to(torch.int32), probs


def _dropless(xt: torch.Tensor, p: dict, cfg: ModelConfig):
    """xt [T,D] -> (y [T,D] in xt's type, probs [T,E], counts [E] int32).

    All E experts over every token (one ``moe_ffn`` call on the [T,D] block
    expanded to [E,T,D]), combined in float32 with the top-k gates."""
    E = cfg.n_experts
    gates, idx, probs = _route(xt, p["router"], cfg)              # [T,k]
    xe = xt.to(cfg.torch_dtype).contiguous()
    ye = moe_ffn(xe[None].expand(E, *xe.shape), p["w_gate"], p["w_up"],
                 p["w_down"])                                     # [E,T,D]
    onehot = F.one_hot(idx.long(), E).float()                     # [T,k,E]
    w = torch.sum(onehot * gates[..., None], dim=1)               # [T,E]
    y = torch.einsum("te,etd->td", w, ye.float())
    counts = torch.sum(onehot, dim=(0, 1)).to(torch.int32)
    return y.to(xt.dtype), probs, counts


def load_balance_loss(probs: torch.Tensor, counts: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Switch-style aux loss: E * <f_e> . <p_e>."""
    frac = counts.float() / torch.clamp(torch.sum(counts), min=1)
    return cfg.n_experts * torch.sum(frac * torch.mean(probs, dim=0))


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
              impl: str = "dropless"):
    """x [B,S,D] -> (y [B,S,D], aux_loss, expert_counts [E])."""
    if impl != "dropless":
        raise NotImplementedError(
            f"moe impl {impl!r} (the capacity dispatch of training) is not "
            f"ported yet (ROADMAP.md A14)")
    B, S, D = x.shape
    y, probs, counts = _dropless(x.reshape(B * S, D), p, cfg)
    return y.reshape(B, S, D), load_balance_loss(probs, counts, cfg), counts
