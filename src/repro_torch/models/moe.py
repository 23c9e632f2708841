"""Mixture-of-Experts FFN (qwen3-moe / granite-moe families).

The port of the JAX package's ``models/moe.py``.  The serving entry
points use its dropless dispatch: every token keeps all ``top_k``
choices, with no capacity buffers and no cross-token state, so a token's
output does not depend on what it is batched with (chunked == sequential
prefill, paged == dense plane, bitwise).  Like the reference, ``_dropless``
runs all E experts over the step's token block and masks the combine to
the top-k gates; those three products are exactly the grouped expert FFN
over a capacity buffer that holds the whole block for every expert, so they
go through ``kernels/moe_ffn`` (the hand-written CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor), the token block expanded over
the experts without a copy.

Training uses the reference's capacity dispatches (``impl="einsum"``,
the default, and ``"gather"``): tokens in groups of ``group_size`` (the
last padded with zero rows), top-k choices placed into per-expert buffers
of ``_capacity`` rows in priority order (every first choice before any
second), the overflow dropped.  They are plain PyTorch and
differentiable: no kernel of the port has a backward.  The groups run as
one batched call where the reference maps ``jax.vmap`` over them.
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


def _capacity(group: int, cfg: ModelConfig) -> int:
    c = int(group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)   # round up to a multiple of 4


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


def _dispatch_masks(idx: torch.Tensor, gates: torch.Tensor, G: int, C: int,
                    cfg: ModelConfig):
    """Positions in per-expert buffers, the k choices in priority order.

    idx, gates [..., G, k] -> dispatch [..., G, E, C] (0/1 in the model's
    type), combine [..., G, E, C] (float32, the gate of each placed
    choice) and the per-expert counts of placed choices [..., E] (int32).
    A token names an expert at most once, so each (token, expert) holds at
    most one choice: its buffer slot and gate are kept per (token,
    expert) and expanded over C once, where the reference adds up one
    [G, E, C] one-hot per choice (the same values: each sum has one
    nonzero term)."""
    E = cfg.n_experts
    lead = idx.shape[:-2]
    dev = idx.device
    counts = torch.zeros((*lead, E), dtype=torch.long, device=dev)
    slot = torch.zeros((*lead, G, E), dtype=torch.long, device=dev)
    placed = torch.zeros((*lead, G, E), dtype=torch.bool, device=dev)
    gate = torch.zeros((*lead, G, E), dtype=torch.float32, device=dev)
    for j in range(cfg.top_k):                     # static small loop
        mask_j = F.one_hot(idx[..., j].long(), E)                  # [..,G,E]
        pos_j = torch.cumsum(mask_j, dim=-2) - 1 + counts[..., None, :]
        within = (pos_j < C) & (mask_j > 0)
        slot = torch.where(within, pos_j, slot)
        placed = placed | within
        gate = gate + within.float() * gates[..., j, None]
        counts = counts + torch.sum(mask_j * within, dim=-2)
    oh = (slot[..., None] == torch.arange(C, device=dev)) & placed[..., None]
    dispatch = oh.to(cfg.torch_dtype)
    combine = oh.float() * gate[..., None]
    return dispatch, combine, counts.to(torch.int32)


def _expert_ffn(xe: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """xe [n,E,C,D] -> [n,E,C,D]: each expert's SwiGLU over its rows."""
    h = F.silu(torch.einsum("necd,edf->necf", xe, p["w_gate"]))
    h = h * torch.einsum("necd,edf->necf", xe, p["w_up"])
    return torch.einsum("necf,efd->necd", h, p["w_down"])


def _route_groups(xg: torch.Tensor, p: dict, cfg: ModelConfig):
    """:func:`_route` over xg [n,G,D] -> gates, idx [n,G,k], probs
    [n,G,E]."""
    n, G, D = xg.shape
    gates, idx, probs = _route(xg.reshape(n * G, D), p["router"], cfg)
    return (gates.reshape(n, G, -1), idx.reshape(n, G, -1),
            probs.reshape(n, G, -1))


def _group_einsum(xg: torch.Tensor, p: dict, cfg: ModelConfig):
    """One-hot matmul dispatch of n groups, xg [n,G,D] -> (y [n,G,D],
    probs [n,G,E], counts [n,E])."""
    G = xg.shape[1]
    C = _capacity(G, cfg)
    gates, idx, probs = _route_groups(xg, p, cfg)
    dispatch, combine, counts = _dispatch_masks(idx, gates, G, C, cfg)
    xe = torch.einsum("ngec,ngd->necd", dispatch, xg.to(cfg.torch_dtype))
    ye = _expert_ffn(xe, p, cfg)
    y = torch.einsum("ngec,necd->ngd", combine.to(ye.dtype), ye)
    return y.to(xg.dtype), probs, counts


def _group_gather(xg: torch.Tensor, p: dict, cfg: ModelConfig):
    """Index dispatch of n groups: the routing of :func:`_group_einsum`
    without its one-hot matmuls.  The (token, choice) pairs are sorted
    stably by expert; each lands at its rank within its expert, or is
    dropped past C.  ``counts`` holds every choice, dropped or not, as
    the reference's ``bincount`` does."""
    n, G, D = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(G, cfg)
    dev = xg.device
    gates, idx, probs = _route_groups(xg, p, cfg)
    flat_e = idx.reshape(n, G * k).long()
    flat_t = torch.arange(G, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]                                         # [n,G*k]
    sg = torch.gather(gates.reshape(n, G * k), 1, order)
    counts = F.one_hot(flat_e, E).sum(dim=1)                   # [n,E]
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(G * k, device=dev) - torch.gather(starts, 1, se)
    within = pos < C
    slot = torch.where(within, se * C + pos, E * C)            # E*C: dropped
    grp = torch.arange(n, device=dev)[:, None].expand(n, G * k)
    rows = xg.to(cfg.torch_dtype)[grp, st]
    buf = torch.zeros((n, E * C + 1, D), dtype=cfg.torch_dtype, device=dev)
    buf = buf.index_put((grp, slot), rows)
    ye = _expert_ffn(buf[:, :-1].reshape(n, E, C, D), p, cfg)
    ye_flat = torch.cat([ye.reshape(n, E * C, D),
                         torch.zeros((n, 1, D), dtype=ye.dtype, device=dev)],
                        dim=1)
    contrib = ye_flat[grp, slot] * (sg * within).to(ye.dtype)[..., None]
    y = torch.zeros((n, G, D), dtype=ye.dtype, device=dev).index_put(
        (grp, st), contrib, accumulate=True)
    return y.to(xg.dtype), probs, counts.to(torch.int32)


def load_balance_loss(probs: torch.Tensor, counts: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Switch-style aux loss: E * <f_e> . <p_e>."""
    frac = counts.float() / torch.clamp(torch.sum(counts), min=1)
    return cfg.n_experts * torch.sum(frac * torch.mean(probs, dim=0))


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
              group_size: int = 2048, impl: str = "einsum"):
    """x [B,S,D] -> (y [B,S,D], aux_loss, expert_counts [E]).

    ``impl`` is ``"einsum"`` or ``"gather"`` (the capacity dispatches of
    training, in groups of ``group_size`` tokens; the aux loss and counts
    are over every group, padding rows included, as the reference's) or
    ``"dropless"`` (serving, through the expert-FFN kernel)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    if impl == "dropless":
        y, probs, counts = _dropless(xt, p, cfg)
        return y.reshape(B, S, D), load_balance_loss(probs, counts, cfg), \
            counts
    if impl not in ("einsum", "gather"):
        raise ValueError(f"unknown moe impl {impl!r}")
    G = min(group_size, T)
    if T % G:   # pad to a whole number of groups
        xt = torch.cat([xt, xt.new_zeros((G - T % G, D))])
    fn = _group_gather if impl == "gather" else _group_einsum
    y, probs, counts = fn(xt.reshape(-1, G, D), p, cfg)
    counts = torch.sum(counts, dim=0, dtype=torch.int32)
    aux = load_balance_loss(probs.reshape(-1, cfg.n_experts), counts, cfg)
    return y.reshape(-1, D)[:T].reshape(B, S, D), aux, counts
