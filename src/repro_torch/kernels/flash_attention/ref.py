"""Plain PyTorch version of the flash attention kernel.

Repeats the kernel's arithmetic: f32 logits, masked positions set to
-1e30, f32 softmax, probabilities rounded to v's type before the P.V
product (the kernel rounds its unnormalised tile probabilities, this rounds
the normalised ones: the two agree to the input type's precision), one cast
to q's type.  It materialises the full score matrix, so it is the oracle
and the CPU path, not a fast path.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_bhsd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """q [BH,Sq,D]; k/v [BH,Skv,D] (GQA already expanded) -> [BH,Sq,D]."""
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else scale
    Sq, Skv = q.shape[1], k.shape[1]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)
