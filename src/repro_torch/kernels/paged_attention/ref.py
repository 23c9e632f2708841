"""Plain PyTorch versions of the decode attention kernels.

Each repeats its kernel's arithmetic: f32 logits, invisible positions
masked with -1e30, f32 softmax, and P.V kept in f32 (as the TPU kernels
do), then one cast to q's type.  They materialize the masked logits over
the whole cache (the paged one gathers the pages densely), so they are the
oracles and the CPU path, not fast paths.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def ring_visible(pos: torch.Tensor, C: int,
                 window: Optional[int]) -> torch.Tensor:
    """[B, C] mask of the cache slots a query at ``pos`` [B] sees.  With a
    window the cache is a ring (slot = position % C) and a slot is visible
    when its age ``(pos % C - slot) % C`` is below ``min(window, pos+1)``;
    without one, slots ``<= pos`` are visible."""
    pos = pos.long()[:, None]
    slots = torch.arange(C, device=pos.device)[None, :]
    if window is None:
        return slots <= pos
    age = torch.remainder(torch.remainder(pos, C) - slots, C)
    return age < torch.clamp(pos + 1, max=window)


def decode_ring_ref(q: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, pos: torch.Tensor, *,
                    scale: float, n_rep: int,
                    window: Optional[int] = None) -> torch.Tensor:
    """One-token attention: q [B,1,H,D] over the dense per-slot cache
    [B,C,Hkv,D] (query head g*n_rep + r reads kv head g), visibility by
    :func:`ring_visible`.  -> [B,1,H,D]."""
    B, C, Hkv, D = cache_k.shape
    qg = q.float().reshape(B, Hkv, n_rep, D)
    logits = torch.einsum("bgrd,bcgd->bgrc", qg, cache_k.float()) * scale
    visible = ring_visible(pos, C, window)
    logits = torch.where(visible[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", probs, cache_v.float())
    return out.reshape(B, 1, Hkv * n_rep, D).to(q.dtype)


def paged_decode_chunk_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, *, scale: float,
                           n_rep: int) -> torch.Tensor:
    """q [B,T,H,D] over pages [n_pages,P,Hkv,D] by ``page_table``
    [B,max_pages] (-1 = no page); chunk token t of sequence b attends pool
    positions <= pos[b] + t.  -> [B,T,H,D]."""
    B, T, H, D = q.shape
    _n, P, Hkv, _ = k_pages.shape
    maxp = page_table.shape[1]
    C = maxp * P
    pt = page_table.long()
    idx = pt.clamp(min=0)
    k = k_pages[idx].reshape(B, C, Hkv, D).float()
    v = v_pages[idx].reshape(B, C, Hkv, D).float()
    qg = q.float().reshape(B, T, Hkv, n_rep, D)
    logits = torch.einsum("btgrd,bcgd->bgrtc", qg, k) * scale
    tok = torch.arange(C, device=q.device)
    qpos = pos.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    present = (pt >= 0).repeat_interleave(P, dim=1)              # [B,C]
    visible = (tok[None, None, :] <= qpos[:, :, None]) & present[:, None, :]
    logits = torch.where(visible[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrtc,bcgd->btgrd", probs, v)
    return out.reshape(B, T, H, D).to(q.dtype)
