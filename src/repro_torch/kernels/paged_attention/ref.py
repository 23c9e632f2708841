"""Plain PyTorch version of the paged chunk attention kernel.

Repeats the kernel's arithmetic: f32 logits, positions past a row's query
position and pages whose table entry is -1 masked with -1e30, f32 softmax,
and P.V kept in f32 (as ``_paged_chunk_kernel`` does on the TPU), then one
cast to q's type.  It gathers the pages densely, so it is the oracle and the
CPU path, not a fast path.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


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
