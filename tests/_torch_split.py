"""The split block of the port's split-KV kernels (``csrc/
split_attention.cuh``) and their merge (``csrc/split_merge.cuh``) in plain
torch, for the CPU emulations of the ring kernel
(``test_torch_ring_split.py``), the paged chunk kernel
(``test_torch_paged_split.py``, :func:`paged_chunk_emulation`) and the
one-token paged decode (``test_torch_paged_decode_split.py``).

The kernels' arithmetic, split by split: f32 scores of the inputs masked
to -inf where a row may not see a key, the K and V of keys no row of the
block sees zero-filled, a row's max replaced by 0 in its exponent when it
sees no key of the split (so its p are 0 and its l is 0), and in bf16 the
probabilities fed to P.V as bf16 hi + lo (or as hi alone with
``p_lo=False``).  Then the merge: splits with l = 0 pass over, the rest
weigh exp(m_s - max m), summed in the merge kernel's order.
"""

import numpy as np
import torch

from repro_torch.kernels.paged_attention.ops import SPLIT


def split_bounds(C, S):
    """[(first key, end key)] of each split of C keys cut every S."""
    return [(s * S, min(C, (s + 1) * S)) for s in range(-(-C // S))]


def split_states(qg, k, v, visible, S, *, scale, p_lo=True):
    """Each split's (m, l, acc) per query row, as the split kernel leaves
    them.  qg [B,G,R,D] holds the rows of kv head g, k and v [B,C,G,D],
    visible [B,1,R,C] (or [B,1,1,C]) whether row r may see key c.  Returns
    m, l [B,G,R,n] and acc [B,G,R,n,D] in f32 over n splits of S keys; a
    split a row does not see gets (-inf, 0) and acc 0."""
    bf16 = qg.dtype == torch.bfloat16
    block = visible.any(2)[..., None].transpose(1, 2)          # [B,C,1,1]
    zero = torch.zeros(())
    k = torch.where(block, k.float(), zero)
    v = torch.where(block, v.float(), zero)
    qf = qg.float().contiguous()
    ms, ls, accs = [], [], []
    for t0, t1 in split_bounds(k.shape[1], S):
        vis = visible[..., t0:t1]
        s = torch.einsum("bgrd,bcgd->bgrc", qf, k[:, t0:t1]) * scale
        s = torch.where(vis, s, torch.full_like(s, -np.inf))
        m = s.amax(-1)
        base = torch.where(m == -np.inf, torch.zeros_like(m), m)
        p = torch.exp(s - base[..., None])
        if bf16:
            hi = p.bfloat16().float()
            acc = torch.einsum("bgrc,bcgd->bgrd", hi, v[:, t0:t1])
            if p_lo:
                lo = (p - hi).bfloat16().float()
                acc = acc + torch.einsum("bgrc,bcgd->bgrd", lo, v[:, t0:t1])
        else:
            acc = torch.einsum("bgrc,bcgd->bgrd", p, v[:, t0:t1])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(acc)
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


GROUPS = 16  # split groups of the merge (split_merge::kGroups)
LANES = 32   # lanes of the warp that sums a row's denominator


def merge_states(m, l, acc, dtype):
    """The merge (``csrc/split_merge.cuh``) over the last split axis of m,
    l [..., n] and acc [..., n, D], in the kernel's order: w_s = exp(m_s -
    max m) over the splits with l > 0, 0 for the others; a split whose
    w_s is 0 is passed over (the kernel never reads its acc); den = sum_s
    w_s l_s, lane by lane (lane i takes splits i, i + 32, ... in order)
    and then over the 32 lanes by an xor tree; the numerator group by
    group (group g takes splits g, g + 16, ... in order), then the 16
    groups' sums in group order.  A row with no live split gets zeros.
    The order depends on n alone (the kernel fuses each product into its
    sum, so the two differ by rounding)."""
    n = m.shape[-1]
    live = l > 0
    m_max = torch.where(live, m, torch.full_like(m, -np.inf)).amax(-1, True)
    w = torch.where(live, torch.exp(m - torch.where(
        live.any(-1, True), m_max, torch.zeros_like(m_max))),
        torch.zeros_like(m))
    wl = w * l
    lanes = [torch.zeros_like(m[..., 0]) for _ in range(LANES)]
    for s in range(n):
        lanes[s % LANES] = lanes[s % LANES] + wl[..., s]
    lanes = torch.stack(lanes, -1)
    idx = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    den = lanes[..., :1]
    wacc = torch.where(w[..., None] != 0, w[..., None] * acc,
                       torch.zeros_like(acc))               # w = 0: unread
    groups = [torch.zeros_like(acc[..., 0, :]) for _ in range(GROUPS)]
    for s in range(n):
        groups[s % GROUPS] = groups[s % GROUPS] + wacc[..., s, :]
    num = groups[0]
    for g in groups[1:]:
        num = num + g
    return (num / den.clamp(min=1e-30)).to(dtype)


def chunk_visible(page_table, pos, T, P):
    """[B,T,C] whether chunk token t of sequence b sees table position c of
    a paged table: c <= pos[b] + t and its entry is not -1."""
    C = page_table.shape[1] * P
    present = (page_table >= 0).repeat_interleave(P, 1)          # [B,C]
    qpos = pos.long()[:, None] + torch.arange(T)[None]           # [B,T]
    return (torch.arange(C)[None, None] <= qpos[..., None]) \
        & present[:, None]


def paged_chunk_emulation(q, k_pages, v_pages, page_table, pos, *, scale,
                          n_rep, p_lo=True):
    """The paged chunk kernel (B1, ``csrc/paged_chunk.cu``) and its merge
    in plain torch: q [B,T,H,D] over the pages by ``page_table``, fixed
    splits of ``SPLIT[dtype]`` table positions, row r = t * n_rep + rep of
    kv head g masked by its own position pos[b] + t -> [B,T,H,D]."""
    B, T, H, D = q.shape
    _n, P, Hkv, _ = k_pages.shape
    C = page_table.shape[1] * P
    idx = page_table.long().clamp(min=0)
    k = k_pages[idx].reshape(B, C, Hkv, D)
    v = v_pages[idx].reshape(B, C, Hkv, D)
    # rows r = t * n_rep + rep of kv head g, as the kernel's block holds them
    qg = q.reshape(B, T, Hkv, n_rep, D).transpose(1, 2).reshape(
        B, Hkv, T * n_rep, D)
    visible = chunk_visible(page_table, pos, T, P).repeat_interleave(
        n_rep, 1)[:, None]                                      # [B,1,R,C]
    m, l, acc = split_states(qg, k, v, visible, SPLIT[q.dtype], scale=scale,
                             p_lo=p_lo)
    out = merge_states(m, l, acc, q.dtype)                       # [B,G,R,D]
    return out.reshape(B, Hkv, T, n_rep, D).transpose(1, 2).reshape(
        B, T, H, D)
