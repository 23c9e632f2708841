"""The split block of the port's split-KV kernels (``csrc/
split_attention.cuh``) and their merge (``csrc/split_merge.cuh``) in plain
torch, for the CPU emulations of the ring kernel
(``test_torch_ring_split.py``) and the paged chunk kernel
(``test_torch_paged_split.py``).

The kernels' arithmetic, split by split: f32 scores of the inputs masked
to -inf where a row may not see a key, the K and V of keys no row of the
block sees zero-filled, a row's max replaced by 0 in its exponent when it
sees no key of the split (so its p are 0 and its l is 0), and in bf16 the
probabilities fed to P.V as bf16 hi + lo (or as hi alone with
``p_lo=False``).  Then the merge: splits with l = 0 pass over, the rest
weigh exp(m_s - max m) in split order.
"""

import numpy as np
import torch


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
    qf = qg.float()
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


def merge_states(m, l, acc, dtype):
    """The merge (``merge_splits_kernel``) over the last split axis of m,
    l [..., n] and acc [..., n, D]: splits with l = 0 pass over, the rest
    weigh exp(m_s - max m); a row with none gets zeros."""
    live = l > 0
    m_max = torch.where(live, m, torch.full_like(m, -np.inf)).amax(-1, True)
    w = torch.where(live, torch.exp(m - torch.where(
        live.any(-1, True), m_max, torch.zeros_like(m_max))),
        torch.zeros_like(m))
    num = (w[..., None] * acc).sum(-2)
    den = (w * l).sum(-1, True)
    return (num / den.clamp(min=1e-30)).to(dtype)
