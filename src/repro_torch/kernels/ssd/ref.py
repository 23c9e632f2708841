"""Plain PyTorch versions of the SSD chunk scan.

``ssd_chunked_ref`` is the JAX package's ``models/ssm.py::ssd_chunked``
(the chunked dual form the model runs), rounding where it rounds: with a
bf16 ``x`` the intra-chunk scores ``C.B^T`` come out in bf16, the decayed
score matrix ``M`` and ``dt`` are rounded to bf16 before the intra-chunk
product, which yields bf16; the chunk states and the inter-chunk term are
float32, and ``y`` is rounded once more at the end.  It materialises the
[B, nc, H, Q, Q] decay matrix, so it is the oracle and the CPU path, not a
fast path.

``ssd_sequential`` is the token-by-token recurrence (the port of the
reference's ``kernels/ssd/ref.py::ssd_sequential_ref``), the ground truth
both chunked forms must match, used by tests and ``chip_smoke.py`` only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """log_a [..., Q] -> [..., Q, Q]: out[i, j] = sum_{j < m <= i} log_a[m],
    -inf above the diagonal (j > i)."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=log_a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P]; dt [B,S,H] (softplus'd, > 0); A [H] (positive rates);
    Bm, Cm [B,S,N] (one group, shared by the heads); init_state [B,H,P,N]
    float32 or None.  Returns y [B,S,H,P] in x's type and the final state
    [B,H,P,N] float32.  A ragged tail is padded with identity steps (dt=0:
    decay 1, no input), which leave the state unchanged."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    wt = x.dtype

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    log_a = -dtc * A.float()[None, None, None, :]

    # within-chunk (attention-like) term, in the working type
    Lmat = torch.exp(_segsum(log_a.permute(0, 1, 3, 2)))     # [B,nc,H,Q,Q]
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)          # [B,nc,Q,Q]
    M = scores.float()[:, :, None] * Lmat                    # [B,nc,H,Q,Q]
    y_intra = torch.einsum("bchij,bcjh,bcjhp->bcihp", M.to(wt),
                           dtc.to(wt), xc)

    # per-chunk summary states, float32
    a_cum = torch.cumsum(log_a, dim=2)                       # [B,nc,Q,H]
    a_total = a_cum[:, :, -1:, :]
    decay_to_end = torch.exp(a_total - a_cum)
    state_c = torch.einsum("bcjh,bcjh,bcjhp,bcjn->bchpn", decay_to_end, dtc,
                           xc.float(), Bc.float())

    # recurrence across chunks
    a_tot = torch.exp(a_total[:, :, 0, :])                   # [B,nc,H]
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    states_in = []
    for c in range(nc):
        states_in.append(state)              # the state entering chunk c
        state = state * a_tot[:, c, :, None, None] + state_c[:, c]
    states_in = torch.stack(states_in, dim=1)                # [B,nc,H,P,N]

    # inter-chunk term: y_i += C_i . (decay(start -> i) * S_in)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc.float(), states_in,
                           torch.exp(a_cum))
    y = (y_intra.float() + y_inter).reshape(Bsz, S, H, P)
    return y[:, :S_orig].to(wt).contiguous(), state


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token by token, float32: h_t = exp(-dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = C_t h_t.  Returns y [B,S,H,P] in x's type and the final state
    [B,H,P,N] float32."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    xf, dtf, bf, cf = x.float(), dt.float(), Bm.float(), Cm.float()
    Af = A.float()
    ys = []
    for t in range(S):
        decay = torch.exp(-dtf[:, t] * Af[None, :])           # [B,H]
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], bf[:, t])
        h = h * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h
