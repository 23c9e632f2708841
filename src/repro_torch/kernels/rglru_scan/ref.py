"""Plain PyTorch version of the RG-LRU scan kernel.

The first-order linear recurrence ``h_t = a_t * h_{t-1} + b_t`` over
[B, S, W], walked step by step in float32: a product, rounded, then a sum,
rounded, as the CUDA kernel does, so the two agree bit for bit.  The JAX
package computes the same recurrence with an associative scan (the same
function, summed in another order).  One loop iteration per step, so it is
the oracle and the CPU path, not a fast path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b [B,S,W] (the per-step decay and input); h0 [B,W] or None (a
    zero state).  Returns (h [B,S,W] float32, the final state [B,W]
    float32; h0, or zeros, when S = 0)."""
    a, b = a.float(), b.float()
    B, S, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float().clone())
    y = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h
