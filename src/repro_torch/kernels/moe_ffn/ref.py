"""Plain PyTorch version of the grouped expert-FFN kernel.

The model's expert FFN, as the JAX package's oracle computes it: the three
products as float32 einsums, silu in float32, ``h`` kept in float32, and one
rounding to ``xe``'s type at the end.  It materialises the [E,C,F]
activations, so it is the oracle and the CPU path, not a fast path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_ffn_ref(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """xe [E,C,D]; w_gate/w_up [E,D,F]; w_down [E,F,D] -> [E,C,D]."""
    xf = xe.float()
    h = F.silu(torch.einsum("ecd,edf->ecf", xf, w_gate.float()))
    h = h * torch.einsum("ecd,edf->ecf", xf, w_up.float())
    return torch.einsum("ecf,efd->ecd", h, w_down.float()).to(xe.dtype)
