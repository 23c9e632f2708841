"""Token sampling.

Greedy sampling is an exact argmax.  Temperature and top-k sampling draw
from a ``torch.Generator`` that the engine keeps per request, so a
request's draws do not depend on what it is batched with.  They cannot
reproduce the JAX package's ``jax.random`` draws; the two agree in
distribution only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = disabled
    max_new_tokens: int = 32
    eos_token: int = -1           # -1 = never stop early
    # Seeds this request's private generator (temperature > 0).  None
    # derives a seed from the request id; either way draws are independent
    # of batch composition.
    seed: Optional[int] = None


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """logits: [B, V] -> tokens [B] (int32).  ``generator`` must live on
    the logits' device; greedy sampling does not use it."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / params.temperature
    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, float("-inf")), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
