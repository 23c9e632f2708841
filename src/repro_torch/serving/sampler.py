"""Token sampling and speculative-decode rejection sampling.

Greedy sampling is an exact argmax.  Temperature and top-k sampling draw
from a ``torch.Generator`` that the engine keeps per request, so a
request's draws do not depend on what it is batched with.  They cannot
reproduce the JAX package's ``jax.random`` draws; the two agree in
distribution only.  The same holds for the verifier's draws: each draw of
a verification round comes from a generator seeded by the round's seed and
the draw's position alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
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


# ------------------------------------------------- speculative verification
def target_probs(logits: np.ndarray, params: SamplingParams) -> np.ndarray:
    """The distribution :func:`sample` draws from, as explicit probabilities.

    logits [..., V] -> float32 probabilities [..., V] after temperature
    scaling and top-k filtering.  ``temperature <= 0`` returns the argmax
    point mass (greedy is a distribution too, which keeps the accept rule
    uniform across both modes)."""
    logits = np.asarray(logits, dtype=np.float32)
    if params.temperature <= 0.0:
        out = np.zeros_like(logits)
        idx = np.argmax(logits, axis=-1)
        np.put_along_axis(out, idx[..., None], 1.0, axis=-1)
        return out
    logits = logits / params.temperature
    if params.top_k > 0:
        kth = np.sort(logits, axis=-1)[..., -params.top_k][..., None]
        logits = np.where(logits < kth, -np.inf, logits)
    logits = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(logits)
    return e / e.sum(axis=-1, keepdims=True)


def _draw_generator(seed: int, j: int) -> torch.Generator:
    """The host generator of draw ``j`` of a round seeded ``seed``: it
    depends on the two numbers alone, so a position's draw does not depend
    on batch composition nor on how many positions end up accepted."""
    mixed = np.random.SeedSequence([seed, j]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(mixed[0]))


def _choice(row: np.ndarray, seed: int, j: int) -> int:
    """One draw from the distribution ``row`` [V] with draw ``j``'s
    generator."""
    return int(torch.multinomial(torch.from_numpy(row), 1,
                                 generator=_draw_generator(seed, j))[0])


def greedy_accept(greedy: np.ndarray,
                  draft_tokens: List[int]) -> Tuple[List[int], int]:
    """Greedy verification of one draft chunk from its target argmax row
    ``greedy`` [k+1]: the longest prefix where the argmax equals the draft,
    then the argmax at the first divergence (or the bonus argmax after a
    full accept).  Returns ``(tokens, n_accepted)``."""
    k = len(draft_tokens)
    m = 0
    while m < k and int(greedy[m]) == int(draft_tokens[m]):
        m += 1
    return [int(t) for t in draft_tokens[:m]] + [int(greedy[m])], m


def speculative_verify(
        logits: np.ndarray, draft_tokens: List[int], params: SamplingParams,
        seed: Optional[int],
        draft_probs: Optional[np.ndarray] = None) -> Tuple[List[int], int]:
    """Rejection sampling over one verified draft chunk.

    ``logits`` [k+1, V] (on the host): target logits where row ``j`` is
    the next-token distribution after consuming the committed prefix
    plus ``draft_tokens[:j]``, which is what one ragged
    ``decode_chunk_paged`` call over ``[prev_token, d_1..d_k]`` returns.
    ``draft_probs`` [k, V] is the proposal distribution each draft token
    was sampled from; ``None`` declares a deterministic (argmax) draft,
    i.e. a point mass at ``draft_tokens[j]``.  The engine's draft is
    argmax-only and passes None; the argument keeps the reference
    verifier's signature and its general accept rule.

    Returns ``(tokens, n_accepted)``: the accepted draft prefix followed by
    exactly one correction or bonus token.  Greedy (``temperature <= 0``)
    is :func:`greedy_accept` over the rows' argmax and draws nothing
    (``seed`` may be None).  Stochastic uses the standard accept-with-p/q,
    resample-from-max(p-q, 0) rule (Leviathan et al.), which preserves the
    target distribution exactly for any proposal; the accept test of
    position ``j`` draws from generator ``(seed, j)``, its resample from
    ``(seed, 1000 + j)``."""
    if params.temperature <= 0.0:
        return greedy_accept(
            np.argmax(np.asarray(logits, dtype=np.float32), axis=-1),
            draft_tokens)

    k = len(draft_tokens)
    p = target_probs(logits, params)                      # [k+1, V]
    out: List[int] = []
    for j in range(k):
        d = int(draft_tokens[j])
        q_d = 1.0 if draft_probs is None else float(draft_probs[j, d])
        u = float(torch.rand((), generator=_draw_generator(seed, j)))
        if q_d > 0.0 and u < min(1.0, float(p[j, d]) / q_d):
            out.append(d)
            continue
        # rejected: resample from the normalized residual max(p - q, 0)
        if draft_probs is None:
            q_row = np.zeros_like(p[j])
            q_row[d] = 1.0
        else:
            q_row = np.asarray(draft_probs[j], dtype=np.float32)
        resid = np.maximum(p[j] - q_row, 0.0)
        total = float(resid.sum())
        row = resid / total if total > 0.0 else p[j]
        return out + [_choice(row, seed, 1000 + j)], j
    # every draft accepted: bonus token from the final target row
    return out + [_choice(p[k], seed, 1000 + k)], k
