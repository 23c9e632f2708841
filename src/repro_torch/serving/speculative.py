"""Draft engine for speculative decoding on the paged data plane.

The port of the JAX package's ``serving/speculative.py``.  A small-tier
model proposes ``k`` greedy tokens per scheduling round for each decoding
slot; the target engine verifies all ``k+1`` positions in one ragged
``decode_chunk_paged`` call (the paged chunk kernel on the card) and
accepts a prefix (see ``serving/sampler.speculative_verify``).  The draft
runs the port's own dense ``decode_chunk`` over its own ``init_cache``
slot cache, slot-aligned with the target's batch slots, so draft catch-up
and proposal steps batch across slots like the target's chunked data
plane.  The dense ``decode_chunk`` launches no attention kernel.

Proposals are deterministic (argmax), i.e. the proposal distribution is a
point mass: the accept rule reduces to "accept with probability p(d)" and
the residual resample stays unbiased, so no draft generator and no draft
logits ever cross to the verifier.  The argmax stays on the device; each
``propose`` iteration copies only the [B,T] greedy tokens to the host.
The draft may be any tokenizer-compatible config; ``truncated_draft``
below makes a layer-truncated view of the target's own parameters (the
LayerSkip-style self-speculation baseline, no extra weights).

Per-slot state is a token ``stream`` (everything the target consumed plus
the draft's own proposals) and a ``consumed`` watermark (how much of the
stream is in the draft cache).  Rollback after a rejected tail truncates
the stream and rewinds the slot's ``cache["pos"]``: attention masks by
position, so stale K/V past the watermark is unreachable.  That requires a
non-windowed attention draft (a ring loses clobbered slots on rewind, a
recurrent state cannot rewind at all), which the constructor enforces.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_CHUNK = 16     # max draft catch-up feed width per call


class DraftEngine:
    """Slot-aligned greedy proposer over a dense ``decode_chunk`` cache."""

    def __init__(self, model, params, *, max_batch: int, max_seq: int,
                 device: DeviceLike = None):
        if model.cfg.sliding_window:
            raise ValueError("draft model must be non-windowed "
                             "(rollback rewinds cache positions)")
        if model.decode_chunk is None:
            raise ValueError("draft model has no fused decode_chunk")
        if model.cfg.family in ("ssm", "hybrid"):
            raise ValueError("draft model must be an attention model "
                             "(rollback rewinds cache positions)")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.cache = model.init_cache(max_batch, max_seq, device=self.device)
        self._stream: List[List[int]] = [[] for _ in range(max_batch)]
        self._consumed = [0] * max_batch

    # ------------------------------------------------------------- protocol
    def observe(self, slot: int, tokens: List[int]) -> None:
        """Extend the slot's stream with tokens the target consumed."""
        self._stream[slot].extend(int(t) for t in tokens)

    def rollback(self, slot: int, n_stream: int) -> None:
        """Truncate the slot's stream to its first ``n_stream`` tokens (the
        part the verifier kept); rewind the cache watermark to match."""
        del self._stream[slot][n_stream:]
        if self._consumed[slot] > n_stream:
            self._consumed[slot] = n_stream
            self.cache["pos"][slot] = n_stream

    def reset(self, slot: int) -> None:
        self._stream[slot] = []
        self._consumed[slot] = 0
        self.cache["pos"][slot] = 0

    def propose(self, want: Dict[int, int]) -> Dict[int, List[int]]:
        """Propose ``want[slot]`` greedy tokens per slot, batched.

        Feeds each slot's unconsumed stream (catch-up), then extends it
        autoregressively; every iteration is one ragged ``decode_chunk``
        over all still-working slots.  The final proposal is appended to
        the stream but not fed: the verifier's outcome decides (through
        :meth:`rollback`) whether it survives."""
        props: Dict[int, List[int]] = {s: [] for s in want}
        for s, k in want.items():
            if self._consumed[s] >= len(self._stream[s]):
                # generation only happens off a fed position: the caller
                # must observe() the next consumed token before proposing
                raise ValueError(f"slot {s}: nothing pending to extend")
            if len(self._stream[s]) + k - 1 > self.max_seq:
                raise ValueError(f"slot {s}: stream would exceed draft "
                                 f"max_seq {self.max_seq}")
        dev = self.device
        while True:
            feeds = {}
            for s, k in want.items():
                if len(props[s]) >= k:
                    continue
                fs = self._stream[s][self._consumed[s]:]
                feeds[s] = fs[:_CHUNK]
            if not feeds:
                break
            width = max(len(f) for f in feeds.values())
            width = 1 << (width - 1).bit_length() if width > 1 else 1
            toks = np.zeros((self.max_batch, width), np.int64)
            valid = np.zeros((self.max_batch,), np.int32)
            for s, fs in feeds.items():
                toks[s, :len(fs)] = fs
                valid[s] = len(fs)
            logits, self.cache = self.model.decode_chunk(
                self.params, torch.from_numpy(toks).to(dev),
                torch.from_numpy(valid).to(dev), self.cache)
            greedy = torch.argmax(logits, dim=-1).cpu().numpy()
            for s, fs in feeds.items():
                self._consumed[s] += len(fs)
                if self._consumed[s] == len(self._stream[s]):
                    d = int(greedy[s, len(fs) - 1])
                    props[s].append(d)
                    self._stream[s].append(d)
        return props


def distill_draft(draft, dparams, target, tparams, data_fn, *,
                  steps: int = 250, lr: float = 3e-3, seed: int = 0):
    """Distill ``draft`` toward the target's greedy decisions: minimize
    cross-entropy between the draft's logits and ``argmax`` of the
    target's, over contexts drawn from ``data_fn(generator) -> [B, S]``
    integer tokens (a ``torch.Generator`` seeded with ``seed``, in place of
    the reference's JAX key; use the serving distribution: acceptance is
    an on-policy property).  This is the "distilled shadow" draft: unlike
    :func:`truncated_draft` alone it tracks what the target *does*, not
    just what its early layers compute.  AdamW at a constant ``lr``, no
    weight decay.  ``dparams`` is copied first (a truncated draft's layers
    are views of the target's), and the returned params hold no
    ``requires_grad``, so ``DraftEngine`` serves them through the
    kernels."""
    from ..training.optimizer import AdamW, constant_schedule
    from ..training.tree import tree_leaves, tree_map, tree_unflatten

    dev = tree_leaves(tparams)[0].device
    dparams = tree_map(lambda p: p.detach().clone(), dparams)
    opt = AdamW(learning_rate=constant_schedule(lr), weight_decay=0.0)
    state = opt.init(dparams)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        toks = torch.as_tensor(data_fn(gen)).long().to(dev)
        with torch.no_grad():
            labels = torch.argmax(_logits(target, tparams, toks), dim=-1)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(dparams)]
        with torch.enable_grad():
            lp = torch.log_softmax(
                _logits(draft, tree_unflatten(dparams, leaves), toks).float(),
                dim=-1)
            loss = -torch.mean(torch.gather(lp, -1, labels[..., None]))
            grads = torch.autograd.grad(loss, leaves)
        dparams, state = opt.update(list(grads), state, dparams)
    return dparams


def _logits(model, params, toks):
    return model.forward(params, {"tokens": toks})[0]


def truncated_draft(model, params, n_layers: int):
    """A layer-truncated self-draft: the target's own first ``n_layers``
    layers plus its embedding/unembedding and final norm, as an independent
    small-tier model (LayerSkip-style self-speculation: no training, same
    tokenizer by construction).  The draft's layer tensors are views of
    the target's, no weight is copied.  Returns ``(draft_model,
    draft_params)``."""
    from ..models.model import build_model

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[:n_layers]
                for k, v in tree.items()}

    draft = build_model(dataclasses.replace(model.cfg, n_layers=n_layers))
    dparams = dict(params)
    dparams["layers"] = take(params["layers"])
    return draft, dparams
