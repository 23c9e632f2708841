"""Synthetic token data pipeline (the port of the JAX package's
``training/data.py``, verbatim: it was pure numpy there too).

Deterministic, seeded, shardable: each (step, shard) pair maps to a unique
counter-based PRNG stream, so any data shard can be regenerated anywhere —
which is what makes the pipeline compatible with NALAR-style migration and
with multi-host training (every host draws only its shard).

The "corpus" is a mixture of Zipf-distributed unigrams and short repeated
motifs, which gives the language models a learnable signal (loss drops well
below log V) without any external dataset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.5


class Syntheticcorpus:
    """Counter-based synthetic corpus; host-side numpy for the input
    pipeline (the device never waits on Python)."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        # fixed motif bank (the learnable structure)
        self.motifs = root.integers(
            0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len))
        # Zipf-ish unigram distribution
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.unigram = p / p.sum()

    def _sample_doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length + self.cfg.motif_len, dtype=np.int32)
        i = 0
        while i < length:
            if rng.random() < self.cfg.motif_prob:
                m = self.motifs[rng.integers(self.cfg.n_motifs)]
                out[i:i + self.cfg.motif_len] = m
                i += self.cfg.motif_len
            else:
                out[i] = rng.choice(self.cfg.vocab_size, p=self.unigram)
                i += 1
        return out[:length]

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        """Batch for one (step, shard).  tokens[t+1] are labels[t]."""
        assert self.cfg.global_batch % n_shards == 0
        b = self.cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (self.cfg.seed, step, shard))   # counter-based stream
        toks = np.stack([self._sample_doc(rng, self.cfg.seq_len + 1)
                         for _ in range(b)])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int = 0, shard: int = 0,
                n_shards: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, shard, n_shards)
            step += 1


def extra_inputs(cfg, batch_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Stub modality-frontend inputs for vlm/audio families."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (batch_size, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch_size, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out
