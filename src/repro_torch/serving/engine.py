"""PyTorch inference engine: slot-based continuous batching.

The port of the JAX package's ``serving/engine.py`` for the dense, MoE,
ssm and hybrid families, on its three data planes:

  * the paged-native plane (the default): ``max_batch`` slots decode
    straight into the session pages of one ``PagedKVPool``; each step feeds
    per-slot page tables to the model, which writes the new K/V into the
    pages and attends over them with the paged chunk kernel, so admission,
    resume and finish move no cache bytes;
  * the dense plane (``paged_decode=False``, and windowed configs whose
    ring wraps, ``max_seq > sliding_window``): the slots share a dense
    per-slot cache (``model.init_cache``) stepped by ``model.decode_chunk``;
    a resumed session is gathered from the pool into its slot row
    (``gather_contiguous``) and a finished one written back
    (``write_session``);
  * the state-cache plane (the ssm and hybrid families, whose decode state
    is O(1) per recurrent layer): the slots share the model's conv and
    recurrent state rows (and the hybrid's sliding-window K/V rings),
    stepped by
    ``model.decode_chunk`` (or, for a model without one, per-token masked
    ``decode_step``s); a finished session's row is stored in a
    ``StateCachePool``, and a resumed session is prefilled cold, as on the
    reference;
  * admission pulls from a bounded, heap-ordered priority wait queue; a new
    request resumes its session's pages (prefix reuse), adopts another
    session's indexed prefix pages (cross-session prefix sharing), or
    starts a chunked prefill: its prompt is consumed ``prefill_chunk``
    tokens per step, piggybacked on the batched decode.  With
    ``prefill_chunk=0`` it runs the monolithic bucket prefill instead,
    through the flash attention kernel;
  * ``warm_session`` replays a transcript into the pool (the replay side of
    migration) without occupying a slot.

The device is ``torch.device("cuda")`` unless the caller names another;
each step copies only the [B] greedy tokens to the host (the [B,V]
next-token rows stay on the device unless a stochastic request samples
from them).  Not ported yet (ROADMAP.md): speculative decoding
(``draft_model``), the vlm and audio families, request
``extras``, and the runtime-facing plumbing of the bridge (KV registry
hooks, completion callbacks, token streaming).
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models.layers import mask_cache_rows
from ..models.model import Model
from .batching import (EngineOverloaded, Request, RequestExpired, WaitQueue,
                       bucket_len)
from .kv_cache import PagedKVPool, StateCachePool
from .sampler import SamplingParams, sample


@dataclass
class EngineMetrics:
    queued: int = 0
    active: int = 0
    completed: int = 0
    decode_steps: int = 0
    prefills: int = 0
    prefix_hits: int = 0
    # cross-session sharing: cold sessions admitted onto another session's
    # indexed prefix pages (suffix-only prefill)
    shared_prefix_hits: int = 0
    shared_prefix_tokens: int = 0
    tokens_generated: int = 0
    prefill_tokens: int = 0
    admission_rejects: int = 0
    # resumes refused because the restored cache would not fit the slot
    resume_overflows: int = 0
    # admissions/steps aborted because the pool could not provide pages
    # (all residents protected or pinned)
    paged_append_failures: int = 0
    # requests dropped because their deadline passed: rejected at admission
    # (push/pop) or preempted mid-decode with slot + KV pages reclaimed
    expired: int = 0

    @property
    def decode_tokens_per_step(self) -> float:
        return (self.tokens_generated / self.decode_steps
                if self.decode_steps else 0.0)


# the families the port serves; the reference's _CHUNKABLE_FAMILIES also
# has vlm.  Nothing else in the engine is MoE-specific: the MoE layers live
# inside the model's entry points.
_SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid")
# the families whose sessions live in a StateCachePool, as on the reference
_STATE_FAMILIES = ("ssm", "hybrid")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def _cache_slot_axis(key: str) -> int:
    return 0 if key == "pos" else 1


def set_slot(cache: dict, slot: int, row: dict) -> dict:
    """Insert a single sequence's cache (batch dim 1) into batch ``slot``,
    in place (the reference returns a new cache).

    Row caches produced by bucketed prefill can be shorter in the seq dim
    than the slot cache; they are zero-padded at the end (consistent with
    the ring layout: prefill caches are unrolled when S <= window).
    """
    for k, v in cache.items():
        ax = _cache_slot_axis(k)
        r = row[k]
        r = r.squeeze(ax) if r.dim() == v.dim() else r
        target = tuple(s for i, s in enumerate(v.shape) if i != ax)
        if tuple(r.shape) != target:
            grow = [t - s for s, t in zip(r.shape, target)]
            if len(grow) != len(target) or min(grow) < 0:
                raise ValueError(f"row cache leaf {k}: {tuple(r.shape)} "
                                 f"exceeds slot shape {target}")
            r = F.pad(r, [p for g in reversed(grow) for p in (0, g)])
        idx = [slice(None)] * v.dim()
        idx[ax] = slot
        v[tuple(idx)] = r.to(device=v.device, dtype=v.dtype)
    return cache


def get_slot(cache: dict, slot: int) -> dict:
    """Batch ``slot`` of the cache as a batch-1 row (views, no copy)."""
    out = {}
    for k, v in cache.items():
        ax = _cache_slot_axis(k)
        out[k] = v.select(ax, slot).unsqueeze(ax)
    return out


class InferenceEngine:
    def __init__(self, model: Model, params: dict, *, max_batch: int = 8,
                 max_seq: int = 512, pool_pages: int = 0, page_size: int = 64,
                 rng_seed: int = 0, prefill_chunk: int = 8,
                 max_queue: int = 0, paged_decode: bool = True,
                 draft_model: Optional[Model] = None,
                 device: DeviceLike = None) -> None:
        if draft_model is not None:
            raise _not_ported("speculative decoding (draft_model)", "A9")
        self.model = model
        self.cfg: ModelConfig = model.cfg
        if self.cfg.family not in _SERVED_FAMILIES:
            raise _not_ported(f"serving the {self.cfg.family!r} family",
                              "A12")
        self.device = resolve_device(device)
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.metrics = EngineMetrics()
        # prompt tokens consumed per slot per step while prefilling;
        # 0 = monolithic bucket prefill at admission
        self.prefill_chunk = int(prefill_chunk)
        self.max_queue = int(max_queue)
        self.queue = WaitQueue(maxsize=self.max_queue)
        self._rng_seed = int(rng_seed)       # base of request streams
        self._lock = threading.RLock()

        # per-slot state: the slim cache is each slot's next position, kept
        # on the host (the K/V lives in the pool pages)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self._pos = np.zeros(max_batch, np.int32)
        self._active_mask = np.zeros(max_batch, bool)
        # slot -> prompt tokens not yet consumed (resumed suffixes and
        # chunked prefills); always cleared when the slot is vacated
        self._pending_prompt: Dict[int, List[int]] = {}
        # request_id -> private generator (stochastic sampling only)
        self._req_gen: Dict[str, torch.Generator] = {}

        # session cache pool: paged K/V for the attention families, state
        # rows for ssm and hybrid
        self.pool: Any
        self._state_pool = self.cfg.family in _STATE_FAMILIES
        if self._state_pool:
            self.pool = StateCachePool(self.cfg)
        else:
            n_pages = pool_pages or (max_batch * (max_seq // page_size + 1)
                                     * 2)
            self.pool = PagedKVPool(self.cfg, n_pages=n_pages,
                                    page_size=page_size, device=self.device)
        W = self.cfg.sliding_window
        # cross-session prefix sharing: admission and warm_session consult
        # the pool's prefix index.  Valid only for a paged pool where a
        # cache position maps 1:1 to a token prefix position: no
        # sliding-window ring wrap.
        self._prefix_share_ok = (not self._state_pool
                                 and (not W or self.max_seq <= W))
        # paged-native decode: the KV pool IS the decode cache.  Windowed
        # configs qualify only when the ring never wraps (slot == position,
        # so the linear page layout matches the ring layout); the others,
        # and paged_decode=False, run the dense plane.
        self.paged_decode = bool(paged_decode)
        self._paged = self.paged_decode and self._prefix_share_ok
        # dense per-slot cache length
        self._slot_C = min(self.max_seq, W) if W else self.max_seq
        # dense plane: the per-slot k/v [L,B,C,Hkv,Dh]; state-cache plane:
        # conv [L,B,K-1,C] and ssm [L,B,H,P,N], or the hybrid's conv, h
        # [L_rec,B,W] and k/v rings [L_att,B,C,Hkv,Dh] (the slots' positions
        # live on the host in _pos on every plane)
        self.cache: Dict[str, torch.Tensor] = {}
        self._blank_row_cache: Optional[Dict[str, torch.Tensor]] = None
        if self._paged:
            self._max_pages = self.pool.pages_needed(self.max_seq)
        else:
            full = model.init_cache(max_batch, max_seq, device=self.device)
            self.cache = {k: v for k, v in full.items() if k != "pos"}
        # slot -> pool session key the slot decodes into (paged plane only;
        # anonymous requests get a synthetic key released at vacate)
        self._slot_sid: Dict[int, str] = {}
        # slot -> token ids whose K/V occupy the slot's cache positions so
        # far (None = unknown provenance, the session stays opaque).  They
        # key the pool's prefix index.
        self._slot_tokens: Dict[int, Optional[List[int]]] = {}

    # ----------------------------------------------------------- submission
    def submit(self, req: Request) -> str:
        """Queue ``req``.  Raises :class:`EngineOverloaded` when the bounded
        wait queue is at capacity (backpressure — callers retry or shed) and
        :class:`RequestExpired` when the request's deadline already passed."""
        if req.extras:
            raise _not_ported("requests with extras (non-text inputs)",
                              "A12")
        if req.submitted_wall < 0:
            req.submitted_wall = time.monotonic()
        try:
            self.queue.push(req)
        except EngineOverloaded:
            self.metrics.admission_rejects += 1
            raise
        except RequestExpired:
            self.metrics.expired += 1
            raise
        return req.request_id

    def generate(self, prompt, session_id: str = "",
                 sampling: Optional[SamplingParams] = None) -> Request:
        """Synchronous helper: submit + run until this request finishes."""
        req = Request.make(prompt, session_id=session_id, sampling=sampling,
                           now=time.monotonic())
        self.submit(req)
        while not req.finished:
            self.step()
        return req

    # ------------------------------------------------------------ admission
    def saturation(self) -> float:
        """Wait-queue depth as a fraction of capacity (0.0 if unbounded)."""
        return self.queue.saturation()

    def _prefill(self, req: Request, align: str = "left"):
        """Monolithic bucketed prefill (``prefill_chunk=0`` + warm replay).

        ``align="right"`` places the prompt at the start of the bucket:
        under causal attention the trailing pads never contaminate the
        first ``len(prompt)`` cache positions, so callers that only need
        the cache (``warm_session``) get an exact-token prefix.  The
        left-aligned default keeps the final position's logits real, at
        the cost of pad positions entering the cache.
        """
        S = len(req.prompt)
        bucket = min(bucket_len(S), self.max_seq)
        toks = np.zeros((1, bucket), np.int64)
        if align == "right":
            toks[0, :S] = req.prompt
        else:
            toks[0, -S:] = req.prompt      # left-pad so last position is real
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, row_cache = self.model.prefill(self.params, batch)
        self.metrics.prefills += 1
        self.metrics.prefill_tokens += S
        return logits, row_cache

    def _try_resume(self, req: Request
                    ) -> Optional[Tuple[Optional[dict], int]]:
        """Prefix reuse: ``(row, tokens)`` for this session's cache resident
        in the pool, or None when the caller must build the context cold
        (``resume_overflows`` counts an explicit refusal).  On the paged
        plane a resume moves no bytes, the slot adopts the session's pages
        and ``row`` is None; on the dense plane ``row`` is the session's
        cache gathered into a batch-1 slot row.  A ``StateCachePool``
        session is never resumed: the reference loads its state row and
        then prefills cold all the same (its state plus the prompt fed
        incrementally would be the same prefill), so the port skips the
        load."""
        if self._state_pool:
            return None
        if self._paged:
            sp = self.pool.session(req.session_id)
            if sp is None or not sp.pages or sp.tokens <= 0:
                return None
            if sp.tokens > self.max_seq:
                self.metrics.resume_overflows += 1
                return None
            return None, sp.tokens
        got = self.pool.gather_contiguous(req.session_id, self.max_seq)
        if got is None:
            return None
        k, v, tokens = got
        pad = self._slot_C - k.shape[1]
        if pad < 0:
            self.metrics.resume_overflows += 1
            return None
        row = {"k": F.pad(k, (0, 0, 0, 0, 0, pad))[:, None],
               "v": F.pad(v, (0, 0, 0, 0, 0, pad))[:, None]}
        return row, tokens

    def _blank_row(self) -> Dict[str, torch.Tensor]:
        """Zeroed single-slot cache row for chunked-prefill admission on
        the dense and state-cache planes (recurrent state accumulates
        unconditionally), so a recycled slot never starts from its previous
        occupant's row."""
        if self._blank_row_cache is None:
            self._blank_row_cache = {
                k: torch.zeros_like(v[:, 0]) for k, v in self.cache.items()}
        return self._blank_row_cache

    def _resumed_slot_tokens(self, req: Request,
                             tokens: int) -> Optional[List[int]]:
        """Token provenance of a resumed slot: the pool session's ids, when
        they exactly describe the restored cache positions."""
        if not self._prefix_share_ok:
            return None
        sp = self.pool.session(req.session_id)
        if (sp is not None and sp.tokens == tokens
                and len(sp.token_ids) == sp.tokens):
            return list(sp.token_ids)
        return None

    def _request_generator(self, req: Request) -> torch.Generator:
        """The request's private generator, seeded from the engine seed and
        ``SamplingParams.seed``, else ``crc32(request_id)``."""
        sp = req.sampling
        salt = (sp.seed if sp.seed is not None
                else zlib.crc32(req.request_id.encode()))
        seed = (self._rng_seed << 31) ^ (int(salt) & 0x7FFFFFFF)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _sample_slot(self, req: Request, rows: torch.Tensor, row: int,
                     greedy: np.ndarray) -> int:
        """Sample one token for ``row`` with the request's *own* params,
        exactly once.  Greedy requests take the batch argmax and draw
        nothing; stochastic requests draw from their private generator, so
        batch composition never perturbs a request's samples."""
        sp = req.sampling
        if sp.temperature <= 0.0:
            return int(greedy[row])
        gen = self._req_gen.get(req.request_id)
        if gen is None:
            gen = self._req_gen[req.request_id] = self._request_generator(req)
        return int(sample(rows[row:row + 1], sp, gen)[0])

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self._active_mask[slot]:
                continue
            req = self.queue.pop_next()
            if req is None:
                return
            now = time.monotonic()
            while 0 <= req.deadline_wall <= now:
                # expired while waiting: never occupy a slot
                req.expired = True
                req.finished = True
                req.finished_at = now
                self.metrics.expired += 1
                req = self.queue.pop_next()
                if req is None:
                    return
            if (self._paged and req.session_id
                    and req.session_id in self._slot_sid.values()):
                # the session's pages are already the live in-place write
                # target of an active slot; a second concurrent appender
                # would corrupt them.  Defer until that slot finishes.
                self.queue.push(req)
                return
            W = self.cfg.sliding_window
            if self._paged:
                req.decode_path = "paged"
            elif self.model.decode_chunk is None:
                req.decode_path = "masked"
            elif W and self.max_seq > W:
                # windowed config whose ring wraps (max_seq > window): the
                # paged plane cannot serve it (linear page layout != ring
                # layout), so it stays on the dense ring plane
                req.decode_path = "dense-ring"
            else:
                req.decode_path = "fused"
            resumed = self._try_resume(req) if req.session_id else None
            if resumed is not None and resumed[1] + len(req.prompt) \
                    > self.max_seq - 1:
                # the resumed suffix would run past the slot's capacity
                # mid-prompt; rebuild the (bounded) full context cold
                self.metrics.resume_overflows += 1
                resumed = None
            if resumed is None and req.fallback_prompt is not None:
                # the caller sent only a continuation suffix expecting a
                # warm session cache, but the cache is cold: rebuild the
                # full context instead
                req.prompt = req.fallback_prompt
            if len(req.prompt) > self.max_seq - 1:
                req.prompt = req.prompt[-(self.max_seq - 1):]
            if (resumed is None and req.session_id and self._prefix_share_ok
                    and len(req.prompt) > 1):
                # cold session: another session may have indexed this
                # prompt's prefix.  Adopt the shared pages and feed only
                # the novel suffix (keep >= 1 token so the final position's
                # logits are computed by a real forward).
                ids = [int(t) for t in req.prompt]
                matched = self.pool.acquire_prefix(req.session_id, ids[:-1],
                                                   now=now)
                if matched > 0:
                    resumed = self._try_resume(req)
                    if resumed is None:    # defensive: capacity race
                        self.pool.release(req.session_id)
                    else:
                        self.metrics.shared_prefix_hits += 1
                        self.metrics.shared_prefix_tokens += matched
                        req.prompt = req.prompt[matched:]
            if resumed is not None:
                row, tokens = resumed
                req.prefix_reused_tokens = tokens
                self.metrics.prefix_hits += 1
                if self._paged:
                    # zero-copy resume: the slot decodes straight into the
                    # session's resident pages (shared prefix tails are
                    # privatized lazily by begin_append's copy-on-write)
                    self.pool.protect(req.session_id)
                    self._slot_sid[slot] = req.session_id
                else:
                    set_slot(self.cache, slot, row)
                # the prompt is fed as a suffix through the step loop
                self._pos[slot] = tokens
                self._pending_prompt[slot] = [int(t) for t in req.prompt]
                self._slot_tokens[slot] = self._resumed_slot_tokens(
                    req, tokens)
            elif self.prefill_chunk > 0:
                # chunked prefill: blank row now, prompt consumed by step()
                # in prefill_chunk-sized pieces piggybacked on decode
                if self._paged:
                    sid = req.session_id or f"__anon:{req.request_id}"
                    if req.session_id:
                        # stale pages from a refused resume would misplace
                        # the first in-place append: start cold
                        self.pool.release(sid)
                    self.pool.protect(sid)
                    self._slot_sid[slot] = sid
                else:
                    set_slot(self.cache, slot, self._blank_row())
                self._pos[slot] = 0
                self._pending_prompt[slot] = [int(t) for t in req.prompt]
                self._slot_tokens[slot] = [] if self._prefix_share_ok \
                    else None
                self.metrics.prefills += 1
                self.metrics.prefill_tokens += len(req.prompt)
            elif not self._admit_prefilled(slot, req, now):
                continue
            self.slots[slot] = req
            self._active_mask[slot] = True

    def _admit_prefilled(self, slot: int, req: Request, now: float) -> bool:
        """Monolithic admission: bucket prefill, write the row's K/V into
        the session's pages (paged plane) or the slot's cache row (dense
        plane), sample the first token.  Returns False when the request
        already finished (pool exhausted, or its first token met a stop
        condition)."""
        logits, row_cache = self._prefill(req)
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        tok = self._sample_slot(req, logits, 0, greedy)
        req.generated.append(tok)
        # TTFT: the first token exists *now*, after the prefill compute
        req.first_token_at = time.monotonic()
        S = len(req.prompt)
        bucket = min(bucket_len(S), self.max_seq)
        # left-aligned bucket prefill: pad token 0's K/V enters the leading
        # positions and is part of the provenance
        ids = ([0] * (bucket - S) + [int(t) for t in req.prompt]
               if self._prefix_share_ok else None)
        self.metrics.tokens_generated += 1
        if self._paged:
            sid = req.session_id or f"__anon:{req.request_id}"
            if req.session_id:
                self.pool.release(sid)
            if not self.pool.write_session(sid, row_cache["k"][:, 0],
                                           row_cache["v"][:, 0], bucket, now,
                                           token_ids=ids):
                # pool exhausted (residents all protected/pinned): deliver
                # what we have instead of wedging the slot
                self.metrics.paged_append_failures += 1
                self.metrics.completed += 1
                req.finished = True
                req.finished_at = time.monotonic()
                return False
            self.pool.protect(sid)
            self._slot_sid[slot] = sid
        else:
            set_slot(self.cache, slot, row_cache)
        self._pos[slot] = bucket
        self._slot_tokens[slot] = ids
        if (len(req.generated) >= req.sampling.max_new_tokens
                or tok == req.sampling.eos_token):
            # stop conditions apply to the admission-sampled token too
            self.slots[slot] = req
            self._active_mask[slot] = True
            self._finish_slot(slot, time.monotonic())
            return False
        return True

    # ------------------------------------------------------------ migration
    def warm_session(self, session_id: str, prompt_tokens: List[int]) -> int:
        """Prefill ``prompt_tokens`` straight into the session cache pool.

        The migration-in half of transcript replay: the next call in the
        session becomes a warm continuation; no batch slot is occupied and
        nothing is generated.  Returns the number of tokens now cached for
        the session (0 if nothing to do).  The prefill cost shows up in
        ``metrics.prefill_tokens``."""
        if not session_id or not prompt_tokens:
            return 0
        vocab = self.cfg.vocab_size
        toks = [int(t) % vocab for t in prompt_tokens]
        toks = toks[-(self.max_seq - 1):]       # respect the context budget
        req = Request.make(toks, session_id=session_id)
        now = time.monotonic()
        W = self.cfg.sliding_window
        bucket = min(bucket_len(len(toks)), self.max_seq)
        with self._lock:
            if self._state_pool:
                # the left-padded bucket's state row: its last position is
                # the transcript's last token
                _logits, row_cache = self._prefill(req)
                self.pool.store(session_id, row_cache, bucket)
                return bucket
            if self._prefix_share_ok:
                # resident-prefix fast path: pages covering a prefix of the
                # transcript (this session's own, or another session's via
                # the index) make the replay partial or entirely redundant
                warmed = self._warm_from_resident(session_id, toks, now)
                if warmed:
                    return warmed
            if not W or bucket <= W:
                # right-aligned prefill: under causal attention the trailing
                # pads never touch the first len(toks) positions, so the
                # stored prefix is exact
                _logits, row_cache = self._prefill(req, align="right")
                tokens = len(toks)
                ids = toks if self._prefix_share_ok else None
            else:
                # the bucket wraps the ring: store the left-padded bucket's
                # ring, opaque
                _logits, row_cache = self._prefill(req)
                tokens = bucket
                ids = None
            if not self.pool.write_session(
                    session_id, row_cache["k"][:, 0, :tokens],
                    row_cache["v"][:, 0, :tokens], tokens, now,
                    token_ids=ids):
                return 0
        return tokens

    def _warm_from_resident(self, session_id: str, toks: List[int],
                            now: float) -> int:
        """Warm a session from pages already resident in the pool.

        Full coverage costs zero prefill steps; partial coverage prefills
        only the missing suffix (``_extend_session``).  Returns tokens
        cached, or 0 to make the caller fall back to the full replay."""
        pool = self.pool
        sp = pool.session(session_id)
        if sp is not None and sp.pages:
            if len(sp.token_ids) != sp.tokens:
                return 0    # opaque contents: cannot trust the prefix
            n = min(sp.tokens, len(toks))
            if sp.token_ids[:n] != toks[:n]:
                return 0    # diverged: full replay reconciles via COW
            if sp.tokens >= len(toks):
                return sp.tokens
            resident = sp.tokens
        else:
            resident = pool.acquire_prefix(session_id, toks, now=now)
            if resident >= len(toks):
                return resident
        if resident <= 0:
            return 0
        return self._extend_session(session_id, toks, resident, now)

    def _extend_session(self, session_id: str, toks: List[int],
                        resident: int, now: float) -> int:
        """Suffix-only warm: gather the session's resident cache into a
        batch-1 dense row, feed ``toks[resident:]`` through batch-1
        ``decode_chunk`` steps and store the extended row with one
        ``write_session``, which dedups full pages against the prefix index
        and is all-or-nothing: a failure leaves the session as it was."""
        suffix = toks[resident:]
        C = self._slot_C
        if resident + len(suffix) > min(C, self.max_seq):
            return 0
        got = self.pool.gather_contiguous(session_id, self.max_seq)
        if got is None:
            return 0
        k, v, cached = got
        if cached != resident:
            return 0
        pad = C - k.shape[1]
        if pad < 0:
            return 0
        dev = self.device
        row = {"k": F.pad(k, (0, 0, 0, 0, 0, pad))[:, None],
               "v": F.pad(v, (0, 0, 0, 0, 0, pad))[:, None],
               "pos": torch.tensor([resident], dtype=torch.int32,
                                   device=dev)}
        T = max(1, self.prefill_chunk or 8)
        for i in range(0, len(suffix), T):
            n = min(T, len(suffix) - i)
            tk = np.zeros((1, T), np.int64)
            tk[0, :n] = suffix[i:i + n]
            _logits, row = self.model.decode_chunk(
                self.params, torch.from_numpy(tk).to(dev),
                torch.tensor([n], dtype=torch.int32, device=dev), row)
        tokens = resident + len(suffix)
        if not self.pool.write_session(session_id, row["k"][:, 0, :tokens],
                                       row["v"][:, 0, :tokens], tokens, now,
                                       token_ids=toks):
            return 0
        self.metrics.prefills += 1
        self.metrics.prefill_tokens += len(suffix)
        return tokens

    # ----------------------------------------------------------------- step
    def step(self) -> int:
        """Admit + one piggybacked batched step.

        Every decoding slot advances one token; prefilling slots consume up
        to ``prefill_chunk`` prompt tokens in the same chunk forward.
        Returns #active sequences.
        """
        with self._lock:
            self._admit()
            now = time.monotonic()
            expired = [i for i in range(self.max_batch)
                       if self._active_mask[i] and self.slots[i] is not None
                       and 0 <= self.slots[i].deadline_wall <= now]
            for i in expired:
                # mid-decode preemption: the deadline passed, so further
                # tokens are worthless; the slot is free for the next
                # admission this very step
                self.slots[i].expired = True
                self._finish_slot(i, now)
            if expired:
                self._admit()
            active = [i for i in range(self.max_batch) if self._active_mask[i]]
            if not active:
                self.metrics.queued = len(self.queue)
                self.metrics.active = 0
                return 0
            prefilling = any(self._pending_prompt.get(i) for i in active)
            budget = max(1, self.prefill_chunk) if prefilling else 1
            if self._paged:
                sampled = self._step_paged(active, budget)
            elif self.model.decode_chunk is not None:
                sampled = self._step_fused(active, budget)
            else:
                sampled = self._step_masked(active, budget)
            now = time.monotonic()
            for i in active:
                req = self.slots[i]
                if req is None:
                    continue
                done = False
                if i in sampled:
                    tok = req.generated[-1]
                    done = (len(req.generated) >= req.sampling.max_new_tokens
                            or tok == req.sampling.eos_token)
                if self._pos[i] >= self.max_seq - 1:
                    done = True
                if done:
                    self._finish_slot(i, now)
            self.metrics.queued = len(self.queue)
            self.metrics.active = int(self._active_mask.sum())
            return len(active)

    def _paged_forward(self, toks: np.ndarray, valid: np.ndarray,
                       pos: np.ndarray, pt: np.ndarray):
        """One paged chunk forward on the device.  Returns the [B,V]
        next-token rows (each sequence's last valid row) and their greedy
        argmax, both left on the device."""
        dev = self.device
        valid_t = torch.from_numpy(valid).to(dev)
        logits, _cache, _kp, _vp = self.model.decode_chunk_paged(
            self.params, torch.from_numpy(toks).to(dev), valid_t,
            {"pos": torch.from_numpy(pos).to(dev)}, self.pool.k, self.pool.v,
            torch.from_numpy(pt).to(dev), max_seq=self.max_seq)
        last = torch.clamp(valid_t.long() - 1, min=0)
        rows = logits[torch.arange(logits.shape[0], device=dev), last]
        return rows, torch.argmax(rows, dim=-1)

    def _plan_chunk(self, active: List[int], budget: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The chunk every plane's step feeds: prefilling slots consume up
        to ``budget`` prompt tokens, decoding slots advance one, idle slots
        none.  The chunk width is sized to the actual need and rounded up
        to a power of two (so a short prompt never pays a full-width chunk
        step).  Returns (tokens [B,T], valid lengths [B])."""
        pending = self._pending_prompt
        need = 1
        for i in active:
            q = pending.get(i)
            if q:
                need = max(need, min(len(q), budget))
        T = min(1 << (need - 1).bit_length(), budget)
        toks = np.zeros((self.max_batch, T), np.int64)
        valid = np.zeros((self.max_batch,), np.int32)
        for i in active:
            q = pending.get(i)
            if q:
                n = min(len(q), T)
                toks[i, :n] = q[:n]
                del q[:n]
                valid[i] = n
                if not q:
                    pending.pop(i, None)
            else:
                req = self.slots[i]
                toks[i, 0] = req.generated[-1] if req.generated else 0
                valid[i] = 1
        return toks, valid

    def _sample_ready(self, active: List[int], valid: np.ndarray,
                      rows: torch.Tensor, greedy: torch.Tensor) -> set:
        """Sample the next token of every slot that finished its prompt
        this step; returns those slots."""
        ready = [i for i in active
                 if valid[i] and i not in self._pending_prompt]
        if not ready:
            return set()
        greedy_np = greedy.cpu().numpy()
        sampled: set = set()
        for i in ready:
            req = self.slots[i]
            tok = self._sample_slot(req, rows, i, greedy_np)
            req.generated.append(tok)
            if req.first_token_at < 0:
                req.first_token_at = time.monotonic()
            self.metrics.tokens_generated += 1
            sampled.add(i)
        return sampled

    def _step_paged(self, active: List[int], budget: int) -> set:
        """One paged-native fused step.

        ``begin_append`` reserves (and copy-on-write privatizes) each
        advancing session's pages, the model writes the new K/V into them
        by page table, and ``commit_append`` publishes the new tokens
        (re-keying the prefix index).  A slot whose reservation fails is
        aborted explicitly — counted, finished with what it has."""
        toks, valid = self._plan_chunk(active, budget)
        now = time.monotonic()
        aborted: List[int] = []
        for i in active:
            if not valid[i]:
                continue
            if not self.pool.begin_append(self._slot_sid[i], int(valid[i]),
                                          now):
                self.metrics.paged_append_failures += 1
                valid[i] = 0
                aborted.append(i)
        for i in active:
            ids = self._slot_tokens.get(i)
            if ids is not None and valid[i]:
                ids.extend(int(t) for t in toks[i, :valid[i]])
        pt = np.full((self.max_batch, self._max_pages), -1, np.int32)
        for i in active:
            if valid[i]:
                pt[i] = self.pool.page_table(self._slot_sid[i],
                                             self._max_pages)
        rows, greedy = self._paged_forward(toks, valid, self._pos, pt)
        self._pos += valid
        self.metrics.decode_steps += 1
        for i in active:
            if valid[i]:
                n = int(valid[i])
                ids = (toks[i, :n].tolist()
                       if self._slot_tokens.get(i) is not None else None)
                self.pool.commit_append(self._slot_sid[i], n, token_ids=ids,
                                        now=now)
        for i in aborted:
            self._finish_slot(i, now)
        return self._sample_ready(active, valid, rows, greedy)

    def _step_fused(self, active: List[int], budget: int) -> set:
        """One fused chunk forward over the slot cache
        (``model.decode_chunk``), the dense and state-cache planes' step."""
        toks, valid = self._plan_chunk(active, budget)
        if self._prefix_share_ok:
            for i in active:
                ids = self._slot_tokens.get(i)
                if ids is not None and valid[i]:
                    ids.extend(int(t) for t in toks[i, :valid[i]])
        dev = self.device
        valid_t = torch.from_numpy(valid).to(dev)
        cache = dict(self.cache, pos=torch.from_numpy(self._pos).to(dev))
        logits, new = self.model.decode_chunk(
            self.params, torch.from_numpy(toks).to(dev), valid_t, cache)
        # the transformer and the hybrid update their k/v in place, the
        # recurrences return new state rows
        self.cache = {k: new[k] for k in self.cache}
        self._pos += valid
        self.metrics.decode_steps += 1
        # next-token distribution sits at each slot's last valid row
        last = torch.clamp(valid_t.long() - 1, min=0)
        rows = logits[torch.arange(logits.shape[0], device=dev), last]
        return self._sample_ready(active, valid, rows,
                                  torch.argmax(rows, dim=-1))

    def _masked_decode(self, tokens: np.ndarray,
                       mask: np.ndarray) -> torch.Tensor:
        """One batched ``decode_step`` where only masked-in slots advance:
        a masked-out slot's cache rows are kept, so prompt tokens and
        single decode tokens share one step.  Returns the logits [B,V]."""
        dev = self.device
        cache = dict(self.cache, pos=torch.from_numpy(self._pos).to(dev))
        logits, new = self.model.decode_step(
            self.params, torch.from_numpy(tokens).to(dev), cache)
        kept = mask_cache_rows(torch.from_numpy(mask).to(dev), new, cache)
        self.cache = {k: kept[k] for k in self.cache}
        self._pos += mask
        return logits

    def _step_masked(self, active: List[int], budget: int) -> set:
        """Per-token step for models without a fused chunk step: up to
        ``budget`` masked sub-steps over ``decode_step``, where only
        prompt-consuming slots advance after the first."""
        pending = self._pending_prompt
        sampled: set = set()
        for j in range(budget):
            toks = np.zeros((self.max_batch,), np.int64)
            mask = np.zeros((self.max_batch,), bool)
            for i in active:
                q = pending.get(i)
                if q:
                    toks[i] = q.pop(0)
                    mask[i] = True
                    if not q:
                        pending.pop(i, None)
                elif j == 0 and i not in sampled:
                    req = self.slots[i]
                    toks[i] = req.generated[-1] if req.generated else 0
                    mask[i] = True
            if not mask.any():
                break
            if self._prefix_share_ok:
                for i in active:
                    ids = self._slot_tokens.get(i)
                    if ids is not None and mask[i]:
                        ids.append(int(toks[i]))
            logits = self._masked_decode(toks, mask)
            self.metrics.decode_steps += 1
            ready = [i for i in active
                     if mask[i] and i not in pending and i not in sampled]
            if not ready:
                continue
            greedy = torch.argmax(logits, dim=-1).cpu().numpy()
            for i in ready:
                req = self.slots[i]
                tok = self._sample_slot(req, logits, i, greedy)
                req.generated.append(tok)
                if req.first_token_at < 0:
                    req.first_token_at = time.monotonic()
                self.metrics.tokens_generated += 1
                sampled.add(i)
        return sampled

    def _vacate_slot(self, slot: int) -> None:
        """Free a batch slot and every per-slot residue (pending prompt,
        request generator) so a recycled slot can never inherit a previous
        request's unconsumed prompt tokens."""
        req = self.slots[slot]
        self.slots[slot] = None
        self._active_mask[slot] = False
        self._pending_prompt.pop(slot, None)
        self._slot_tokens.pop(slot, None)
        sid = self._slot_sid.pop(slot, None)
        if sid is not None:
            self.pool.unprotect(sid)
            if req is None or not req.session_id:
                # anonymous paged session: no follow-up can resume it
                self.pool.release(sid)
        if req is not None:
            self._req_gen.pop(req.request_id, None)

    def _finish_slot(self, slot: int, now: float) -> None:
        req = self.slots[slot]
        req.finished = True
        req.finished_at = now
        if req.expired:
            # deadline preemption: the partial generation never reaches the
            # transcript, so leave no warm session cache behind (a later
            # resume would continue from divergent history)
            self.metrics.expired += 1
            self._vacate_slot(slot)
            if req.session_id:
                self.pool.release(req.session_id)
        else:
            self.metrics.completed += 1
            if self._state_pool and req.session_id:
                # a copy of the slot's state row (the slot is recycled)
                tokens = int(self._pos[slot])
                row = {k: v.clone() for k, v in
                       get_slot(self.cache, slot).items()}
                row["pos"] = torch.tensor([tokens], dtype=torch.int32,
                                          device=self.device)
                self.pool.store(req.session_id, row, tokens)
            elif not self._paged and req.session_id:
                # dense plane: persist the slot's cache for prefix reuse on
                # follow-ups (on the paged plane the pool pages ARE the
                # session cache, already current through commit_append)
                tokens = int(self._pos[slot])
                row = get_slot(self.cache, slot)
                ids = self._slot_tokens.get(slot)
                if ids is not None and len(ids) != tokens:
                    ids = None      # provenance lost: keep the write opaque
                if tokens <= self.max_seq:
                    self.pool.write_session(
                        req.session_id, row["k"][:, 0, :tokens],
                        row["v"][:, 0, :tokens], tokens, now, token_ids=ids)
            self._vacate_slot(slot)

    def cancel_request(self, request_id: str) -> bool:
        """Abandon one request (hedge loser / caller gone): remove it from
        the wait queue, or vacate its batch slot mid-decode — the slot and
        its protected KV pages are reclaimed through the normal vacate
        path.  The request is NOT delivered as finished.  Returns True if
        the request was found."""
        with self._lock:
            req = self.queue.remove(request_id)
            if req is not None:
                self.metrics.queued = len(self.queue)
                return True
            for slot in range(self.max_batch):
                r = self.slots[slot]
                if r is not None and r.request_id == request_id:
                    self._vacate_slot(slot)
                    if r.session_id:
                        # the abandoned decode already extended this
                        # session's cache with tokens that will never reach
                        # the transcript: drop the cache outright
                        self.pool.release(r.session_id)
                    self.metrics.active = int(self._active_mask.sum())
                    return True
        return False

    # ------------------------------------------------------------ telemetry
    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and len(self.queue) == 0:
                return

    def slot_sessions(self) -> Dict[int, str]:
        """Session tag of every occupied batch slot (cache-slot ownership)."""
        with self._lock:
            return {i: r.session_id for i, r in enumerate(self.slots)
                    if r is not None}

    def telemetry(self) -> Dict[str, Any]:
        m = self.metrics
        return {"queued": len(self.queue), "active": m.active,
                "completed": m.completed, "decode_steps": m.decode_steps,
                "prefills": m.prefills, "prefill_tokens": m.prefill_tokens,
                "prefix_hits": m.prefix_hits,
                "shared_prefix_hits": m.shared_prefix_hits,
                "shared_prefix_tokens": m.shared_prefix_tokens,
                "prefix_sharing": ({} if self._state_pool
                                   else dict(self.pool.stats)),
                "tokens_generated": m.tokens_generated,
                "queue_limit": self.max_queue,
                "queue_saturation": self.saturation(),
                "admission_rejects": self.queue.rejected,
                "expired": m.expired,
                "expired_rejects": self.queue.expired_rejects,
                "prefill_chunk": self.prefill_chunk,
                "paged_decode": self._paged,
                "device": str(self.device),
                "decode_tokens_per_step": m.decode_tokens_per_step,
                "resume_overflows": m.resume_overflows,
                "paged_append_failures": m.paged_append_failures,
                "slot_sessions": self.slot_sessions()}
