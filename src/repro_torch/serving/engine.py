"""PyTorch inference engine: slot-based continuous batching.

The port of the JAX package's ``serving/engine.py`` for every family
(dense, MoE, VLM, audio, ssm, hybrid), on its three data planes:

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
  * non-text inputs ride on the request's ``extras``: a VLM request's
    ``image_embeds`` [T_img, D] take the monolithic prefill (the image
    prefix enters the cache there); an audio request's ``frames``
    [T_enc, D] go through one ``encode_cross`` at admission, whose
    cross-attention memory the slot keeps (``xk`` / ``xv`` rows beside
    the K/V on every plane), and its prompt then chunks like any other.
    An audio session is never resumed (its memory is not pooled:
    ``resume_unsupported``) and never shares prefix pages (its K/V
    depends on the frames);
  * ``warm_session`` replays a transcript into the pool (the replay side of
    migration) without occupying a slot;
  * the Nalar bridge's side of the engine: ``submit_async`` registers
    completion and stream-chunk callbacks that ``drain_completions`` fires
    off the step lock, finished requests wait in a bounded list, the pool
    takes the ``KVRegistry``'s hints (``bind_registry``) and the engine
    ``touch``es a session's residency at admission, warm and finish;
  * speculative decoding on the paged plane (``draft_model``): a draft
    (``serving/speculative.DraftEngine``) proposes ``spec_k`` tokens per
    decoding slot and round, one paged chunk step verifies all ``k+1``
    positions, the accepted prefix is committed and the rejected tail's
    reserved pages are released (``truncate_reserved``).  Greedy
    speculative decoding gives the plain decode's tokens.

The device is ``torch.device("cuda")`` unless the caller names another;
each step copies only the [B] greedy tokens to the host (the [B,V]
next-token rows stay on the device unless a stochastic request samples
from them; a verify step copies the [B,T] greedy tokens instead).
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

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
from .sampler import (SamplingParams, greedy_accept, sample,
                      speculative_verify)


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
    # resumes refused because the family cannot restore from the pool (the
    # audio family: its cross-attention memory is not pooled)
    resume_unsupported: int = 0
    # admissions/steps aborted because the pool could not provide pages
    # (all residents protected or pinned)
    paged_append_failures: int = 0
    # speculative decoding: rounds that ran a draft, draft tokens proposed,
    # and tokens the verifier accepted
    spec_rounds: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    # requests dropped because their deadline passed: rejected at admission
    # (push/pop) or preempted mid-decode with slot + KV pages reclaimed
    expired: int = 0

    @property
    def spec_acceptance(self) -> float:
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    @property
    def decode_tokens_per_step(self) -> float:
        """Acceptance-weighted decode throughput: > 1 means speculation is
        paying (every accepted draft token rides a step for free)."""
        return (self.tokens_generated / self.decode_steps
                if self.decode_steps else 0.0)


# families whose prompts can be consumed in chunks and whose cache position
# is a token's identity (prefix sharing).  Encoder-decoder ("audio") models
# chunk too (``_chunked_for`` special-cases them: one ``encode_cross`` pass
# supplies the cross-attention memory first), but stay out of this tuple:
# it also gates prefix sharing, and audio decoder K/V depends on the
# frames, so token identity never implies K/V identity.  Nothing in the
# engine is MoE-specific: the MoE layers live inside the model.
_CHUNKABLE_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
# the families whose sessions live in a StateCachePool, as on the reference
_STATE_FAMILIES = ("ssm", "hybrid")


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
                 max_seq: int = 512, instance_id: str = "engine:0",
                 kv_registry=None, pool_pages: int = 0, page_size: int = 64,
                 rng_seed: int = 0, prefill_chunk: int = 8,
                 max_queue: int = 0, queue_watermark: float = 0.75,
                 finished_cap: int = 8192, prefix_sharing: bool = True,
                 paged_decode: bool = True,
                 draft_model: Optional[Model] = None,
                 draft_params: Optional[dict] = None,
                 spec_k: int = 3, spec_min_accept: float = 0.25,
                 spec_warmup: int = 24, tier: str = "",
                 device: DeviceLike = None) -> None:
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.device = resolve_device(device)
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.instance_id = instance_id
        self.kv_registry = kv_registry
        self.tier = str(tier)
        self.metrics = EngineMetrics()
        # optional fault injector (serving.chaos); when set, step() calls
        # chaos.before_step(engine) outside the lock
        self.chaos: Optional[Any] = None
        # prompt tokens consumed per slot per step while prefilling;
        # 0 = monolithic bucket prefill at admission
        self.prefill_chunk = int(prefill_chunk)
        self.max_queue = int(max_queue)
        # saturation fraction above which routers should shed new sessions
        # to a sibling replica (advisory, through telemetry)
        self.queue_watermark = queue_watermark
        self.finished_cap = int(finished_cap)
        self.queue = WaitQueue(maxsize=self.max_queue)
        self._rng_seed = int(rng_seed)       # base of request streams
        self._lock = threading.RLock()
        # completion plumbing has its own lock: submissions and drains never
        # serialize behind a long step
        self._done_lock = threading.Lock()
        # request_id -> completion callback, finished requests awaiting a
        # drain, and the token-streaming callbacks with the (request,
        # chunk) pairs the steps emitted; callbacks fire from
        # drain_completions, off the step lock, chunks before completions
        self._callbacks: Dict[str, Callable[[Request], None]] = {}
        self._finished: List[Request] = []
        self._stream_cbs: Dict[str, Callable[[Request, List[int]],
                                             None]] = {}
        self._stream_pending: List[Tuple[Request, List[int]]] = []

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
        if kv_registry is not None:
            kv_registry.register_hook(instance_id, self.pool.on_hint)
        W = self.cfg.sliding_window
        # a paged pool where a cache position maps 1:1 to a token position:
        # no sliding-window ring wrap
        linear = not self._state_pool and (not W or self.max_seq <= W)
        # cross-session prefix sharing: admission and warm_session consult
        # the pool's prefix index
        self.prefix_sharing = bool(prefix_sharing)
        self._prefix_share_ok = (self.prefix_sharing and linear
                                 and self.cfg.family in _CHUNKABLE_FAMILIES)
        # paged-native decode: the KV pool IS the decode cache.  Windowed
        # configs qualify only when the ring never wraps (slot == position,
        # so the linear page layout matches the ring layout); the others,
        # and paged_decode=False, run the dense plane.
        self.paged_decode = bool(paged_decode)
        self._paged = self.paged_decode and linear
        # dense per-slot cache length
        self._slot_C = min(self.max_seq, W) if W else self.max_seq
        # dense plane: the per-slot k/v [L,B,C,Hkv,Dh]; state-cache plane:
        # conv [L,B,K-1,C] and ssm [L,B,H,P,N], or the hybrid's conv, h
        # [L_rec,B,W] and k/v rings [L_att,B,C,Hkv,Dh]; the audio family's
        # cross memory xk/xv [L,B,T_enc,Hkv,Dh] on the dense and the paged
        # plane (the slots' positions live on the host in _pos on every
        # plane)
        self.cache: Dict[str, torch.Tensor] = {}
        self._blank_row_cache: Optional[Dict[str, torch.Tensor]] = None
        if self._paged:
            self._max_pages = self.pool.pages_needed(self.max_seq)
            # the slim cache: what the pages do not hold (the K/V of a
            # one-position cache is dropped)
            full = model.init_cache(max_batch, 1, device=self.device)
            drop = ("k", "v", "pos")
        else:
            full = model.init_cache(max_batch, max_seq, device=self.device)
            drop = ("pos",)
        self.cache = {k: v for k, v in full.items() if k not in drop}
        # slot -> pool session key the slot decodes into (paged plane only;
        # anonymous requests get a synthetic key released at vacate)
        self._slot_sid: Dict[int, str] = {}
        # slot -> token ids whose K/V occupy the slot's cache positions so
        # far (None = unknown provenance, the session stays opaque).  They
        # key the pool's prefix index.
        self._slot_tokens: Dict[int, Optional[List[int]]] = {}

        # speculative decoding (paged plane only): a small-tier draft
        # proposes spec_k tokens per decode round; the same paged chunk
        # step verifies all k+1 positions at once
        self.spec_k = int(spec_k)
        self.spec_min_accept = float(spec_min_accept)
        self.spec_warmup = int(spec_warmup)
        self._spec = None
        # pool session -> [proposed, accepted]: the acceptance ledger that
        # disables speculation per session
        self._spec_ledger: Dict[str, List[int]] = {}
        self._spec_off: set = set()
        # slots whose draft stream mirrors the target's consumed tokens
        # (unknown provenance = no speculation for that slot)
        self._spec_ok: set = set()
        if draft_model is not None and self._paged and self.spec_k > 0:
            if draft_model.cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(
                    "draft/target vocab mismatch: "
                    f"{draft_model.cfg.vocab_size} vs {self.cfg.vocab_size}")
            from .speculative import DraftEngine
            self._spec = DraftEngine(draft_model, draft_params,
                                     max_batch=max_batch, max_seq=max_seq,
                                     device=self.device)

    # ----------------------------------------------------------- submission
    def submit(self, req: Request) -> str:
        """Queue ``req``.  Raises :class:`EngineOverloaded` when the bounded
        wait queue is at capacity (backpressure — callers retry or shed) and
        :class:`RequestExpired` when the request's deadline already passed."""
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

    def submit_async(self, req: Request,
                     on_done: Optional[Callable[[Request], None]] = None,
                     on_chunk: Optional[
                         Callable[[Request, List[int]], None]] = None) -> str:
        """Queue ``req``; ``on_done(req)`` fires from ``drain_completions``
        after the request finishes (the Nalar future-resolution hook).
        ``on_chunk(req, tokens)`` fires from the same drain for every batch
        of tokens the request's slot emitted since the previous drain, in
        order, and always before the request's ``on_done``."""
        with self._done_lock:
            if on_done is not None:
                self._callbacks[req.request_id] = on_done
            if on_chunk is not None:
                self._stream_cbs[req.request_id] = on_chunk
        try:
            return self.submit(req)
        except BaseException:
            with self._done_lock:       # rejected: no completion will fire
                self._callbacks.pop(req.request_id, None)
                self._stream_cbs.pop(req.request_id, None)
            raise

    def poll_finished(self) -> List[Request]:
        """Requests finished since the last poll/drain (no callbacks fired)."""
        with self._done_lock:
            out, self._finished = self._finished, []
        return out

    def drain_completions(self) -> int:
        """Fire stream-chunk then completion callbacks for the work the step
        loop emitted.  The bridge's pump thread calls it after each step,
        outside the engine lock; a request's chunk callbacks always fire
        before (and never after) its completion callback."""
        with self._done_lock:
            chunks, self._stream_pending = self._stream_pending, []
            ccbs = [(r, c, self._stream_cbs.get(r.request_id))
                    for r, c in chunks]
            done, self._finished = self._finished, []
            cbs = [(r, self._callbacks.pop(r.request_id, None)) for r in done]
            for r in done:
                self._stream_cbs.pop(r.request_id, None)
        for req, chunk, ccb in ccbs:
            if ccb is not None:
                ccb(req, chunk)
        for req, cb in cbs:
            if cb is not None:
                cb(req)
        return len(cbs)

    def bind_registry(self, kv_registry, instance_id: str) -> None:
        """(Re)bind this engine to a Nalar runtime identity: its telemetry
        and pool hints are tagged with the agent-instance id, so the
        runtime's Router and KVRegistry see one name."""
        self.instance_id = instance_id
        self.kv_registry = kv_registry
        if kv_registry is not None:
            kv_registry.register_hook(instance_id, self.pool.on_hint)

    def _touch(self, session_id: str, tokens: int, now: float) -> None:
        """Tell the KV registry that ``session_id`` holds ``tokens`` cached
        tokens on this engine."""
        if self.kv_registry is not None:
            self.kv_registry.touch(session_id, self.instance_id, tokens, now)

    def generate(self, prompt, session_id: str = "",
                 sampling: Optional[SamplingParams] = None,
                 **extras) -> Request:
        """Synchronous helper: submit + run until this request finishes."""
        req = Request.make(prompt, session_id=session_id, sampling=sampling,
                           now=time.monotonic(), **extras)
        self.submit(req)
        while not req.finished:
            self.step()
        return req

    # ------------------------------------------------------------ admission
    def saturation(self) -> float:
        """Wait-queue depth as a fraction of capacity (0.0 if unbounded)."""
        return self.queue.saturation()

    def overloaded(self) -> bool:
        """Above the shed watermark: routers should prefer a sibling."""
        return bool(self.max_queue) and self.saturation() >= self.queue_watermark

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
        for k, v in req.extras.items():
            batch[k] = self._extra(v)
        logits, row_cache = self.model.prefill(self.params, batch)
        self.metrics.prefills += 1
        self.metrics.prefill_tokens += S
        return logits, row_cache

    def _extra(self, v: np.ndarray) -> torch.Tensor:
        """A request's extra ([T, D], or batched [1, T, D]) as a batch-1
        tensor on the device."""
        return torch.from_numpy(v[None] if v.ndim == 2 else v).to(
            self.device)

    def _chunked_for(self, req: Request) -> bool:
        """Whether admission feeds ``req``'s prompt through the step loop in
        chunks (else the monolithic prefill): never with other extras than
        an audio request's ``frames``."""
        if self.prefill_chunk <= 0:
            return False
        if self.model.encode_cross is not None:
            # encoder-decoder: one encoder pass computes the cross-attention
            # memory (exactly the bytes prefill would), then the decoder
            # prompt chunks like any causal family
            return set(req.extras) == {"frames"}
        return not req.extras

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
        if self.model.encode_cross is not None:
            # the decoder's self-attention K/V is poolable, but the
            # cross-attention memory (xk/xv) is not: a resumed slot would
            # cross-attend zeros.  Refuse and count.
            sp = self.pool.session(req.session_id)
            if sp is not None and sp.pages:
                self.metrics.resume_unsupported += 1
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
        """Zeroed single-slot cache row for chunked-prefill admission
        (recurrent state accumulates unconditionally; on the paged plane
        the row holds the audio family's cross memory, or nothing), so a
        recycled slot never starts from its previous occupant's row."""
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
                # expired while waiting: never occupy a slot.  Delivered as
                # finished with expired=True, so the bridge's callback still
                # fires and resolves the future DeadlineExceeded.
                req.expired = True
                req.finished = True
                req.finished_at = now
                self.metrics.expired += 1
                with self._done_lock:
                    self._finished.append(req)
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
            if (resumed is None and req.session_id and not req.extras
                    and self._prefix_share_ok and len(req.prompt) > 1):
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
                if self._spec is not None:
                    # the draft can only shadow this slot if the resumed
                    # positions have exact token provenance to replay
                    self._spec.reset(slot)
                    ids = self._slot_tokens[slot]
                    if ids is not None and len(ids) == tokens:
                        self._spec.observe(slot, ids)
                        self._spec_ok.add(slot)
            elif self._chunked_for(req):
                # chunked prefill: blank row now, prompt consumed by step()
                # in prefill_chunk-sized pieces piggybacked on decode
                row = self._blank_row()
                if "frames" in req.extras:
                    xk, xv = self.model.encode_cross(
                        self.params, self._extra(req.extras["frames"]))
                    row = dict(row, xk=xk[:, 0], xv=xv[:, 0])
                set_slot(self.cache, slot, row)
                if self._paged:
                    sid = req.session_id or f"__anon:{req.request_id}"
                    if req.session_id:
                        # stale pages from a refused resume would misplace
                        # the first in-place append: start cold
                        self.pool.release(sid)
                    self.pool.protect(sid)
                    self._slot_sid[slot] = sid
                self._pos[slot] = 0
                self._pending_prompt[slot] = [int(t) for t in req.prompt]
                self._slot_tokens[slot] = [] if self._prefix_share_ok \
                    else None
                if self._spec is not None:
                    # chunked prefill feeds the whole prompt through the
                    # step loop, which mirrors each chunk into the draft
                    self._spec.reset(slot)
                    self._spec_ok.add(slot)
                self.metrics.prefills += 1
                self.metrics.prefill_tokens += len(req.prompt)
            elif not self._admit_prefilled(slot, req, now):
                continue
            self.slots[slot] = req
            self._active_mask[slot] = True
            self._touch(req.session_id, len(req.prompt), now)

    def _admit_prefilled(self, slot: int, req: Request, now: float) -> bool:
        """Monolithic admission: bucket prefill, write the row's K/V into
        the session's pages (paged plane) or the slot's cache row (dense
        plane), sample the first token.  The cache covers the bucket, and
        a VLM request's image prefix before it.  Returns False when the
        request already finished (pool exhausted, or its first token met a
        stop condition)."""
        logits, row_cache = self._prefill(req)
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        tok = self._sample_slot(req, logits, 0, greedy)
        req.generated.append(tok)
        # TTFT: the first token exists *now*, after the prefill compute
        req.first_token_at = time.monotonic()
        S = len(req.prompt)
        bucket = min(bucket_len(S), self.max_seq)
        tokens = int(row_cache["pos"].reshape(-1)[0])
        # left-aligned bucket prefill: pad token 0's K/V enters the leading
        # positions and is part of the provenance
        full = [0] * (bucket - S) + [int(t) for t in req.prompt]
        ids = full if self._prefix_share_ok and not req.extras else None
        self.metrics.tokens_generated += 1
        if self._paged:
            sid = req.session_id or f"__anon:{req.request_id}"
            if req.session_id:
                self.pool.release(sid)
            if tokens > self.max_seq or not self.pool.write_session(
                    sid, row_cache["k"][:, 0, :tokens],
                    row_cache["v"][:, 0, :tokens], tokens, now,
                    token_ids=ids):
                # pool exhausted (residents all protected/pinned): deliver
                # what we have instead of wedging the slot
                self.metrics.paged_append_failures += 1
                self.metrics.completed += 1
                req.finished = True
                req.finished_at = time.monotonic()
                self._emit_stream(req)
                with self._done_lock:
                    self._finished.append(req)
                return False
            self.pool.protect(sid)
            self._slot_sid[slot] = sid
            if self._spec is not None:
                # the pages hold the left-padded bucket, whose tokens are
                # known whether or not they were indexed
                self._spec.reset(slot)
                if tokens == len(full):
                    self._spec.observe(slot, full)
                    self._spec_ok.add(slot)
        # the slot's cache row: K/V on the dense plane, the audio memory on
        # both
        set_slot(self.cache, slot, row_cache)
        self._pos[slot] = tokens
        self._slot_tokens[slot] = ids
        if (len(req.generated) >= req.sampling.max_new_tokens
                or tok == req.sampling.eos_token):
            # stop conditions apply to the admission-sampled token too
            self.slots[slot] = req
            self._active_mask[slot] = True
            self._finish_slot(slot, time.monotonic())
            self._touch(req.session_id, len(req.prompt), now)
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
                self._touch(session_id, bucket, now)
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
            self._touch(session_id, tokens, now)
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
                self._touch(session_id, sp.tokens, now)
                return sp.tokens
            resident = sp.tokens
        else:
            resident = pool.acquire_prefix(session_id, toks, now=now)
            if resident >= len(toks):
                self._touch(session_id, resident, now)
                return resident
        if resident <= 0:
            return 0
        tokens = self._extend_session(session_id, toks, resident, now)
        if tokens:
            self._touch(session_id, tokens, now)
        return tokens

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
        if self.chaos is not None:
            self.chaos.before_step(self)
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
                else:
                    self._emit_stream(req)
            self.metrics.queued = len(self.queue)
            self.metrics.active = int(self._active_mask.sum())
            return len(active)

    def _emit_stream(self, req: Request) -> None:
        """Buffer the tokens this request's slot appended since the last
        emission as one stream chunk (the caller holds the step lock;
        ``drain_completions`` delivers it).  Only a request with a chunk
        callback buffers anything."""
        n = len(req.generated)
        if n <= req.streamed:
            return
        chunk = [int(t) for t in req.generated[req.streamed:]]
        req.streamed = n
        with self._done_lock:
            if req.request_id in self._stream_cbs:
                self._stream_pending.append((req, chunk))

    def _paged_forward(self, toks: np.ndarray, valid: np.ndarray,
                       pos: np.ndarray, pt: np.ndarray):
        """One paged chunk forward on the device.  Returns the [B,T,V]
        logits and the [B,V] next-token rows (each sequence's last valid
        row), both left on the device."""
        dev = self.device
        valid_t = torch.from_numpy(valid).to(dev)
        logits, _cache, _kp, _vp = self.model.decode_chunk_paged(
            self.params, torch.from_numpy(toks).to(dev), valid_t,
            dict(self.cache, pos=torch.from_numpy(pos).to(dev)), self.pool.k,
            self.pool.v, torch.from_numpy(pt).to(dev), max_seq=self.max_seq)
        last = torch.clamp(valid_t.long() - 1, min=0)
        rows = logits[torch.arange(logits.shape[0], device=dev), last]
        return logits, rows

    def _plan_chunk(self, active: List[int], budget: int,
                    drafts: Optional[Dict[int, List[int]]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The chunk every plane's step feeds: prefilling slots consume up
        to ``budget`` prompt tokens, decoding slots advance one (a slot
        with ``drafts`` feeds its last token and its draft tokens), idle
        slots none.  The chunk width is sized to the actual need and
        rounded up to a power of two (so a short prompt never pays a
        full-width chunk step).  Prompt chunks of a slot whose draft
        shadows it are mirrored into the draft's stream.  Returns (tokens
        [B,T], valid lengths [B])."""
        pending = self._pending_prompt
        drafts = drafts or {}
        need = 1
        for i in active:
            q = pending.get(i)
            if q:
                need = max(need, min(len(q), budget))
            elif i in drafts:
                need = max(need, 1 + len(drafts[i]))
        cap = max([budget] + [1 + len(d) for d in drafts.values()])
        T = min(1 << (need - 1).bit_length(), cap)
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
                if i in self._spec_ok:
                    self._spec.observe(i, toks[i, :n].tolist())
            else:
                req = self.slots[i]
                seq = [req.generated[-1] if req.generated else 0]
                seq += drafts.get(i, [])
                toks[i, :len(seq)] = seq
                valid[i] = len(seq)
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
        aborted explicitly — counted, finished with what it has.  With a
        draft, decoding slots first get their proposals; such a slot feeds
        them in the same chunk and its outcome is decided (and committed)
        by :meth:`_verify_slot`."""
        plan = (self._plan_speculation(active)
                if self._spec is not None else {})
        pos0 = self._pos.copy()
        toks, valid = self._plan_chunk(active, budget, plan)
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
            if ids is not None and valid[i] and i not in plan:
                ids.extend(int(t) for t in toks[i, :valid[i]])
        pt = np.full((self.max_batch, self._max_pages), -1, np.int32)
        for i in active:
            if valid[i]:
                pt[i] = self.pool.page_table(self._slot_sid[i],
                                             self._max_pages)
        logits, rows = self._paged_forward(toks, valid, self._pos, pt)
        self._pos += valid
        self.metrics.decode_steps += 1
        for i in active:
            if valid[i] and i not in plan:
                n = int(valid[i])
                ids = (toks[i, :n].tolist()
                       if self._slot_tokens.get(i) is not None else None)
                self.pool.commit_append(self._slot_sid[i], n, token_ids=ids,
                                        now=now)
        for i in aborted:
            self._finish_slot(i, now)
        if not plan:
            return self._sample_ready(active, valid, rows,
                                      torch.argmax(rows, dim=-1))
        # one host copy of every position's argmax: the plain slots' tokens
        # and the verifier's greedy walk
        greedy_all = torch.argmax(logits, dim=-1).cpu().numpy()     # [B,T]
        greedy = greedy_all[np.arange(self.max_batch),
                            np.maximum(valid - 1, 0)]
        sampled = self._sample_ready([i for i in active if i not in plan],
                                     valid, rows, torch.from_numpy(greedy))
        for i in active:
            if i in plan and valid[i]:
                self._verify_slot(self.slots[i], i, plan[i], int(toks[i, 0]),
                                  int(pos0[i]), logits, greedy_all, now)
                sampled.add(i)
        return sampled

    def _plan_speculation(self, active: List[int]) -> Dict[int, List[int]]:
        """Draft proposals for this round: every decoding slot whose draft
        stream shadows it proposes up to ``spec_k`` tokens (batched across
        slots in the draft).  Returns slot -> draft tokens."""
        want: Dict[int, int] = {}
        for i in active:
            if self._pending_prompt.get(i) or i not in self._spec_ok:
                continue
            req = self.slots[i]
            if req is None or not req.generated:
                continue
            k = self._spec_budget(i, req, int(self._pos[i]))
            if k > 0:
                self._spec.observe(i, [int(req.generated[-1])])
                want[i] = k
        return self._spec.propose(want) if want else {}

    def _spec_budget(self, slot: int, req: Request, pos: int) -> int:
        """Draft tokens worth proposing for this slot this round (0 = run a
        plain decode step): bounded by ``spec_k``, by the request's
        remaining new-token budget (a round emits at most k+1), by the
        slot's remaining positions, and by the per-session off-switch."""
        sid = self._slot_sid.get(slot)
        if sid is None or sid in self._spec_off:
            return 0
        remaining_new = req.sampling.max_new_tokens - len(req.generated)
        n_max = self.max_seq - 1 - pos       # emission budget to the cap
        return max(0, min(self.spec_k, remaining_new - 1, n_max - 1))

    def _round_seed(self, req: Request) -> int:
        """One seed per verification round, drawn from the request's own
        generator (the verifier derives each position's draws from it)."""
        gen = self._req_gen.get(req.request_id)
        if gen is None:
            gen = self._req_gen[req.request_id] = self._request_generator(req)
        return int(torch.randint(0, 1 << 62, (1,), generator=gen,
                                 device=gen.device)[0])

    def _verify_slot(self, req: Request, slot: int, drafts: List[int],
                     t_prev: int, pos0: int, logits: torch.Tensor,
                     greedy_all: np.ndarray, now: float) -> None:
        """Decide one verified draft chunk for ``slot``.

        The step already wrote K/V for all ``k+1`` fed positions into the
        slot's reserved pages; this decides how many survive.  Greedy
        accepts the longest prefix where the argmax equals the draft (the
        plain decode's tokens, because a chunk's rows equal the one-token
        steps'); stochastic runs the accept/resample rule on the slot's
        k+1 logits rows with a seed from the request's generator.  Commits
        exactly the consumed positions, releases the rejected tail's
        reserved pages, rewinds the slot's position and truncates the
        draft's stream to the surviving prefix."""
        k = len(drafts)
        sp = req.sampling
        if sp.temperature <= 0.0:
            candidates, m = greedy_accept(greedy_all[slot], drafts)
        else:
            candidates, m = speculative_verify(
                logits[slot, :k + 1].float().cpu().numpy(), drafts, sp,
                self._round_seed(req))
        # trim emissions at the request's stop conditions (a mid-chunk eos
        # or budget hit ends the round early, as the one-token path would)
        emitted: List[int] = []
        for t in candidates:
            emitted.append(int(t))
            if (len(req.generated) + len(emitted) >= sp.max_new_tokens
                    or t == sp.eos_token
                    or pos0 + len(emitted) >= self.max_seq - 1):
                break
        r = len(emitted)
        sid = self._slot_sid[slot]
        consumed = [t_prev] + emitted[:r - 1]
        ids = self._slot_tokens.get(slot)
        if ids is not None:
            ids.extend(consumed)
        self.pool.commit_append(
            sid, r, token_ids=(consumed if ids is not None else None),
            now=now)
        self.pool.truncate_reserved(sid)
        # the step advanced the position by the full k+1 feed; only r
        # positions exist
        self._pos[slot] = pos0 + r
        self._spec.rollback(slot, pos0 + r)
        req.generated.extend(emitted)
        self.metrics.tokens_generated += r
        if req.first_token_at < 0:
            req.first_token_at = time.monotonic()
        self.metrics.spec_rounds += 1
        self.metrics.spec_proposed += k
        self.metrics.spec_accepted += m
        led = self._spec_ledger.setdefault(sid, [0, 0])
        led[0] += k
        led[1] += m
        if (led[0] >= self.spec_warmup
                and led[1] < self.spec_min_accept * led[0]):
            # observed acceptance makes speculation a loss for this
            # session: every future round decodes plain
            self._spec_off.add(sid)
        if len(self._spec_ledger) > 8192:
            self._spec_ledger.clear()
            self._spec_off.clear()

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
        if self._spec is not None:
            self._spec.reset(slot)
            self._spec_ok.discard(slot)
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
            # deadline preemption: the partial generation is worthless and
            # never reaches the transcript, so it emits nothing further and
            # leaves no warm session cache behind (a later resume would
            # continue from divergent history)
            self.metrics.expired += 1
            self._vacate_slot(slot)
            if req.session_id:
                self.pool.release(req.session_id)
        else:
            # flush the final tokens as a last chunk before delivery, so a
            # consumer's chunk stream concatenates to the completion value
            self._emit_stream(req)
            self.metrics.completed += 1
            if req.session_id:
                self._touch(req.session_id, self._persist(slot, req, now),
                            now)
            self._vacate_slot(slot)
        with self._done_lock:
            self._finished.append(req)
            if len(self._finished) > self.finished_cap:
                self._trim_finished()

    def _persist(self, slot: int, req: Request, now: float) -> int:
        """Keep a finishing session's cache for follow-ups; returns the
        tokens it covers.  On the paged plane the pool pages ARE the
        session cache, already current through ``commit_append``."""
        tokens = int(self._pos[slot])
        if self._paged:
            sp = self.pool.session(req.session_id)
            return sp.tokens if sp is not None else tokens
        if self._state_pool:
            # a copy of the slot's state row (the slot is recycled)
            row = {k: v.clone() for k, v in
                   get_slot(self.cache, slot).items()}
            row["pos"] = torch.tensor([tokens], dtype=torch.int32,
                                      device=self.device)
            self.pool.store(req.session_id, row, tokens)
            return tokens
        # dense plane: write the slot's cache into the session's pages
        row = get_slot(self.cache, slot)
        ids = self._slot_tokens.get(slot)
        if ids is not None and len(ids) != tokens:
            ids = None      # provenance lost: keep the write opaque
        if tokens <= self.max_seq:
            self.pool.write_session(
                req.session_id, row["k"][:, 0, :tokens],
                row["v"][:, 0, :tokens], tokens, now, token_ids=ids)
        return tokens

    def _trim_finished(self) -> None:
        """Bound the finished list without losing async completions.

        Sync callers never drain, so the list must stay bounded; but a
        request with a registered callback still owes its caller a
        completion.  Evict the oldest callback-less requests first; only
        past twice the cap (callbacks registered but never drained) are
        callback-bearing requests evicted too, with their callback entries.
        The caller holds ``_done_lock``."""
        cut = len(self._finished) - self.finished_cap // 2
        kept: List[Request] = []
        for idx, r in enumerate(self._finished):
            if idx < cut and r.request_id not in self._callbacks:
                continue
            kept.append(r)
        overflow = len(kept) - 2 * self.finished_cap
        if overflow > 0:
            for r in kept[:overflow]:
                self._callbacks.pop(r.request_id, None)
            kept = kept[overflow:]
        self._finished = kept

    def cancel_request(self, request_id: str) -> bool:
        """Abandon one request (hedge loser / caller gone): remove it from
        the wait queue, or vacate its batch slot mid-decode — the slot and
        its protected KV pages are reclaimed through the normal vacate
        path.  The request is NOT delivered as finished and its callbacks
        are dropped: the caller resolved the future elsewhere.  Returns
        True if the request was found."""
        with self._lock:
            with self._done_lock:
                self._callbacks.pop(request_id, None)
                self._stream_cbs.pop(request_id, None)
                self._stream_pending = [
                    (r, c) for r, c in self._stream_pending
                    if r.request_id != request_id]
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

    def abort_all(self) -> int:
        """Clear the wait queue and vacate every slot (replica death, the
        bridge's ``fail_inflight``): no result will be delivered, and a
        recycled slot must not inherit a dead request's pending prompt.
        Returns the number of requests dropped."""
        with self._lock:
            n = self.queue.clear()
            for slot in range(self.max_batch):
                if self.slots[slot] is not None:
                    n += 1
                    self._vacate_slot(slot)
            self._pending_prompt.clear()
            self._slot_tokens.clear()
            with self._done_lock:
                self._callbacks.clear()
                self._stream_cbs.clear()
                self._stream_pending.clear()
            self.metrics.queued = 0
            self.metrics.active = 0
            return n

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
                # the paged step's attention runs the CUDA kernel on a card
                "paged_kernel": self._paged and self.device.type == "cuda",
                "tier": self.tier,
                "device": str(self.device),
                "speculative": self._spec is not None,
                "spec_rounds": m.spec_rounds,
                "spec_proposed": m.spec_proposed,
                "spec_accepted": m.spec_accepted,
                "spec_acceptance": m.spec_acceptance,
                "decode_tokens_per_step": m.decode_tokens_per_step,
                "resume_overflows": m.resume_overflows,
                "resume_unsupported": m.resume_unsupported,
                "paged_append_failures": m.paged_append_failures,
                "slot_sessions": self.slot_sessions()}
