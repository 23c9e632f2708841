"""Paged K,V cache pool with per-session page tables (the port of the JAX
package's ``serving/kv_cache.py``: vLLM's PagedAttention plus the paper's
LMCache control hooks, §4.3.2).

The pool is one device-resident tensor per K and V,
[L, n_pages, page, Hkv, Dh].  Sessions own page lists; pages are the unit of
eviction, sharing and session migration.  All bookkeeping is the
reference's, unchanged: refcounts, the page-granular radix prefix index
``(parent_page, token_block) -> page`` (root parent ``-1``), copy-on-write
divergence, protect/unprotect of the sessions an engine slot decodes into,
and the ``begin_append``/``commit_append`` reservation protocol of the
paged-native decode step.

``StateCachePool`` keeps the ssm and hybrid families' sessions instead:
one decode-state row each (conv window and recurrent state, and for the
hybrid the sliding-window K/V rings of its attention layers), no pages.

PyTorch tensors are mutable, so every page write (copy-on-write, import,
``write_session``, the decode step's scatter) updates the pool tensors in
place; this replaces the JAX package's functional ``.at[].set`` updates and
the donation of the page arrays to the jitted step.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device

# radix-index root: the "parent" of a session's first page
_ROOT = -1


@dataclass
class SessionPages:
    session_id: str
    pages: List[int] = field(default_factory=list)
    tokens: int = 0                  # valid tokens across pages
    # token ids whose K/V the pages hold, in position order.  Valid (and
    # eligible for sharing / keep-in-place rewrites) only when
    # len(token_ids) == tokens; sessions built through raw allocate() are
    # opaque (token_ids == []) and never enter the prefix index.
    token_ids: List[int] = field(default_factory=list)
    pinned: bool = False             # retain hint from the global controller
    offloaded: bool = False          # "far memory" (host) residency
    last_used: float = 0.0


class PagedKVPool:
    """One pool per engine instance.

    The pool stores K and V as [L, n_pages, page_size, Hkv, Dh] on
    ``device`` (the CUDA card unless the caller names the CPU); pages are
    the granularity of eviction, sharing and session migration (the
    paper's K,V migration maps to copying a session's page list between
    instances' pools).
    """

    def __init__(self, cfg: ModelConfig, n_pages: int, page_size: int = 128,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None) -> None:
        if cfg.family == "ssm":
            raise ValueError("SSM caches are O(1) state, kept by "
                             "StateCachePool, not in pages")
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
                 cfg.head_dim_)
        self.device = resolve_device(device)
        dt = dtype or cfg.torch_dtype
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self._free: List[int] = list(range(n_pages))
        self._sessions: Dict[str, SessionPages] = {}
        # page -> number of session page-lists containing it
        self._ref: Dict[int, int] = {}
        # prefix index: parent page (or _ROOT) -> {token block -> page}.
        # The index holds no references of its own — entries die with the
        # page — and a page has at most one entry (its _page_key).
        self._index: Dict[int, Dict[Tuple[int, ...], int]] = {}
        self._page_key: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self.stats: Dict[str, int] = {
            "prefix_queries": 0, "prefix_hits": 0, "prefix_tokens": 0,
            "cow_copies": 0, "dedup_pages": 0, "evictions": 0,
            "inplace_appends": 0,
        }
        # sessions an engine slot is actively decoding into: never evicted
        # (their pages are the live write targets of the paged-native step)
        self._protected: set = set()
        self._lock = threading.RLock()

    # ---------------------------------------------------------- allocation
    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def _free_page(self, page: int) -> None:
        """Return ``page`` to the free list and drop its index entries."""
        self._unindex(page)
        sub = self._index.pop(page, None)
        if sub:
            # orphan any children: their chain prefix no longer exists, so
            # they must not be discoverable under a recycled parent id
            for child in sub.values():
                self._page_key.pop(child, None)
        self._ref.pop(page, None)
        self._free.append(page)

    def _incref(self, page: int) -> None:
        self._ref[page] = self._ref.get(page, 0) + 1

    def _decref(self, page: int) -> None:
        r = self._ref.get(page, 0) - 1
        if r <= 0:
            self._free_page(page)
        else:
            self._ref[page] = r

    def _alloc_page(self, now: float, avoid: Optional[str] = None
                    ) -> Optional[int]:
        while not self._free:
            if not self._evict_one(now, avoid=avoid):
                return None
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def allocate(self, session_id: str, tokens: int, now: float = 0.0,
                 evict: bool = True) -> Optional[SessionPages]:
        """Reserve pages for ``tokens`` new tokens of a session.

        Raw reservations carry no token identity: the session becomes
        opaque to the prefix index until a ``write_session`` with
        ``token_ids`` re-describes its contents.
        """
        with self._lock:
            sp = self._sessions.setdefault(session_id,
                                           SessionPages(session_id))
            have = len(sp.pages) * self.page_size
            need_pages = self.pages_needed(max(0, sp.tokens + tokens - have))
            got: List[int] = []
            for _ in range(need_pages):
                if evict:
                    page = self._alloc_page(now, avoid=session_id)
                elif self._free:
                    page = self._free.pop()
                    self._ref[page] = 1
                else:
                    page = None
                if page is None:
                    for p in got:
                        self._decref(p)
                    return None
                got.append(page)
            sp.pages.extend(got)
            sp.tokens += tokens
            sp.token_ids = []
            sp.last_used = now
            return sp

    def _evict_one(self, now: float, avoid: Optional[str] = None) -> bool:
        """Evict the LRU unpinned session (hint-aware, unlike vanilla LRU).

        Shared pages survive eviction of one owner — only their last
        reference frees them — so evicting a donor never corrupts the
        sessions that acquired its prefix.  Protected sessions (actively
        decoding in an engine slot) are never candidates."""
        cands = [s for s in self._sessions.values()
                 if s.pages and not s.pinned and s.session_id != avoid
                 and s.session_id not in self._protected]
        if not cands:
            return False
        victim = min(cands, key=lambda s: s.last_used)
        self._release(victim)
        self.stats["evictions"] += 1
        return True

    def _release(self, sp: SessionPages) -> None:
        for p in sp.pages:
            self._decref(p)
        sp.pages = []
        sp.tokens = 0
        sp.token_ids = []
        sp.offloaded = False

    def release(self, session_id: str) -> None:
        with self._lock:
            sp = self._sessions.pop(session_id, None)
            if sp is not None:
                self._release(sp)

    # ------------------------------------------------- paged-native appends
    def protect(self, session_id: str) -> None:
        """Pin a session against eviction and drop/migrate hints while an
        engine slot decodes straight into its pages."""
        with self._lock:
            self._protected.add(session_id)

    def unprotect(self, session_id: str) -> None:
        with self._lock:
            self._protected.discard(session_id)

    def begin_append(self, session_id: str, n: int, now: float = 0.0) -> bool:
        """Reserve in-place write capacity for ``n`` more tokens.

        The paged-native decode step writes new K/V straight into the
        session's pages (positions ``tokens .. tokens+n-1``).  This call
        makes that safe:

        * every page about to be written becomes exclusively owned — a
          shared page (refcount > 1, e.g. an adopted prefix tail)
          is privatized onto a fresh page first (the copy-on-write event),
          so **an in-place write never mutates a page with refcount > 1**;
        * an exclusively-owned tail is unindexed before the write: its
          index key may still describe a departed donor's longer block, and
          any chain hanging off it would splice content computed under a
          different prefix (``commit_append`` re-keys it afterwards);
        * capacity pages for the overflow are allocated up front.

        All-or-nothing: returns False (session untouched) if the pool
        cannot provide the pages.  The caller publishes the write with
        ``commit_append`` after the step lands."""
        if n <= 0:
            return True
        P = self.page_size
        with self._lock:
            sp = self._sessions.setdefault(session_id,
                                           SessionPages(session_id))
            first_b = sp.tokens // P
            last_b = (sp.tokens + n - 1) // P
            existing = list(range(first_b, min(last_b + 1, len(sp.pages))))
            n_new = max(0, last_b + 1 - len(sp.pages))
            n_cow = sum(1 for b in existing
                        if self._ref.get(sp.pages[b], 0) > 1)
            fresh: List[int] = []
            for _ in range(n_new + n_cow):
                page = self._alloc_page(now, avoid=session_id)
                if page is None:
                    for p in fresh:
                        self._decref(p)
                    return False
                fresh.append(page)
            for b in existing:
                old = sp.pages[b]
                if self._ref.get(old, 0) > 1:
                    # privatize: the other owners keep the old page (and
                    # its index entry) untouched
                    new = fresh.pop()
                    self.k[:, new] = self.k[:, old]
                    self.v[:, new] = self.v[:, old]
                    sp.pages[b] = new
                    self._decref(old)
                    self.stats["cow_copies"] += 1
                else:
                    # exclusively ours, but its key/children may describe a
                    # departed donor's content past our valid tokens —
                    # stale the moment we write in place
                    self._unindex(old)
                    sub = self._index.pop(old, None)
                    if sub:
                        for child in sub.values():
                            self._page_key.pop(child, None)
            sp.pages.extend(fresh)
            sp.last_used = now
            self.stats["inplace_appends"] += 1
            return True

    def commit_append(self, session_id: str, n: int, token_ids=None,
                      now: float = 0.0) -> None:
        """Publish ``n`` tokens written in place by the paged decode step.

        With ``token_ids`` (the ``n`` consumed tokens, extending a valid
        provenance) the affected pages (re-)enter the prefix index —
        completed full pages and the new partial tail — so cross-session
        sharing keeps working without any gather/write-back.  Without ids
        (or on a provenance break) the session goes opaque; already-indexed
        prefix pages keep their entries, which stay valid."""
        P = self.page_size
        with self._lock:
            sp = self._sessions.get(session_id)
            if sp is None or n <= 0:
                return
            old_tokens = sp.tokens
            sp.tokens = old_tokens + n
            sp.last_used = now
            ok = (token_ids is not None and len(token_ids) == n
                  and len(sp.token_ids) == old_tokens)
            if not ok:
                sp.token_ids = []
                return
            sp.token_ids = sp.token_ids + [int(t) for t in token_ids]
            ids = sp.token_ids
            for b in range(old_tokens // P, (sp.tokens - 1) // P + 1):
                page = sp.pages[b]
                block = tuple(ids[b * P:min((b + 1) * P, sp.tokens)])
                parent = sp.pages[b - 1] if b > 0 else _ROOT
                self._unindex(page)
                if block:
                    self._index_page(parent, block, page)

    def truncate_reserved(self, session_id: str) -> int:
        """Release reserved pages past the committed token count.

        Speculative decoding reserves ``begin_append(sid, k+1)`` capacity
        but may commit fewer positions (a rejected tail): the trailing
        pages hold K/V of draft tokens that never became part of the
        sequence.  ``begin_append`` made every page of the write range
        exclusively owned and unindexed, so dropping them cannot disturb a
        sharer or the prefix index; the partial tail page that still holds
        committed tokens is kept (what lies past ``sp.tokens`` in it is
        masked by position everywhere).  Returns the number of pages
        freed."""
        with self._lock:
            sp = self._sessions.get(session_id)
            if sp is None:
                return 0
            keep = self.pages_needed(sp.tokens)
            freed = len(sp.pages) - keep
            if freed <= 0:
                return 0
            for page in sp.pages[keep:]:
                self._decref(page)
            del sp.pages[keep:]
            return freed

    # --------------------------------------------------------- prefix index
    def _unindex(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is not None:
            parent, block = key
            children = self._index.get(parent)
            if children is not None and children.get(block) == page:
                del children[block]
                if not children:
                    self._index.pop(parent, None)

    def _index_page(self, parent: int, block: Tuple[int, ...],
                    page: int) -> None:
        if page in self._page_key:      # one entry per page
            return
        children = self._index.setdefault(parent, {})
        if block in children:           # first writer wins
            return
        children[block] = page
        self._page_key[page] = (parent, block)

    def _match_prefix_locked(self, ids: List[int]
                             ) -> Tuple[List[int], int]:
        """Longest resident chain covering a prefix of ``ids``.

        Full-page blocks must match a stored block exactly; the walk ends
        at the first block matched only partially (the page is shared up
        to the common token prefix — positions beyond it are never read,
        and rewrites COW)."""
        P = self.page_size
        pages: List[int] = []
        matched = 0
        parent = _ROOT
        n = len(ids)
        while matched < n:
            block = tuple(ids[matched:matched + P])
            children = self._index.get(parent)
            if not children:
                break
            page = children.get(block)
            if page is not None and len(block) == P:
                pages.append(page)
                matched += P
                parent = page
                continue
            best, best_c = None, 0
            for key, kpage in children.items():
                m = min(len(key), len(block))
                c = 0
                while c < m and key[c] == block[c]:
                    c += 1
                if c > best_c:
                    best, best_c = kpage, c
            if best is not None:
                pages.append(best)
                matched += best_c
            break
        return pages, matched

    def match_prefix(self, token_ids: List[int]) -> int:
        """Tokens of ``token_ids`` resident in the index (read-only probe)."""
        with self._lock:
            _pages, matched = self._match_prefix_locked(
                [int(t) for t in token_ids])
            return matched

    def acquire_prefix(self, session_id: str, token_ids: List[int],
                       now: float = 0.0) -> int:
        """Adopt the longest indexed chain covering a prefix of
        ``token_ids`` as the (cold) session's initial pages.

        Returns the number of tokens now cached for the session (0 on a
        miss or if the session already holds pages)."""
        ids = [int(t) for t in token_ids]
        with self._lock:
            sp = self._sessions.get(session_id)
            if sp is not None and sp.pages:
                return 0
            self.stats["prefix_queries"] += 1
            pages, matched = self._match_prefix_locked(ids)
            if matched <= 0:
                return 0
            for p in pages:
                self._incref(p)
            if sp is None:
                sp = SessionPages(session_id)
                self._sessions[session_id] = sp
            sp.pages = list(pages)
            sp.tokens = matched
            sp.token_ids = ids[:matched]
            sp.last_used = now
            sp.offloaded = False
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens"] += matched
            return matched

    # ----------------------------------------------------------- hint hooks
    def on_hint(self, session_id: str, hint: str) -> None:
        """KVRegistry hook target (retain/drop/offload/migrate_*)."""
        with self._lock:
            sp = self._sessions.get(session_id)
            if sp is None:
                return
            if hint == "retain":
                sp.pinned = True
            elif hint == "drop":
                sp.pinned = False
                # a protected session is the live write target of an active
                # paged decode: freeing its pages under the step would hand
                # them to another session mid-write.  The hint downgrades
                # to unpin; LRU reclaims the pages once decode finishes.
                if session_id not in self._protected:
                    self._release(sp)
                    self._sessions.pop(session_id, None)
            elif hint == "offload":
                sp.offloaded = True
                sp.pinned = False
            elif hint == "migrate_out":
                # ownership moved away; drop local references (shared pages
                # stay alive for their remaining owners)
                if session_id not in self._protected:
                    self._release(sp)
                    self._sessions.pop(session_id, None)
            # "migrate_in": the pages arrive through import_session

    # ----------------------------------------------------------- migration
    def compatible_with(self, other: "PagedKVPool") -> bool:
        """Page payloads are portable between pools of identical geometry."""
        return (isinstance(other, PagedKVPool)
                and self.page_size == other.page_size
                and self.k.shape[0] == other.k.shape[0]
                and self.k.shape[2:] == other.k.shape[2:]
                and self.k.dtype == other.k.dtype)

    def export_session(self, session_id: str) -> Optional[Dict[str, Any]]:
        """Serialize a session's K/V pages (the migration payload; the
        page tensors are copied to host memory)."""
        with self._lock:
            sp = self._sessions.get(session_id)
            if sp is None or not sp.pages:
                return None
            idx = torch.as_tensor(sp.pages, device=self.device)
            return {"k": self.k[:, idx].cpu(),
                    "v": self.v[:, idx].cpu(),
                    "tokens": sp.tokens,
                    "token_ids": list(sp.token_ids),
                    "page_size": self.page_size}

    def import_session(self, session_id: str, payload,
                       now: float = 0.0) -> bool:
        """Install a migration payload, deduplicating against the local
        prefix index: full pages whose token blocks are already resident
        are adopted (refcounted) instead of copied."""
        if payload is None:
            return False
        if isinstance(payload, dict):
            kpages, vpages = payload["k"], payload["v"]
            tokens = payload["tokens"]
            token_ids = payload.get("token_ids") or []
            if payload.get("page_size", self.page_size) != self.page_size:
                return False
        else:   # legacy (k, v, tokens) tuple
            kpages, vpages, tokens = payload
            token_ids = []
        n = kpages.shape[1]
        ids = [int(t) for t in token_ids]
        if len(ids) != tokens:
            ids = []
        P = self.page_size
        with self._lock:
            old = self._sessions.pop(session_id, None)
            if old is not None:
                self._release(old)
            # adopt resident full pages (exact-chain matches only: a
            # partially matched page cannot be spliced with payload pages)
            shared: List[int] = []
            if ids:
                chain, matched = self._match_prefix_locked(ids)
                shared = chain[:matched // P]
                for p in shared:
                    self._incref(p)
                self.stats["dedup_pages"] += len(shared)
            first_new = len(shared)
            fresh: List[int] = []
            for _ in range(first_new, n):
                page = self._alloc_page(now, avoid=session_id)
                if page is None:
                    for p in shared:
                        self._decref(p)
                    for p in fresh:
                        self._decref(p)
                    return False
                fresh.append(page)
            if fresh:
                idx = torch.as_tensor(fresh, device=self.device)
                self.k[:, idx] = self._on_device(kpages[:, first_new:])
                self.v[:, idx] = self._on_device(vpages[:, first_new:])
            pages = shared + fresh
            if ids:
                parent = shared[-1] if shared else _ROOT
                for b, page in enumerate(fresh, start=first_new):
                    block = tuple(ids[b * P:min((b + 1) * P, tokens)])
                    if block:
                        self._index_page(parent, block, page)
                    parent = page
            self._sessions[session_id] = SessionPages(
                session_id, pages=pages, tokens=tokens, token_ids=ids,
                last_used=now)
            return True

    # ------------------------------------------------------------- reading
    def session(self, session_id: str) -> Optional[SessionPages]:
        with self._lock:
            return self._sessions.get(session_id)

    def page_table(self, session_id: str, max_pages: int) -> np.ndarray:
        """Padded page table row for the paged attention kernel."""
        with self._lock:
            sp = self._sessions.get(session_id)
            pages = sp.pages if sp else []
        row = np.full((max_pages,), -1, np.int32)
        row[:len(pages)] = pages[:max_pages]
        return row

    def gather_contiguous(self, session_id: str, max_seq: int):
        """Materialize [L, max_seq, Hkv, Dh] dense K/V.

        Not on the paged plane's hot path (paged-native decode consumes
        page tables directly).  The dense plane's resume, the suffix-only
        warm extension and the tests that compare cache bytes use it."""
        with self._lock:
            sp = self._sessions.get(session_id)
            if sp is None or not sp.pages:
                return None
            idx = torch.as_tensor(sp.pages, device=self.device)
            tokens = sp.tokens
        L = self.cfg.n_layers
        k = self.k[:, idx].reshape(L, -1, *self.k.shape[3:])[:, :max_seq]
        v = self.v[:, idx].reshape(L, -1, *self.v.shape[3:])[:, :max_seq]
        return k, v, tokens

    # ------------------------------------------------------------- writing
    def write_session(self, session_id: str, k_seq, v_seq, tokens: int,
                      now: float = 0.0, token_ids=None) -> bool:
        """Store a sequence's dense K/V ([L, S, Hkv, Dh]) into pages.

        With ``token_ids`` (one id per cached position) the write is
        sharing-aware: full pages whose token prefix is unchanged stay in
        place untouched — shared pages stay shared, which *is* the
        copy-on-write: the diverging tail gets fresh pages while the old
        tail pages survive for their other owners.  New full pages (and
        the partial tail) enter the prefix index for future cross-session
        hits.  Without ``token_ids`` the legacy release-and-rewrite path
        runs (opaque contents, no sharing)."""
        ids = None
        if token_ids is not None:
            ids = [int(t) for t in token_ids]
            if len(ids) != tokens:
                ids = None
        if ids is None:
            return self._write_opaque(session_id, k_seq, v_seq, tokens, now)
        P = self.page_size
        n_blocks = self.pages_needed(tokens)
        with self._lock:
            sp = self._sessions.setdefault(session_id,
                                           SessionPages(session_id))
            old_pages = list(sp.pages)
            old_valid = len(sp.token_ids) == sp.tokens and sp.tokens > 0
            common = 0
            if old_valid:
                m = min(len(sp.token_ids), tokens)
                while common < m and sp.token_ids[common] == ids[common]:
                    common += 1
            keep = min(common // P, sp.tokens // P, len(old_pages))
            # build the new chain before dropping the old tail, so an
            # unchanged tail is re-adopted instead of freed and rewritten
            pages = old_pages[:keep]
            parent = pages[-1] if pages else _ROOT
            adopted: List[int] = []
            fresh: List[int] = []
            novel: List[Tuple[int, int]] = []       # (block index, page)
            ok = True
            for b in range(keep, n_blocks):
                block = tuple(ids[b * P:min((b + 1) * P, tokens)])
                child = self._index.get(parent, {}).get(block)
                if child is not None and self._ref.get(child, 0) > 0:
                    self._incref(child)
                    adopted.append(child)
                    pages.append(child)
                    parent = child
                    continue
                page = self._alloc_page(now, avoid=session_id)
                if page is None:
                    ok = False
                    break
                fresh.append(page)
                novel.append((b, page))
                self._index_page(parent, block, page)
                pages.append(page)
                parent = page
            if not ok:
                for p in adopted + fresh:
                    self._decref(p)
                return False
            self.stats["dedup_pages"] += len(adopted)
            # divergence from a shared page = the copy-on-write event: the
            # old owner keeps the page, this session wrote a fresh one
            new_set = set(pages)
            self.stats["cow_copies"] += sum(
                1 for p in old_pages[keep:]
                if p not in new_set and self._ref.get(p, 0) > 1)
            for p in old_pages[keep:]:
                self._decref(p)
            if novel:
                kp = self._as_pages(k_seq, n_blocks)
                vp = self._as_pages(v_seq, n_blocks)
                bsel = torch.as_tensor([b for b, _ in novel],
                                       device=self.device)
                psel = torch.as_tensor([p for _, p in novel],
                                       device=self.device)
                self.k[:, psel] = kp[:, bsel]
                self.v[:, psel] = vp[:, bsel]
            sp.pages = pages
            sp.tokens = tokens
            sp.token_ids = ids
            sp.last_used = now
            sp.offloaded = False
            return True

    def _write_opaque(self, session_id: str, k_seq, v_seq, tokens: int,
                      now: float) -> bool:
        """Legacy path: fresh exclusive pages, contents unindexed."""
        self.release(session_id)
        sp = self.allocate(session_id, tokens, now)
        if sp is None:
            return False
        idx = torch.as_tensor(sp.pages, device=self.device)
        kp = self._as_pages(k_seq, len(sp.pages))
        vp = self._as_pages(v_seq, len(sp.pages))
        with self._lock:
            self.k[:, idx] = kp
            self.v[:, idx] = vp
        return True

    def _on_device(self, x) -> torch.Tensor:
        """A payload or sequence tensor (torch or numpy) in the pool's
        device and type."""
        return torch.as_tensor(x).to(device=self.device, dtype=self.k.dtype)

    def _as_pages(self, seq, n_blocks: int) -> torch.Tensor:
        """Dense [L, S, Hkv, Dh] -> [L, n_blocks, P, Hkv, Dh], zero-padded
        past S."""
        seq = self._on_device(seq)
        pad = n_blocks * self.page_size - seq.shape[1]
        if pad:
            seq = F.pad(seq, (0, 0, 0, 0, 0, pad))
        return seq.reshape(self.cfg.n_layers, n_blocks, self.page_size,
                           *seq.shape[2:])

    # ----------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Assert the pool's aliasing/accounting invariants (test hook).

        * every page is exactly one of: free, or referenced by >= 1 session;
        * refcounts equal the number of session page-lists containing the
          page (no double-free, no leak: free + live == n_pages);
        * no page appears twice in one session (aliased positions);
        * index entries point at live pages, agree with the reverse map,
          and hang off live parents.
        """
        with self._lock:
            free = list(self._free)
            assert len(free) == len(set(free)), "duplicate pages in free list"
            occ: Dict[int, int] = {}
            for sp in self._sessions.values():
                assert len(sp.pages) == len(set(sp.pages)), \
                    f"session {sp.session_id} owns a page twice"
                assert sp.tokens <= len(sp.pages) * self.page_size, \
                    f"session {sp.session_id} tokens exceed its pages"
                assert len(sp.token_ids) in (0, sp.tokens), \
                    f"session {sp.session_id} token_ids length mismatch"
                for p in sp.pages:
                    occ[p] = occ.get(p, 0) + 1
            for p, n in occ.items():
                assert self._ref.get(p, 0) == n, \
                    f"page {p}: refcount {self._ref.get(p, 0)} != {n} owners"
                assert p not in free, f"page {p} is both owned and free"
            live = {p for p, r in self._ref.items() if r > 0}
            assert live == set(occ), \
                f"refcounted pages {live} != owned pages {set(occ)}"
            assert len(free) + len(live) == self.n_pages, \
                f"{len(free)} free + {len(live)} live != {self.n_pages}"
            for page, (parent, block) in self._page_key.items():
                assert self._ref.get(page, 0) > 0, \
                    f"index entry for free page {page}"
                assert self._index.get(parent, {}).get(block) == page, \
                    f"reverse map for page {page} disagrees with index"
                assert parent == _ROOT or self._ref.get(parent, 0) > 0, \
                    f"page {page} indexed under freed parent {parent}"
            for parent, children in self._index.items():
                for block, page in children.items():
                    assert self._page_key.get(page) == (parent, block), \
                        f"index entry ({parent},{block})->{page} unmapped"


class StateCachePool:
    """State cache pool for SSM and hybrid sessions: each session's conv
    window and recurrent state (one batch-1 cache row; the hybrid's row
    also holds the K/V rings of its local-attention layers, bounded by the
    window) and the tokens it stands for.  Migration costs the same
    whatever the session's length.

    The pool keeps what it is given: the engine stores copies, never views
    of its live slot cache.  ``import_session`` copies the payload's
    tensors (the reference's arrays are immutable, torch tensors are not),
    so an exporting and an importing pool never share a tensor."""

    def __init__(self, cfg: ModelConfig) -> None:
        self.cfg = cfg
        self._states: Dict[str, Tuple[dict, int]] = {}
        self._lock = threading.RLock()

    def store(self, session_id: str, state: dict, tokens: int) -> None:
        with self._lock:
            self._states[session_id] = (state, tokens)

    def load(self, session_id: str) -> Optional[Tuple[dict, int]]:
        with self._lock:
            return self._states.get(session_id)

    def release(self, session_id: str) -> None:
        with self._lock:
            self._states.pop(session_id, None)

    def on_hint(self, session_id: str, hint: str) -> None:
        if hint in ("drop", "migrate_out"):
            self.release(session_id)

    def export_session(self, session_id: str
                       ) -> Optional[Tuple[dict, int]]:
        with self._lock:
            return self._states.get(session_id)

    def import_session(self, session_id: str, payload,
                       now: float = 0.0) -> bool:
        state, tokens = payload
        copy = {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in state.items()}
        with self._lock:
            self._states[session_id] = (copy, tokens)
            return True
