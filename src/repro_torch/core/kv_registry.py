"""K,V-cache residency registry (paper §4.3.2).

NALAR tracks futures, so it knows which requests are pending or likely to
arrive, and can hint the LLM serving layer which K,V caches to retain, evict,
or migrate — the LMCache-hook mechanism in the paper.  This registry is the
agent-layer side of that contract; ``repro_torch.serving.kv_cache`` consumes the
hints on the TPU side (HBM-resident paged cache with per-session page tables).

Hints are advisory; the serving layer remains correct if it ignores them —
it just falls back to generic LRU like vanilla vLLM/SGLang.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple


class Residency(str, Enum):
    DEVICE = "device"        # keep in HBM (GPU memory in the paper)
    FAR = "far"              # offload to host/far memory
    DROP = "drop"            # safe to evict


@dataclass
class SessionCacheInfo:
    session_id: str
    instance_id: str                  # engine instance holding the cache
    tokens: int = 0                   # cached prefix length
    residency: Residency = Residency.DEVICE
    pinned_until: float = 0.0         # retain-hint deadline
    last_used: float = 0.0


class KVRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sessions: Dict[str, SessionCacheInfo] = {}
        # serving-layer callbacks: instance_id -> hook(session_id, hint)
        self._hooks: Dict[str, Callable[[str, str], None]] = {}
        # reuse-decision telemetry: how often the agent layer found a warm
        # cache when preparing a call (consumed by the engine bridge)
        self.stats: Dict[str, int] = {"reuse_queries": 0, "reuse_hits": 0,
                                      "reuse_tokens": 0}

    # ------------------------------------------------------------ bookkeeping
    def touch(self, session_id: str, instance_id: str, tokens: int,
              now: float) -> None:
        with self._lock:
            info = self._sessions.get(session_id)
            if info is None or info.instance_id != instance_id:
                info = SessionCacheInfo(session_id, instance_id)
                self._sessions[session_id] = info
            info.tokens = max(info.tokens, tokens)
            info.last_used = now

    def lookup(self, session_id: str) -> Optional[SessionCacheInfo]:
        with self._lock:
            return self._sessions.get(session_id)

    def cached_tokens(self, session_id: str, instance_id: str) -> int:
        with self._lock:
            info = self._sessions.get(session_id)
            if info is None or info.instance_id != instance_id:
                return 0
            if info.residency == Residency.DROP:
                return 0
            return info.tokens

    def expect_reuse(self, session_id: str, instance_id: str) -> int:
        """Like ``cached_tokens`` but records the query in ``stats`` — the
        agent layer calls this when deciding whether a follow-up can be sent
        as a continuation suffix (warm cache) or needs its full context
        rebuilt (cold)."""
        tokens = self.cached_tokens(session_id, instance_id)
        with self._lock:
            self.stats["reuse_queries"] += 1
            if tokens > 0:
                self.stats["reuse_hits"] += 1
                self.stats["reuse_tokens"] += tokens
        return tokens

    def instance_sessions(self, instance_id: str) -> List[str]:
        """Sessions whose cache currently resides on ``instance_id``."""
        with self._lock:
            return [s for s, i in self._sessions.items()
                    if i.instance_id == instance_id
                    and i.residency != Residency.DROP]

    def residency_map(self) -> Dict[str, Tuple[str, int]]:
        """session_id -> (instance holding its cache, cached token count).

        The global controller snapshots this into ``ClusterView.kv_residency``
        so policies can express KV-affinity with the plain ``route``
        primitive (see ``policy.KVAffinityPolicy``).  Dropped caches are
        excluded — a released session has no affinity."""
        with self._lock:
            return {s: (i.instance_id, i.tokens)
                    for s, i in self._sessions.items()
                    if i.residency != Residency.DROP}

    # ----------------------------------------------------------------- hints
    def register_hook(self, instance_id: str,
                      hook: Callable[[str, str], None]) -> None:
        with self._lock:
            self._hooks[instance_id] = hook

    def _fire(self, instance_id: str, session_id: str, hint: str) -> None:
        hook = self._hooks.get(instance_id)
        if hook is not None:
            hook(session_id, hint)

    def retain(self, session_id: str, until: float) -> None:
        """Global-controller hint: this session's cache will be reused soon."""
        with self._lock:
            info = self._sessions.get(session_id)
            if info is None:
                return
            info.pinned_until = max(info.pinned_until, until)
            inst = info.instance_id
        self._fire(inst, session_id, "retain")

    def release(self, session_id: str) -> None:
        """Session ended: the cache may be evicted immediately."""
        with self._lock:
            info = self._sessions.get(session_id)
            if info is None:
                return
            info.residency = Residency.DROP
            info.pinned_until = 0.0
            inst = info.instance_id
        self._fire(inst, session_id, "drop")

    def offload(self, session_id: str) -> None:
        with self._lock:
            info = self._sessions.get(session_id)
            if info is None:
                return
            info.residency = Residency.FAR
            inst = info.instance_id
        self._fire(inst, session_id, "offload")

    # -------------------------------------------------------------- migration
    def migrate(self, session_id: str, src_instance: str,
                dst_instance: str) -> int:
        """Move cache ownership; returns migrated token count (cost model)."""
        with self._lock:
            info = self._sessions.get(session_id)
            if info is None or info.instance_id != src_instance:
                return 0
            info.instance_id = dst_instance
            tokens = info.tokens
        self._fire(src_instance, session_id, "migrate_out")
        self._fire(dst_instance, session_id, "migrate_in")
        return tokens

    def eviction_candidates(self, instance_id: str, now: float) -> List[str]:
        """Sessions safe to evict on this instance (not pinned), LRU order."""
        with self._lock:
            cands = [i for i in self._sessions.values()
                     if i.instance_id == instance_id and i.pinned_until <= now
                     and i.residency != Residency.DROP]
        return [i.session_id for i in sorted(cands, key=lambda i: i.last_used)]
