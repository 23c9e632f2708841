"""Session registry (paper §3.3, §4.3.2).

A *request* is a single inference request from the user; a *session* is a
collection of requests that share context (e.g. a chat).  NALAR assigns every
new session a unique id and propagates it with each future, which is what lets
controllers tag, track, and relocate state without developer involvement.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Thread-local execution context: which (session, request) the current code
# runs under.  Stubs read this to tag futures automatically.
_ctx = threading.local()


@dataclass
class SessionInfo:
    session_id: str
    priority: float = 0.0
    created_at: float = 0.0
    # per-agent-type priority overrides (Table 2 set_priority variant 2)
    agent_priority: Dict[str, float] = field(default_factory=dict)
    # requests issued under this session
    request_ids: List[str] = field(default_factory=list)
    active: bool = True

    def priority_for(self, agent_type: str) -> float:
        return self.agent_priority.get(agent_type, self.priority)


class SessionRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sessions: Dict[str, SessionInfo] = {}
        # per-runtime counters: session-id strings seed workload RNG
        # streams, so they must be reproducible run-to-run
        self._session_ids = itertools.count()
        self._request_ids = itertools.count()

    def new_session(self, now: float = 0.0, priority: float = 0.0) -> SessionInfo:
        sid = f"s{next(self._session_ids)}"
        info = SessionInfo(session_id=sid, priority=priority, created_at=now)
        with self._lock:
            self._sessions[sid] = info
        return info

    def new_request(self, session_id: str) -> str:
        rid = f"r{next(self._request_ids)}"
        with self._lock:
            info = self._sessions.get(session_id)
            if info is not None:
                info.request_ids.append(rid)
        return rid

    def get(self, session_id: str) -> Optional[SessionInfo]:
        with self._lock:
            return self._sessions.get(session_id)

    def set_priority(self, session_id: str, value: float,
                     agent_type: Optional[str] = None) -> None:
        with self._lock:
            info = self._sessions.get(session_id)
            if info is None:
                return
            if agent_type is None:
                info.priority = value
            else:
                info.agent_priority[agent_type] = value

    def close(self, session_id: str) -> None:
        with self._lock:
            info = self._sessions.get(session_id)
            if info is not None:
                info.active = False

    def all(self) -> List[SessionInfo]:
        with self._lock:
            return list(self._sessions.values())


# ------------------------------------------------------------- exec context
def set_context(session_id: str, request_id: str, caller: str) -> None:
    _ctx.session_id = session_id
    _ctx.request_id = request_id
    _ctx.caller = caller


def get_context() -> tuple:
    return (
        getattr(_ctx, "session_id", ""),
        getattr(_ctx, "request_id", ""),
        getattr(_ctx, "caller", "driver:anonymous"),
    )


def clear_context() -> None:
    for a in ("session_id", "request_id", "caller", "deadline"):
        if hasattr(_ctx, a):
            delattr(_ctx, a)


# The current code's absolute deadline (kernel time), or -1.0 when none.
# Stubs read it so child calls inherit the parent's *remaining* budget; the
# runtime sets it when entering an agent context (from the running future's
# metadata) and drivers seed it via ``submit_request(deadline_s=...)``.
def set_current_deadline(deadline: float) -> None:
    if deadline is None or deadline < 0:
        if hasattr(_ctx, "deadline"):
            delattr(_ctx, "deadline")
    else:
        _ctx.deadline = deadline


def get_current_deadline() -> float:
    return getattr(_ctx, "deadline", -1.0)
