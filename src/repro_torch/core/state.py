"""Managed state layer (paper §3.3, §4.3.2).

``managedList`` / ``managedDict`` look like ordinary Python containers but are
runtime-tracked entities with user-session-based identities.  Logical state is
indexed by (session_id, agent_type, name) in the node store; the physical copy
lives wherever the owning agent instance runs and moves with session
migration.  To the developer the state appears local and stable.

Design notes mirroring the paper:
* the local controller always knows which session a request belongs to, so
  state access needs no explicit session plumbing (the session id comes from
  the thread-local execution context);
* when an agent begins serving a request, the controller consults the node
  store and reconstructs the managed containers ("materialization");
* migration transfers the serialized state between node stores and updates
  the placement index.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .session import get_context

# sentinel recorded in an epoch's undo log when the state object did not
# exist before the epoch's first touch (rollback deletes it again)
_MISSING = object()


class SessionStateStore:
    """Authoritative registry of managed state, layered on node stores.

    Keys: (session_id, agent_type, name) -> (node_id, payload).
    The payload is the *logical* value; placement (node_id) is runtime-owned.

    **State epochs (consistent retries).**  Every agent-method attempt runs
    inside an epoch keyed by ``(fid, attempt)``: the controller opens it via
    ``begin_epoch`` before invoking user code, and the first touch of each
    state object inside the epoch records a deep-copy undo snapshot.  On
    success the epoch is committed (snapshots dropped); on failure it is
    rolled back *before* the retry re-executes, so ``ManagedList`` /
    ``ManagedDict`` / ``SessionTranscript`` mutations are exactly-once
    across retries.  Snapshots store *logical* values — rollback writes
    through the current placement, so a migration landing between the failed
    attempt and the retry restores correctly at the new node.

    Epochs cover the failing method's own writes.  A retried *composite*
    re-issues its nested stub calls as fresh futures with fresh epochs;
    nested effects should be idempotent or live in the leaf that owns them.
    """

    def __init__(self, store_cluster) -> None:
        self._cluster = store_cluster
        self._lock = threading.RLock()
        # (sid, agent_type, name) -> node_id  (placement index)
        self._placement: Dict[Tuple[str, str, str], str] = {}
        # epoch token -> {(sid, agent_type, name): pre-epoch value | _MISSING}
        self._epochs: Dict[Any, Dict[Tuple[str, str, str], Any]] = {}
        # per-thread stack of active epoch tokens (innermost = writes owner)
        self._epoch_tl = threading.local()
        # rolled-back epochs (bounded, insertion-ordered).  A hard-killed or
        # cancelled *composite* attempt keeps executing on its driver thread
        # (threads cannot be killed); once its epoch is rolled back, any
        # further write it makes must be DROPPED — un-journaled writes from
        # a superseded attempt would break the exactly-once guarantee.
        self._aborted: Dict[Any, None] = {}

    # ------------------------------------------------------------- epochs
    def _epoch_stack(self) -> list:
        st = getattr(self._epoch_tl, "stack", None)
        if st is None:
            st = []
            self._epoch_tl.stack = st
        return st

    def begin_epoch(self, token: Any) -> None:
        """Open (or re-bind) the undo log for one execution attempt."""
        with self._lock:
            self._epochs.setdefault(token, {})
        self._epoch_stack().append(token)

    def end_epoch_binding(self) -> None:
        """Unbind the innermost epoch from this thread (the undo log itself
        survives until commit/rollback — the completion path owns that)."""
        st = self._epoch_stack()
        if st:
            st.pop()

    _MAX_ABORTED = 4096

    def _active_token(self) -> Any:
        st = self._epoch_stack()
        return st[-1] if st else None

    def _active_aborted(self) -> bool:
        """Is the calling thread executing a rolled-back attempt?
        (Caller holds ``_lock``.)"""
        t = self._active_token()
        return t is not None and t in self._aborted

    def commit_epoch(self, token: Any) -> None:
        """Attempt succeeded: its writes are final, drop the undo log."""
        with self._lock:
            self._epochs.pop(token, None)

    def rollback_epoch(self, token: Any) -> int:
        """Attempt failed: restore every state object it touched.

        Returns the number of restored objects.  Restores go through the
        *current* placement, which makes rollback correct even when the
        session migrated after the snapshot was taken.
        """
        with self._lock:
            snap = self._epochs.pop(token, None)
            # tombstone the attempt even when it wrote nothing yet: its
            # (possibly still-running) thread may write later
            self._aborted[token] = None
            while len(self._aborted) > self._MAX_ABORTED:
                self._aborted.pop(next(iter(self._aborted)))
            if not snap:
                return 0
            n = 0
            for (sid, at, name), prior in snap.items():
                node = self._placement.get((sid, at, name))
                key = self._key(sid, at, name)
                if prior is _MISSING:
                    if node is not None:
                        self._placement.pop((sid, at, name), None)
                        self._cluster.get(node).delete(key)
                elif node is not None:
                    self._cluster.get(node).hset(
                        key, "value", copy.deepcopy(prior))
                n += 1
            return n

    def _note(self, sid: str, agent_type: str, name: str, prior: Any) -> None:
        """Record the pre-epoch value on first touch (caller holds _lock)."""
        st = self._epoch_stack()
        if not st:
            return
        snap = self._epochs.get(st[-1])
        if snap is None:
            return
        key = (sid, agent_type, name)
        if key not in snap:
            snap[key] = prior if prior is _MISSING else copy.deepcopy(prior)

    @staticmethod
    def _key(sid: str, agent_type: str, name: str) -> str:
        return f"state:{sid}:{agent_type}:{name}"

    def load(self, sid: str, agent_type: str, name: str, node_id: str,
             default: Any) -> Any:
        with self._lock:
            aborted = self._active_aborted()
            placed = self._placement.get((sid, agent_type, name))
            if placed is None:
                if aborted:
                    # a superseded attempt must not create state objects
                    return default
                # first touch ever: inside an epoch, rollback must delete it
                self._note(sid, agent_type, name, _MISSING)
                self._placement[(sid, agent_type, name)] = node_id
                store = self._cluster.get(node_id)
                store.hset(self._key(sid, agent_type, name), "value", default)
                return default
            store = self._cluster.get(placed)
            v = store.hget(self._key(sid, agent_type, name), "value")
            if aborted:
                # read-only for zombies: no journaling, no placement moves —
                # and a COPY, because callers (ManagedList.append) mutate
                # the returned object in place before saving
                return copy.deepcopy(v) if v is not None else default
            # epoch undo log: snapshot the pristine value before the caller
            # mutates the returned object in place (ManagedList.append etc.)
            self._note(sid, agent_type, name, v if v is not None else default)
            if placed != node_id:
                # State lives elsewhere: materialize locally (the runtime moved
                # the request here, so the state follows — §4.3.2).
                self.migrate(sid, agent_type, name, node_id)
            return v if v is not None else default

    def save(self, sid: str, agent_type: str, name: str, value: Any) -> None:
        with self._lock:
            if self._active_aborted():
                return      # drop writes from superseded (rolled-back) attempts
            node_id = self._placement.get((sid, agent_type, name))
            if node_id is None:
                return
            key = self._key(sid, agent_type, name)
            if self._epoch_stack():
                # write-without-load (e.g. ManagedList.clear): capture the
                # pre-overwrite value if this epoch hasn't touched the key
                # yet.  Epoch-less writers (the engine bridge's pump thread)
                # skip the read-before-write entirely.
                cur = self._cluster.get(node_id).hget(key, "value")
                self._note(sid, agent_type, name,
                           cur if cur is not None else _MISSING)
            self._cluster.get(node_id).hset(key, "value", value)

    def migrate(self, sid: str, agent_type: str, name: str, dst_node: str) -> int:
        """Move one state object; returns payload size estimate (bytes-ish)."""
        with self._lock:
            src_node = self._placement.get((sid, agent_type, name))
            if src_node is None or src_node == dst_node:
                self._placement[(sid, agent_type, name)] = dst_node
                return 0
            key = self._key(sid, agent_type, name)
            src = self._cluster.get(src_node)
            val = src.hget(key, "value")
            src.delete(key)
            self._cluster.get(dst_node).hset(key, "value", val)
            self._placement[(sid, agent_type, name)] = dst_node
            return _sizeof(val)

    def migrate_session(self, sid: str, agent_type: str, dst_node: str) -> int:
        """Move all state of (session, agent) to dst.  Returns total bytes."""
        with self._lock:
            keys = [k for k in self._placement if k[0] == sid and k[1] == agent_type]
        return sum(self.migrate(sid, agent_type, name, dst_node)
                   for (_, _, name) in keys)

    def session_state_names(self, sid: str, agent_type: str) -> List[str]:
        with self._lock:
            return [n for (s, a, n) in self._placement
                    if s == sid and a == agent_type]

    def placement_of(self, sid: str, agent_type: str, name: str) -> Optional[str]:
        with self._lock:
            return self._placement.get((sid, agent_type, name))

    def drop_session(self, sid: str) -> None:
        with self._lock:
            keys = [k for k in self._placement if k[0] == sid]
            for k in keys:
                node = self._placement.pop(k)
                self._cluster.get(node).delete(self._key(*k))


def _sizeof(v: Any) -> int:
    try:
        import sys
        if isinstance(v, (list, tuple)):
            return sum(_sizeof(i) for i in v) + 56
        if isinstance(v, dict):
            return sum(_sizeof(k) + _sizeof(x) for k, x in v.items()) + 64
        return sys.getsizeof(v)
    except Exception:
        return 64


# --------------------------------------------------------------------------
# Developer-facing containers.  They bind lazily: the first access inside an
# agent resolves (session, agent_type, node) from the execution context that
# the component controller installed before invoking user code.
# --------------------------------------------------------------------------
class _ManagedBase:
    def __init__(self, name: str, runtime=None) -> None:
        self._name = name
        self._runtime = runtime  # bound at first access if None

    def _bind(self) -> Tuple[SessionStateStore, str, str, str]:
        from .runtime import current_runtime
        rt = self._runtime or current_runtime()
        if rt is None:
            raise RuntimeError(
                "managed state used outside a NALAR runtime; run the workflow "
                "via deployment.main() or nalar.testing.local_runtime()")
        sid, _rid, caller = get_context()
        agent_type = caller.split(":")[0]
        node = rt.node_of_instance(caller)
        rt.mark_uses_managed_state(agent_type)
        return rt.state_store, sid or "_global", agent_type, node


class ManagedList(_ManagedBase):
    """Drop-in list with session-scoped identity and runtime-managed placement."""

    def _get(self) -> list:
        store, sid, at, node = self._bind()
        return store.load(sid, at, self._name, node, default=[])

    def _put(self, v: list) -> None:
        store, sid, at, _ = self._bind()
        store.save(sid, at, self._name, v)

    def append(self, item: Any) -> None:
        v = self._get(); v.append(item); self._put(v)

    def extend(self, items) -> None:
        v = self._get(); v.extend(items); self._put(v)

    def __getitem__(self, i):
        return self._get()[i]

    def __setitem__(self, i, val) -> None:
        v = self._get(); v[i] = val; self._put(v)

    def __len__(self) -> int:
        return len(self._get())

    def __iter__(self) -> Iterator:
        return iter(self._get())

    def __contains__(self, item) -> bool:
        return item in self._get()

    def clear(self) -> None:
        self._put([])

    def snapshot(self) -> list:
        return list(self._get())


class ManagedDict(_ManagedBase):
    """Drop-in dict with session-scoped identity and runtime-managed placement."""

    def _get(self) -> dict:
        store, sid, at, node = self._bind()
        return store.load(sid, at, self._name, node, default={})

    def _put(self, v: dict) -> None:
        store, sid, at, _ = self._bind()
        store.save(sid, at, self._name, v)

    def __getitem__(self, k):
        v = self._get()
        if k not in v:
            raise KeyError(k)
        return v[k]

    def __setitem__(self, k, val) -> None:
        v = self._get(); v[k] = val; self._put(v)

    def __delitem__(self, k) -> None:
        v = self._get(); del v[k]; self._put(v)

    def get(self, k, default=None):
        return self._get().get(k, default)

    def setdefault(self, k, default=None):
        v = self._get()
        out = v.setdefault(k, default)
        self._put(v)
        return out

    def __len__(self) -> int:
        return len(self._get())

    def __iter__(self) -> Iterator:
        return iter(self._get())

    def __contains__(self, k) -> bool:
        return k in self._get()

    def items(self):
        return self._get().items()

    def keys(self):
        return self._get().keys()

    def values(self):
        return self._get().values()

    def clear(self) -> None:
        self._put({})

    def snapshot(self) -> dict:
        return dict(self._get())


class SessionTranscript:
    """Per-(session, agent_type) token transcript kept in managed state.

    The engine bridge uses this to make prefix-KV reuse *semantically* real:
    every LLM call in a session appends (prompt + generated) token ids here,
    so a follow-up call knows the full conversation context.  When the
    engine still holds the session's KV cache (per ``KVRegistry``), only the
    new suffix is sent; when the cache was evicted or the session migrated
    to a cold instance, the transcript rebuilds the full context in one
    prefill.  Because it lives in the ``SessionStateStore``, the transcript
    moves with session migration like any other managed state (§3.3).
    """

    NAME = "__llm_transcript__"

    def __init__(self, state_store: SessionStateStore, agent_type: str,
                 node_id: str) -> None:
        self._store = state_store
        self._agent_type = agent_type
        self._node = node_id

    def tokens(self, session_id: str) -> list:
        """The session's transcript, materialized at this binding's node.

        ``SessionStateStore.load`` moves the logical transcript here when it
        is placed elsewhere — which makes this call the state-layer half of
        cross-replica migration: the destination bridge's transcript binding
        reads the tokens (materializing them at the destination node) and
        ``serving.pool.EnginePool`` replays them into the destination
        engine's cache.  Token-level replay is what makes the move work
        across *heterogeneous* replicas, where raw KV pages would not be
        layout-compatible."""
        return list(self._store.load(session_id, self._agent_type, self.NAME,
                                     self._node, default=[]))

    def extend(self, session_id: str, new_tokens: list,
               max_tokens: Optional[int] = None) -> None:
        """Append tokens; with ``max_tokens``, keep only the trailing window
        (tokens beyond the engine's context budget can never be prefilled
        again, so storing them only bloats migration payloads)."""
        cur = self._store.load(session_id, self._agent_type, self.NAME,
                               self._node, default=[])
        out = list(cur) + [int(t) for t in new_tokens]
        if max_tokens is not None and len(out) > max_tokens:
            out = out[-max_tokens:]
        self._store.save(session_id, self._agent_type, self.NAME, out)

    def clear(self, session_id: str) -> None:
        self._store.save(session_id, self._agent_type, self.NAME, [])


# aliases matching the paper's naming
managedList = ManagedList
managedDict = ManagedDict
